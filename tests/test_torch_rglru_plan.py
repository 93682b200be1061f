"""The RG-LRU scan kernels' launch plan (``kernels/rglru/plan.py``), on the
CPU: the route each input takes, the ring's tile and depth against the
limits of TMA and of the H100's shared memory, the grid at the shapes the
LM path gives it, and each plan against the instantiations and constants
of ``csrc/rglru_scan.cu``; the same for the reverse mode (the gradient),
with a CPU twin of the reverse ring's walk over its zero-filled boxes held
bit-equal to the plain backward.  The kernels themselves, and their
stepping of exactly S rows of the zero-filled boxes, run only on the card
(``tests/test_torch_kernels_cuda.py``)."""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru import plan as P

# (B, S, R) at which the LM path launches the scan: the RecurrentGemma-9B
# prefill wave, ``score`` at B = 1, decode never (it steps the recurrence)
PREFILL, SCORE = (4, 4096, 4096), (1, 1024, 4096)
ITEMSIZE = {"f32": 4, "bf16": 2}
# the H100's limits: dynamic shared memory a block may take, the largest
# TMA box edge, and TMA's 16-byte unit of inner boxes and pitches
SMEM_LIMIT, TMA_BOX_MAX, TMA_UNIT = 232_448, 256, 16

SHAPES = [PREFILL, SCORE, (2, 37, 100), (3, 129, 200), (40, 167, 520),
          (2, 647, 4040), (1, 4096, 64), (64, 8, 4096), (4, 1, 4096),
          (2, 1000, 4096), (1, 5000, 8)]
# the (shape, dtype) pairs whose row pitch TMA takes (R = 100 in bf16 is
# 200 bytes, which it does not)
RING_CASES = [(shape, dt) for shape in SHAPES for dt in ITEMSIZE
              if shape[2] * ITEMSIZE[dt] % 16 == 0]
# the kernel source: its (dtype code, C, Tc) instantiations of the ring
SOURCE = (build.CSRC_DIR / "rglru_scan.cu").read_text()
INSTANTIATIONS = {tuple(map(int, m)) for m in re.findall(
    r"RGLRU_RING\(\w+, (\d), (\d+), (\d+)\)", SOURCE)}
DTYPE_CODE = {"f32": 0, "bf16": 1}


@pytest.mark.parametrize("shape,dt", RING_CASES)
def test_aligned_inputs_take_the_ring_within_the_limits(shape, dt):
    b, s, r = shape
    size = ITEMSIZE[dt]
    p = P.ring_plan(b, s, r, size)
    assert p.route == P.RING
    assert p.channels in P.RING_CHANNELS and p.stages == P.RING_STAGES
    # TMA: box edges <= 256, an inner box of whole 16-byte units
    assert p.channels <= TMA_BOX_MAX and p.steps <= TMA_BOX_MAX
    assert (p.channels * size) % TMA_UNIT == 0
    assert p.channels % 32 == 0               # whole consumer warps
    # a stage of 32 KB, 128 KB of a and b in the ring, two h tiles
    box = p.steps * p.channels * size
    assert 2 * box == P.STAGE_BYTES
    assert p.stages * 2 * box == 128 * 1024
    assert p.smem_bytes == P.SMEM_ALIGN + p.stages * 2 * box + 2 * box
    assert p.smem_bytes <= SMEM_LIMIT
    assert p.grid == (-(-r // p.channels), b)
    assert P.plan(b, s, r, size, (0, 256, 4096)) == p


@pytest.mark.parametrize("shape,dt", RING_CASES)
def test_every_ring_plan_has_its_instantiation(shape, dt):
    """The kernel launches only a (dtype, C, Tc) it was compiled for and
    refuses any other plan, so every plan the wrapper can make must name
    one of the source's instantiations."""
    p = P.ring_plan(*shape, ITEMSIZE[dt])
    assert (DTYPE_CODE[dt], p.channels, p.steps) in INSTANTIATIONS


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("c", P.RING_CHANNELS)
def test_each_channel_tile_is_instantiated_once(dt, c):
    """Each channel tile C of each dtype has exactly one instantiation,
    with the Tc that makes a stage of STAGE_BYTES."""
    steps = [tc for code, cc, tc in INSTANTIATIONS
             if code == DTYPE_CODE[dt] and cc == c]
    assert steps == [P.STAGE_BYTES // (2 * c * ITEMSIZE[dt])]


def test_plan_constants_match_the_kernel_source():
    """The shared memory the plan passes is checked against the kernel's
    own sum, which uses these constants."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])
    assert const("SMEM_ALIGN") == P.SMEM_ALIGN
    assert const("H_TILES") == P.H_TILES
    assert const("THREADS") == P.SIMPLE_THREADS
    assert const("UNROLL") == P.SIMPLE_UNROLL
    assert f"if (stages != {P.RING_STAGES}) return ERR_PLAN;" in SOURCE
    assert len(INSTANTIATIONS) == 2 * len(P.RING_CHANNELS)


@pytest.mark.parametrize("r,size,ring", [
    (37, 4, False),      # a row pitch of 148 bytes
    (100, 2, False),     # 200 bytes
    (100, 4, True),      # 400 bytes
    (4, 4, True),        # 16 bytes
    (4, 2, False),       # 8 bytes
    (8, 2, True),
    (4096, 4, True),
    (4095, 2, False),
])
def test_route_follows_the_row_pitch(r, size, ring):
    p = P.plan(2, 10, r, size, (0, 1024, 2048))
    assert p.route == (P.RING if ring else P.SIMPLE)


@pytest.mark.parametrize("which", range(3))
@pytest.mark.parametrize("offset", (1, 2, 4, 8, 12))
def test_any_unaligned_pointer_takes_the_simple_route(which, offset):
    """A view at a storage offset (a, b or h) moves its base off the
    16-byte grid TMA needs; the simple kernel takes it, with its own
    grid of 64 channels a block."""
    ptrs = [4096, 8192, 12288]
    ptrs[which] += offset
    p = P.plan(3, 100, 4096, 4, ptrs)
    assert p == P.simple_plan(3, 100, 4096)
    assert (p.route, p.channels, p.steps, p.stages, p.smem_bytes) == (
        P.SIMPLE, 64, 16, 0, 0)
    assert p.grid == (64, 3)


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_lm_shapes_fill_the_card(dt):
    """At least 128 blocks, about one for each of the H100's 132 SMs:
    C = 128 at the prefill (4 x 32), C = 32 at score's B = 1 (128 x 1)."""
    size = ITEMSIZE[dt]
    pre, score = P.ring_plan(*PREFILL, size), P.ring_plan(*SCORE, size)
    assert (pre.channels, pre.grid) == (128, (32, 4))
    assert (score.channels, score.grid) == (32, (128, 1))
    assert pre.grid[0] * pre.grid[1] >= 128
    assert score.grid[0] * score.grid[1] >= 128
    assert pre.steps == (32 if dt == "f32" else 64)
    assert score.steps == (128 if dt == "f32" else 256)


@pytest.mark.parametrize("b,r,c", [(4, 4096, 128), (2, 4096, 64),
                                   (2, 4040, 64), (1, 4096, 32),
                                   (1, 200, 32), (128, 8, 128),
                                   (127, 8, 32), (40, 520, 128)])
def test_channel_tile_is_the_largest_that_reaches_the_block_target(b, r, c):
    assert P.ring_channels(b, r) == c
    if c != P.RING_CHANNELS[0]:
        bigger = P.RING_CHANNELS[P.RING_CHANNELS.index(c) - 1]
        assert b * -(-r // bigger) < P.MIN_BLOCKS


def test_build_hashes_the_shared_headers(tmp_path, monkeypatch):
    """The kernels include ``csrc/tma.cuh``: editing it must give every
    source a new library name, so the next use rebuilds."""
    (tmp_path / "k.cu").write_text('#include "tma.cuh"\n')
    (tmp_path / "tma.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k.cu")
    assert first == build.library_path("k.cu")
    (tmp_path / "tma.cuh").write_text("// two\n")
    assert build.library_path("k.cu") != first
    assert build.library_path("k.cu").parent == build.BUILD_DIR


# --- the reverse mode (the gradient): its ring plan, box rows and a CPU
# twin of the reverse ring's walk -----------------------------------------

REVERSE_INSTANTIATIONS = {tuple(map(int, m)) for m in re.findall(
    r"RGLRU_RING_BWD\(\w+, (\d), (\d+), (\d+)\)", SOURCE)}


@pytest.mark.parametrize("shape,dt", RING_CASES)
def test_reverse_ring_plan_within_the_limits(shape, dt):
    """Three boxes a stage (a, dh, h) of the forward's channel tile, Tc
    from the same STAGE_BYTES, each box on a 128-byte boundary, two pairs
    of output tiles, within TMA's box limits and the shared memory."""
    b, s, r = shape
    size = ITEMSIZE[dt]
    p = P.ring_bwd_plan(b, s, r, size)
    assert p.route == P.RING and p.stages == P.RING_STAGES
    assert p.channels == P.ring_plan(b, s, r, size).channels
    assert p.steps == P.STAGE_BYTES // (3 * p.channels * size)
    assert p.steps <= TMA_BOX_MAX and (p.channels * size) % TMA_UNIT == 0
    box = p.steps * p.channels * size
    assert box % P.SMEM_ALIGN == 0
    assert 3 * box <= P.STAGE_BYTES
    assert p.smem_bytes == (P.SMEM_ALIGN + p.stages * 3 * box
                            + P.H_TILES * 2 * box) <= SMEM_LIMIT
    assert p.grid == (-(-r // p.channels), b)
    assert P.plan_bwd(b, s, r, size, (0, 256, 4096, 8192, 12288)) == p
    assert (DTYPE_CODE[dt], p.channels, p.steps) in REVERSE_INSTANTIATIONS


@pytest.mark.parametrize("which", range(5))
def test_reverse_takes_the_simple_route_where_tma_cannot_read(which):
    """Any of a, h, dh, da, db off the 16-byte grid (or a row pitch TMA
    refuses) sends the reverse mode to the simple kernel."""
    ptrs = [4096 * (i + 1) for i in range(5)]
    ptrs[which] += 4
    assert P.plan_bwd(2, 100, 4096, 4, ptrs) == P.simple_plan(2, 100, 4096)
    assert P.plan_bwd(2, 100, 100, 2, [4096] * 5).route == P.SIMPLE


def test_reverse_constants_match_the_kernel_source():
    """The stage's three boxes, the two output pairs, the depth the C side
    accepts, one instantiation a (dtype, C), and the box rows the producer
    asks for."""
    assert "static constexpr int STAGE_BYTES = 3 * BOX_BYTES;" in SOURCE
    assert "SMEM_ALIGN + STAGES * STAGE_BYTES + H_TILES * 2 * BOX_BYTES" \
        in SOURCE
    assert SOURCE.count(f"if (stages != {P.RING_STAGES}) return ERR_PLAN;") \
        == 2
    assert P.BWD_BOXES == 3 and P.BWD_OUTPUTS == 2
    assert len(REVERSE_INSTANTIATIONS) == 2 * len(P.RING_CHANNELS)
    for code, size in ((0, 4), (1, 2)):
        assert sorted(c for k, c, _ in REVERSE_INSTANTIATIONS if k == code) \
            == sorted(P.RING_CHANNELS)
        for k, c, tc in REVERSE_INSTANTIATIONS:
            if k == code:
                assert tc == P.STAGE_BYTES // (3 * c * size)
    for rows in ("k * TC + 1, row", "k * TC, row", "k * TC - 1,"):
        assert rows in SOURCE
    assert P.bwd_box_rows(0, 21) == (1, 0, -1)
    assert P.bwd_box_rows(3, 85) == (256, 255, 254)


def reverse_ring_walk(a, h, dh, steps):
    """The reverse ring kernel's walk on the CPU: tiles of ``steps`` rows
    from the last to the first, each a box of a (one step ahead), dh and
    h (one step behind) with rows outside [0, S) zero-filled, stepped from
    the tile's last real row down in float32, g rounded to the dtype
    before it multiplies h."""
    bsz, s, r = a.shape

    def box(x, row0):
        out = torch.zeros((bsz, steps, r), dtype=x.dtype)
        lo, hi = max(row0, 0), min(row0 + steps, s)
        if lo < hi:
            out[:, lo - row0:hi - row0] = x[:, lo:hi]
        return out

    da, db = torch.empty_like(a), torch.empty_like(a)
    g = torch.zeros((bsz, r), dtype=torch.float32)
    for k in range(-(-s // steps) - 1, -1, -1):
        ra, rg, rh = P.bwd_box_rows(k, steps)
        ba, bg, bh = box(a, ra), box(dh, rg), box(h, rh)
        t0 = k * steps
        for t in range(min(steps, s - t0) - 1, -1, -1):
            g = torch.add(torch.mul(ba[:, t].float(), g), bg[:, t].float())
            gt = g.to(a.dtype)
            db[:, t0 + t] = gt
            da[:, t0 + t] = torch.mul(gt.float(), bh[:, t].float()).to(
                a.dtype)
    return da, db


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("b,s,r", [(2, 1, 64), (1, 20, 32), (2, 21, 32),
                                   (3, 22, 40), (1, 107, 32), (2, 200, 48)])
def test_reverse_ring_walk_equals_the_plain_backward(b, s, r, dt):
    """The CPU twin of the reverse ring, at the f32 C = 128 plan's Tc of
    21 steps (one tile, a tile and one row, several tiles with a ragged
    first tile), bit-equal to ``rglru_scan_backward_ref``: the zero-filled
    rows past S and below 0 are exactly a_S = 0 and h_{-1} = 0."""
    from repro_torch.kernels.rglru.ref import (rglru_scan_backward_ref,
                                               rglru_scan_ref)
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    rng = np.random.default_rng(s * 100 + r)
    a = torch.from_numpy(rng.uniform(0.85, 0.999, (b, s, r))).to(dtype)
    x = torch.from_numpy(rng.standard_normal((b, s, r))).to(dtype)
    dh = torch.from_numpy(rng.standard_normal((b, s, r))).to(dtype)
    h = rglru_scan_ref(a, x)
    steps = P.ring_bwd_plan(4, s, 4096, 4).steps
    assert steps == 21
    got = reverse_ring_walk(a, h, dh, steps)
    want = rglru_scan_backward_ref(a, h, dh)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
