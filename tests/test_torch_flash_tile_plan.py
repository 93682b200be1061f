"""The flash-attention kernels' tile schedule (``kernels/flash_attention/
tiles.py``) against the mask of ``attention_reference``, and the route
each dtype takes; the backward's two walks (dk/dv blocks over query tiles,
dq blocks over kv tiles) the same way, with its tiles, head splits and
shared memory.  Pure Python and the CPU plain version: no card.

The mask is read off the plain version itself: with q = 0 every valid key
of a row gets the same weight, and with v the identity the output row is
that weight vector, so the keys a row attends to are its positive
entries (every key, uniformly, for a row without a valid key)."""

import functools
import itertools
import re

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import tiles
from repro_torch.kernels.flash_attention.ref import attention_reference

TILES = (tiles.tc_tile(128), tiles.tc_tile(256), tiles.F32_TILE, (16, 8))
WINDOWS = (None, 1, 5, 37, 64, 130)
LENGTHS = (1, 63, 64, 65, 127, 129, 200)


@functools.lru_cache(maxsize=None)
def reference_weights(sq, sk, causal, window, q_offset) -> torch.Tensor:
    """[sq, sk] attention weights of attention_reference at q = 0."""
    q = torch.zeros((1, 1, sq, sk), dtype=torch.float64)
    k = torch.ones((1, 1, sk, sk), dtype=torch.float64)
    v = torch.eye(sk, dtype=torch.float64)[None, None]
    return attention_reference(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)[0, 0]


def valid_pairs(sq, sk, causal, window, q_offset) -> torch.Tensor:
    """[sq, sk] bool: the pairs the mask keeps, from its definition."""
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= qp - kp < window
    return ok


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_schedule_covers_the_reference_mask(tile, window, causal):
    bq, bk = tile
    for sq, sk in itertools.product(LENGTHS, LENGTHS):
        for q_offset in sorted({0, max(sk - sq, 0), 50}):
            kw = dict(sq=sq, sk=sk, causal=causal, window=window,
                      q_offset=q_offset)
            attended = reference_weights(sq, sk, causal, window,
                                         q_offset) > 0
            ok = valid_pairs(**kw)
            # the reference attends to the valid keys, or to every key
            keyless = ~ok.any(1)
            assert torch.equal(attended, ok | keyless[:, None])
            plan = tiles.schedule(bq=bq, bk=bk, **kw)
            assert len(plan) == tiles.n_q_tiles(sq, bq)
            for t, row in enumerate(plan):
                rows = slice(t * bq, min(t * bq + bq, sq))
                r = tiles.kv_range(t * bq, bq=bq, bk=bk, **kw)
                assert r.visits_all == bool(keyless[rows].any()), (kw, t)
                covered = torch.zeros(sk, dtype=torch.bool)
                for k0, masked in row:
                    covered[k0:k0 + bk] = True
                    pairs = ok[rows, k0:k0 + bk]
                    # only tiles with a dropped pair take the mask
                    full = k0 + bk <= sk and bool(pairs.all())
                    assert masked == (not full), (kw, t, k0)
                    # a visited tile holds a valid pair unless all are visited
                    assert bool(pairs.any()) or r.visits_all, (kw, t, k0)
                # every key a row of the block attends to is in a visited tile
                assert bool(covered[attended[rows].any(0)].all()), (kw, t)
                if r.visits_all:
                    assert [k0 for k0, _ in row] == list(range(0, sk, bk))


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_computed_flops_count_the_visited_tiles(tile):
    bq, bk = tile
    kw = dict(sq=300, sk=300, causal=True, window=37, q_offset=0)
    n_tiles = sum(len(r) for r in tiles.schedule(bq=bq, bk=bk, **kw))
    assert tiles.computed_flops(2, 3, 64, bq=bq, bk=bk, **kw) == (
        4.0 * bq * bk * 64 * n_tiles * 2 * 3)


def test_prefill_plan_skips_the_tiles_outside_the_band():
    """RecurrentGemma-9B's prefill (S 4096, window 2048, D 256) on the
    tensor-core tiles (64 x 64): 1584 of the 4096 (query, kv) tile pairs of
    a (batch, head), 96 of them masked (the diagonal and the window's left
    edge)."""
    assert tiles.tc_tile(256) == (64, 64)
    plan = tiles.schedule(sq=4096, sk=4096, causal=True, window=2048,
                          q_offset=0, bq=64, bk=64)
    assert sum(len(r) for r in plan) == 1584
    assert sum(m for r in plan for _, m in r) == 96


def test_tiles_by_route_and_head_dim():
    assert K.tile(K.TC, 256) == (64, 64)
    for d in (16, 32, 64, 128):
        assert K.tile(K.TC, d) == (128, 64)
        assert K.tile(K.F32, d) == tiles.F32_TILE == (64, 32)


def test_route_by_dtype():
    assert K.route(torch.bfloat16) == K.TC == "flash_attention_tc"
    assert K.route(torch.float32) == K.F32 == "flash_attention_f32"
    assert set(K.LAUNCHES) == {K.TC, K.F32}
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            K.route(dtype)


# --- the backward's schedule (``dkdv_range`` / ``dkdv_tile_masked`` and the
# dq blocks' ``kv_range``), tiles and shared memory -----------------------

#: the kernels' templates and constants (both K4 sources include them)
FLASH_SOURCE = (build.CSRC_DIR / "flash_attention.cuh").read_text()
# shared memory a block of the H100 may take (bytes)
SMEM_LIMIT = 232_448


def bwd_cases():
    """(s, causal, window) of self-attention, the backward's only kind."""
    return [(s, causal, window) for s in LENGTHS for causal in (True, False)
            for window in WINDOWS]


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("window", WINDOWS)
def test_dkdv_schedule_visits_every_kept_pair_once(window, causal):
    """The dk/dv blocks' query tiles (one walk a head of the group) hold
    every pair the reference keeps exactly once; a tile with a dropped
    pair, or a key or query past S, is masked, and only such tiles are."""
    bk, bq = tiles.BWD_KV_TILE
    for s in LENGTHS:
        ok = valid_pairs(s, s, causal, window, 0)
        attended = reference_weights(s, s, causal, window, 0) > 0
        assert torch.equal(attended, ok)   # every row keeps a key
        visits = torch.zeros((s, s), dtype=torch.int64)
        plan = tiles.dkdv_schedule(sq=s, causal=causal, window=window, bk=bk,
                                   bq=bq)
        assert len(plan) == -(-s // bk)
        for t, row in enumerate(plan):
            k0 = t * bk
            for q0, masked in row:
                pad = torch.zeros((bq, bk), dtype=torch.bool)
                pad[:min(bq, s - q0), :min(bk, s - k0)] = ok[q0:q0 + bq,
                                                            k0:k0 + bk]
                assert masked == (not bool(pad.all())), (s, k0, q0)
                assert bool(pad.any()), (s, k0, q0)   # no idle tile
                visits[q0:q0 + bq, k0:k0 + bk] += 1
        assert torch.equal(visits[ok], torch.ones(int(ok.sum()),
                                                  dtype=torch.int64))
        assert int(visits.max()) <= 1


#: (Sq, Sk, q_offset) of query chunks: the sequence-sharded attention's
#: ranks (a quarter or a half of S at each offset), ragged chunks and keys,
#: a chunk of one row, and chunks whose keys past their last row (or left
#: of their window) no row sees
CHUNKS = ([(s // n, s, r * s // n) for s in (128, 200, 256) for n in (2, 4)
           for r in range(n)]
          + [(63, 129, 66), (1, 65, 0), (1, 65, 64), (100, 200, 37),
             (65, 300, 130), (127, 129, 0)])


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("tile", (tiles.BWD_KV_TILE, (32, 64), (32, 32)),
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_dkdv_schedule_of_a_query_chunk_visits_every_kept_pair_once(
        tile, window, causal):
    """A query chunk (rows at q_offset + i, Sq < Sk): by brute force over
    every (row, key), the dk/dv blocks' query tiles hold each kept pair
    once and nothing else, only the tiles with a dropped pair (or a row or
    key past the end) take the mask, no visited tile is idle, and a key
    tile that no row sees walks no tile (its dk and dv are zeros)."""
    bk, bq = tile
    for sq, sk, q_offset in CHUNKS:
        assert q_offset + sq <= sk
        ok = valid_pairs(sq, sk, causal, window, q_offset)
        plan = tiles.dkdv_schedule(sq=sq, sk=sk, q_offset=q_offset,
                                   causal=causal, window=window, bk=bk,
                                   bq=bq)
        assert len(plan) == -(-sk // bk)
        visits = torch.zeros((sq, sk), dtype=torch.int64)
        for t, row in enumerate(plan):
            k0 = t * bk
            seen = bool(ok[:, k0:k0 + bk].any())
            assert bool(row) == seen, (sq, sk, q_offset, k0)
            for q0, masked in row:
                pad = torch.zeros((bq, bk), dtype=torch.bool)
                pad[:min(bq, sq - q0), :min(bk, sk - k0)] = ok[q0:q0 + bq,
                                                              k0:k0 + bk]
                assert masked == (not bool(pad.all())), (sq, k0, q0)
                assert bool(pad.any()), (sq, sk, q_offset, k0, q0)
                visits[q0:q0 + bq, k0:k0 + bk] += 1
        assert bool((visits[ok] == 1).all()), (sq, sk, q_offset)
        assert int(visits.max()) <= 1
        # the self-attention schedule is the chunk schedule at offset 0
        if sq == sk:
            assert plan == tiles.dkdv_schedule(sq=sq, causal=causal,
                                               window=window, bk=bk, bq=bq)


def test_bwd_flops_of_a_query_chunk():
    """The chunks of one sequence split four ways count the tiles of their
    own schedules, which add up to at most the whole sequence's, and the
    last chunk's dk/dv blocks walk every key tile."""
    d, bk, bq = 64, *tiles.BWD_KV_TILE
    whole = K.bwd_flops(1, 2, 4096, d, True, None, True)
    parts = [K.bwd_flops(1, 2, 1024, d, True, None, True, sk=4096,
                         q_offset=r * 1024) for r in range(4)]
    for r, f in enumerate(parts):
        n = sum(len(row) for row in tiles.dkdv_schedule(
            sq=1024, sk=4096, q_offset=r * 1024, causal=True, window=None,
            bk=bk, bq=bq))
        assert f == 10.0 * d * bk * bq * n * 2
    assert parts == sorted(parts) and sum(parts) == whole
    assert K.bwd_flops(1, 2, 4096, d, True, None, True, sk=4096) == whole


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("d", (64, 256))
def test_dq_schedule_visits_every_kept_pair_once(d, window, causal):
    """The dq blocks (the tensor-core forward's rows, q_offset 0, Sq = Sk)
    visit every kept pair exactly once, masking the tiles that need it."""
    bq, bk = tiles.bwd_tiles(True, d)[:2]
    for s in LENGTHS:
        ok = valid_pairs(s, s, causal, window, 0)
        visits = torch.zeros((s, s), dtype=torch.int64)
        for t, row in enumerate(tiles.schedule(
                sq=s, sk=s, causal=causal, window=window, q_offset=0, bq=bq,
                bk=bk)):
            q0 = t * bq
            for k0, masked in row:
                block = ok[q0:q0 + bq, k0:k0 + bk]
                full = k0 + bk <= s and bool(block.all())
                assert masked == (not full), (s, q0, k0)
                visits[q0:q0 + bq, k0:k0 + bk] += 1
        assert bool((visits[ok] == 1).all())


@pytest.mark.parametrize("b,kvh,s,group", [
    (1, 2, 4096, 7), (1, 1, 4096, 16), (4, 1, 4096, 16), (2, 2, 150, 3),
    (1, 1, 100, 16), (1, 2, 1000, 7), (2, 4, 200, 1), (1, 14, 4096, 1),
    (1, 8, 100, 2), (1, 1, 1, 5), (3, 2, 700, 12)])
def test_dkdv_splits_cover_the_group(b, kvh, s, group):
    """A group's heads cut into runs, one dk/dv block each: every head in
    exactly one run, in order, none empty; runs are added only where the
    key tiles alone give fewer blocks than the target."""
    splits = tiles.dkdv_splits(b, kvh, s, group)
    runs = tiles.split_heads(group, splits)
    assert 1 <= splits <= group and len(runs) == splits
    assert [h for r in runs for h in r] == list(range(group))
    assert all(len(r) > 0 for r in runs)
    blocks = -(-s // tiles.BWD_KV_TILE[0]) * kvh * b
    if blocks >= tiles.BWD_TARGET_BLOCKS:
        assert splits == 1
    assert (splits - 1) * -(-group // splits) < group   # as the C side asks


@pytest.mark.parametrize("d", K.HEAD_DIMS)
def test_backward_tiles_and_shared_memory(d):
    """Both routes' backward tiles, and the tensor-core kernels' shared
    memory within the H100's 232,448 bytes a block (less the static
    barriers), from the constants of ``csrc/flash_attention.cuh``."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             FLASH_SOURCE)[1])
    assert tiles.BWD_KV_TILE == (const("BK"), const("BQ_KV")) == (64, 64)
    assert tiles.BWD_STAGES == const("STAGES")
    assert tiles.BWD_PAD_ROWS == const("PAD_ROWS")
    assert tiles.bwd_tiles(True, d) == (*tiles.tc_tile(d), 64, 64)
    bq = 32 if d == 256 else 64
    assert tiles.bwd_tiles(False, d) == (bq, 32, 32, bq)
    assert "d == 256 ? 32 : 64" in FLASH_SOURCE      # bwd::bq_rows
    dkdv, dq = tiles.tc_bwd_smem_bytes(d)
    assert max(dkdv, dq) <= SMEM_LIMIT - 128
    assert dkdv == 1024 + 2 * 128 * d + 2 * (2 * 128 * d + 512) + 32768
    assert (dkdv, dq) == {16: (47104, 17408), 64: (83968, 66560),
                          256: (231424, 197632)}.get(d, (dkdv, dq))
    assert tiles.bwd_pad_rows(1) == 128 and tiles.bwd_pad_rows(256) == 256
    assert tiles.bwd_pad_rows(257) == 384


def test_backward_routes_by_dtype():
    assert K.BWD_ROUTES == {K.TC: "flash_attention_bwd/tc",
                            K.F32: "flash_attention_bwd/f32"}
    assert set(K.BACKWARD_LAUNCHES) == {K.BWD, *K.BWD_ROUTES.values()}
