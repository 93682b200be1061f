"""The flash-attention kernels' tile schedule (``kernels/flash_attention/
tiles.py``) against the mask of ``attention_reference``, and the route
each dtype takes.  Pure Python and the CPU plain version: no card.

The mask is read off the plain version itself: with q = 0 every valid key
of a row gets the same weight, and with v the identity the output row is
that weight vector, so the keys a row attends to are its positive
entries (every key, uniformly, for a row without a valid key)."""

import functools
import itertools

import pytest
import torch

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
