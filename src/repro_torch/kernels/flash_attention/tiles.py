"""The kv-tile schedule of the flash-attention kernels, in plain Python.

A block of a kernel owns ``bq`` query rows and walks kv tiles of ``bk``
keys.  ``kv_range`` says which tiles the block visits: tiles wholly above
the causal diagonal are skipped, and so are tiles wholly left of the
window, unless some row of the block has no valid key at all — the
reference then averages v over every key, so the block visits every tile.
``tile_masked`` says which visited tiles need the mask: those holding a
(real row, key) pair the mask drops; interior tiles take none.

``kv_range`` and ``tile_masked`` are the twins of the functions of the same
names in ``src/repro_torch/csrc/flash_attention.cu``.  The wrapper takes
its tile sizes and grid from here, ``chip_smoke.py`` counts the flops the
kernel computes with ``computed_flops``, and
``tests/test_torch_flash_tile_plan.py`` holds the schedule against the
mask of ``attention_reference``.
"""

from __future__ import annotations

from dataclasses import dataclass

#: (query rows, keys) of a block of the f32 CUDA-core kernel
F32_TILE = (64, 32)


def tc_tile(d: int) -> tuple[int, int]:
    """(query rows, keys) of a block of the bf16 tensor-core kernel: a
    consumer warpgroup takes 64 rows, two a block, one at D = 256."""
    return (64 if d == 256 else 128, 64)


@dataclass(frozen=True)
class KvRange:
    begin: int        # first key of the first visited tile (a multiple of bk)
    end: int          # keys [begin, end) are visited, in tiles of bk
    visits_all: bool  # some row of the block has no valid key
    q_lo: int         # positions of the block's first and last real rows
    q_hi: int


def n_q_tiles(sq: int, bq: int) -> int:
    """Blocks along the query axis."""
    return -(-sq // bq)


def kv_range(q0: int, *, bq: int, bk: int, sq: int, sk: int, causal: bool,
             window: int | None, q_offset: int) -> KvRange:
    """The kv keys the block of query rows [q0, q0 + bq) visits."""
    q_lo = q_offset + q0
    q_hi = q_offset + min(q0 + bq, sq) - 1
    end = min(sk, q_hi + 1) if causal else sk
    visits_all = bool(window) and q_hi - window + 1 > sk - 1
    begin = 0
    if window and not visits_all:
        begin = max(0, q_lo - window + 1) // bk * bk
    return KvRange(begin, end, visits_all, q_lo, q_hi)


def tile_masked(r: KvRange, k0: int, *, bk: int, sk: int, causal: bool,
                window: int | None) -> bool:
    """Whether the kv tile at key k0 holds a pair the mask drops."""
    return not (k0 + bk <= sk and (not causal or k0 + bk - 1 <= r.q_lo)
                and (not window or r.q_hi - k0 < window))


def schedule(*, sq: int, sk: int, causal: bool, window: int | None,
             q_offset: int, bq: int, bk: int) -> list[list[tuple[int, bool]]]:
    """For each query tile, its visited kv tiles as (first key, masked)."""
    out = []
    for t in range(n_q_tiles(sq, bq)):
        r = kv_range(t * bq, bq=bq, bk=bk, sq=sq, sk=sk, causal=causal,
                     window=window, q_offset=q_offset)
        out.append([(k0, tile_masked(r, k0, bk=bk, sk=sk, causal=causal,
                                     window=window))
                    for k0 in range(r.begin, r.end, bk)])
    return out


def computed_flops(b: int, h: int, d: int, *, sq: int, sk: int, causal: bool,
                   window: int | None, q_offset: int, bq: int,
                   bk: int) -> float:
    """Flops the kernel computes: 4 bq bk d for every visited tile pair
    (q.k and p.v, ragged tiles counted whole), over batch and heads."""
    tiles = sum(len(row) for row in schedule(
        sq=sq, sk=sk, causal=causal, window=window, q_offset=q_offset,
        bq=bq, bk=bk))
    return 4.0 * bq * bk * d * tiles * b * h
