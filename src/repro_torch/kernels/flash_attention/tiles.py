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

The backward walks the same pairs twice.  Its dq kernel is a block of
query rows over ``kv_range`` (as the forward, with q_offset 0 and Sq =
Sk); its dk/dv kernel is a block of keys over the query tiles that can
see them (``dkdv_range``), for every head of its run of the kv head's
group (``dkdv_splits``, ``split_heads``), and ``dkdv_tile_masked`` (the
twin of ``dkdv_masked``) says which of those tiles take the mask.
``bwd_tiles`` gives both kernels' tiles per route and
``tc_bwd_smem_bytes`` the tensor-core kernels' shared memory.
"""

from __future__ import annotations

from dataclasses import dataclass

#: (query rows, keys) of a block of the f32 CUDA-core kernel
F32_TILE = (64, 32)


def tc_tile(d: int) -> tuple[int, int]:
    """(query rows, keys) of a block of the bf16 tensor-core kernel: a
    consumer warpgroup takes 64 rows, two a block, one at D = 256."""
    return (64 if d == 256 else 128, 64)


#: the tensor-core backward's dk/dv block: (keys, query rows of a tile)
BWD_KV_TILE = (64, 64)
#: its ring depth (both kernels)
BWD_STAGES = 2
#: the rows of its lse / delta scratch are padded to a multiple of this
BWD_PAD_ROWS = 128
#: dk/dv blocks the tensor-core backward aims for: two for each of the
#: H100's 132 SMs, so that the longest key tiles do not set the time alone
BWD_TARGET_BLOCKS = 264


def bwd_tiles(tensor_cores: bool, d: int) -> tuple[int, int, int, int]:
    """(query rows, keys) of a dq block, then (keys, query rows) of a
    dk/dv block's tiles, of the tensor-core (bf16) or CUDA-core (f32)
    backward at head dim d."""
    if tensor_cores:
        return (*tc_tile(d), *BWD_KV_TILE)
    bq = 32 if d == 256 else 64
    return (bq, 32, 32, bq)


def bwd_pad_rows(s: int) -> int:
    """Rows a (batch, head) of the tensor-core backward's scratch holds."""
    return -(-s // BWD_PAD_ROWS) * BWD_PAD_ROWS


def dkdv_splits(b: int, kvh: int, s: int, group: int) -> int:
    """Runs of consecutive heads the tensor-core backward cuts a group
    into, one dk/dv block each (their f32 sums are then added in run
    order): enough for about BWD_TARGET_BLOCKS blocks, none empty."""
    blocks = -(-s // BWD_KV_TILE[0]) * kvh * b
    want = min(group, max(1, -(-BWD_TARGET_BLOCKS // blocks)))
    return -(-group // -(-group // want))


def split_heads(group: int, splits: int) -> list[range]:
    """The heads of a group (0 .. group - 1) each of the ``splits`` dk/dv
    blocks of a key tile walks, in order."""
    per = -(-group // splits)
    return [range(i * per, min(group, (i + 1) * per)) for i in range(splits)]


def tc_bwd_smem_bytes(d: int) -> tuple[int, int]:
    """Dynamic shared memory (bytes) of a dk/dv block and of a dq block of
    the tensor-core backward at head dim d: 1024 for the swizzle's
    alignment; dk/dv: K and V, a ring of (Q, dO, lse, delta) tiles of 64
    rows and two f32 P^T exchange buffers of 64 x 64; dq: Q and dO of its
    rows and a ring of (K, V)."""
    tile = 64 * d * 2
    dkdv = (1024 + 2 * tile + BWD_STAGES * (2 * tile + 2 * 64 * 4)
            + 2 * 64 * 64 * 4)
    dq = 1024 + 2 * tc_tile(d)[0] * d * 2 + BWD_STAGES * 2 * tile
    return dkdv, dq


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


def dkdv_range(k0: int, *, bk: int, bq: int, s: int, causal: bool,
               window: int | None) -> tuple[int, int]:
    """Query rows [begin, end) a dk/dv block of keys [k0, k0 + bk) walks
    (in tiles of bq rows from begin): those that can see one of its keys
    (self-attention, every row with a valid key)."""
    begin = k0 // bq * bq if causal else 0
    end = min(s, k0 + bk - 1 + window) if window else s
    return begin, end


def dkdv_tile_masked(k0: int, q0: int, *, bk: int, bq: int, s: int,
                     causal: bool, window: int | None) -> bool:
    """Whether the (key tile k0, query tile q0) pair holds a pair the mask
    drops, or a key or query past S."""
    return not (q0 + bq <= s and k0 + bk <= s
                and (not causal or q0 >= k0 + bk - 1)
                and (not window or q0 + bq - 1 - k0 < window))


def dkdv_schedule(*, s: int, causal: bool, window: int | None, bk: int,
                  bq: int) -> list[list[tuple[int, bool]]]:
    """For each key tile of a dk/dv kernel, its visited query tiles as
    (first row, masked); the block walks them once for each head of its
    group."""
    out = []
    for k0 in range(0, s, bk):
        begin, end = dkdv_range(k0, bk=bk, bq=bq, s=s, causal=causal,
                                window=window)
        out.append([(q0, dkdv_tile_masked(k0, q0, bk=bk, bq=bq, s=s,
                                          causal=causal, window=window))
                    for q0 in range(begin, end, bq)])
    return out
