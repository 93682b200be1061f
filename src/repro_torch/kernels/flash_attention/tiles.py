"""The kv-tile schedule of the flash-attention kernels, in plain Python.

A block of a kernel owns ``bq`` query rows and walks kv tiles of ``bk``
keys.  ``kv_range`` says which tiles the block visits: tiles wholly above
the causal diagonal are skipped, and so are tiles wholly left of the
window, unless some row of the block has no valid key at all — the
reference then averages v over every key, so the block visits every tile.
``tile_masked`` says which visited tiles need the mask: those holding a
(real row, key) pair the mask drops; interior tiles take none.

``kv_range`` and ``tile_masked`` are the twins of the functions of the same
names in ``src/repro_torch/csrc/flash_attention.cuh``.  The wrapper takes
its tile sizes and grid from here, ``chip_smoke.py`` counts the flops the
kernel computes with ``computed_flops``, and
``tests/test_torch_flash_tile_plan.py`` holds the schedule against the
mask of ``attention_reference``.

The backward walks the same pairs twice, for queries at ``q_offset +
i`` (i < Sq) over keys j < Sk with ``q_offset + Sq <= Sk``
(self-attention, or one chunk of its queries).  Its dq kernel is a block
of query rows over ``kv_range``, as the forward; its dk/dv kernel is a
block of keys over the query tiles that can see them (``dkdv_range``:
none for keys past the chunk's last row or left of its window, whose dk
and dv are then zeros), for every head of its run of the kv head's group
(``dkdv_splits``, ``split_heads``), and ``dkdv_tile_masked`` (the twin
of ``dkdv_masked``) says which of those tiles take the mask.
``bwd_tiles`` gives both kernels' tiles per route and
``tc_bwd_smem_bytes`` the tensor-core kernels' shared memory.

With caller positions (``q_pos`` / ``k_pos``, one row a batch entry) the
EXT kernels work in position order (``csrc/flash_attention.cuh``, "caller
positions"), and this module holds the plan's plain twin: ``pos_sort``
(the stable sort of ``plan.PosPlan``) and ``pos_band`` (``searchsorted``,
the twin of the pre-pass ``flash_pos_band``): sorted row r keeps the
sorted keys [lo_r, hi_r), sorted key j is kept by the rows [qlo_j,
qhi_j), and the hull spans the rows that keep no key.  ``pos_schedule``
walks a query block's band (every tile, masked, for a block meeting the
hull), ``pos_dkdv_schedule`` a key block's band of query tiles and the
hull's; a visited tile takes no mask only when every pair is kept.  For
positions ``q_offset + arange`` / ``arange`` they visit and mask exactly
the tiles of the index schedules.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

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


def dkdv_splits(b: int, kvh: int, sk: int, group: int) -> int:
    """Runs of consecutive heads the tensor-core backward cuts a group
    into, one dk/dv block each (their f32 sums are then added in run
    order): enough for about BWD_TARGET_BLOCKS blocks of ``sk`` keys'
    tiles, none empty."""
    blocks = -(-sk // BWD_KV_TILE[0]) * kvh * b
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
                   bk: int, q_pos=None, k_pos=None) -> float:
    """Flops the kernel computes: 4 bq bk d for every visited tile pair
    (q.k and p.v, ragged tiles counted whole), over batch and heads; with
    positions ([B, Sq] / [B, Sk]) the sorted schedule of each batch
    entry."""
    if q_pos is None:
        tiles = b * sum(len(row) for row in schedule(
            sq=sq, sk=sk, causal=causal, window=window, q_offset=q_offset,
            bq=bq, bk=bk))
    else:
        tiles = sum(len(row) for i in range(b) for row in pos_schedule(
            pos_band(q_pos[i], k_pos[i], causal=causal, window=window),
            bq=bq, bk=bk))
    return 4.0 * bq * bk * d * tiles * h


def dkdv_range(k0: int, *, bk: int, bq: int, sq: int, q_offset: int = 0,
               causal: bool, window: int | None) -> tuple[int, int]:
    """Query rows [begin, end) a dk/dv block of keys [k0, k0 + bk) walks
    (in tiles of bq rows from begin; row i at position q_offset + i):
    those that can see one of its keys, every row with a valid key; empty
    (end <= begin) where none can."""
    first = max(0, k0 - q_offset) if causal else 0
    begin = first // bq * bq
    end = min(sq, k0 + bk - 1 + window - q_offset) if window else sq
    return (begin, end) if first < end else (begin, begin)


def dkdv_tile_masked(k0: int, q0: int, *, bk: int, bq: int, sq: int,
                     sk: int, q_offset: int = 0, causal: bool,
                     window: int | None) -> bool:
    """Whether the (key tile k0, query tile q0) pair holds a pair the mask
    drops, or a key or query past the end."""
    return not (q0 + bq <= sq and k0 + bk <= sk
                and (not causal or q_offset + q0 >= k0 + bk - 1)
                and (not window or q_offset + q0 + bq - 1 - k0 < window))


def dkdv_schedule(*, sq: int, sk: int | None = None, q_offset: int = 0,
                  causal: bool, window: int | None, bk: int,
                  bq: int) -> list[list[tuple[int, bool]]]:
    """For each key tile of a dk/dv kernel (``sk`` keys; None: ``sq``),
    its visited query tiles as (first row, masked); the block walks them
    once for each head of its group."""
    sk = sq if sk is None else sk
    out = []
    for k0 in range(0, sk, bk):
        begin, end = dkdv_range(k0, bk=bk, bq=bq, sq=sq, q_offset=q_offset,
                                causal=causal, window=window)
        out.append([(q0, dkdv_tile_masked(
            k0, q0, bk=bk, bq=bq, sq=sq, sk=sk, q_offset=q_offset,
            causal=causal, window=window)) for q0 in range(begin, end, bq)])
    return out


# ---------------------------------------------------------------------------
# the position plan (caller positions)
# ---------------------------------------------------------------------------

#: the band's row and key arrays are padded to a multiple of this
POS_PAD = 128


def pos_pad(n: int) -> int:
    """Length of a padded array of n rows or keys."""
    return -(-n // POS_PAD) * POS_PAD


def pos_scratch_ints(b: int, sq: int, sk: int) -> int:
    """int32 elements of the plan's band for b batch entries (the pre-pass
    ``flash_pos_band``'s output): per entry lo, hi [pos_pad(sq)], qlo, qhi
    [pos_pad(sk)], the hull (as sq - first, last + 1) and two pad ints."""
    return b * (2 * pos_pad(sq) + 2 * pos_pad(sk) + 4)


def pos_sort(pos) -> tuple[torch.Tensor, torch.Tensor]:
    """One batch entry's positions [S]: (the stable sort permutation, the
    sorted positions), int64."""
    values, perm = torch.sort(torch.as_tensor(pos).to(torch.int64)
                              .reshape(-1), stable=True)
    return perm, values


@dataclass(frozen=True)
class PosBand:
    """One batch entry's band in sorted order: sorted row r keeps the
    sorted keys [lo[r], hi[r]); sorted key j is kept by the rows [qlo[j],
    qhi[j]); the hull (first, last) spans the rows keeping no key ((sq,
    -1) when every row keeps one)."""
    lo: tuple
    hi: tuple
    qlo: tuple
    qhi: tuple
    hull: tuple

    @property
    def sq(self) -> int:
        return len(self.lo)

    @property
    def sk(self) -> int:
        return len(self.qlo)


def band_of_sorted(qs: torch.Tensor, ks: torch.Tensor, *, causal: bool,
                   window: int | None) -> tuple[torch.Tensor, ...]:
    """(lo, hi, qlo, qhi, keyless) of one batch entry from its sorted
    positions qs [Sq], ks [Sk] (int64, on any device): the plain version
    of ``flash_pos_band``, by ``searchsorted``; ``keyless`` [Sq] marks the
    rows that keep no key."""
    sq, sk = qs.numel(), ks.numel()
    hi = (torch.searchsorted(ks, qs, right=True) if causal
          else torch.full_like(qs, sk))
    lo = (torch.searchsorted(ks, qs - window, right=True) if window
          else torch.zeros_like(qs))
    qlo = torch.searchsorted(qs, ks) if causal else torch.zeros_like(ks)
    qhi = (torch.searchsorted(qs, ks + window) if window
           else torch.full_like(ks, sq))
    return lo, hi, qlo, qhi, hi <= lo


def pos_band(q_pos, k_pos, *, causal: bool,
             window: int | None) -> PosBand:
    """The band of one batch entry's q_pos [Sq], k_pos [Sk] (sorted here),
    as ``flash_pos_band`` computes it from the sorted positions."""
    lo, hi, qlo, qhi, keyless = band_of_sorted(
        pos_sort(q_pos)[1], pos_sort(k_pos)[1], causal=causal, window=window)
    rows = torch.nonzero(keyless).flatten().tolist()
    hull = (rows[0], rows[-1]) if rows else (lo.numel(), -1)
    return PosBand(tuple(lo.tolist()), tuple(hi.tolist()),
                   tuple(qlo.tolist()), tuple(qhi.tolist()), hull)


@dataclass(frozen=True)
class BandRange:
    begin: int        # first key of the first visited tile (a multiple of bk)
    end: int          # sorted keys [begin, end) are visited, in tiles of bk
    keyless: bool     # the block meets the hull: every tile, masked
    lo_last: int      # the band of the block's last and first real rows
    hi_first: int


def band_range(p: PosBand, q0: int, *, bq: int, bk: int) -> BandRange:
    """The sorted keys a block of sorted rows [q0, q0 + bq) visits (the
    twin of the kernels' ``band_range``)."""
    r1 = min(q0 + bq, p.sq) - 1
    keyless = p.hull[0] <= r1 and p.hull[1] >= q0
    begin = 0 if keyless else p.lo[q0] // bk * bk
    end = p.sk if keyless else p.hi[r1]
    return BandRange(begin, end, keyless, p.lo[r1], p.hi[q0])


def band_masked(r: BandRange, k0: int, *, bk: int, sk: int) -> bool:
    """Whether the key tile at k0 holds a pair the mask drops."""
    return r.keyless or not (k0 + bk <= sk and r.lo_last <= k0
                             and k0 + bk <= r.hi_first)


def band_runs(p: PosBand, k0: int, *, bk: int,
              bq: int) -> list[tuple[int, int]]:
    """The query tiles a dk/dv block of sorted keys [k0, k0 + bk) walks,
    as runs (first row, tiles): the band of rows keeping one of its keys
    and the hull's tiles, merged where they meet (the twin of the kernels'
    ``band_runs``)."""
    kl = min(k0 + bk, p.sk) - 1
    runs = []
    for a0, a1 in ((p.qlo[k0] // bq * bq, p.qhi[kl]),
                   (p.hull[0] // bq * bq, p.hull[1] + 1)):
        if a1 > a0:
            runs.append((a0, a0 + -(-(a1 - a0) // bq) * bq))
    runs.sort()
    if len(runs) == 2 and runs[1][0] <= runs[0][1]:
        runs = [(runs[0][0], max(runs[0][1], runs[1][1]))]
    return [(a0, (a1 - a0) // bq) for a0, a1 in runs]


def band_tile_masked(p: PosBand, q0: int, k0: int, *, bq: int,
                     bk: int) -> bool:
    """Whether the (query tile q0, key tile k0) pair holds a pair the mask
    drops, or a row or key past the end."""
    return not (q0 + bq <= p.sq and k0 + bk <= p.sk
                and p.lo[q0 + bq - 1] <= k0 and k0 + bk <= p.hi[q0])


def pos_schedule(p: PosBand, *, bq: int,
                 bk: int) -> list[list[tuple[int, bool]]]:
    """``schedule`` in sorted order: for each query tile of sorted rows,
    its visited tiles of sorted keys as (first key, masked)."""
    out = []
    for q0 in range(0, p.sq, bq):
        r = band_range(p, q0, bq=bq, bk=bk)
        out.append([(k0, band_masked(r, k0, bk=bk, sk=p.sk))
                    for k0 in range(r.begin, r.end, bk)])
    return out


def pos_dkdv_schedule(p: PosBand, *, bk: int,
                      bq: int) -> list[list[tuple[int, bool]]]:
    """``dkdv_schedule`` in sorted order (any Sq, Sk): for each tile of
    sorted keys, its visited tiles of sorted rows as (first row,
    masked)."""
    out = []
    for k0 in range(0, p.sk, bk):
        out.append([(q0, band_tile_masked(p, q0, k0, bq=bq, bk=bk))
                    for a0, n in band_runs(p, k0, bk=bk, bq=bq)
                    for q0 in range(a0, a0 + n * bq, bq)])
    return out
