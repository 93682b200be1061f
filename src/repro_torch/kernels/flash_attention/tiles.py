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

With caller positions (``q_pos`` / ``k_pos``, one row a batch entry) the
walks follow a positional rule instead, read from per-chunk summaries of
the positions (``pos_summary``, the twin of the kernels' pre-pass
``flash_pos_prep``): a (query tile, key tile) pair is visited unless it can
hold no kept pair — all its keys after all its queries (``min k_pos >
max q_pos``, causal) or all left of the window (``max k_pos <= min q_pos -
window``) — and every tile is visited for a query tile holding a row with
no kept key at all; a visited tile takes no mask only when every pair is
kept.  For positions ``q_offset + arange`` / ``arange`` the rule visits
and masks exactly the tiles of the index schedule.
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
                   bk: int, q_pos=None, k_pos=None) -> float:
    """Flops the kernel computes: 4 bq bk d for every visited tile pair
    (q.k and p.v, ragged tiles counted whole), over batch and heads; with
    positions ([B, Sq] / [B, Sk]) the positional schedule of each batch
    entry."""
    if q_pos is None:
        tiles = b * sum(len(row) for row in schedule(
            sq=sq, sk=sk, causal=causal, window=window, q_offset=q_offset,
            bq=bq, bk=bk))
    else:
        tiles = sum(len(row) for i in range(b) for row in pos_schedule(
            pos_summary(q_pos[i], k_pos[i], causal=causal, window=window),
            causal=causal, window=window, bq=bq, bk=bk))
    return 4.0 * bq * bk * d * tiles * h


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


# ---------------------------------------------------------------------------
# the positional rule (caller positions)
# ---------------------------------------------------------------------------

#: positions are summarised in chunks of this many rows or keys; every
#: tile of every kernel is a whole number of chunks
POS_CHUNK = 32
#: the pre-pass pads its copies of the positions to a multiple of this
#: (the largest tile), so that a tile's positions are one aligned copy
POS_PAD = 128


def pos_pad(n: int) -> int:
    """Length of a padded copy of n positions."""
    return -(-n // POS_PAD) * POS_PAD


def pos_scratch_ints(b: int, sq: int, sk: int) -> int:
    """int32 elements of the pre-pass's scratch (``flash_pos_prep``): the
    padded copies of q_pos and k_pos, then q_min, q_max and q_keyless per
    chunk of rows and k_min, k_max per chunk of keys, for b entries."""
    nqc, nkc = -(-sq // POS_CHUNK), -(-sk // POS_CHUNK)
    return b * (pos_pad(sq) + pos_pad(sk) + 3 * nqc + 2 * nkc)


@dataclass(frozen=True)
class PosSummary:
    """One batch entry's positions as the pre-pass reduces them: per chunk
    of POS_CHUNK real rows (keys) their least and greatest position, and
    per chunk of rows whether one of them keeps no key at all."""
    sq: int
    sk: int
    q_min: tuple
    q_max: tuple
    q_keyless: tuple
    k_min: tuple
    k_max: tuple


def _chunks(pos: torch.Tensor):
    n = pos.shape[0]
    pad = -n % POS_CHUNK
    big = torch.iinfo(torch.int64).max
    lo = torch.cat([pos, pos.new_full((pad,), big)]).view(-1, POS_CHUNK)
    hi = torch.cat([pos, pos.new_full((pad,), -big)]).view(-1, POS_CHUNK)
    return tuple(lo.amin(1).tolist()), tuple(hi.amax(1).tolist())


def keyless_rows(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                 window: int | None) -> torch.Tensor:
    """[Sq] bool: the rows of q_pos that keep no key of k_pos."""
    q = torch.as_tensor(q_pos).to(torch.int64)
    k = torch.as_tensor(k_pos).to(torch.int64)
    ok = torch.ones((q.shape[0], k.shape[0]), dtype=torch.bool)
    if causal:
        ok &= q[:, None] >= k[None, :]
    if window:
        ok &= q[:, None] - k[None, :] < window
    return ~ok.any(1)


def pos_summary(q_pos, k_pos, *, causal: bool,
                window: int | None) -> PosSummary:
    """The pre-pass's summary of one batch entry's q_pos [Sq], k_pos [Sk]."""
    q = torch.as_tensor(q_pos).to(torch.int64).reshape(-1)
    k = torch.as_tensor(k_pos).to(torch.int64).reshape(-1)
    keyless = keyless_rows(q, k, causal, window)
    pad = -q.shape[0] % POS_CHUNK
    flags = torch.cat([keyless, keyless.new_zeros(pad)]).view(-1, POS_CHUNK)
    return PosSummary(q.shape[0], k.shape[0], *_chunks(q),
                      tuple(flags.any(1).tolist()), *_chunks(k))


def _span(mins, maxs, lo: int, n: int) -> tuple[int, int]:
    """Least and greatest position of rows [lo, lo + n) (real rows only)."""
    c0, c1 = lo // POS_CHUNK, min(len(mins), -(-(lo + n) // POS_CHUNK))
    return min(mins[c0:c1]), max(maxs[c0:c1])


def _any(flags, lo: int, n: int) -> bool:
    return any(flags[lo // POS_CHUNK:min(len(flags),
                                         -(-(lo + n) // POS_CHUNK))])


def pos_visit(qmn: int, qmx: int, keyless: bool, kmn: int, kmx: int,
              causal: bool, window: int | None) -> bool:
    """Is the (query tile, key tile) pair visited: can it hold a kept
    pair, or does the query tile hold a row without a kept key?"""
    return keyless or ((not causal or kmn <= qmx)
                       and (not window or kmx > qmn - window))


def pos_full(qmn: int, qmx: int, kmn: int, kmx: int, causal: bool,
             window: int | None) -> bool:
    """Is every (query, key) pair of the two tiles kept?"""
    return (not causal or kmx <= qmn) and (not window or qmx - kmn < window)


def pos_schedule(p: PosSummary, *, causal: bool, window: int | None, bq: int,
                 bk: int) -> list[list[tuple[int, bool]]]:
    """``schedule`` under the positional rule: for each query tile, its
    visited kv tiles as (first key, masked)."""
    out = []
    for q0 in range(0, p.sq, bq):
        qmn, qmx = _span(p.q_min, p.q_max, q0, bq)
        keyless = _any(p.q_keyless, q0, bq)
        row = []
        for k0 in range(0, p.sk, bk):
            kmn, kmx = _span(p.k_min, p.k_max, k0, bk)
            if pos_visit(qmn, qmx, keyless, kmn, kmx, causal, window):
                full = k0 + bk <= p.sk and pos_full(qmn, qmx, kmn, kmx,
                                                    causal, window)
                row.append((k0, not full))
        out.append(row)
    return out


def pos_dkdv_schedule(p: PosSummary, *, causal: bool, window: int | None,
                      bk: int, bq: int) -> list[list[tuple[int, bool]]]:
    """``dkdv_schedule`` under the positional rule (Sq = Sk): for each key
    tile, its visited query tiles as (first row, masked)."""
    s = p.sk
    out = []
    for k0 in range(0, s, bk):
        kmn, kmx = _span(p.k_min, p.k_max, k0, bk)
        row = []
        for q0 in range(0, s, bq):
            qmn, qmx = _span(p.q_min, p.q_max, q0, bq)
            if pos_visit(qmn, qmx, _any(p.q_keyless, q0, bq), kmn, kmx,
                         causal, window):
                full = (q0 + bq <= s and k0 + bk <= s
                        and pos_full(qmn, qmx, kmn, kmx, causal, window))
                row.append((q0, not full))
        out.append(row)
    return out
