"""The SSD trace event recurrence as (max,+) linear algebra.

The per-op update of the trace simulator (``repro_torch.core.sim``)

    ready    = chip_free[c,w] + cmd + pre               (eager)
               round_start[c] + (w+1)·cmd + pre         (batched)
    start    = max(bus_free[c], ready, ctrl_free) + arb
    bus'_c   = start + slot ;  ctrl' = start + ctrl
    chip'_cw = bus'_c + post(parity)

is affine in the (max,+) semiring over the state vector

    s = [bus_0..bus_{C-1},
         chip_00..chip_{C-1,W-1},
         ctrl_free,
         round_start_0..round_start_{C-1},
         origin]

so one op is a matvec  s' = A ⊗ s  with (A ⊗ s)_r = max_c (A_rc + s_c).
Each *distinct* (op-class, channel, way, parity) combination appearing in
a trace gets one matrix; the trace compiles to a **matrix dictionary**
``mats [M, N, N]`` plus an index sequence ``idx [T]``, and the whole
trace is the fold  s_T = A_{idx[T-1]} ⊗ … ⊗ A_{idx[0]} ⊗ s_0, which the
CUDA kernel of ``repro_torch.kernels.maxplus`` evaluates for a batch of
design points.  A homogeneous single-channel stream degenerates to the
periodic form: M = 2·MAX_WAYS matrices and idx[t] = t mod M.

These builders run on the host in numpy float32, exactly as the JAX
package builds them, so the dictionaries are bit-identical.

Because ⊗ is associative, the fold need not be evaluated sequentially.
This module also holds the **log-depth evaluation strategies**, in plain
torch on the device of their inputs:

* ``structured_segment_products`` — chunk the trace into S segments and
  fold every segment's matrix product **concurrently**.  One op matrix
  is the identity plus ≤ 4 rewritten rows, so ``A_t ⊗ P`` only rewrites
  those rows of P: the segment fold is the *scan recurrence itself with
  each scalar resource time replaced by an N-row of the evolving
  product* — O(T·N) work instead of the O(T·N³) of dense matmuls, with
  sequential depth L = T/S;
* ``maxplus_fold_segmented`` — the dense twin over a matrix dictionary,
  with ``segment_len=None`` dispatching to ``maxplus_fold_assoc``, the
  pure O(log T)-depth product tree;
* ``maxplus_matrix_power`` / ``periodic_fold_squaring`` — a homogeneous
  periodic stream folds one period into ``A_period`` and reaches
  ``n_pages`` ops via repeated squaring: O(log n_pages) matmuls total.

Every (max,+) product here is an exact max over correctly rounded
float32 adds, so any evaluation order of the max gives the same bits;
the product *tree* of the log-depth combines is the one the JAX
package's ``associative_scan`` evaluates (``_assoc_total``), since
float32 (max,+) products are not associative in their adds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.sim import MAX_WAYS, PageOpParams, policy_is_batched

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Row indexing of the (max,+) state vector for a (C, W) geometry.

    The last row is the **origin** — a constant-zero row no op ever
    rewrites (its step-matrix row is the identity basis row).  Request
    arrival times enter the recurrence through its *column*: an op with
    arrival a contributes ``a + offset`` to the start-time max via
    ``A[row, origin] = a + offset`` and ``s[origin] = 0``, so
    arrival-aware traces stay inside the (max,+) algebra and compose
    across segment products exactly like every other source
   ."""

    channels: int = 1
    ways: int = MAX_WAYS

    @property
    def n_state(self) -> int:
        c, w = self.channels, self.ways
        return c + c * w + 1 + c + 1

    def bus(self, c: int) -> int:
        return c

    def chip(self, c: int, w: int) -> int:
        return self.channels + c * self.ways + w

    @property
    def ctrl(self) -> int:
        return self.channels * (1 + self.ways)

    def rs(self, c: int) -> int:
        return self.ctrl + 1 + c

    @property
    def origin(self) -> int:
        """The constant-zero (time-origin) row arrivals enter through."""
        return self.ctrl + 1 + self.channels

    @property
    def n_completion_rows(self) -> int:
        """bus + chip rows participate in the completion time; the ctrl,
        round_start and origin helpers never exceed them."""
        return self.channels * (1 + self.ways)


DEFAULT_LAYOUT = StateLayout(1, MAX_WAYS)
N_STATE = DEFAULT_LAYOUT.n_state   # bus, chips 0..15, ctrl, round_start, origin
PERIOD = 2 * MAX_WAYS              # homogeneous: round-robin × page parity


def ready_offset_us(cmd_us: float, pre_us: float, way: int,
                    batched: bool) -> float:
    """Command-issue latency between the ready *base* (chip free or round
    start — or the request arrival, whichever is later) and the op being
    ready for the bus: cmd+pre eager, (w+1)·cmd+pre batched.  The single
    definition the scan step, the structured fold, the step matrices and
    the oracles all share."""
    return ((way + 1) * cmd_us + pre_us) if batched else (cmd_us + pre_us)


def op_matrix(layout: StateLayout, *, cmd_us: float, pre_us: float,
              slot_us: float, ctrl_us: float, arb_us: float, post_us: float,
              channel: int, way: int, policy: str = "eager",
              arrival_us: float = 0.0, extra_us: float = 0.0) -> np.ndarray:
    """(max,+) step matrix of one op on (channel, way).

    ``arrival_us`` enters through the origin column: the op's ready time
    is max(base, arrival) + ready_offset, so the origin source carries
    ``arrival + ready_offset``.  At arrival 0 the origin candidate is
    dominated by every real source (state values are >= 0), leaving
    zero-arrival traces numerically identical to the pre-arrival form.

    ``extra_us`` is the op's reliability surcharge: it
    extends the op's *chip* occupancy (chip = bus' + post + extra) — an
    additive per-op shift that stays inside the (max,+) algebra.
    Retries re-run the sense inside the die, so neither the channel bus
    nor the serial controller is held: one retry-stormed read delays
    its own request and later ops on the same chip, never the channel
    or the FCFS issue stage."""
    n = layout.n_state
    a = np.full((n, n), NEG, np.float32)
    for r in range(n):
        a[r, r] = 0.0                       # untouched resources persist
    bus, chip = layout.bus(channel), layout.chip(channel, way)
    ctrl, rs, origin = layout.ctrl, layout.rs(channel), layout.origin
    batched = policy_is_batched(policy)
    ready_off = ready_offset_us(cmd_us, pre_us, way, batched)
    # start = max over these source columns (+ per-column offsets) + arb:
    if batched:
        if way == 0:
            sources = {bus: cmd_us + pre_us}
            a[rs, :] = NEG
            a[rs, bus] = 0.0                # round_start' = old bus_free
        else:
            sources = {bus: 0.0, rs: (way + 1) * cmd_us + pre_us}
    else:
        sources = {bus: 0.0, chip: cmd_us + pre_us}
    sources[ctrl] = max(sources.get(ctrl, NEG), 0.0)
    sources[origin] = arrival_us + ready_off
    for row, tail in ((bus, slot_us), (ctrl, ctrl_us),
                      (chip, slot_us + extra_us + post_us)):
        a[row, :] = NEG
        for col, off in sources.items():
            a[row, col] = arb_us + off + tail
    return a


def transition_matrices(op: PageOpParams, ways: int, policy: str = "eager",
                        arb_us: float = 0.0) -> np.ndarray:
    """[PERIOD, N_STATE, N_STATE] periodic matrices of a homogeneous
    single-channel stream (back-compat design-point batching form)."""
    assert MAX_WAYS % ways == 0, f"kernel path needs ways | {MAX_WAYS}, got {ways}"
    mats = np.stack([
        op_matrix(DEFAULT_LAYOUT, cmd_us=op.cmd_us, pre_us=op.pre_us,
                  slot_us=op.slot_us, ctrl_us=op.ctrl_us, arb_us=arb_us,
                  post_us=(op.post_lo_us if (i // ways) % 2 == 0
                           else op.post_hi_us),
                  channel=0, way=i % ways, policy=policy)
        for i in range(PERIOD)])
    return mats


def trace_combos(trace) -> tuple[list[tuple[int, int, int, int]], np.ndarray]:
    """Distinct (class, channel, way, parity) combos of a trace, in order
    of first appearance, plus the per-op index into them.  Depends only on
    the trace — shareable across a batch of timing tables."""
    combos: dict[tuple[int, int, int, int], int] = {}
    idx = np.empty(trace.n_ops, np.int32)
    for t in range(trace.n_ops):
        key = (int(trace.cls[t]), int(trace.channel[t]),
               int(trace.way[t]), int(trace.parity[t]) % 2)
        m = combos.get(key)
        if m is None:
            m = combos[key] = len(combos)
        idx[t] = m
    return list(combos), idx


def combo_matrices(table, combos, layout: StateLayout,
                   policy: str = "eager") -> np.ndarray:
    """[M, N, N] step matrices for one timing table over shared combos.

    Arrivals are *not* baked in (they vary per op, not per combo): the
    matrices carry the zero-arrival origin column, and arrival-aware
    folds max the per-op ``combo_arrival_offsets`` row + arrival into
    the state each step — algebraically the same augmented matrix,
    without exploding the dictionary to one matrix per op."""
    return np.stack([
        op_matrix(
            layout,
            cmd_us=float(table.cmd_us[k]), pre_us=float(table.pre_us[k]),
            slot_us=float(table.slot_us[k]), ctrl_us=float(table.ctrl_us[k]),
            arb_us=float(table.arb_us[k]),
            post_us=float(table.post_lo_us[k] if par == 0
                          else table.post_hi_us[k]),
            channel=c, way=w, policy=policy)
        for k, c, w, par in combos])


def combo_arrival_offsets(table, combos, layout: StateLayout,
                          policy: str = "eager") -> np.ndarray:
    """[M, N] origin-column templates per combo: row r of op combo m
    holds the offset the op's arrival contributes to state row r
    (NEG for rows the op does not rewrite).  The per-op augmented
    matrix is ``mats[m]`` with its origin column maxed against
    ``arrival + g[m]`` — equivalently, a fold step is
    ``s' = max(A_m (x) s, arrival + g[m])`` since ``s[origin] = 0``."""
    batched = policy_is_batched(policy)
    g = np.full((len(combos), layout.n_state), NEG, np.float32)
    for m, (k, c, w, par) in enumerate(combos):
        ready_off = ready_offset_us(float(table.cmd_us[k]),
                                    float(table.pre_us[k]), w, batched)
        arb = float(table.arb_us[k])
        slot = float(table.slot_us[k])
        post = float(table.post_lo_us[k] if par == 0
                     else table.post_hi_us[k])
        g[m, layout.bus(c)] = arb + ready_off + slot
        g[m, layout.ctrl] = arb + ready_off + float(table.ctrl_us[k])
        g[m, layout.chip(c, w)] = arb + ready_off + slot + post
    return g


def combo_written_rows(combos, layout: StateLayout) -> np.ndarray:
    """[M, N] float32 mask: 1.0 on the state rows the per-op reliability
    surcharge *shifts* (op combo m's chip only — retries re-run the
    sense in the die, so the bus, serial-ctrl and round-start rows are
    never extended), 0.0 elsewhere.

    This is how the surcharge (``OpTrace.extra_us``)
    enters the dictionary-matrix folds without exploding the dictionary
    to one matrix per op: a fold step becomes
    ``s' = max(A_m (x) s, arr + g[m]) + wrows[m] * extra_t`` — the
    shifted chip row moves by the op's extra (exactly the scan
    recurrence, where chip = bus' + post + extra), untouched rows add
    0.0 (exact)."""
    wr = np.zeros((len(combos), layout.n_state), np.float32)
    for m, (_, c, w, _) in enumerate(combos):
        wr[m, layout.chip(c, w)] = 1.0
    return wr


def maxplus_eye(n: int) -> np.ndarray:
    """(max,+) identity: 0 on the diagonal, -inf (NEG) elsewhere."""
    return np.where(np.eye(n, dtype=bool), 0.0, NEG).astype(np.float32)


# ---------------------------------------------------------------------------
# Log-depth evaluation: (max,+) matmul algebra
# ---------------------------------------------------------------------------

#: Largest [..., R, K, C] sum tensor ``maxplus_matmul`` forms in one piece;
#: bigger products reduce over k one column at a time instead.
MATMUL_CUBE_ELEMS = 1 << 24


def _eye_like(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(maxplus_eye(n), device=like.device)


def maxplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(max,+) matrix product C[..., r, c] = max_k (a[..., r, k] +
    b[..., k, c]).

    Saturates at NEG so identity rows stay exactly NEG under repeated
    squaring instead of drifting towards float -inf/overflow.  Small
    products form the [..., R, K, C] sums at once; larger ones keep a
    running maximum over k, so the cube never exists on the device.
    Each sum is one correctly rounded add and the max is exact, so both
    give the same bits."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    k = a.shape[-1]
    if math.prod(lead) * a.shape[-2] * k * b.shape[-1] <= MATMUL_CUBE_ELEMS:
        c = (a[..., :, :, None] + b[..., None, :, :]).amax(dim=-2)
    else:
        c = a[..., :, :1] + b[..., :1, :]
        for j in range(1, k):
            torch.maximum(c, a[..., :, j:j + 1] + b[..., j:j + 1, :], out=c)
    return c.clamp_min_(NEG)


def maxplus_matvec(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(A ⊗ s)[..., r] = max_c (a[..., r, c] + s[..., c])."""
    return (a + s[..., None, :]).amax(dim=-1)


def maxplus_matrix_power(a: torch.Tensor, n: int) -> torch.Tensor:
    """a^⊗n by binary exponentiation — O(log n) (max,+) matmuls.

    ``n`` is a python int >= 0; n == 0 returns the identity."""
    assert n >= 0
    result = _eye_like(a.shape[-1], a).expand(a.shape)
    while n:
        if n & 1:
            result = maxplus_matmul(a, result)
        n >>= 1
        if n:
            a = maxplus_matmul(a, a)
    return result


def _chain_product(g: torch.Tensor) -> torch.Tensor:
    """Sequential fold P = g[-1] ⊗ … ⊗ g[0] over the leading axis."""
    p = _eye_like(g.shape[-1], g).expand(g.shape[1:])
    for a in g:
        p = maxplus_matmul(a, p)
    return p


def _assoc_total(x: torch.Tensor) -> torch.Tensor:
    """x[-1] ⊗ … ⊗ x[0] over the leading axis, in the product tree of the
    last prefix of ``jax.lax.associative_scan(lambda x, y:
    maxplus_matmul(y, x), x)``: pair neighbours, reduce the pairs, and
    fold an odd last element in after them.  One batched matmul a
    level, O(log n) depth."""
    n = x.shape[0]
    if n == 1:
        return x[0]
    m = n // 2
    total = _assoc_total(maxplus_matmul(x[1:2 * m:2], x[0:2 * m:2]))
    return total if n % 2 == 0 else maxplus_matmul(x[-1], total)


def maxplus_fold_assoc(g: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """Pure log-depth fold: s_T = g[T-1] ⊗ … ⊗ g[0] ⊗ s0.

    ``g`` [T, ..., N, N] per-op matrices (already gathered), ``s0``
    [..., N].  O(T·N³) work in O(log T) depth."""
    return maxplus_matvec(_assoc_total(g), s0)


def maxplus_fold_segmented(mats: torch.Tensor, idx, s0: torch.Tensor, *,
                           segment_len: int | None = 64) -> torch.Tensor:
    """Segmented parallel-prefix fold of a trace-indexed matrix product.

    ``mats`` [..., M, N, N] matrix dictionary, ``idx`` [T] per-op matrix
    index (shared by the batch), ``s0`` [..., N].  The trace is chunked
    into S = ceil(T/L) segments of length L = ``segment_len``; all S
    segment products fold concurrently (L steps of batched matmuls over
    [..., S, N, N]), then the S products combine in the log-depth tree —
    O(L + log S) depth vs the O(T) sequential matvec fold.  The tail pads
    with the (max,+) identity (index M), a no-op on the product.  This is
    the dense strategy over a matrix dictionary; the O(T·N) structured
    twin is ``structured_segment_products``.  ``segment_len=None``
    gathers all T matrices and runs the pure O(log T)-depth
    ``maxplus_fold_assoc``."""
    idx = torch.as_tensor(idx, device=mats.device).long()
    if segment_len is None:
        return maxplus_fold_assoc(
            mats.index_select(-3, idx).movedim(-3, 0), s0)
    n = mats.shape[-1]
    t_steps = idx.shape[0]
    seg = max(1, min(segment_len, t_steps))
    n_seg = -(-t_steps // seg)
    eye = _eye_like(n, mats)
    # index M = identity padding for the ragged tail
    mats_ext = torch.cat(
        [mats, eye.expand(mats.shape[:-3] + (1, n, n))], dim=-3)
    idx_ext = torch.cat([idx, idx.new_full((n_seg * seg - t_steps,),
                                           mats.shape[-3])])
    idx_cols = idx_ext.reshape(n_seg, seg).T            # [L, S]
    p = eye.expand(mats.shape[:-3] + (n_seg, n, n))
    for cols in idx_cols:
        p = maxplus_matmul(mats_ext.index_select(-3, cols), p)
    return maxplus_matvec(_assoc_total(p.movedim(-3, 0)), s0)


def structured_segment_products(
    cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us, arb_us,
    cls, channel, way, parity, arrival_us=None, extra_us=None, *,
    channels: int, ways: int, batched: bool, segment_len: int,
    valid=None,
) -> torch.Tensor:
    """[..., S, N, N] (max,+) products of the trace's S = ceil(T/L)
    segments.

    Table columns are [K] float32 tensors, or [B, K] for a batch of
    design points sharing the trace (the result then leads with B); the
    per-op arrays ([T]: class, channel, way, parity, optional arrival,
    surcharge and validity) are host arrays or tensors, moved to the
    table's device.

    Exploits the structure of the step matrices: one op rewrites only
    the bus/ctrl/chip (and round-start) rows, each a max of ≤ 3 source
    rows plus offsets — so ``A_t ⊗ P`` is the scan-engine recurrence
    applied to *N-row-valued* resource times.  Every segment runs that
    recurrence from identity basis rows, all segments advancing in one
    vectorised step: O(T·N) work, sequential depth L.  Each op computes,
    in this float32 order (the JAX package's): ``ready_off = (w+1)·cmd +
    pre`` (batched) or ``cmd + pre``; ``ready = max(base_row, origin_row
    + arrival) + ready_off``; ``start = max(max(bus_row, ready),
    ctrl_row) + arb``; ``bus' = start + slot``; ``chip' = (bus' + post)
    + extra``; ``ctrl' = start + ctrl``.

    ``arrival_us`` enters through the constant origin basis row, so the
    segment products compose arrival effects across segments like every
    other (max,+) source; ``extra_us`` extends the op's chip row only.
    ``valid`` masks ops out *exactly*: a False op, like the padding of
    the ragged tail, writes no row, so it is the (max,+) identity on the
    product, not a zero-timing op (which would still serialise the
    bus).  The product lives in one [B, S, N + 1, N] tensor updated in
    place; row N is a per-segment sentinel that masked writes land in,
    sliced off the returned view."""
    table = (cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us,
             arb_us)
    single = table[0].dim() == 1
    if single:
        table = tuple(x[None] for x in table)
    cmd, pre, slot, lo, hi, ctru, arb = table
    dev = cmd.device
    layout = StateLayout(channels, ways)
    n = layout.n_state
    t_steps = len(cls)
    seg = max(1, min(segment_len, t_steps))
    n_seg = -(-t_steps // seg)

    def lanes(x, dtype, fill=0):
        """[T] per-op array -> [L, S] (op s·L + l at [l, s]), the tail
        padded with ``fill``."""
        x = torch.as_tensor(x, device=dev).to(dtype)
        x = torch.cat([x, x.new_full((n_seg * seg - t_steps,), fill)])
        return x.reshape(n_seg, seg).T.contiguous()

    f32 = torch.float32
    k = lanes(cls, torch.long)
    c = lanes(channel, torch.long)
    w = lanes(way, torch.long)
    par = lanes(parity, torch.long)
    arr = lanes(np.zeros(t_steps, np.float32) if arrival_us is None
                else arrival_us, f32)
    ext = lanes(np.zeros(t_steps, np.float32) if extra_us is None
                else extra_us, f32)
    ok = lanes(np.ones(t_steps, bool) if valid is None else valid,
               torch.bool, fill=False)
    # hoist every per-op quantity out of the step loop: class-table
    # gathers ([B, L, S]), parity-resolved post times, and the rows each
    # op reads and writes, as flat indices into the [B, S·(N+1), N] view
    ready_off = ((w + 1).to(f32) * cmd[:, k] if batched
                 else cmd[:, k]) + pre[:, k]
    post = torch.where(par % 2 == 0, lo[:, k], hi[:, k])
    slot, ctru, arb = slot[:, k], ctru[:, k], arb[:, k]
    base = torch.arange(n_seg, device=dev) * (n + 1)       # lane row 0
    sentinel = base + n
    bus_rd = base + c
    chip_rd = base + layout.channels + c * ways + w
    rs_rd = base + layout.ctrl + 1 + c
    ctl_rd = base + layout.ctrl
    bus_wr = torch.where(ok, bus_rd, sentinel)
    chip_wr = torch.where(ok, chip_rd, sentinel)
    ctl_wr = torch.where(ok, ctl_rd, sentinel)
    first = (w == 0) & ok
    rs_wr = torch.where(first, rs_rd, sentinel)

    eye = torch.as_tensor(maxplus_eye(n), device=dev)
    origin_row = eye[layout.origin]                        # never written
    prods = torch.empty((cmd.shape[0], n_seg, n + 1, n), dtype=f32,
                        device=dev)
    prods[:, :, :n] = eye
    prods[:, :, n] = NEG
    flat = prods.view(cmd.shape[0], n_seg * (n + 1), n)
    for t in range(seg):
        bus_c = flat.index_select(1, bus_rd[t])            # [B, S, N]
        arr_row = origin_row + arr[t, :, None]             # [S, N]
        if batched:
            rs_row = torch.where(first[t, :, None], bus_c,
                                 flat.index_select(1, rs_rd[t]))
            flat.index_copy_(1, rs_wr[t], bus_c)
        else:                          # rs rows stay identity
            rs_row = flat.index_select(1, chip_rd[t])
        ready = torch.maximum(rs_row, arr_row) + ready_off[:, t, :, None]
        start = (torch.maximum(torch.maximum(bus_c, ready),
                               flat.index_select(1, ctl_rd))
                 + arb[:, t, :, None])
        new_bus = start + slot[:, t, :, None]
        flat.index_copy_(1, bus_wr[t], new_bus)
        flat.index_copy_(1, chip_wr[t],
                         new_bus + post[:, t, :, None] + ext[t, :, None])
        flat.index_copy_(1, ctl_wr[t], start + ctru[:, t, :, None])
    out = prods[:, :, :n]
    return out[0] if single else out


def structured_segment_energy(e_op_uj: torch.Tensor, cls, parity, *,
                              segment_len: int) -> torch.Tensor:
    """[S, P] per-segment phase-energy sums (uJ) of the trace's
    S = ceil(T/L) segments — the energy twin of
    ``structured_segment_products``.  Energy is (+, +)-linear in the ops,
    so the phase accumulator needs only a segment *sum* over the same
    chunking: gather each op's [P] phase vector (parity-resolved), pad
    the ragged tail with zeros (a true no-op for +), and reduce per
    segment.  ``e_op_uj`` is [K, 2, P]; the per-op arrays are host
    arrays or tensors."""
    dev = e_op_uj.device
    t_steps = len(cls)
    seg = max(1, min(segment_len, t_steps))
    n_seg = -(-t_steps // seg)
    k = torch.as_tensor(np.asarray(cls), device=dev).long()
    par = torch.as_tensor(np.asarray(parity), device=dev).long() % 2
    e = e_op_uj[k, par]                                    # [T, P]
    e = torch.cat([e, e.new_zeros((n_seg * seg - t_steps, e.shape[-1]))])
    return e.reshape(n_seg, seg, e.shape[-1]).sum(dim=1)


def periodic_fold_squaring(period_mats: torch.Tensor, s0: torch.Tensor,
                           n_steps: int) -> torch.Tensor:
    """Homogeneous stream: fold one period, then square to ``n_steps``.

    ``period_mats`` [..., P, N, N] (op order along axis -3); the fold
        s_T = R ⊗ A_period^q ⊗ s0,  n_steps = q·P + r,
    needs the P-step period product, ~log2(q) squarings and an r-step
    remainder prefix — O(P + log n_steps) matmuls vs O(n_steps) matvecs."""
    p = period_mats.shape[-3]
    q, r = divmod(int(n_steps), p)
    lead = period_mats.movedim(-3, 0)                     # [P, ..., N, N]
    total = maxplus_matrix_power(_chain_product(lead), q)
    if r:
        total = maxplus_matmul(_chain_product(lead[:r]), total)
    return maxplus_matvec(total, s0)


def init_state(layout: StateLayout = DEFAULT_LAYOUT) -> np.ndarray:
    """All resources free at t=0 (controller and round_starts included)."""
    return np.zeros((layout.n_state,), np.float32)


def end_time_from_state(state: np.ndarray,
                        layout: StateLayout = DEFAULT_LAYOUT) -> np.ndarray:
    """Completion = max(bus, chip frees); excludes the ctrl/round_start
    helper rows (they never exceed the issuing op's bus row)."""
    return state[..., :layout.n_completion_rows].max(axis=-1)
