"""The SSD trace event recurrence as (max,+) linear algebra — host builders.

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
package builds them, so the dictionaries are bit-identical.  The
log-depth (max,+) matmul algebra is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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


def init_state(layout: StateLayout = DEFAULT_LAYOUT) -> np.ndarray:
    """All resources free at t=0 (controller and round_starts included)."""
    return np.zeros((layout.n_state,), np.float32)


def end_time_from_state(state: np.ndarray,
                        layout: StateLayout = DEFAULT_LAYOUT) -> np.ndarray:
    """Completion = max(bus, chip frees); excludes the ctrl/round_start
    helper rows (they never exceed the issuing op's bus row)."""
    return state[..., :layout.n_completion_rows].max(axis=-1)
