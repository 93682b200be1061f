"""Plain-Python oracles for the multi-channel trace simulation.

Explicit event loops with no vectorisation tricks, in numpy and Python
floats: the independent reference every engine of the port (the torch
``scan`` fold and the CUDA (max,+) kernel) is held against.
``simulate_trace_ref`` walks a heterogeneous ``OpTrace`` against an
``OpClassTable`` with per-channel buses, the shared-controller occupancy
row and the firmware arbitration charge; ``simulate_trace_energy_ref``
also accumulates each op's phase energies and
``simulate_trace_completions_ref`` records each op's completion.
``simulate_trace_matfold_ref`` evaluates a trace as explicit float64
(max,+) segment products combined in a pairwise tree — the oracle of the
log-depth ``prefix`` engine — and ``simulate_channel_ref`` /
``bandwidth_ref_mb_s`` the homogeneous single-channel stream the
``squaring`` engine serves.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.energy import N_OP_PHASES, op_phase_energy_uj
from repro_torch.core.sim import MAX_WAYS, PageOpParams, policy_is_batched


def _trace_event_loop(table, trace, policy, per_op=None) -> float:
    """The one explicit event loop behind both trace oracles.  Calls
    ``per_op(k, parity, completion_us)`` after each op's state update
    when given.  Request arrivals (``trace.arrival_us``) lower-bound the
    ready base: an op's command cannot issue before its request arrives
    (absent/zero arrivals reproduce the back-to-back loop exactly).
    The per-op reliability surcharge (``trace.extra_us``, read retries +
    jitter, the reliability model) extends the op's *chip* occupancy — retries
    re-run the sense inside the die, so neither the channel bus nor the
    serial controller is held, and a retry storm only delays its own
    request and later ops on the same chip (absent/zero extras add
    +0.0 — exact)."""
    batched = policy_is_batched(policy)   # typos raise, never fall through
    c_count, w_count = trace.channels, trace.ways
    arrival = trace.arrival_us
    extra = trace.extra_us
    bus_free = [0.0] * c_count
    chip_free = [[0.0] * w_count for _ in range(c_count)]
    ctrl_free = 0.0
    round_start = [0.0] * c_count
    for t in range(trace.n_ops):
        k = int(trace.cls[t])
        c = int(trace.channel[t])
        w = int(trace.way[t])
        par = int(trace.parity[t])
        arr = 0.0 if arrival is None else float(arrival[t])
        ext = 0.0 if extra is None else float(extra[t])
        if w == 0:
            round_start[c] = bus_free[c]
        if batched:
            ready = (max(round_start[c], arr)
                     + (w + 1) * table.cmd_us[k] + table.pre_us[k])
        else:
            ready = (max(chip_free[c][w], arr)
                     + table.cmd_us[k] + table.pre_us[k])
        start = max(bus_free[c], ready, ctrl_free) + table.arb_us[k]
        bus_free[c] = start + table.slot_us[k]
        ctrl_free = start + table.ctrl_us[k]
        post = table.post_lo_us[k] if par % 2 == 0 else table.post_hi_us[k]
        chip_free[c][w] = bus_free[c] + post + ext
        if per_op is not None:
            per_op(k, par, chip_free[c][w])
    return float(max(max(bus_free), max(max(row) for row in chip_free)))


def simulate_trace_ref(table, trace, policy: str = "eager") -> float:
    """Completion time (us) of an OpTrace on C channels (trace oracle)."""
    return _trace_event_loop(table, trace, policy)


def simulate_trace_completions_ref(table, trace, policy: str = "eager"
                                   ) -> tuple[float, np.ndarray]:
    """(end_us, [T] per-op completion times) — the oracle twin of
    ``repro_torch.core.sim.trace_completions`` (latency extraction for
    arrival-aware request workloads)."""
    comp: list[float] = []

    def per_op(k, par, done_us):
        comp.append(float(done_us))

    end = _trace_event_loop(table, trace, policy, per_op)
    return end, np.asarray(comp, np.float64)


def trace_bandwidth_ref_mb_s(table, trace, policy: str = "eager") -> float:
    return trace.total_bytes(table) / simulate_trace_ref(table, trace, policy)


def simulate_trace_energy_ref(table, trace, kind,
                              policy: str = "eager"
                              ) -> tuple[float, np.ndarray]:
    """(end_us, [N_OP_PHASES] phase-energy sums in uJ): the event-loop
    oracle accumulating each op's phase energies alongside the
    recurrence.  Pure python floats, no vectorisation."""
    e_op = np.asarray(op_phase_energy_uj(table, kind), np.float64)
    acc = np.zeros((N_OP_PHASES,), np.float64)

    def per_op(k, par, done_us):
        acc[:] += e_op[k, par % 2]

    end = _trace_event_loop(table, trace, policy, per_op)
    return end, acc


def maxplus_matmul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(max,+) matrix product in plain numpy (oracle building block)."""
    return np.max(a[..., :, :, None] + b[..., None, :, :], axis=-2)


def simulate_trace_matfold_ref(table, trace, policy: str = "eager",
                               segment_len: int = 64) -> float:
    """Completion time (us) of an OpTrace via explicit (max,+) segment
    products — the oracle for the segmented parallel-prefix engines.

    Each length-``segment_len`` chunk of the trace folds into one step
    matrix with sequential numpy matmuls; the chunk products then
    combine in a pairwise tree (the log-depth combine), and the total
    product applies to the all-free initial state.  Arrivals ride the
    per-op matrices through the origin column (one matrix per op when
    the trace carries them; the shared combo dictionary otherwise)."""
    from repro_torch.core.maxplus_form import (StateLayout, combo_matrices,
                                               end_time_from_state,
                                               init_state, maxplus_eye,
                                               op_matrix, trace_combos)

    layout = StateLayout(trace.channels, trace.ways)
    combos, idx = trace_combos(trace)
    if trace.arrival_us is None and trace.extra_us is None:
        mats = combo_matrices(table, combos, layout, policy)
        per_op = [mats[int(m)] for m in idx]
    else:
        per_op = []
        for t in range(trace.n_ops):
            k, c, w = (int(trace.cls[t]), int(trace.channel[t]),
                       int(trace.way[t]))
            par = int(trace.parity[t]) % 2
            per_op.append(op_matrix(
                layout, cmd_us=float(table.cmd_us[k]),
                pre_us=float(table.pre_us[k]),
                slot_us=float(table.slot_us[k]),
                ctrl_us=float(table.ctrl_us[k]),
                arb_us=float(table.arb_us[k]),
                post_us=float(table.post_lo_us[k] if par == 0
                              else table.post_hi_us[k]),
                channel=c, way=w, policy=policy,
                arrival_us=(0.0 if trace.arrival_us is None
                            else float(trace.arrival_us[t])),
                extra_us=(0.0 if trace.extra_us is None
                          else float(trace.extra_us[t]))))
    prods = []
    for lo in range(0, trace.n_ops, segment_len):
        p = maxplus_eye(layout.n_state).astype(np.float64)
        for a in per_op[lo:lo + segment_len]:
            p = maxplus_matmul_np(a.astype(np.float64), p)
        prods.append(p)
    while len(prods) > 1:          # pairwise tree: prods[i+1] is later
        nxt = [maxplus_matmul_np(prods[i + 1], prods[i])
               for i in range(0, len(prods) - 1, 2)]
        if len(prods) % 2:
            nxt.append(prods[-1])
        prods = nxt
    state = np.max(prods[0] + init_state(layout)[None, :], axis=-1)
    return float(end_time_from_state(state, layout))


def simulate_channel_ref(op: PageOpParams, ways: int, n_pages: int,
                         batched: bool = False) -> float:
    """Completion time (us) of n_pages round-robin page ops on one channel.

    Single-channel homogeneous special case: the shared controller never
    binds (ctrl_us <= slot_us, arb_us = 0), so the loop carries the bus,
    the chips and the round start only."""
    assert 1 <= ways <= MAX_WAYS
    bus_free = 0.0
    chip_free = [0.0] * ways
    round_start = 0.0
    for i in range(n_pages):
        w = i % ways
        rnd = i // ways
        if w == 0:
            round_start = bus_free
        if batched:
            ready = round_start + (w + 1) * op.cmd_us + op.pre_us
        else:
            ready = chip_free[w] + op.cmd_us + op.pre_us
        start = max(bus_free, ready)
        bus_free = start + op.slot_us
        post = op.post_lo_us if rnd % 2 == 0 else op.post_hi_us
        chip_free[w] = bus_free + post
    return max(bus_free, max(chip_free))


def bandwidth_ref_mb_s(op: PageOpParams, ways: int, n_pages: int = 512,
                       batched: bool = False) -> float:
    """Steady single-channel bandwidth (MB/s) of ``simulate_channel_ref``."""
    end = simulate_channel_ref(op, ways, n_pages, batched)
    return n_pages * op.data_bytes / end
