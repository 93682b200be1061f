"""Plain-Python oracles for the multi-channel trace simulation.

Explicit event loops with no vectorisation tricks, in numpy and Python
floats: the independent reference every engine of the port (the torch
``scan`` fold and the CUDA (max,+) kernel) is held against.
``simulate_trace_ref`` walks a heterogeneous ``OpTrace`` against an
``OpClassTable`` with per-channel buses, the shared-controller occupancy
row and the firmware arbitration charge; ``simulate_trace_energy_ref``
also accumulates each op's phase energies and
``simulate_trace_completions_ref`` records each op's completion.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.energy import N_OP_PHASES, op_phase_energy_uj
from repro_torch.core.sim import policy_is_batched


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
