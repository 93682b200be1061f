"""Public ops: SSD completion times via the (max,+) CUDA kernel.

Three entry points mirror the scan-engine paths in ``repro_torch.core``:

* ``channel_end_time_maxplus`` — homogeneous single-channel design-point
  batches (periodic matrix form; ways must divide MAX_WAYS — the
  power-of-two sweep grid of the paper);
* ``trace_end_time_maxplus`` — one heterogeneous ``OpTrace`` evaluated
  for a batch of design-point ``OpClassTable``s (the matrix-dictionary
  form);
* ``run_many_end_time_maxplus`` — a fleet of traces under one table, one
  many-trace kernel launch over the fleet's union dictionary.

``trace_energy_maxplus`` additionally accumulates the phase-resolved
per-op energies ``E[idx[t]]`` inside the kernel's fold.

The matrix dictionaries are built on the host in numpy float32
(``repro_torch.core.maxplus_form``), moved to ``device`` once, and folded
by ``kernel.maxplus_fold_kernel`` — the CUDA kernel for a CUDA device,
its plain version for the CPU.  Only ``strategy="sequential"`` exists so
far; the log-depth strategies ("segmented", "squaring") come with the
(max,+) matmul algebra.  Every entry point takes ``device`` (None =
``cuda``, raising when there is no card).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.energy import op_phase_energy_uj
from repro_torch.core.maxplus_form import (NEG, StateLayout,
                                           combo_arrival_offsets,
                                           combo_matrices, combo_written_rows,
                                           end_time_from_state, init_state,
                                           maxplus_eye, trace_combos,
                                           transition_matrices)
from repro_torch.core.sim import PageOpParams
from repro_torch.device import resolve_device
from repro_torch.kernels.maxplus.kernel import (maxplus_fold_kernel,
                                                maxplus_fold_many_kernel)

STRATEGIES = ("sequential",)


def _check_strategy(strategy: str) -> None:
    if strategy in ("segmented", "squaring"):
        raise ValueError(f"strategy={strategy!r} is not ported yet: the "
                         "log-depth (max,+) algebra lands with slice C")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} (one of "
                         "'sequential', 'segmented', 'squaring')")


def _f32(x, device) -> torch.Tensor:
    """Explicit float32 on ``device`` (numpy's float64 never leaks in)."""
    return torch.as_tensor(np.require(x, np.float32, ("C", "W")),
                           device=device)


def maxplus_fold(mats, s0, *, t_steps: int, idx=None,
                 strategy: str = "sequential", arrivals=None, gvec=None,
                 extras=None, wvec=None):
    """Fold dispatch over ``strategy`` (only "sequential" so far).
    ``arrivals`` [T] + ``gvec`` [B, M, N] make the fold arrival-aware;
    ``extras`` [T] + ``wvec`` [B, M, N] add per-op reliability
    surcharges on the written rows (trace-indexed path only)."""
    _check_strategy(strategy)
    return maxplus_fold_kernel(mats, s0, t_steps=t_steps, idx=idx,
                               arrivals=arrivals, gvec=gvec, extras=extras,
                               wvec=wvec)


def channel_end_time_maxplus(
    ops: list[PageOpParams],
    ways: list[int],
    *,
    n_pages: int,
    policy: str = "eager",
    strategy: str = "sequential",
    device=None,
) -> np.ndarray:
    """Completion times (us) for a batch of homogeneous design points."""
    dev = resolve_device(device)
    mats = np.stack([transition_matrices(op, w, policy)
                     for op, w in zip(ops, ways)])
    s0 = np.broadcast_to(init_state(), (mats.shape[0],
                                        init_state().shape[0]))
    final = maxplus_fold(_f32(mats, dev), _f32(s0, dev), t_steps=n_pages,
                         strategy=strategy)
    return end_time_from_state(final.cpu().numpy())


def bandwidth_maxplus_mb_s(ops, ways, *, n_pages: int = 512,
                           policy: str = "eager", **kw) -> np.ndarray:
    end = channel_end_time_maxplus(ops, ways, n_pages=n_pages, policy=policy,
                                   **kw)
    data = np.array([op.data_bytes for op in ops], np.float64)
    return data * n_pages / np.asarray(end)


def _combo_setup(tables, trace, policy, device):
    """(layout, combos, idx, mats [B,M,N,N], s0 [B,N], arrivals, gvec,
    extras, wvec) on ``device``, shared by the trace-indexed end-time and
    energy entry points.  ``arrivals``/``gvec`` are None for back-to-back
    traces and ``extras``/``wvec`` for fault-free ones.  The dictionary is
    filled table by table into one float32 array, so the host holds it
    once."""
    layout = StateLayout(trace.channels, trace.ways)
    combos, idx = trace_combos(trace)   # trace-only: shared by the batch
    n = layout.n_state
    mats = np.empty((len(tables), len(combos), n, n), np.float32)
    for b, table in enumerate(tables):
        mats[b] = combo_matrices(table, combos, layout, policy)
    s0 = np.broadcast_to(init_state(layout), (len(tables), n))
    arrivals = gvec = None
    if trace.arrival_us is not None:
        arrivals = _f32(trace.arrival_us, device)
        gvec = _f32(np.stack([
            combo_arrival_offsets(table, combos, layout, policy)
            for table in tables]), device)
    extras = wvec = None
    if trace.extra_us is not None:
        extras = _f32(trace.extra_us, device)
        w = combo_written_rows(combos, layout)          # combo-only: shared
        wvec = _f32(np.broadcast_to(w, (len(tables),) + w.shape), device)
    idx_t = torch.as_tensor(np.require(idx, np.int32, ("C", "W")),
                            device=device)
    return (layout, combos, idx_t, _f32(mats, device), _f32(s0, device),
            arrivals, gvec, extras, wvec)


def trace_end_time_maxplus(
    tables,                    # OpClassTable | list[OpClassTable]
    trace,                     # OpTrace (shared across the batch)
    *,
    policy: str = "eager",
    strategy: str = "sequential",
    device=None,
) -> np.ndarray:
    """Completion times (us) of one heterogeneous trace under a batch of
    design-point timing tables ([B], or scalar for a single table)."""
    dev = resolve_device(device)
    _check_strategy(strategy)
    single = not isinstance(tables, (list, tuple))
    if single:
        tables = [tables]
    layout, _, idx, mats, s0, arrivals, gvec, extras, wvec = _combo_setup(
        tables, trace, policy, dev)
    final = maxplus_fold(mats, s0, t_steps=trace.n_ops, idx=idx,
                         strategy=strategy, arrivals=arrivals, gvec=gvec,
                         extras=extras, wvec=wvec)
    end = end_time_from_state(final.cpu().numpy(), layout)
    return end[0] if single else end


def _many_setup(table, traces, policy, device):
    """(layout, order, kernel arguments) of a fleet sharing one (C, W)
    geometry: the fleet's union combo dictionary with the identity pad
    row appended, and the per-lane index / arrival / surcharge arrays
    with the lanes sorted longest-first (``order[lane]`` is the trace
    index of each lane).  Arrival and fault operands are None when the
    whole fleet has none, the same choice as the JAX package, so the same
    operations run."""
    geom = (traces[0].channels, traces[0].ways)
    for tr in traces:
        if (tr.channels, tr.ways) != geom:
            raise ValueError(
                "fused run_many needs one shared (channels, ways) geometry "
                f"per call — got {geom} and {(tr.channels, tr.ways)}")
    layout = StateLayout(*geom)
    # union combo dictionary across the fleet: pack each op's (class,
    # channel, way, parity) into one integer key and let np.unique build
    # the dictionary and the per-op indices in one pass
    keys = np.concatenate([
        (np.asarray(tr.cls, np.int64) << 24)
        | (np.asarray(tr.channel, np.int64) << 16)
        | (np.asarray(tr.way, np.int64) << 8)
        | (np.asarray(tr.parity, np.int64) & 1)
        for tr in traces])
    uniq, inv = np.unique(keys, return_inverse=True)
    combos = [(int(k >> 24), int((k >> 16) & 0xFF),
               int((k >> 8) & 0xFF), int(k & 1)) for k in uniq]
    bounds = np.cumsum([0] + [tr.n_ops for tr in traces])
    m = len(combos)
    n = layout.n_state
    mats = np.concatenate([combo_matrices(table, combos, layout, policy),
                           maxplus_eye(n)[None]])
    gvec = np.concatenate([combo_arrival_offsets(table, combos, layout,
                                                 policy),
                           np.full((1, n), NEG, np.float32)])
    order = sorted(range(len(traces)), key=lambda i: -traces[i].n_ops)
    b, t_max = len(traces), traces[order[0]].n_ops
    idx = np.full((b, t_max), m, np.int32)
    arr = np.zeros((b, t_max), np.float32)
    ext = np.zeros((b, t_max), np.float32)
    lengths = np.zeros((b,), np.int32)
    for lane, i in enumerate(order):
        tr = traces[i]
        idx[lane, :tr.n_ops] = inv[bounds[i]:bounds[i + 1]]
        if tr.arrival_us is not None:
            arr[lane, :tr.n_ops] = np.asarray(tr.arrival_us, np.float32)
        if tr.extra_us is not None:
            ext[lane, :tr.n_ops] = np.asarray(tr.extra_us, np.float32)
        lengths[lane] = tr.n_ops
    extras = wvec = None
    if ext.any():
        wvec = _f32(np.concatenate([combo_written_rows(combos, layout),
                                    np.zeros((1, n), np.float32)]), device)
        extras = _f32(ext, device)
    args = dict(mats=_f32(mats, device), gvec=_f32(gvec, device),
                idx=torch.as_tensor(idx, device=device),
                arrivals=_f32(arr, device),
                s0=_f32(init_state(layout), device),
                lengths=torch.as_tensor(lengths, device=device),
                extras=extras, wvec=wvec, with_arrivals=bool(arr.any()))
    return layout, order, args


def run_many_end_time_maxplus(
    table,                     # OpClassTable (one design point)
    traces,                    # list[OpTrace], one shared (C, W) geometry
    *,
    policy: str = "eager",
    device=None,
) -> np.ndarray:
    """End times (us) of B independent heterogeneous traces in ONE launch
    of the many-trace kernel (``maxplus_fold_many_kernel``): lanes are
    whole traces rather than design points, folding their own op
    sequences against the *union* combo dictionary of the fleet.  An
    appended (max,+) identity combo (NEG origin template, zero written
    rows) pads short lanes in the index array as an exact no-op; lanes
    sort longest-first and each stops at its own length."""
    dev = resolve_device(device)
    if not traces:
        return np.zeros((0,), np.float64)
    layout, order, args = _many_setup(table, traces, policy, dev)
    final = maxplus_fold_many_kernel(**args)
    end = end_time_from_state(final.cpu().numpy(), layout)
    out = np.empty((len(traces),), np.float64)
    out[np.asarray(order)] = end
    return out


def combo_energy_uj(table, combos, kind) -> np.ndarray:
    """[M, P] phase-energy vector per (class, channel, way, parity) combo
    — the energy twin of ``combo_matrices`` (parity resolved here, so the
    kernel's per-step gather index serves both)."""
    e = op_phase_energy_uj(table, kind)            # [K, 2, P]
    return np.stack([e[k, par] for k, _c, _w, par in combos])


def trace_energy_maxplus(
    tables,                    # OpClassTable | list[OpClassTable]
    trace,                     # OpTrace (shared across the batch)
    kinds,                     # InterfaceKind | list[InterfaceKind]
    *,
    policy: str = "eager",
    strategy: str = "sequential",
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(end_us, phase-energy sums in uJ) of one trace under a batch of
    design points ([B] / [B, P], or scalar / [P] for a single table).
    The kernel accumulates ``E[idx[t]]`` in op order next to the (max,+)
    matvec."""
    dev = resolve_device(device)
    _check_strategy(strategy)
    single = not isinstance(tables, (list, tuple))
    if single:
        tables, kinds = [tables], [kinds]
    if len(kinds) != len(tables):
        raise ValueError("need one interface kind per op-class table")
    layout, combos, idx, mats, s0, arrivals, gvec, extras, wvec = \
        _combo_setup(tables, trace, policy, dev)
    e = _f32(np.stack([combo_energy_uj(table, combos, kind)
                       for table, kind in zip(tables, kinds)]), dev)
    final, acc = maxplus_fold_kernel(
        mats, s0, t_steps=trace.n_ops, idx=idx, energy=e, arrivals=arrivals,
        gvec=gvec, extras=extras, wvec=wvec)
    end = end_time_from_state(final.cpu().numpy(), layout)
    acc = acc.cpu().numpy()
    return (end[0], acc[0]) if single else (end, acc)


def trace_bandwidth_maxplus_mb_s(tables, trace, **kw) -> np.ndarray:
    """Aggregate payload bandwidth (MB/s) of a trace per design point."""
    single = not isinstance(tables, (list, tuple))
    end = trace_end_time_maxplus(tables, trace, **kw)
    if single:
        return trace.total_bytes(tables) / end
    data = np.array([trace.total_bytes(t) for t in tables], np.float64)
    return data / np.asarray(end)
