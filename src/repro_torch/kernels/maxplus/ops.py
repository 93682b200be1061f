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
(``repro_torch.core.maxplus_form``) and moved to ``device`` once.  The
entry points take a ``strategy``:

* ``"sequential"`` — the O(T) matvec fold of ``kernel.maxplus_fold_kernel``:
  the CUDA kernel for a CUDA device, its plain version for the CPU;
* ``"segmented"`` — the segmented parallel-prefix matmul fold,
  O(segment_len + log T) depth, in plain torch on ``device``;
* ``"squaring"`` (homogeneous only) — periodic matrix squaring,
  O(log n_pages) matmuls, in plain torch on ``device``.

Every entry point takes ``device`` (None = ``cuda``, raising when there
is no card).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.energy import op_phase_energy_uj
from repro_torch.core.maxplus_form import (NEG, StateLayout,
                                           combo_arrival_offsets,
                                           combo_matrices, combo_written_rows,
                                           end_time_from_state, init_state,
                                           maxplus_eye, maxplus_fold_segmented,
                                           periodic_fold_squaring,
                                           trace_combos, transition_matrices)
from repro_torch.core.sim import PageOpParams
from repro_torch.device import resolve_device
from repro_torch.kernels.maxplus.kernel import (maxplus_fold_kernel,
                                                maxplus_fold_many_kernel)

def _f32(x, device) -> torch.Tensor:
    """Explicit float32 on ``device`` (numpy's float64 never leaks in)."""
    return torch.as_tensor(np.require(x, np.float32, ("C", "W")),
                           device=device)


def _augment_arrivals(mats, gvec, idx, arrivals, wvec=None, extras=None):
    """[B, T, N, N] per-op matrices with the arrival origin column maxed
    in and the fault surcharge added to the written rows — the dense
    expansion the segmented strategy folds when a trace carries arrivals
    or per-op extras (the sequential kernel keeps the compact per-combo
    dictionary and applies ``gvec[idx[t]] + arrivals[t]`` /
    ``wvec[idx[t]] * extras[t]`` per step instead).  The origin row is
    the last layout row by construction.  Adding ``extras[t]`` uniformly
    across a written row commutes bit-exactly with the row max (rounding
    is monotone), so the dense form reproduces the per-step one."""
    per = mats.index_select(1, idx)                         # [B, T, N, N]
    if arrivals is not None:
        cand = gvec.index_select(1, idx) + arrivals[None, :, None]
        per[..., -1] = torch.maximum(per[..., -1], cand)
    if extras is not None:
        shift = wvec.index_select(1, idx) * extras[None, :, None]
        per = per + shift[..., None]                        # all columns
    return per


def maxplus_fold(mats, s0, *, t_steps: int, idx=None,
                 strategy: str = "sequential", segment_len: int | None = 64,
                 arrivals=None, gvec=None, extras=None, wvec=None):
    """Fold dispatch: ``strategy`` picks the evaluation shape (see module
    docstring).  ``arrivals`` [T] + ``gvec`` [B, M, N] make the fold
    arrival-aware; ``extras`` [T] + ``wvec`` [B, M, N] add per-op
    reliability surcharges on the written rows (trace-indexed path
    only).  The log-depth strategies run in plain torch on the device of
    ``mats``; only "sequential" launches the kernel."""
    if (arrivals is not None or extras is not None) and idx is None:
        raise ValueError("arrivals/extras need the trace-indexed path "
                         "(pass idx)")
    if strategy == "segmented":
        dev = mats.device
        if idx is None:
            idx = torch.arange(t_steps, device=dev) % mats.shape[-3]
        idx = torch.as_tensor(idx, device=dev).long()[:t_steps]
        if arrivals is not None or extras is not None:
            mats = _augment_arrivals(mats, gvec, idx, arrivals, wvec, extras)
            idx = torch.arange(t_steps, device=dev)
        return maxplus_fold_segmented(mats, idx, s0,
                                      segment_len=segment_len)
    if strategy == "squaring":
        if idx is not None:
            raise ValueError(
                "strategy='squaring' needs a periodic (homogeneous) "
                "stream — got an explicit idx sequence")
        return periodic_fold_squaring(mats, s0, t_steps)
    if strategy != "sequential":
        raise ValueError(f"unknown strategy {strategy!r} (one of "
                         "'sequential', 'segmented', 'squaring')")
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
    segment_len: int | None = 64,
    device=None,
) -> np.ndarray:
    """Completion times (us) of one heterogeneous trace under a batch of
    design-point timing tables ([B], or scalar for a single table)."""
    dev = resolve_device(device)
    single = not isinstance(tables, (list, tuple))
    if single:
        tables = [tables]
    layout, _, idx, mats, s0, arrivals, gvec, extras, wvec = _combo_setup(
        tables, trace, policy, dev)
    final = maxplus_fold(mats, s0, t_steps=trace.n_ops, idx=idx,
                         strategy=strategy, segment_len=segment_len,
                         arrivals=arrivals, gvec=gvec, extras=extras,
                         wvec=wvec)
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
    segment_len: int | None = 64,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(end_us, phase-energy sums in uJ) of one trace under a batch of
    design points ([B] / [B, P], or scalar / [P] for a single table).
    ``strategy="sequential"`` accumulates ``E[idx[t]]`` in op order in
    the kernel next to the (max,+) matvec; the segmented strategy folds
    the end time as usual and reduces the energy as the plain sum it
    is."""
    dev = resolve_device(device)
    if strategy not in ("sequential", "segmented"):
        raise ValueError(f"unknown trace energy strategy {strategy!r} "
                         "(one of 'sequential', 'segmented')")
    single = not isinstance(tables, (list, tuple))
    if single:
        tables, kinds = [tables], [kinds]
    if len(kinds) != len(tables):
        raise ValueError("need one interface kind per op-class table")
    layout, combos, idx, mats, s0, arrivals, gvec, extras, wvec = \
        _combo_setup(tables, trace, policy, dev)
    e = _f32(np.stack([combo_energy_uj(table, combos, kind)
                       for table, kind in zip(tables, kinds)]), dev)
    if strategy == "sequential":
        final, acc = maxplus_fold_kernel(
            mats, s0, t_steps=trace.n_ops, idx=idx, energy=e,
            arrivals=arrivals, gvec=gvec, extras=extras, wvec=wvec)
    else:
        final = maxplus_fold(
            mats, s0, t_steps=trace.n_ops, idx=idx, strategy="segmented",
            segment_len=segment_len, arrivals=arrivals, gvec=gvec,
            extras=extras, wvec=wvec)
        acc = e.index_select(1, idx.long()).sum(dim=1)
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
