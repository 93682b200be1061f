"""Unified ``Simulator`` session API of the port: one request/response
surface over every simulation engine.

* an **engine registry** — every evaluation strategy registers once
  under a name with a declared :class:`EngineCaps` capability row.
  Unknown names raise one ``ValueError`` listing the registered engines;
  a registered engine asked for something outside its capability row
  raises :class:`CapabilityError` (a ``ValueError``).  Registered here:

  - ``scan``   — the torch step loop of ``repro_torch.core.sim`` (the
    default of ``run``);
  - ``prefix`` — the segmented parallel-prefix (max,+) fold, O(L + log T)
    depth, in plain torch (the default of ``sweep_tables`` and
    ``Simulator.sweep``, as in the JAX package);
  - ``squaring`` — periodic (max,+) matrix squaring, O(log T) matmuls,
    for homogeneous single-channel round-robin streams only;
  - ``cuda``   — the (max,+) matrix fold of ``repro_torch.kernels.maxplus``
    on the hand-written CUDA kernel (the JAX package's ``pallas``
    engine); on a CPU session it folds with the kernel's plain version;
  - ``oracle`` — the plain-Python event loop of ``repro_torch.core.sim_ref``;
  - ``streaming`` — the scan step folded chunk by chunk from a carried
    state (``repro_torch.core.sim.trace_chunk_fold``), bit-equal to
    ``scan`` for any chunk length; :meth:`Simulator.run_stream` feeds it
    chunk iterators that never hold the whole trace.

* a **session object** — :class:`Simulator` binds an ``SSDConfig`` /
  ``OpClassTable`` and a device once and moves the timing table to that
  device once.  ``device=None`` means the card, and raises when there is
  none; pass ``device="cpu"`` to run on the CPU.  PyTorch runs eagerly,
  so the JAX package's jit-closure cache has no counterpart here.
  ``Simulator.for_config`` memoises sessions per (design point, device).

* one **request/response pair** — :class:`SimRequest` (trace, policy,
  objective ∈ {end_time, bandwidth, energy, all}, optional engine) in,
  :class:`SimResult` (end_us, per-channel bus occupancy, MB/s, optional
  ``EnergyBreakdown``) out, for every engine.

* **request-level workloads** (DESIGN.md §2.6, §2.8) — a ``SimRequest``
  may carry a placement-free ``repro_torch.core.workload.RequestStream``
  plus a ``sched_policy`` and a ``FaultSpec``: static policies lower
  offline through ``repro_torch.core.sched`` and reach every engine;
  dynamic policies need the ``dispatch`` capability (``scan``) and run
  the joint dispatch+simulate fold on the session's device.  Engines that
  emit per-op completions (``scan``, ``oracle``, ``streaming``) attach
  per-request latencies (``SimResult.p50_us`` / ``p99_us`` /
  ``p99_9_us``); the (max,+) engines (``cuda``, ``prefix``) answer
  makespan and energy only, as the JAX package's ``pallas`` and
  ``prefix`` do.

* the **fleet and fan-out paths** — :meth:`Simulator.run_many` (many
  traces, one design point: the ``scan`` engine steps each length bucket
  as lanes of one masked fold, the ``cuda`` engine makes one many-trace
  kernel launch per geometry), :meth:`Simulator.sweep` /
  :func:`sweep_tables` (one trace, many design points),
  :func:`sweep_steady_bandwidth_mb_s` (homogeneous single-channel design
  points) and :meth:`Simulator.run_stream` (a trace as chunks).
  With ``shard`` not False, ``run_many(engine="scan")``, the sweeps on
  ``scan`` / ``prefix`` / ``squaring`` and the aged FTL sweep split their
  design points (or traces) over the 1-D ``("points",)`` mesh
  (``distributed.partitioning.shard_points``): every card where the host
  has two or more and the call runs on the card, or the mesh a
  :func:`points_mesh` block installs (three CPU "devices", two shards of
  ``cuda:0``).  ``shard=False`` keeps one device; ``cuda`` and
  ``oracle`` never shard, as the JAX package's ``pallas`` and
  ``oracle`` do not.

* the **FTL stage** (DESIGN.md §2.10-§2.11) — a workload request may
  carry an ``FTLSpec``: the stream runs through the L2P map and garbage
  collection first (the torch translation machine of
  ``repro_torch.core.ftl_scan`` on the session's device; the numpy host
  translator of ``repro_torch.core.ftl`` when block-level program/erase
  failures are on), and the translated stream — GC relocations and
  erases included — lowers and prices on a sibling session over the
  7-class FTL table.  ``run_stream(ftl=)`` translates chunk by chunk
  carrying the drive, and ``sweep(None, stream, ftl=specs)`` is the aged
  design-space sweep.  Every engine but ``squaring`` has the ``ftl``
  capability.

Traces that carry ``arrival_us`` / ``extra_us`` are served by every
engine here except ``squaring``, whose fixed period they would break.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import functools
import threading
import warnings
from typing import Literal, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import ftl as _ftl
from repro_torch.core import ftl_scan as _ftl_scan
from repro_torch.core import sched as _sched
from repro_torch.core import sim as _sim
from repro_torch.core import trace as _trace
from repro_torch.core import workload as _workload
from repro_torch.core.energy import (EnergyBreakdown, breakdown_from_sums,
                                     op_phase_energy_uj)
from repro_torch.core.faults import FaultSampler, FaultSpec
from repro_torch.core.interface import InterfaceKind
from repro_torch.core.sched import LoweredWorkload
from repro_torch.core.sim import (PageOpParams, Policy, SSDConfig,
                                  policy_is_batched)
from repro_torch.core.sim_ref import (simulate_trace_completions_ref,
                                      simulate_trace_energy_ref,
                                      simulate_trace_ref)
from repro_torch.core.trace import OpClassTable, OpTrace, op_class_table
from repro_torch.core.workload import RequestStream, request_ops
from repro_torch.device import resolve_device
from repro_torch.kernels.maxplus.ops import (run_many_end_time_maxplus,
                                             trace_end_time_maxplus,
                                             trace_energy_maxplus)

Objective = Literal["end_time", "bandwidth", "energy", "all"]
OBJECTIVES: tuple[str, ...] = ("end_time", "bandwidth", "energy", "all")

#: Op-class table columns, in the positional order the engines take.
_TABLE_FIELDS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
                 "ctrl_us", "arb_us")


class CapabilityError(ValueError):
    """A *registered* engine was asked for a query outside its declared
    capability row, or a query needs a part of the system this port has
    not reached yet (vs plain ``ValueError`` for unknown engine names)."""


# ---------------------------------------------------------------------------
# Engine protocol + registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineCaps:
    """Declared capability row of one registered engine."""

    name: str
    batched_tables: bool  # one trace x stacked design-point tables
    energy: bool          # phase-resolved energy accumulation
    arrivals: bool = False  # arrival-aware traces (request workloads)
    dispatch: bool = False  # joint dispatch+simulate (dynamic sched policies)
    heterogeneous: bool = True  # arbitrary OpTrace (vs homogeneous periodic)
    ftl: bool = False       # FTL-translated streams (GC/erase op classes)
    shard: bool = False     # its design-point batches split over a points mesh

    def describe(self) -> str:
        flags = [k for k in ("batched_tables", "energy", "arrivals",
                             "dispatch", "ftl") if getattr(self, k)]
        return f"{self.name}: {', '.join(flags) or 'none'}"


@runtime_checkable
class Engine(Protocol):
    """What a registered engine must answer.  ``sim`` is the session — it
    supplies the bound table, its device copies and the device."""

    caps: EngineCaps

    def end_time(self, sim: "Simulator", trace: OpTrace, *,
                 batched: bool, segment_len: int | None) -> float: ...

    def energy_sums(self, sim: "Simulator", trace: OpTrace,
                    kind: InterfaceKind, *, batched: bool,
                    segment_len: int | None) -> tuple[float, np.ndarray]: ...


_REGISTRY: dict[str, Engine] = {}


def register_engine(name: str, *, batched_tables: bool, energy: bool,
                    arrivals: bool = False, dispatch: bool = False,
                    heterogeneous: bool = True, ftl: bool = False,
                    shard: bool = False):
    """Class decorator: instantiate and register an engine under ``name``
    with its declared capability row.  Names are unique."""

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"engine {name!r} is already registered")
        inst = cls()
        inst.caps = EngineCaps(name=name, batched_tables=batched_tables,
                               energy=energy, arrivals=arrivals,
                               dispatch=dispatch, heterogeneous=heterogeneous,
                               ftl=ftl, shard=shard)
        _REGISTRY[name] = inst
        return cls

    return deco


def registered_engines() -> tuple[str, ...]:
    """Sorted names of every registered engine."""
    return tuple(sorted(_REGISTRY))


def engine_capabilities() -> dict[str, EngineCaps]:
    """The full declared capability table, by engine name."""
    return {name: _REGISTRY[name].caps for name in registered_engines()}


def get_engine(name: str) -> Engine:
    """Look up a registered engine; unknown names raise ``ValueError``
    listing the registered engines."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(
        f"unknown engine {name!r} (registered engines: "
        f"{', '.join(registered_engines())})")


def _policy_name(batched: bool) -> str:
    return "batched" if batched else "eager"


def _bucket_len(n: int, floor: int = 64) -> int:
    """Trace lengths round up to power-of-two buckets; ``run_many``'s
    scan path steps the traces of one bucket together."""
    return max(floor, 1 << max(0, (n - 1).bit_length()))


def _payload_latencies(lowered: LoweredWorkload, completion_us,
                       stream: RequestStream) -> np.ndarray:
    """Per-request latencies restricted to *payload* requests: hedged
    duplicates are transport, not requests — a duplicate queueing
    behind its primary must not inflate the reported tail.  When the
    stream links duplicates to their primaries (``hedge_of``, the
    ``with_hedges`` builder), the first response wins: the primary is
    credited with ``min(own done, duplicate done)`` (DESIGN.md §2.8).
    Unlinked legacy duplicates keep the conservative bound (the
    primary's own completion)."""
    comp = np.asarray(completion_us, np.float64)
    done = np.zeros(len(lowered.request_arrival_us), np.float64)
    np.maximum.at(done, lowered.request_id, comp)
    if stream.hedge_of is not None:
        h = np.asarray(stream.hedge_of, np.int64)
        link = h >= 0
        if link.any():
            np.minimum.at(done, h[link], done[link])
    lat = done - np.asarray(lowered.request_arrival_us, np.float64)
    pay = stream.payload_mask()
    return lat if pay.all() else lat[pay]


def _read_write_view(op_cls: np.ndarray) -> np.ndarray:
    """Host READ / WRITE classes of a translated FTL op stream (GC reads
    retry like reads, GC writes and erases program like writes) — the
    view the per-op fault sampler draws on."""
    return np.where(np.isin(op_cls, (_ftl.FTL_READ, _ftl.GC_READ)),
                    _trace.READ, _trace.WRITE).astype(np.int32)


def _op_arrivals(trace: OpTrace) -> np.ndarray:
    """Per-op arrival array for the engines (zeros = back-to-back)."""
    if trace.arrival_us is None:
        return np.zeros(trace.n_ops, np.float32)
    return np.asarray(trace.arrival_us, np.float32)


def _op_extras(trace: OpTrace) -> np.ndarray:
    """Per-op reliability surcharge array (zeros = fault-free)."""
    if trace.extra_us is None:
        return np.zeros(trace.n_ops, np.float32)
    return np.asarray(trace.extra_us, np.float32)


def _pad_trace_np(trace: OpTrace, t_bucket: int):
    """Zero-pad the per-op arrays to ``t_bucket`` plus the validity mask
    consumed by the masked scan folds (padding ops are state no-ops)."""
    pad = t_bucket - trace.n_ops
    valid = np.zeros(t_bucket, bool)
    valid[: trace.n_ops] = True
    return (np.pad(np.asarray(trace.cls), (0, pad)),
            np.pad(np.asarray(trace.channel), (0, pad)),
            np.pad(np.asarray(trace.way), (0, pad)),
            np.pad(np.asarray(trace.parity), (0, pad)),
            np.pad(_op_arrivals(trace), (0, pad)),
            np.pad(_op_extras(trace), (0, pad)),
            valid)


def _trace_arrays(trace: OpTrace):
    """The per-op host arrays the scan engine steps through."""
    return (trace.cls, trace.channel, trace.way, trace.parity,
            trace.arrival_us, trace.extra_us)


def _table_tensors(tables, device) -> tuple[torch.Tensor, ...]:
    """[B, K] float32 columns of a list of tables on ``device``."""
    return tuple(torch.as_tensor(
        np.stack([np.asarray(getattr(t, f), np.float32) for t in tables]),
        device=device) for f in _TABLE_FIELDS)


def _op_scalars(op: PageOpParams, device) -> tuple[torch.Tensor, ...]:
    """0-d float32 tensors of one op class: cmd, pre, slot, post lo/hi,
    ctrl."""
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in (op.cmd_us, op.pre_us, op.slot_us, op.post_lo_us,
                           op.post_hi_us, op.ctrl_us))


def _steady_table(op: PageOpParams, device) -> tuple[torch.Tensor, ...]:
    """[1] table columns of one op class, arbitration zero (one channel)."""
    return tuple(x[None] for x in _op_scalars(op, device)) + (
        torch.zeros((1,), dtype=torch.float32, device=device),)


def _steady_pattern(n_pages: int, ways: int):
    """(cls, channel, way, parity) of a single-channel round-robin stream
    over one op class."""
    i = np.arange(n_pages)
    zeros = np.zeros(n_pages, np.int32)
    return (zeros, zeros, (i % ways).astype(np.int32),
            ((i // ways) % 2).astype(np.int32))


class _EngineBase:
    """Shared defaults: optional capabilities raise ``CapabilityError``
    naming the registered engines that *do* implement them."""

    caps: EngineCaps

    def _unsupported(self, what: str, method: str):
        base = getattr(_EngineBase, method)
        supported = sorted(
            name for name, eng in _REGISTRY.items()
            if getattr(type(eng), method, base) is not base)
        raise CapabilityError(
            f"engine {self.caps.name!r} does not support {what} "
            f"(engines that do: {', '.join(supported)})")

    def end_time_batch(self, tables, trace, *, batched, device,
                       segment_len: int | None = 64,
                       combine: str = "chain") -> np.ndarray:
        """[B] end times of one trace under a batch of tables;
        ``segment_len`` and ``combine`` shape the ``prefix`` fold."""
        self._unsupported("batched design-point tables", "end_time_batch")

    def steady_channel_end(self, op: PageOpParams, ways: int, *,
                           n_pages: int, batched: bool, device) -> float:
        self._unsupported("homogeneous single-channel patterns",
                          "steady_channel_end")

    def sweep_steady(self, scalars, data_bytes, ways, *, n_pages: int,
                     batched: bool, device) -> np.ndarray:
        self._unsupported("homogeneous design-point sweeps", "sweep_steady")

    def completions(self, sim: "Simulator", trace: OpTrace, *,
                    batched: bool, segment_len: int | None = None
                    ) -> tuple[float, np.ndarray]:
        """(end_us, [T] per-op completion times) — what request-latency
        percentiles are computed from.  ``segment_len`` is the chunk
        length for chunked engines (others ignore it)."""
        self._unsupported("per-op completion times", "completions")

    def dispatch_run(self, sim: "Simulator", cls, arrival_us, *,
                     n_channels: int, n_ways: int, rule: str,
                     extra_us=None, retired=None):
        """Joint dispatch+simulate under a dynamic sched policy; returns
        (end_us, completion[T], channel[T], way[T], parity[T]).
        ``extra_us`` / ``retired`` are the reliability-layer inputs:
        per-op surcharges and the bad-block mask the dispatch rule must
        never place an op on (DESIGN.md §2.8)."""
        self._unsupported("dynamic dispatch policies", "dispatch_run")


@register_engine("scan", batched_tables=True, energy=True, arrivals=True,
                 dispatch=True, ftl=True, shard=True)
class ScanEngine(_EngineBase):
    """O(T) step loop over device state tensors — the default engine."""

    def end_time(self, sim, trace, *, batched, segment_len=None):
        return float(_sim.trace_end_time(
            *sim._targs, *_trace_arrays(trace), n_channels=trace.channels,
            batched=batched))

    def completions(self, sim, trace, *, batched, segment_len=None):
        end, comp = _sim.trace_completions(
            *sim._targs, *_trace_arrays(trace), n_channels=trace.channels,
            batched=batched)
        return float(end), comp.cpu().numpy().astype(np.float64)

    def dispatch_run(self, sim, cls, arrival_us, *, n_channels, n_ways,
                     rule, extra_us=None, retired=None):
        end, comp, chan, way, par = _sim.dispatch_trace(
            *sim._targs, cls, arrival_us, n_channels=n_channels,
            n_ways=n_ways, rule=rule, extra_us=extra_us, retired=retired)
        return (float(end), comp.cpu().numpy().astype(np.float64),
                chan.cpu().numpy(), way.cpu().numpy(), par.cpu().numpy())

    def energy_sums(self, sim, trace, kind, *, batched, segment_len=None):
        end, sums = _sim.trace_end_time_energy(
            *sim._targs, sim._energy_table(kind), *_trace_arrays(trace),
            n_channels=trace.channels, batched=batched)
        return float(end), sums.cpu().numpy().astype(np.float64)

    def end_time_batch(self, tables, trace, *, batched, device,
                       segment_len=64, combine="chain"):
        end = _sim.trace_end_time_batch(
            *_table_tensors(tables, device), *_trace_arrays(trace),
            n_channels=trace.channels, batched=batched)
        return end.cpu().numpy()

    def steady_channel_end(self, op, ways, *, n_pages, batched, device):
        return float(_sim.trace_end_time(
            *_steady_table(op, device), *_steady_pattern(n_pages, ways),
            n_channels=1, batched=batched))

    def sweep_steady(self, scalars, data_bytes, ways, *, n_pages, batched,
                     device):
        return _sim._sweep_scan(*scalars, data_bytes, ways, n_pages=n_pages,
                                batched=batched, device=device).cpu().numpy()


@register_engine("prefix", batched_tables=True, energy=True, arrivals=True,
                 ftl=True, shard=True)
class PrefixEngine(_EngineBase):
    """Segmented parallel-prefix (max,+) fold, O(L + log T) depth; energy
    rides the same chunking as segment sums.  ``segment_len`` is the
    segment length L."""

    def end_time(self, sim, trace, *, batched, segment_len=64):
        return float(_sim.trace_end_time_prefix(
            *sim._targs, *_trace_arrays(trace),
            n_channels=trace.channels, n_ways=trace.ways, batched=batched,
            segment_len=segment_len))

    def energy_sums(self, sim, trace, kind, *, batched, segment_len=64):
        end, sums = _sim.trace_end_time_prefix_energy(
            *sim._targs, sim._energy_table(kind), *_trace_arrays(trace),
            n_channels=trace.channels, n_ways=trace.ways, batched=batched,
            segment_len=segment_len)
        return float(end), sums.cpu().numpy().astype(np.float64)

    def end_time_batch(self, tables, trace, *, batched, device,
                       segment_len=64, combine="chain"):
        end = _sim.trace_end_time_prefix_batch(
            *_table_tensors(tables, device), *_trace_arrays(trace),
            n_channels=trace.channels, n_ways=trace.ways, batched=batched,
            segment_len=segment_len, combine=combine)
        return end.cpu().numpy()

    def steady_channel_end(self, op, ways, *, n_pages, batched, device):
        return float(_sim.trace_end_time_prefix(
            *_steady_table(op, device), *_steady_pattern(n_pages, ways),
            n_channels=1, n_ways=_sim.MAX_WAYS, batched=batched))


@register_engine("squaring", batched_tables=False, energy=True,
                 heterogeneous=False, shard=True)
class SquaringEngine(_EngineBase):
    """Periodic (max,+) matrix squaring, O(log T) matmuls.  Homogeneous
    only: the trace must be a single-class, single-channel round-robin
    stream with ways | MAX_WAYS.  Energy is (+,+)-linear in the ops, so on
    that domain the accumulator is the exact per-op sum —
    engine-independent by construction."""

    def _periodic_form(self, sim, trace) -> tuple[int, int]:
        t = np.arange(trace.n_ops)
        cls = np.asarray(trace.cls)
        if trace.arrival_us is not None and np.any(trace.arrival_us > 0):
            okay = ", ".join(sorted(
                n for n, e in _REGISTRY.items() if e.caps.arrivals))
            raise CapabilityError(
                "engine 'squaring' folds a fixed period matrix — per-op "
                f"arrivals break periodicity (arrival-aware engines: {okay})")
        if trace.extra_us is not None and np.any(trace.extra_us > 0):
            okay = ", ".join(sorted(
                n for n, e in _REGISTRY.items() if e.caps.arrivals))
            raise CapabilityError(
                "engine 'squaring' folds a fixed period matrix — per-op "
                "reliability surcharges (extra_us) break periodicity "
                f"(fault-aware engines: {okay})")
        if (trace.channels != 1
                or np.any(cls != cls[0])
                or np.any(np.asarray(trace.channel) != 0)
                or np.any(np.asarray(trace.way) != t % trace.ways)
                or np.any(np.asarray(trace.parity)
                          != (t // trace.ways) % 2)):
            hetero = ", ".join(sorted(
                n for n, e in _REGISTRY.items() if e.caps.heterogeneous))
            raise CapabilityError(
                "engine 'squaring' needs a homogeneous single-channel "
                f"round-robin stream (heterogeneous engines: {hetero})")
        _sim._validate_squaring_ways(trace.ways)
        k = int(cls[0])
        if float(np.asarray(sim.table.arb_us)[k]) != 0.0:
            raise CapabilityError(
                "engine 'squaring' models a dedicated single-channel "
                "firmware loop (arb_us must be zero)")
        return k, trace.ways

    def end_time(self, sim, trace, *, batched, segment_len=None):
        k, ways = self._periodic_form(sim, trace)
        return float(_sim._squaring_end_time(
            *(sim._targs[i][k] for i in range(6)), ways,
            n_pages=trace.n_ops, batched=batched)[0])

    def energy_sums(self, sim, trace, kind, *, batched, segment_len=None):
        end = self.end_time(sim, trace, batched=batched,
                            segment_len=segment_len)
        return end, sim._linear_energy_sums(trace, kind)

    def steady_channel_end(self, op, ways, *, n_pages, batched, device):
        _sim._validate_squaring_ways(ways)
        return float(_sim._squaring_end_time(
            *_op_scalars(op, device), ways, n_pages=n_pages,
            batched=batched)[0])

    def sweep_steady(self, scalars, data_bytes, ways, *, n_pages, batched,
                     device):
        _sim._validate_squaring_ways(ways)
        return _sim._sweep_squaring(*scalars, data_bytes, ways,
                                    n_pages=n_pages, batched=batched,
                                    device=device).cpu().numpy()


@register_engine("cuda", batched_tables=True, energy=True, arrivals=True,
                 ftl=True)
class CudaEngine(_EngineBase):
    """The (max,+) matrix fold on the hand-written CUDA kernel (the JAX
    package's ``pallas`` engine).  The step-matrix dictionary is built on
    the host per query and moved to the session's device."""

    def end_time(self, sim, trace, *, batched, segment_len=None):
        return float(trace_end_time_maxplus(
            sim.table, trace, policy=_policy_name(batched),
            device=sim.device))

    def energy_sums(self, sim, trace, kind, *, batched, segment_len=None):
        end, sums = trace_energy_maxplus(
            sim.table, trace, kind, policy=_policy_name(batched),
            device=sim.device)
        return float(end), np.asarray(sums, np.float64)

    def end_time_batch(self, tables, trace, *, batched, device,
                       segment_len=64, combine="chain"):
        return np.asarray(trace_end_time_maxplus(
            list(tables), trace, policy=_policy_name(batched),
            device=device))


@register_engine("oracle", batched_tables=False, energy=True, arrivals=True,
                 ftl=True)
class OracleEngine(_EngineBase):
    """The plain-Python event loop (``repro_torch.core.sim_ref``) — the
    test oracle, first-class behind the same request surface.  It runs
    on the host whatever the session's device."""

    def end_time(self, sim, trace, *, batched, segment_len=None):
        return float(simulate_trace_ref(sim.table, trace,
                                        _policy_name(batched)))

    def completions(self, sim, trace, *, batched, segment_len=None):
        end, comp = simulate_trace_completions_ref(
            sim.table, trace, _policy_name(batched))
        return float(end), comp

    def energy_sums(self, sim, trace, kind, *, batched, segment_len=None):
        end, sums = simulate_trace_energy_ref(
            sim.table, trace, kind, _policy_name(batched))
        return float(end), np.asarray(sums, np.float64)


@register_engine("streaming", batched_tables=False, energy=True,
                 arrivals=True, ftl=True)
class StreamingEngine(_EngineBase):
    """Constant-memory chunked fold: the trace streams through
    ``sim.trace_chunk_fold`` chunk by chunk, with the occupancy state and
    the phase-energy accumulator carried between chunks.  Every op runs
    the scan engine's step, so any chunking reproduces ``scan`` bit for
    bit while the host holds one chunk at a time.  ``segment_len`` is
    the chunk length; :meth:`Simulator.run_stream` feeds this engine
    chunk iterators that never materialise the trace."""

    def _fold(self, sim, chunks, *, batched, kind=None, want_comp=False):
        """Fold an iterator of ``OpTrace`` chunks; returns ``(end_us, [P]
        energy sums, comp list | None, channels)``, the list holding each
        chunk's per-op completions with ``want_comp``."""
        e_tab = None if kind is None else sim._energy_table(kind)
        carry = None
        channels = None
        comps = [] if want_comp else None
        end = None
        for chunk in chunks:
            if chunk.n_ops == 0:
                continue
            if channels is None:
                channels = chunk.channels
                carry = _sim.trace_chunk_init(
                    channels, 0 if e_tab is None else e_tab.shape[-1],
                    sim.device)
            elif chunk.channels != channels:
                raise ValueError(
                    f"streaming chunks switched geometry mid-stream: "
                    f"{chunk.channels} channels after {channels}")
            state, acc, end, comp = _sim.trace_chunk_fold(
                *sim._targs, e_tab, *_trace_arrays(chunk), *carry[0],
                carry[1], n_channels=channels, batched=batched,
                want_comp=want_comp)
            carry = (state, acc)
            if want_comp:
                comps.append(comp)
        if channels is None:
            raise ValueError("empty trace: no ops to simulate")
        if want_comp:
            comps = [c.cpu().numpy().astype(np.float64) for c in comps]
        return (float(end), carry[1].cpu().numpy().astype(np.float64),
                comps, channels)

    def end_time(self, sim, trace, *, batched, segment_len=None):
        end, _, _, _ = self._fold(
            sim, _trace.iter_trace_chunks(trace, segment_len or 64),
            batched=batched)
        return end

    def energy_sums(self, sim, trace, kind, *, batched, segment_len=None):
        end, sums, _, _ = self._fold(
            sim, _trace.iter_trace_chunks(trace, segment_len or 64),
            batched=batched, kind=kind)
        return end, sums

    def completions(self, sim, trace, *, batched, segment_len=None):
        end, _, comps, _ = self._fold(
            sim, _trace.iter_trace_chunks(trace, segment_len or 64),
            batched=batched, want_comp=True)
        return end, np.concatenate(comps)


# ---------------------------------------------------------------------------
# Request / response types
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One simulation query, validated once at construction: the policy
    literals (issue *and* scheduler), the objective and the engine name.

    Exactly one of ``trace`` (placed ops) or ``workload`` (a
    placement-free ``RequestStream``) must be given.  A workload query
    also accepts ``sched_policy``: static policies lower offline to a
    trace any engine can evaluate; dynamic policies need an engine with
    the ``dispatch`` capability and produce per-request latencies.

    ``faults`` attaches a :class:`repro_torch.core.faults.FaultSpec`
    (DESIGN.md §2.8): read-retry/jitter surcharges and program-fault
    remap ops are sampled once, host-side, and rewritten into the placed
    trace before the engine fold.  On workload queries a spec with
    ``hedge_fraction > 0`` also hedges the stream
    (``workload.with_hedges``) before lowering; a bare-trace query has
    no requests to hedge.

    ``ftl`` attaches a :class:`repro_torch.core.ftl.FTLSpec` (DESIGN.md
    §2.10): the workload's logical addresses run through the L2P map
    first, GC relocation and erase ops are injected into the stream, and
    the translated stream lowers through the same scheduler and engines
    as everything else — the result additionally reports ``waf`` /
    ``gc_op_count`` / ``free_page_low_watermark`` / ``fresh_mb_s``.  FTL
    queries need the ``ftl`` capability (the translated stream uses the
    extended 7-class op table)."""

    trace: OpTrace | None = None
    policy: Policy | None = None        # None -> the session's default
    objective: Objective = "end_time"
    engine: str | None = None           # None -> "scan"
    segment_len: int | None = 64        # streaming-engine chunk length
    workload: RequestStream | None = None
    sched_policy: str | None = None     # None -> "stripe" (workload only)
    faults: FaultSpec | None = None     # None -> fault-free
    ftl: _ftl.FTLSpec | None = None     # None -> address-free (no FTL)

    def __post_init__(self):
        if (self.trace is None) == (self.workload is None):
            raise ValueError("SimRequest needs exactly one of trace= or "
                             "workload=")
        if self.ftl is not None:
            if self.workload is None:
                raise ValueError(
                    "ftl= applies to workload requests (a placed trace "
                    "has no logical addresses left to translate)")
            if not isinstance(self.ftl, _ftl.FTLSpec):
                raise ValueError(
                    f"ftl= takes an FTLSpec, got {type(self.ftl).__name__}")
        if self.sched_policy is not None:
            if self.workload is None:
                raise ValueError("sched_policy applies to workload "
                                 "requests (the trace is already placed)")
            _sched.policy_is_dynamic(self.sched_policy)   # validates
        if self.faults is not None and not isinstance(self.faults,
                                                      FaultSpec):
            raise ValueError(
                f"faults= takes a FaultSpec, got {type(self.faults).__name__}")
        if (self.faults is not None and self.trace is not None
                and self.trace.extra_us is not None):
            raise ValueError(
                "trace already carries extra_us — faults were already "
                "applied (attach the FaultSpec OR pre-apply, not both)")
        if self.policy is not None:
            policy_is_batched(self.policy)
        if self.objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r} "
                             f"(one of {', '.join(OBJECTIVES)})")
        if self.engine is not None:
            get_engine(self.engine)


@dataclasses.dataclass(frozen=True, eq=False)
class SimResult:
    """One simulation answer — the same shape for every engine and
    objective.  ``energy`` is populated for objective "energy"/"all";
    ``mb_s`` is user-payload bandwidth (None for payload-free traces).
    Workload queries additionally carry per-request latencies when the
    serving engine emits per-op completions (scan / oracle / streaming /
    every dynamic dispatch; the (max,+) ``cuda`` and ``prefix`` engines
    answer makespan only and leave them None).  Fault-injected queries
    carry the sampled ``retry_hist`` (retry-count histogram over read
    ops) and ``n_remap_ops`` (program-fault remap writes inserted).

    Percentile properties are guarded: a pN on fewer than
    ``100 / (100 - N)`` requests (e.g. p99 on < 100, p99.9 on < 1000)
    is below the percentile resolution — it clamps to the max observed
    latency and emits a ``RuntimeWarning``; an empty latency stream
    answers NaN."""

    end_us: float
    mb_s: float | None
    channel_busy_us: np.ndarray          # [channels] bus occupancy (us)
    energy: EnergyBreakdown | None
    engine: str
    n_ops: int
    payload_bytes: int
    request_lat_us: np.ndarray | None = None   # [R] per-request latency
    sched_policy: str | None = None            # workload queries only
    retry_hist: np.ndarray | None = None       # [max_retries+1] counts
    n_remap_ops: int = 0                       # program-fault remap writes
    # FTL queries only (DESIGN.md §2.10): write amplification, injected
    # GC traffic, the free-pool low watermark, and the fresh-drive
    # bandwidth of the same host stream (mb_s is the aged/steady-state
    # number once GC competes for the bus)
    waf: float | None = None                   # pages written / host pages
    gc_op_count: int | None = None             # GC reads + writes + erases
    free_page_low_watermark: int | None = None
    fresh_mb_s: float | None = None            # host-only (GC-free) MB/s
    ftl_stats: _ftl.FTLStats | None = None     # full FTL counter block

    @property
    def channel_occupancy(self) -> np.ndarray:
        """Per-channel bus busy fraction of the makespan."""
        return self.channel_busy_us / max(self.end_us, 1e-30)

    def _latency_percentile(self, q: float) -> float | None:
        """Guarded percentile (see class docstring)."""
        if self.request_lat_us is None:
            return None
        lat = np.asarray(self.request_lat_us, np.float64)
        if lat.size == 0:
            return float("nan")
        # resolving pN needs >= 100/(100-N) samples: below that the
        # order statistic for the tail does not exist yet
        if lat.size * (100.0 - q) < 100.0:
            warnings.warn(
                f"p{q:g} on {lat.size} request(s) is below the percentile "
                "resolution — clamping to the max observed latency",
                RuntimeWarning, stacklevel=3)
            return float(np.max(lat))
        return float(np.percentile(lat, q))

    @property
    def p50_us(self) -> float | None:
        """Median request latency (workload queries with completions)."""
        return self._latency_percentile(50)

    @property
    def p99_us(self) -> float | None:
        """99th-percentile request latency."""
        return self._latency_percentile(99)

    @property
    def p99_9_us(self) -> float | None:
        """99.9th-percentile request latency — the retry-storm tail the
        reliability layer exists to measure (DESIGN.md §2.8)."""
        return self._latency_percentile(99.9)

    def describe(self) -> str:
        occ = "/".join(f"{x:.2f}" for x in self.channel_occupancy)
        bw = f"{self.mb_s:.1f} MB/s" if self.mb_s is not None else "no payload"
        lat = ("" if self.request_lat_us is None else
               f", p50/p99 {self.p50_us:.0f}/{self.p99_us:.0f} us")
        ftl = ("" if self.waf is None else
               f", WAF {self.waf:.2f} ({self.gc_op_count} GC ops)")
        return (f"[{self.engine}] {self.n_ops} ops in "
                f"{self.end_us / 1e3:.2f} ms, {bw}, occ {occ}{lat}{ftl}")


@dataclasses.dataclass(frozen=True)
class CacheInfo:
    """Counters of the FTL sub-session cache (the shape of the JAX
    package's ``CacheInfo``)."""

    hits: int
    misses: int
    entries: int
    evictions: int = 0
    max_entries: int | None = None


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------


class Simulator:
    """A simulation session bound to one design point and one device.

    Binds an ``SSDConfig`` (or a raw ``OpClassTable``) once; the timing
    table's columns and, per interface kind, the phase-energy table are
    moved to the device once and reused by every query.  All registered
    engines answer through :meth:`run`.  FTL queries run on a sibling
    session over the 7-class FTL table, memoised per timing key (at most
    ``max_ftl_sessions``, least recently used first out).
    """

    def __init__(self, config: SSDConfig | None = None, *,
                 table: OpClassTable | None = None,
                 kind: InterfaceKind | str | None = None,
                 device: torch.device | str | None = None,
                 max_ftl_sessions: int | None = 8):
        if config is None and table is None:
            raise ValueError("Simulator needs an SSDConfig or an "
                             "OpClassTable")
        if max_ftl_sessions is not None and max_ftl_sessions < 1:
            raise ValueError("max_ftl_sessions must be >= 1 or None "
                             f"(unbounded), got {max_ftl_sessions}")
        self.device = resolve_device(device)
        self.config = config
        self.table = table if table is not None else op_class_table(config)
        if kind is not None:
            self.kind: InterfaceKind | None = InterfaceKind(kind)
        else:
            self.kind = config.interface if config is not None else None
        self.default_policy: Policy = (config.policy if config is not None
                                       else "eager")
        self._targs = tuple(
            torch.as_tensor(np.asarray(getattr(self.table, f), np.float32),
                            device=self.device) for f in _TABLE_FIELDS)
        self._e_tables: dict[InterfaceKind, torch.Tensor] = {}
        self._e_tables_np: dict[InterfaceKind, np.ndarray] = {}
        self.max_ftl_sessions = max_ftl_sessions
        self._ftl_sessions: collections.OrderedDict[tuple, Simulator] = \
            collections.OrderedDict()
        self._ftl_hits = self._ftl_misses = self._ftl_evictions = 0
        # preconditioned drives per spec batch (a pure function of the
        # specs: aged once, reused across calls), one cache a device, for
        # the translation of single queries and streams (one-spec keys)
        # and the aged sweep; the session device's is ``_ftl_pre_states``,
        # and the blocks of a sharded sweep share a device's under the lock
        self._ftl_pre_states: collections.OrderedDict[tuple, object] = \
            collections.OrderedDict()
        self._ftl_pre_by_device = {str(self.device): self._ftl_pre_states}
        self._ftl_pre_lock = threading.Lock()

    @classmethod
    def for_config(cls, config: SSDConfig,
                   device: torch.device | str | None = None) -> "Simulator":
        """Process-wide memoised session for a design point on a device."""
        return simulator_for(config, resolve_device(device))

    def _energy_table(self, kind: InterfaceKind) -> torch.Tensor:
        e = self._e_tables.get(kind)
        if e is None:
            e = self._e_tables[kind] = torch.as_tensor(
                op_phase_energy_uj(self.table, kind), device=self.device)
        return e

    # -- queries ------------------------------------------------------------

    def _resolve(self, request: SimRequest, trace: OpTrace | None = None):
        policy = request.policy or self.default_policy
        batched = policy_is_batched(policy)
        eng = get_engine(request.engine or "scan")
        if request.objective in ("energy", "all"):
            if not eng.caps.energy:
                raise CapabilityError(
                    f"engine {eng.caps.name!r} does not accumulate energy")
            if self.kind is None:
                raise ValueError(
                    "energy query on a Simulator with no interface kind "
                    "(pass kind= or bind an SSDConfig)")
        if (trace is not None and trace.arrival_us is not None
                and np.any(trace.arrival_us > 0) and not eng.caps.arrivals):
            okay = ", ".join(n for n in registered_engines()
                             if _REGISTRY[n].caps.arrivals)
            raise CapabilityError(
                f"engine {eng.caps.name!r} cannot consume arrival-aware "
                f"traces (engines that can: {okay})")
        # faults ride the same per-op side-channel machinery as arrivals,
        # so the capability row is shared
        if ((request.faults is not None and not request.faults.is_zero
             or trace is not None and trace.extra_us is not None
             and np.any(trace.extra_us > 0)) and not eng.caps.arrivals):
            okay = ", ".join(n for n in registered_engines()
                             if _REGISTRY[n].caps.arrivals)
            raise CapabilityError(
                f"engine {eng.caps.name!r} cannot consume fault-extended "
                f"traces (engines that can: {okay})")
        if request.ftl is not None and not eng.caps.ftl:
            okay = ", ".join(n for n in registered_engines()
                             if _REGISTRY[n].caps.ftl)
            raise CapabilityError(
                f"engine {eng.caps.name!r} cannot consume FTL-translated "
                f"streams (engines that can: {okay})")
        return eng, batched

    def _result(self, trace: OpTrace, end_us: float, engine: str,
                energy: EnergyBreakdown | None,
                request_lat_us: np.ndarray | None = None,
                sched_policy: str | None = None,
                sampler: FaultSampler | None = None) -> SimResult:
        table = self.table
        payload = trace.total_bytes(table)
        busy = np.bincount(
            np.asarray(trace.channel),
            weights=np.asarray(table.slot_us, np.float64)[
                np.asarray(trace.cls)],
            minlength=trace.channels)
        return SimResult(
            end_us=end_us,
            mb_s=(payload / end_us) if payload > 0 else None,
            channel_busy_us=busy, energy=energy, engine=engine,
            n_ops=trace.n_ops, payload_bytes=payload,
            request_lat_us=request_lat_us, sched_policy=sched_policy,
            retry_hist=(None if sampler is None
                        else sampler.retry_hist.copy()),
            n_remap_ops=0 if sampler is None else sampler.n_remap_ops)

    def _breakdown(self, sums, end_us: float, trace: OpTrace):
        return breakdown_from_sums(
            sums, end_us=end_us,
            payload_bytes=trace.total_bytes(self.table),
            kind=self.kind, channels=trace.channels)

    def run(self, request: SimRequest | OpTrace | RequestStream, /,
            **overrides) -> SimResult:
        """Answer one query.  Accepts a :class:`SimRequest`, a bare
        ``OpTrace``, or a bare ``RequestStream`` (a workload query under
        ``sched_policy``, default static stripe) plus request fields as
        keywords."""
        if isinstance(request, RequestStream):
            request = SimRequest(workload=request, **overrides)
        elif not isinstance(request, SimRequest):
            request = SimRequest(trace=request, **overrides)
        elif overrides:
            request = dataclasses.replace(request, **overrides)
        if request.workload is not None:
            return self._run_workload(request)
        trace = request.trace
        if trace.n_ops == 0:
            raise ValueError("empty trace: no ops to simulate")
        trace.validate_against(self.table)
        eng, batched = self._resolve(request, trace)
        sampler = None
        if request.faults is not None:
            trace, _, sampler = _sched.apply_faults(
                trace, request.faults, self.table)
        energy = None
        if request.objective in ("energy", "all"):
            end_us, sums = eng.energy_sums(self, trace, self.kind,
                                           batched=batched,
                                           segment_len=request.segment_len)
            energy = self._breakdown(sums, end_us, trace)
        else:
            end_us = eng.end_time(self, trace, batched=batched,
                                  segment_len=request.segment_len)
        return self._result(trace, end_us, eng.caps.name, energy,
                            sampler=sampler)

    def _ftl_session(self, spec: _ftl.FTLSpec) -> "Simulator":
        """Memoised sibling session over the 7-class FTL op table, on
        this session's device (DESIGN.md §2.10) — keyed on the fields
        that shape the table, so GC-policy / overprovisioning sweeps at
        fixed timing share one session."""
        key = (float(spec.map_us),
               None if spec.erase_us is None else float(spec.erase_us))
        sess = self._ftl_sessions.get(key)
        if sess is None:
            self._ftl_misses += 1
            sess = self._ftl_sessions[key] = Simulator(
                self.config, table=_ftl.ftl_op_class_table(self.config, spec),
                device=self.device)
            if (self.max_ftl_sessions is not None
                    and len(self._ftl_sessions) > self.max_ftl_sessions):
                self._ftl_sessions.popitem(last=False)
                self._ftl_evictions += 1
        else:
            self._ftl_hits += 1
            self._ftl_sessions.move_to_end(key)
        return sess

    def ftl_cache_info(self) -> CacheInfo:
        """Counters for the FTL sub-session cache: one entry is a whole
        sibling ``Simulator`` (its own 7-class table on the device), so
        the bound is deliberately small."""
        return CacheInfo(self._ftl_hits, self._ftl_misses,
                         len(self._ftl_sessions), self._ftl_evictions,
                         self.max_ftl_sessions)

    def _run_workload_ftl(self, request: SimRequest) -> SimResult:
        """FTL workload queries (DESIGN.md §2.10): the host stream runs
        through the L2P translation stage first — GC relocation and
        erase ops are injected on free-pool pressure and every op gets
        an FTL op class carrying the firmware map cost — then the
        translated stream lowers through the same scheduler / engine
        machinery as any other workload (all ops, GC included, compete
        for placement slots and bus time).  A second host-only pass over
        the same translation prices the fresh-drive bandwidth, so the
        aged-vs-fresh cliff is part of the one answer.

        Block-level program/erase failures are *owned by the FTL
        accounting* (bad blocks retire through the same valid-count
        bookkeeping GC uses) and take the host translator; the fault
        sampler here only prices the per-op retry/jitter surcharges,
        against a read/write view of the translated classes."""
        spec = request.ftl
        stream = request.workload
        fspec = request.faults
        if fspec is not None and fspec.hedge_fraction > 0.0:
            stream = _workload.with_hedges(
                stream, fspec.hedge_fraction,
                after_us=fspec.hedge_after_us or 0.0, seed=fspec.seed)
        sess = self._ftl_session(spec)
        eng, batched = sess._resolve(request)
        policy_s = request.sched_policy or "stripe"
        dynamic = _sched.policy_is_dynamic(policy_s)
        if dynamic and batched:
            raise ValueError(
                "dynamic dispatch is FCFS under the eager issue "
                "policy; 'batched' rounds are fixed at build time "
                "and only exist for static lowerings")
        channels, ways = self.config.channels, self.config.ways
        if fspec is None or (fspec.prog_fail_prob == 0.0
                             and fspec.erase_fail_prob == 0.0):
            # default path: the torch translation machine on the
            # session's device, op-for-op the host translator
            translation = _ftl_scan.translate_scan(
                stream, spec, device=self.device,
                pre_states=self._ftl_pre_states)
        else:
            # block-level program/erase failures draw RNG per attempt:
            # the host translator's path (the folds stay RNG-free)
            translation = _ftl.translate(
                stream, spec, prog_fail_prob=fspec.prog_fail_prob,
                erase_fail_prob=fspec.erase_fail_prob,
                fault_seed=fspec.seed)
        extra = None
        sampler = None
        if fspec is not None:
            # block-level failures were consumed by the translation; the
            # per-op channel prices retries/jitter on a host-class view
            # of the translated stream (GC reads retry like reads)
            neutered = dataclasses.replace(
                fspec, prog_fail_prob=0.0, erase_fail_prob=0.0)
            if not neutered.is_zero:
                sampler = FaultSampler(neutered, channels, ways, sess.table)
                extra, _, _ = sampler.sample(_read_write_view(
                    translation.op_cls))

        def evaluate(mask=None, want_comp=False):
            cls = translation.op_cls
            arr = translation.arrival_us
            pay = translation.payload
            ext = extra
            if mask is not None:
                cls, arr, pay = cls[mask], arr[mask], pay[mask]
                ext = None if ext is None else ext[mask]
            if dynamic:
                end, comp, chan, way, par = eng.dispatch_run(
                    sess, cls, arr, n_channels=channels, n_ways=ways,
                    rule=policy_s, extra_us=ext, retired=None)
                tr = OpTrace(
                    cls=np.asarray(cls, np.int32), channel=chan, way=way,
                    parity=par, channels=channels, ways=ways,
                    payload=None if pay.all() else pay,
                    arrival_us=np.asarray(arr, np.float32),
                    extra_us=(None if ext is None
                              else np.asarray(ext, np.float32)))
                return tr, end, comp
            tr = _sched.lower_ops(cls, arr, channels, ways, policy_s,
                                  payload=pay)
            if ext is not None:
                tr = dataclasses.replace(
                    tr, extra_us=np.asarray(ext, np.float32))
            tr.validate_against(sess.table)
            base = getattr(_EngineBase, "completions")
            if want_comp and getattr(type(eng), "completions",
                                     base) is not base:
                end, comp = eng.completions(
                    sess, tr, batched=batched,
                    segment_len=request.segment_len)
                return tr, end, comp
            end = eng.end_time(sess, tr, batched=batched,
                               segment_len=request.segment_len)
            return tr, end, None

        trace, end_us, comp = evaluate(want_comp=True)
        lat = None
        if comp is not None:
            # GC ops belong to no request (request_id -1): latency
            # accounting sees host ops only — but over the *aged*
            # completion times, so GC queueing is in the tail
            host = translation.request_id >= 0
            lowered = LoweredWorkload(
                trace=trace, request_id=translation.request_id[host],
                request_arrival_us=np.asarray(stream.arrival_us,
                                              np.float32))
            lat = _payload_latencies(lowered, np.asarray(comp)[host],
                                     stream)
        energy = None
        if request.objective in ("energy", "all"):
            # energy is (+,+)-linear, so the engine-free per-op sum is
            # exact for the translated trace too (DESIGN.md §2.4)
            energy = sess._breakdown(
                sess._linear_energy_sums(trace, sess.kind), end_us, trace)
        fresh_mb_s = None
        if bool(translation.gc.any()):
            # fresh-drive reference: the host ops alone (map cost still
            # charged — FTL classes are kept), no GC competition
            _, fresh_end, _ = evaluate(mask=~translation.gc)
            fresh_payload = trace.total_bytes(sess.table)
            if fresh_payload > 0:
                fresh_mb_s = fresh_payload / fresh_end
        stats = translation.stats
        res = sess._result(trace, end_us, eng.caps.name, energy,
                           request_lat_us=lat, sched_policy=policy_s,
                           sampler=sampler)
        return dataclasses.replace(
            res, waf=stats.waf, gc_op_count=stats.gc_op_count,
            free_page_low_watermark=stats.free_page_low_watermark,
            fresh_mb_s=fresh_mb_s, ftl_stats=stats)

    def _run_workload(self, request: SimRequest) -> SimResult:
        """Workload queries: lower the request stream through the
        scheduler (static policies offline, dynamic policies as the
        joint dispatch fold) and attach per-request latencies when the
        engine emits per-op completions (DESIGN.md §2.6)."""
        if self.config is None:
            raise ValueError(
                "workload queries need a Simulator bound to an SSDConfig "
                "(the scheduler needs the channel/way geometry)")
        stream = request.workload
        if stream.n_requests == 0:
            raise ValueError("empty workload: no requests to simulate")
        if request.ftl is not None:
            return self._run_workload_ftl(request)
        if int(np.max(stream.op_cls)) >= self.table.n_classes:
            # checked before the dispatch fold runs: a clamped-garbage
            # simulation followed by a numpy IndexError is not a report
            raise ValueError(
                f"RequestStream.op_cls out of range: max "
                f"{int(np.max(stream.op_cls))} >= table.n_classes "
                f"{self.table.n_classes}")
        spec = request.faults
        if spec is not None and spec.hedge_fraction > 0.0:
            # the spec's mitigation half: hedge payload reads before the
            # scheduler sees the stream, so duplicates flow through the
            # same lowering/dispatch as everything else
            stream = _workload.with_hedges(
                stream, spec.hedge_fraction,
                after_us=spec.hedge_after_us or 0.0, seed=spec.seed)
        policy_s = request.sched_policy or "stripe"
        eng, batched = self._resolve(request)
        channels, ways = self.config.channels, self.config.ways
        if _sched.policy_is_dynamic(policy_s):
            # engines without the dispatch capability raise
            # CapabilityError naming the ones that have it
            if batched:
                raise ValueError(
                    "dynamic dispatch is FCFS under the eager issue "
                    "policy; 'batched' rounds are fixed at build time "
                    "and only exist for static lowerings")
            cls, arrival, req_id, payload = request_ops(stream)
            extra = retired = sampler = None
            if spec is not None:
                # dynamic faults sample on the op-class sequence alone
                # (placement is decided in-fold): retry/jitter surcharges
                # ride extra_us, a program fault inserts its remap write
                # right after the failed op, and retired blocks become a
                # dispatch constraint via the retired mask
                sampler = FaultSampler(spec, channels, ways, self.table)
                extra, write_fail, _ = sampler.sample(cls)
                fail = np.flatnonzero(write_fail)
                if len(fail):
                    ins = fail + 1
                    n = len(cls)
                    new_of_old = np.arange(n) + np.searchsorted(
                        ins, np.arange(n), "right")
                    cls = np.insert(cls, ins, cls[fail])
                    arrival = np.insert(arrival, ins, arrival[fail])
                    req_id = np.insert(req_id, ins, req_id[fail])
                    extra = np.insert(extra, ins, 0.0).astype(np.float32)
                    pay2 = np.insert(payload, ins, payload[fail])
                    # the failed original keeps its bus/cell cost but the
                    # byte credit moves to the remap — totals conserved
                    pay2[new_of_old[fail]] = False
                    payload = pay2
                    sampler.n_remap_ops += len(fail)
                if sampler.retired.any():
                    retired = sampler.retired
            end, comp, chan, way, par = eng.dispatch_run(
                self, cls, arrival, n_channels=channels, n_ways=ways,
                rule=policy_s, extra_us=extra, retired=retired)
            trace = OpTrace(
                cls=np.asarray(cls, np.int32), channel=chan, way=way,
                parity=par, channels=channels, ways=ways,
                payload=None if payload.all() else payload,
                arrival_us=arrival,
                extra_us=(None if extra is None
                          else np.asarray(extra, np.float32)))
            lowered = LoweredWorkload(
                trace=trace, request_id=req_id,
                request_arrival_us=np.asarray(stream.arrival_us,
                                              np.float32))
            lat = _payload_latencies(lowered, comp, stream)
            energy = None
            if request.objective in ("energy", "all"):
                # energy is (+,+)-linear: the dispatched placement fixes
                # the parity sequence, so the engine-free per-op sum is
                # exact (DESIGN.md §2.4)
                energy = self._breakdown(
                    self._linear_energy_sums(trace, self.kind), end, trace)
            return self._result(trace, end, eng.caps.name, energy,
                                request_lat_us=lat, sched_policy=policy_s,
                                sampler=sampler)
        lowered = _sched.lower_static(stream, channels, ways, policy_s)
        trace = lowered.trace
        sampler = None
        if spec is not None:
            trace, rid2, sampler = _sched.apply_faults(
                trace, spec, self.table, request_id=lowered.request_id)
            lowered = LoweredWorkload(
                trace=trace, request_id=rid2,
                request_arrival_us=lowered.request_arrival_us)
        trace.validate_against(self.table)
        energy = None
        lat = None
        base = getattr(_EngineBase, "completions")
        if getattr(type(eng), "completions", base) is not base:
            end_us, comp = eng.completions(self, trace, batched=batched,
                                           segment_len=request.segment_len)
            lat = _payload_latencies(lowered, comp, stream)
        else:   # makespan-only engines (the (max,+) fold)
            end_us = eng.end_time(self, trace, batched=batched,
                                  segment_len=request.segment_len)
        if request.objective in ("energy", "all"):
            end_e, sums = eng.energy_sums(
                self, trace, self.kind, batched=batched,
                segment_len=request.segment_len)
            energy = self._breakdown(sums, end_e, trace)
        return self._result(trace, end_us, eng.caps.name, energy,
                            request_lat_us=lat, sched_policy=policy_s,
                            sampler=sampler)

    def run_many(self, traces, *, policy: Policy | None = None,
                 objective: Objective = "end_time",
                 engine: str | None = None,
                 segment_len: int | None = 64,
                 shard: bool | None = None) -> list[SimResult]:
        """The batched serving path: many traces under the bound design
        point, results identical to per-trace :meth:`run`.

        ``engine="scan"`` (the default) pads the traces to power-of-two
        length buckets and steps each (channels, bucket) group as the
        lanes of one masked fold (padding is a bitwise state no-op).
        ``engine="cuda"`` evaluates each (channels, ways) group as ONE
        many-trace kernel launch over the group's union combo dictionary
        (``kernels.maxplus.ops.run_many_end_time_maxplus``).  Other
        engines go through :meth:`run` trace by trace.  Energies are
        summed per op on the host (energy is (+,+)-linear), exactly as
        the JAX package does.  With ``shard`` not False and a points mesh
        (:func:`points_mesh`), each scan group's lanes split over the
        mesh's devices, the group padded to whole rows a device by
        repeating its first trace."""
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r} "
                             f"(one of {', '.join(OBJECTIVES)})")
        policy = policy or self.default_policy
        batched = policy_is_batched(policy)
        name = engine or "scan"
        get_engine(name)            # raises on unknown engines
        traces = list(traces)
        for t in traces:
            if t.n_ops == 0:
                raise ValueError("empty trace: no ops to simulate")
            t.validate_against(self.table)
        if name not in ("scan", "cuda"):
            return [self.run(SimRequest(trace=t, policy=policy,
                                        objective=objective, engine=name,
                                        segment_len=segment_len))
                    for t in traces]
        if objective in ("energy", "all") and self.kind is None:
            raise ValueError(
                "energy query on a Simulator with no interface kind "
                "(pass kind= or bind an SSDConfig)")
        ends = np.empty(len(traces), np.float64)
        mesh = (_points_mesh(self.device)
                if shard is not False and get_engine(name).caps.shard
                else None)
        groups: dict[tuple[int, int], list[int]] = {}
        for i, t in enumerate(traces):
            key = ((t.channels, t.ways) if name == "cuda"
                   else (t.channels, _bucket_len(t.n_ops)))
            groups.setdefault(key, []).append(i)
        for (channels, t_b), idxs in groups.items():
            if name == "cuda":
                ends[idxs] = run_many_end_time_maxplus(
                    self.table, [traces[i] for i in idxs],
                    policy=_policy_name(batched), device=self.device)
                continue
            rows = [_pad_trace_np(traces[i], t_b) for i in idxs]
            stacked = [np.stack(cols) for cols in zip(*rows)]

            def fold(*args, device, channels=channels):
                """The lanes ``args[:7]`` under the table ``args[7:]``."""
                return _sim.trace_end_time_masked_many(
                    *args[7:], *args[:7], n_channels=channels,
                    batched=batched).cpu().numpy()
            ends[idxs] = (fold(*stacked, *self._targs, device=self.device)
                          if mesh is None else
                          _shard_points(mesh, fold, n_sharded=7)(
                              *stacked, *self._targs))
        return self._many_results(traces, ends, name, objective)

    def _linear_energy_sums(self, trace: OpTrace,
                            kind: InterfaceKind) -> np.ndarray:
        """[P] phase sums (uJ) by direct per-op summation in float64 —
        energy is (+,+)-linear, so this is the engine-free evaluation the
        packed serving path uses."""
        e = self._e_tables_np.get(kind)
        if e is None:
            e = self._e_tables_np[kind] = np.asarray(
                op_phase_energy_uj(self.table, kind), np.float64)
        return e[np.asarray(trace.cls),
                 np.asarray(trace.parity) % 2].sum(axis=0)

    def _many_results(self, traces, ends, name: str,
                      objective: Objective) -> list[SimResult]:
        """Per-trace results of the packed serving paths, energies from
        the engine-free per-op sum."""
        results = []
        for t, end in zip(traces, ends):
            energy = None
            if objective in ("energy", "all"):
                energy = self._breakdown(
                    self._linear_energy_sums(t, self.kind), float(end), t)
            results.append(self._result(t, float(end), name, energy))
        return results

    def run_stream(self, chunks, *, policy: Policy | None = None,
                   objective: Objective = "end_time", ftl=None,
                   faults: FaultSpec | None = None,
                   sched_policy: str = "stripe") -> SimResult:
        """Constant-memory streaming query: fold an *iterator of OpTrace
        chunks* (``trace.iter_trace_chunks``, the generator builder
        ``trace.mixed_trace_chunks``, or any iterable) through the
        streaming engine without ever holding the whole trace — payload
        bytes, per-channel occupancy and the op count accumulate chunk by
        chunk.

        With ``ftl=`` (an :class:`FTLSpec`), ``chunks`` is instead an
        iterator of host :class:`RequestStream` chunks: each chunk runs
        the translation machine carrying the drive state, lowers at the
        carried placement-slot offset (``sched.lower_ops_chunk``) and
        feeds the same streaming fold, so the result (stats included)
        equals the one-shot ``run(SimRequest(ftl=...))``.  ``faults``
        prices per-op retry/jitter surcharges with one sequential sampler
        across chunks; hedging and block-level program/erase failures are
        one-shot-only.  Without ``ftl=``, ``faults=`` raises, as in the
        JAX package (op-trace chunks are already placed: rewrite them
        with ``iter_trace_chunks(faults=...)``)."""
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r} "
                             f"(one of {', '.join(OBJECTIVES)})")
        if ftl is not None:
            return self._run_stream_ftl(
                chunks, ftl, policy=policy, objective=objective,
                faults=faults, sched_policy=sched_policy)
        if faults is not None:
            raise ValueError(
                "run_stream(faults=...) needs ftl= (op-trace chunks are "
                "already placed; apply sched.apply_faults per chunk "
                "instead)")
        batched = policy_is_batched(policy or self.default_policy)
        kind = None
        if objective in ("energy", "all"):
            if self.kind is None:
                raise ValueError(
                    "energy query on a Simulator with no interface kind "
                    "(pass kind= or bind an SSDConfig)")
            kind = self.kind
        stats = {"n_ops": 0, "payload": 0, "busy": None}
        slot = np.asarray(self.table.slot_us, np.float64)

        def tap(cs):
            for c in cs:
                if c.n_ops == 0:
                    continue
                c.validate_against(self.table)
                if stats["busy"] is None:
                    stats["busy"] = np.zeros(c.channels)
                elif len(stats["busy"]) != c.channels:
                    raise ValueError(
                        f"streaming chunks switched geometry mid-stream: "
                        f"{c.channels} channels after {len(stats['busy'])}")
                stats["n_ops"] += c.n_ops
                stats["payload"] += c.total_bytes(self.table)
                stats["busy"] += np.bincount(
                    np.asarray(c.channel), weights=slot[np.asarray(c.cls)],
                    minlength=c.channels)
                yield c

        end, sums, _, channels = get_engine("streaming")._fold(
            self, tap(chunks), batched=batched, kind=kind)
        payload = stats["payload"]
        energy = None
        if kind is not None:
            energy = breakdown_from_sums(
                sums, end_us=end, payload_bytes=payload, kind=kind,
                channels=channels)
        return SimResult(
            end_us=end, mb_s=(payload / end) if payload > 0 else None,
            channel_busy_us=stats["busy"], energy=energy,
            engine="streaming", n_ops=stats["n_ops"], payload_bytes=payload)

    def _run_stream_ftl(self, chunks, spec, *, policy: Policy | None,
                        objective: Objective, faults: FaultSpec | None,
                        sched_policy: str) -> SimResult:
        """FTL-translating adapter for :meth:`run_stream`: a generator
        turns each host ``RequestStream`` chunk into a placed ``OpTrace``
        chunk — translation state, placement-slot offset and the fault
        sampler all carry across chunks, so the chunked answer equals the
        one-shot ``run(SimRequest(ftl=...))`` stream op for op.  The fold
        itself is delegated to the FTL sub-session, whose 7-class table
        owns chunk validation and byte accounting."""
        if self.config is None:
            raise ValueError(
                "workload queries need a Simulator bound to an SSDConfig "
                "(the scheduler needs the channel/way geometry)")
        if _sched.policy_is_dynamic(sched_policy):
            raise ValueError(
                f"sched policy {sched_policy!r} is dynamic — streaming "
                "chunks lower offline at a carried slot offset; dynamic "
                "dispatch needs the one-shot run(SimRequest(ftl=...)) "
                "path")
        if faults is not None and (faults.hedge_fraction > 0.0
                                   or faults.prog_fail_prob > 0.0
                                   or faults.erase_fail_prob > 0.0):
            raise ValueError(
                "run_stream(ftl=...) prices per-op retry/jitter "
                "surcharges only — hedging and block-level program/"
                "erase failures rewrite the whole stream and need the "
                "one-shot run(SimRequest(ftl=...)) path")
        sess = self._ftl_session(spec)
        C, W = self.config.channels, self.config.ways
        carry: dict = {"state": None, "off": 0, "sampler": None,
                       "stats": None}
        if faults is not None and not faults.is_zero:
            carry["sampler"] = FaultSampler(faults, C, W, sess.table)

        def translated():
            for st in chunks:
                if st.n_requests == 0:
                    continue
                tr = _ftl_scan.translate_scan(
                    st, spec, state=carry["state"], device=self.device,
                    pre_states=self._ftl_pre_states)
                carry["state"] = tr.state
                carry["stats"] = tr.stats
                ot, carry["off"] = _sched.lower_ops_chunk(
                    tr.op_cls, tr.arrival_us, C, W, sched_policy,
                    tr.payload, carry["off"])
                if carry["sampler"] is not None:
                    extra, _, _ = carry["sampler"].sample(
                        _read_write_view(tr.op_cls))
                    ot = dataclasses.replace(
                        ot, extra_us=np.asarray(extra, np.float32))
                yield ot

        try:
            res = sess.run_stream(translated(), policy=policy,
                                  objective=objective)
        except ValueError:
            if carry["stats"] is None:     # no chunk carried a request
                raise ValueError(
                    "empty workload: no requests to translate") from None
            raise
        stats = carry["stats"]
        return dataclasses.replace(
            res, waf=stats.waf, gc_op_count=stats.gc_op_count,
            free_page_low_watermark=stats.free_page_low_watermark,
            ftl_stats=stats)

    def sweep(self, tables, trace: OpTrace, *,
              policy: Policy | None = None, engine: str = "prefix",
              segment_len: int | None = 64, combine: str = "chain",
              shard: bool | None = None, ftl=None,
              sched_policy: str = "stripe") -> np.ndarray:
        """[B] completion times of one trace under a batch of design-point
        tables (``tables=None`` sweeps the bound table alone) — the
        design-space fan-out direction of the serving path, through
        :func:`sweep_tables` on the session's device (default engine
        ``prefix``, as in the JAX package), sharded over a points mesh
        as :func:`sweep_tables` is unless ``shard=False``.

        ``ftl=`` switches to the *aged* design-space direction (DESIGN.md
        §2.11): ``trace`` is then a host :class:`RequestStream` and
        ``ftl`` a sequence of :class:`FTLSpec` design points sharing one
        geometry and timing — each point runs the whole
        translate→lower→simulate chain (preconditioning included) as a
        lane of one batched fold, placed by ``sched_policy``.  ``tables``
        must be None (the FTL spec owns the 7-class table) and
        ``engine``/``segment_len``/``combine`` are ignored — the fused
        chain is the masked scan fold by construction."""
        if ftl is not None:
            if tables is not None:
                raise ValueError(
                    "sweep(ftl=...) sweeps FTL design points — the "
                    "7-class table comes from the spec; tables must be "
                    "None")
            return self._sweep_ftl(trace, ftl,
                                   policy=policy or self.default_policy,
                                   sched_policy=sched_policy, shard=shard)
        return sweep_tables(
            [self.table] if tables is None else tables, trace,
            policy=policy or self.default_policy, engine=engine,
            segment_len=segment_len, combine=combine, shard=shard,
            device=self.device)

    def _sweep_ftl(self, stream: RequestStream, specs, *, policy: Policy,
                   sched_policy: str, shard: bool | None = None
                   ) -> np.ndarray:
        """Fused aged sweep: precondition fold → window reset →
        translation fold → compaction → closed-form static lowering →
        masked end-time fold, the FTL design points as the lanes of each
        fold.  Exactness leans on two invariants: the translation machine
        is op-for-op the host translator, and the closed-form
        slot/parity lowering is field-for-field ``lower_ops`` — so each
        lane's end time is the scan engine's on the per-point
        ``run(SimRequest(ftl=...))`` trace.

        The preconditioned states are a pure function of the spec batch,
        so they fold once and are reused across calls
        (one cache a device, at most 4 batches).  Emission rows compact
        into each lane's op sequence (``ftl_scan.translate_lanes``), so
        the end-time fold runs over the longest lane's op count rather
        than the raw emission buffer.

        With ``shard`` not False and a points mesh, the design points
        split over the mesh's devices, both stages (preconditioning and
        translation) run on each block's device, and each device keeps
        its own preconditioned states.  Sharding is unmeasured across
        cards (``points_mesh``)."""
        if self.config is None:
            raise ValueError(
                "workload queries need a Simulator bound to an SSDConfig "
                "(the scheduler needs the channel/way geometry)")
        specs = list(specs)
        if not specs:
            raise ValueError("sweep(ftl=...) needs at least one FTLSpec")
        if stream.n_requests == 0:
            raise ValueError("empty workload: no requests to translate")
        g0 = (specs[0].blocks, specs[0].pages_per_block,
              float(specs[0].map_us), specs[0].erase_us)
        for s in specs[1:]:
            if (s.blocks, s.pages_per_block, float(s.map_us),
                    s.erase_us) != g0:
                raise ValueError(
                    "sweep(ftl=...) points must share geometry and "
                    "timing (blocks, pages_per_block, map_us, erase_us) "
                    "— vary overprovision / gc_policy / gc_free_blocks / "
                    "precondition per point")
        if _sched.policy_is_dynamic(sched_policy):
            raise ValueError(
                f"sched policy {sched_policy!r} is dynamic — the fused "
                "FTL sweep lowers placement in closed form; use "
                "run(SimRequest(ftl=...)) per point")
        batched = policy_is_batched(policy)
        sess = self._ftl_session(specs[0])
        if int(np.max(stream.op_cls)) > _trace.WRITE:
            raise ValueError(
                "FTL translation consumes host READ/WRITE streams only "
                f"(got op class {int(np.max(stream.op_cls))})")
        C, W = self.config.channels, self.config.ways
        mesh = _points_mesh(self.device) if shard is not False else None

        def lanes(idx, *targs, device):
            """The end times of the points ``idx`` on ``device``."""
            pts = [specs[i] for i in idx.tolist()]
            with self._ftl_pre_lock:
                cache = self._ftl_pre_by_device.setdefault(
                    str(device), collections.OrderedDict())
            state = _ftl_scan.preconditioned_lanes(pts, device, cache,
                                                   self._ftl_pre_lock)
            op_cls, arrival, n_ops = _ftl_scan.translate_lanes(pts, stream,
                                                               state)
            # compacted op i sits at slot i, so the closed-form static
            # placement (`lower_ops` field-for-field) is shared by the
            # lanes
            b = len(pts)
            slot = torch.arange(op_cls.shape[1], dtype=torch.int64,
                                device=device)
            if sched_policy == "stripe":
                chan, way = slot % C, (slot // C) % W
            else:                       # "round_robin": way-first
                way, chan = slot % W, (slot // W) % C
            par = (slot // (C * W)) % 2
            return _sim._trace_end_time_masked_impl(
                *targs, op_cls, chan.expand(b, -1), way.expand(b, -1),
                par.expand(b, -1), arrival, torch.zeros_like(arrival),
                slot < n_ops[:, None], C, batched)

        idx = torch.arange(len(specs))
        if mesh is None:
            end = lanes(idx, *sess._targs, device=self.device)
        else:
            end = _shard_points(mesh, lanes, n_sharded=1)(idx, *sess._targs)
        return end.cpu().numpy().astype(np.float64)


@functools.lru_cache(maxsize=128)
def simulator_for(config: SSDConfig, device: torch.device) -> Simulator:
    """Memoised :class:`Simulator` per (design point, device)."""
    return Simulator(config, device=device)


# ---------------------------------------------------------------------------
# Module-level query functions
# ---------------------------------------------------------------------------

_UNSET = object()
_POINTS_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "points_mesh", default=_UNSET)


@contextlib.contextmanager
def points_mesh(mesh):
    """Inside the block, the sharded entry points split their design
    points over ``mesh`` (``launch.mesh.make_points_mesh(devices)``;
    ``None``: one device) wherever ``shard`` is not False, whatever the
    call's device: the port's counterpart of forcing the JAX package's
    host device count.  Outside one they shard over every card where the
    host has two or more and the call runs on the card, as the JAX
    package shards over every device.  That default is unmeasured across
    cards: each block steps the whole trace, so the launch-bound ``scan``
    and ``prefix`` folds launch once a block, from threads that share the
    interpreter lock, and on one H100 two blocks ran 1.8-5.4x slower than
    one device (``chip_smoke.py`` phase 17a); ``shard=False`` keeps one
    device."""
    token = _POINTS_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _POINTS_MESH.reset(token)


@functools.lru_cache(maxsize=1)
def _card_points_mesh():
    from repro_torch.launch.mesh import make_points_mesh
    return make_points_mesh()


def _points_mesh(device: torch.device):
    """The points mesh a call on ``device`` shards over: the installed
    one, else every card (``None`` under two, or off the card)."""
    mesh = _POINTS_MESH.get()
    if mesh is not _UNSET:
        return mesh
    return _card_points_mesh() if device.type == "cuda" else None


def _shard_points(mesh, fn, *, n_sharded: int):
    from repro_torch.distributed.partitioning import shard_points
    return shard_points(mesh, fn, n_sharded=n_sharded)


def _sharded_batch_fn(mesh, eng: Engine, trace: OpTrace, **kw):
    """``eng.end_time_batch`` over ``mesh``: the tables split over the
    devices, the trace goes whole to each."""
    return _shard_points(mesh, lambda tables, *, device: eng.end_time_batch(
        tables, trace, device=device, **kw), n_sharded=1)


def _sharded_sweep_steady_fn(mesh, eng: Engine, **kw):
    """``eng.sweep_steady`` over ``mesh``: all 8 per-point arrays split
    their leading axis."""
    return _shard_points(mesh, lambda *a, device: eng.sweep_steady(
        a[:6], a[6], a[7], device=device, **kw), n_sharded=8)


def sweep_tables(tables, trace: OpTrace, *, policy: Policy = "eager",
                 engine: str = "prefix", segment_len: int | None = 64,
                 combine: str = "chain", shard: bool | None = None,
                 device: torch.device | str | None = None) -> np.ndarray:
    """[B] completion times (us) of one trace under a batch of
    design-point tables, through an engine with the batched-tables
    capability: ``prefix`` (the default, as in the JAX package; its
    ``segment_len`` and ``combine`` shape the fold), ``scan`` or
    ``cuda`` (one kernel launch folds every design point).  On
    ``prefix``, ``segment_len=None`` holds one [N, N] product per op: at
    64 design points x a 65536-op trace on 8 x 16 that is about 360 GB,
    beyond one card (the default 64 holds 5.6 GB).  On ``scan`` and
    ``prefix`` with ``shard`` not False, a points mesh (:func:`points_mesh`;
    every card where there are two or more) splits the tables over its
    devices, the batch padded to a multiple of the mesh and sliced back;
    ``shard=False`` keeps one device.  Whether that pays across cards is
    unmeasured (:func:`points_mesh`)."""
    dev = resolve_device(device)
    batched = policy_is_batched(policy)
    eng = get_engine(engine)
    if trace.n_ops == 0:
        raise ValueError("empty trace: no ops to simulate")
    tables = list(tables)
    for t in tables:
        trace.validate_against(t)
    kw = dict(batched=batched, segment_len=segment_len, combine=combine)
    mesh = _points_mesh(dev) if shard is not False else None
    if mesh is not None and len(tables) > 1 and eng.caps.shard:
        return _sharded_batch_fn(mesh, eng, trace, **kw)(tables)
    return eng.end_time_batch(tables, trace, device=dev, **kw)


@functools.lru_cache(maxsize=256)
def _steady_trace_cached(n_pages: int, channels: int, ways: int,
                         op_cls: int) -> OpTrace:
    return _trace.steady_trace(n_pages, channels, ways, op_cls)


def steady_bandwidth_mb_s(cfg: SSDConfig, mode: str, n_pages: int = 512,
                          device: torch.device | str | None = None) -> float:
    """SSD-level steady-stream bandwidth (MB/s): all channels simulated
    jointly against the shared controller, capped by the SATA host link.
    ``n_pages`` is per channel."""
    if mode not in ("read", "write"):
        raise ValueError(f"unknown mode {mode!r} (one of 'read', 'write')")
    trace = _steady_trace_cached(
        n_pages, cfg.channels, cfg.ways,
        _trace.READ if mode == "read" else _trace.WRITE)
    res = Simulator.for_config(cfg, device).run(trace, policy=cfg.policy)
    return float(min(res.mb_s, cfg.sata_mb_s))


def steady_channel_bandwidth_mb_s(op: PageOpParams, ways: int,
                                  policy: Policy = "eager",
                                  n_pages: int = 512, engine: str = "scan",
                                  device: torch.device | str | None = None
                                  ) -> float:
    """Steady-stream bandwidth of a single channel (MB/s) for one op-class
    design point, via an engine with the homogeneous-pattern capability
    (scan / prefix / squaring)."""
    batched = policy_is_batched(policy)
    end = get_engine(engine).steady_channel_end(
        op, int(ways), n_pages=n_pages, batched=batched,
        device=resolve_device(device))
    return (n_pages * op.data_bytes) / end


def sweep_steady_bandwidth_mb_s(cmd_us, pre_us, slot_us, post_lo_us,
                                post_hi_us, ctrl_us, data_bytes, ways,
                                n_pages: int = 512, batched: bool = False,
                                engine: str = "scan",
                                shard: bool | None = None,
                                device: torch.device | str | None = None
                                ) -> np.ndarray:
    """[B] single-channel steady bandwidths (MB/s, float32) of B design
    points given as arrays of op-class scalars, payload bytes and way
    counts, via an engine with the sweep capability (``scan`` /
    ``squaring``) — the fan-out the ``calibrate`` fitting grids ride.
    With ``shard`` not False and a points mesh (:func:`points_mesh`;
    every card where there are two or more), more than one point splits
    over the mesh's devices; ``shard=False`` keeps one device (whether
    sharding pays across cards is unmeasured: :func:`points_mesh`)."""
    dev = resolve_device(device)
    scalars = (cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us)
    eng = get_engine(engine)
    mesh = _points_mesh(dev) if shard is not False else None
    if mesh is not None and eng.caps.shard:
        args = tuple(np.asarray(x) for x in scalars + (data_bytes, ways))
        if args[0].ndim == 1 and int(args[0].shape[0]) > 1:
            return _sharded_sweep_steady_fn(
                mesh, eng, n_pages=n_pages, batched=batched)(*args)
    return eng.sweep_steady(scalars, data_bytes, ways, n_pages=n_pages,
                            batched=batched, device=dev)


__all__ = [
    "CacheInfo", "CapabilityError", "Engine", "EngineCaps", "OBJECTIVES", "Objective",
    "Policy", "SimRequest", "SimResult", "Simulator", "engine_capabilities",
    "get_engine", "points_mesh", "register_engine", "registered_engines",
    "simulator_for",
    "steady_bandwidth_mb_s",
    "steady_channel_bandwidth_mb_s", "sweep_steady_bandwidth_mb_s",
    "sweep_tables",
]
