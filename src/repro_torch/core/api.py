"""Unified ``Simulator`` session API of the port: one request/response
surface over every simulation engine.

* an **engine registry** — every evaluation strategy registers once
  under a name with a declared :class:`EngineCaps` capability row.
  Unknown names raise one ``ValueError`` listing the registered engines;
  a registered engine asked for something outside its capability row,
  or an engine of the JAX package this port has not reached yet, raises
  :class:`CapabilityError` (a ``ValueError``).  Registered here:

  - ``scan``   — the torch step loop of ``repro_torch.core.sim`` (the
    default);
  - ``cuda``   — the (max,+) matrix fold of ``repro_torch.kernels.maxplus``
    on the hand-written CUDA kernel (the JAX package's ``pallas``
    engine); on a CPU session it folds with the kernel's plain version;
  - ``oracle`` — the plain-Python event loop of ``repro_torch.core.sim_ref``.

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

Request fields whose part of the system is not ported yet raise
:class:`CapabilityError` naming the slice that brings it: ``workload``,
``sched_policy`` and ``faults`` (slice B), ``ftl`` (slice E), and the
engines ``prefix`` and ``squaring`` (slice C) and ``streaming``
(slice D).  Traces that already carry ``arrival_us`` / ``extra_us``
are served by every engine here, since each folds them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import sim as _sim
from repro_torch.core import trace as _trace
from repro_torch.core.energy import (EnergyBreakdown, breakdown_from_sums,
                                     op_phase_energy_uj)
from repro_torch.core.interface import InterfaceKind
from repro_torch.core.sim import (PageOpParams, Policy, SSDConfig,
                                  policy_is_batched)
from repro_torch.core.sim_ref import (simulate_trace_energy_ref,
                                      simulate_trace_ref)
from repro_torch.core.trace import OpClassTable, OpTrace, op_class_table
from repro_torch.device import resolve_device
from repro_torch.kernels.maxplus.ops import (trace_end_time_maxplus,
                                             trace_energy_maxplus)

Objective = Literal["end_time", "bandwidth", "energy", "all"]
OBJECTIVES: tuple[str, ...] = ("end_time", "bandwidth", "energy", "all")

#: Op-class table columns, in the positional order the engines take.
_TABLE_FIELDS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
                 "ctrl_us", "arb_us")

#: Engines of the JAX package not ported yet, by the slice that brings them.
UNPORTED_ENGINES = {"prefix": "slice C", "squaring": "slice C",
                    "streaming": "slice D"}


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

    def describe(self) -> str:
        flags = [k for k in ("batched_tables", "energy") if getattr(self, k)]
        return f"{self.name}: {', '.join(flags) or 'none'}"


@runtime_checkable
class Engine(Protocol):
    """What a registered engine must answer.  ``sim`` is the session — it
    supplies the bound table, its device copies and the device."""

    caps: EngineCaps

    def end_time(self, sim: "Simulator", trace: OpTrace, *,
                 batched: bool) -> float: ...

    def energy_sums(self, sim: "Simulator", trace: OpTrace,
                    kind: InterfaceKind, *,
                    batched: bool) -> tuple[float, np.ndarray]: ...


_REGISTRY: dict[str, Engine] = {}


def register_engine(name: str, *, batched_tables: bool, energy: bool):
    """Class decorator: instantiate and register an engine under ``name``
    with its declared capability row.  Names are unique."""

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"engine {name!r} is already registered")
        inst = cls()
        inst.caps = EngineCaps(name=name, batched_tables=batched_tables,
                               energy=energy)
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
    """Look up a registered engine.  Engines of the JAX package that the
    port has not reached raise ``CapabilityError`` naming their slice;
    unknown names raise ``ValueError`` listing the registered engines."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in UNPORTED_ENGINES:
        raise CapabilityError(
            f"engine {name!r} is not ported yet (it lands with "
            f"{UNPORTED_ENGINES[name]}; registered engines: "
            f"{', '.join(registered_engines())})")
    raise ValueError(
        f"unknown engine {name!r} (registered engines: "
        f"{', '.join(registered_engines())})")


def _policy_name(batched: bool) -> str:
    return "batched" if batched else "eager"


def _trace_arrays(trace: OpTrace):
    """The per-op host arrays the scan engine steps through."""
    return (trace.cls, trace.channel, trace.way, trace.parity,
            trace.arrival_us, trace.extra_us)


def _table_tensors(tables, device) -> tuple[torch.Tensor, ...]:
    """[B, K] float32 columns of a list of tables on ``device``."""
    return tuple(torch.as_tensor(
        np.stack([np.asarray(getattr(t, f), np.float32) for t in tables]),
        device=device) for f in _TABLE_FIELDS)


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

    def end_time_batch(self, tables, trace, *, batched,
                       device) -> np.ndarray:
        self._unsupported("batched design-point tables", "end_time_batch")

    def steady_channel_end(self, op: PageOpParams, ways: int, *,
                           n_pages: int, batched: bool, device) -> float:
        self._unsupported("homogeneous single-channel patterns",
                          "steady_channel_end")


@register_engine("scan", batched_tables=True, energy=True)
class ScanEngine(_EngineBase):
    """O(T) step loop over device state tensors — the default engine."""

    def end_time(self, sim, trace, *, batched):
        return float(_sim.trace_end_time(
            *sim._targs, *_trace_arrays(trace), n_channels=trace.channels,
            batched=batched))

    def energy_sums(self, sim, trace, kind, *, batched):
        end, sums = _sim.trace_end_time_energy(
            *sim._targs, sim._energy_table(kind), *_trace_arrays(trace),
            n_channels=trace.channels, batched=batched)
        return float(end), sums.cpu().numpy().astype(np.float64)

    def end_time_batch(self, tables, trace, *, batched, device):
        end = _sim.trace_end_time_batch(
            *_table_tensors(tables, device), *_trace_arrays(trace),
            n_channels=trace.channels, batched=batched)
        return end.cpu().numpy()

    def steady_channel_end(self, op, ways, *, n_pages, batched, device):
        i = np.arange(n_pages)
        zeros = np.zeros(n_pages, np.int32)
        cols = (op.cmd_us, op.pre_us, op.slot_us, op.post_lo_us,
                op.post_hi_us, op.ctrl_us, 0.0)
        table = tuple(torch.tensor([x], dtype=torch.float32, device=device)
                      for x in cols)
        return float(_sim.trace_end_time(
            *table, zeros, zeros, (i % ways).astype(np.int32),
            ((i // ways) % 2).astype(np.int32), n_channels=1,
            batched=batched))


@register_engine("cuda", batched_tables=True, energy=True)
class CudaEngine(_EngineBase):
    """The (max,+) matrix fold on the hand-written CUDA kernel (the JAX
    package's ``pallas`` engine).  The step-matrix dictionary is built on
    the host per query and moved to the session's device."""

    def end_time(self, sim, trace, *, batched):
        return float(trace_end_time_maxplus(
            sim.table, trace, policy=_policy_name(batched),
            device=sim.device))

    def energy_sums(self, sim, trace, kind, *, batched):
        end, sums = trace_energy_maxplus(
            sim.table, trace, kind, policy=_policy_name(batched),
            device=sim.device)
        return float(end), np.asarray(sums, np.float64)

    def end_time_batch(self, tables, trace, *, batched, device):
        return np.asarray(trace_end_time_maxplus(
            list(tables), trace, policy=_policy_name(batched),
            device=device))


@register_engine("oracle", batched_tables=False, energy=True)
class OracleEngine(_EngineBase):
    """The plain-Python event loop (``repro_torch.core.sim_ref``) — the
    test oracle, first-class behind the same request surface.  It runs
    on the host whatever the session's device."""

    def end_time(self, sim, trace, *, batched):
        return float(simulate_trace_ref(sim.table, trace,
                                        _policy_name(batched)))

    def energy_sums(self, sim, trace, kind, *, batched):
        end, sums = simulate_trace_energy_ref(
            sim.table, trace, kind, _policy_name(batched))
        return float(end), np.asarray(sums, np.float64)


# ---------------------------------------------------------------------------
# Request / response types
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One simulation query, validated once at construction: the policy
    literal, the objective and the engine name.  ``workload``,
    ``sched_policy``, ``faults`` and ``ftl`` mirror the JAX package's
    request and raise :class:`CapabilityError` until their slices land."""

    trace: OpTrace | None = None
    policy: Policy | None = None        # None -> the session's default
    objective: Objective = "end_time"
    engine: str | None = None           # None -> "scan"
    workload: object | None = None      # slice B
    sched_policy: str | None = None     # slice B
    faults: object | None = None        # slice B
    ftl: object | None = None           # slice E

    def __post_init__(self):
        for field, slice_ in (("workload", "slice B"),
                              ("sched_policy", "slice B"),
                              ("faults", "slice B"), ("ftl", "slice E")):
            if getattr(self, field) is not None:
                raise CapabilityError(
                    f"SimRequest.{field} is not ported yet (it lands with "
                    f"{slice_})")
        if self.trace is None:
            raise ValueError("SimRequest needs trace=")
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
    ``mb_s`` is user-payload bandwidth (None for payload-free traces)."""

    end_us: float
    mb_s: float | None
    channel_busy_us: np.ndarray          # [channels] bus occupancy (us)
    energy: EnergyBreakdown | None
    engine: str
    n_ops: int
    payload_bytes: int

    @property
    def channel_occupancy(self) -> np.ndarray:
        """Per-channel bus busy fraction of the makespan."""
        return self.channel_busy_us / max(self.end_us, 1e-30)

    def describe(self) -> str:
        occ = "/".join(f"{x:.2f}" for x in self.channel_occupancy)
        bw = f"{self.mb_s:.1f} MB/s" if self.mb_s is not None else "no payload"
        return (f"[{self.engine}] {self.n_ops} ops in "
                f"{self.end_us / 1e3:.2f} ms, {bw}, occ {occ}")


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------


class Simulator:
    """A simulation session bound to one design point and one device.

    Binds an ``SSDConfig`` (or a raw ``OpClassTable``) once; the timing
    table's columns and, per interface kind, the phase-energy table are
    moved to the device once and reused by every query.  All registered
    engines answer through :meth:`run`.
    """

    def __init__(self, config: SSDConfig | None = None, *,
                 table: OpClassTable | None = None,
                 kind: InterfaceKind | str | None = None,
                 device: torch.device | str | None = None):
        if config is None and table is None:
            raise ValueError("Simulator needs an SSDConfig or an "
                             "OpClassTable")
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

    def _resolve(self, request: SimRequest):
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
        return eng, batched

    def _result(self, trace: OpTrace, end_us: float, engine: str,
                energy: EnergyBreakdown | None) -> SimResult:
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
            n_ops=trace.n_ops, payload_bytes=payload)

    def _breakdown(self, sums, end_us: float, trace: OpTrace):
        return breakdown_from_sums(
            sums, end_us=end_us,
            payload_bytes=trace.total_bytes(self.table),
            kind=self.kind, channels=trace.channels)

    def run(self, request: SimRequest | OpTrace, /,
            **overrides) -> SimResult:
        """Answer one query: a :class:`SimRequest`, or a bare ``OpTrace``
        plus request fields as keywords."""
        if not isinstance(request, SimRequest):
            request = SimRequest(trace=request, **overrides)
        elif overrides:
            request = dataclasses.replace(request, **overrides)
        trace = request.trace
        if trace.n_ops == 0:
            raise ValueError("empty trace: no ops to simulate")
        trace.validate_against(self.table)
        eng, batched = self._resolve(request)
        energy = None
        if request.objective in ("energy", "all"):
            end_us, sums = eng.energy_sums(self, trace, self.kind,
                                           batched=batched)
            energy = self._breakdown(sums, end_us, trace)
        else:
            end_us = eng.end_time(self, trace, batched=batched)
        return self._result(trace, end_us, eng.caps.name, energy)


@functools.lru_cache(maxsize=128)
def simulator_for(config: SSDConfig, device: torch.device) -> Simulator:
    """Memoised :class:`Simulator` per (design point, device)."""
    return Simulator(config, device=device)


# ---------------------------------------------------------------------------
# Module-level query functions
# ---------------------------------------------------------------------------


def sweep_tables(tables, trace: OpTrace, *, policy: Policy = "eager",
                 engine: str = "cuda",
                 device: torch.device | str | None = None) -> np.ndarray:
    """[B] completion times (us) of one trace under a batch of
    design-point tables, through an engine with the batched-tables
    capability.  The default is the kernel engine, whose one launch folds
    every design point (the JAX package defaults to its log-depth
    ``prefix`` engine, which lands with slice C)."""
    dev = resolve_device(device)
    batched = policy_is_batched(policy)
    eng = get_engine(engine)
    if trace.n_ops == 0:
        raise ValueError("empty trace: no ops to simulate")
    tables = list(tables)
    for t in tables:
        trace.validate_against(t)
    return eng.end_time_batch(tables, trace, batched=batched, device=dev)


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
    (scan)."""
    batched = policy_is_batched(policy)
    end = get_engine(engine).steady_channel_end(
        op, int(ways), n_pages=n_pages, batched=batched,
        device=resolve_device(device))
    return (n_pages * op.data_bytes) / end


__all__ = [
    "CapabilityError", "Engine", "EngineCaps", "OBJECTIVES", "Objective",
    "Policy", "SimRequest", "SimResult", "Simulator", "UNPORTED_ENGINES",
    "engine_capabilities", "get_engine", "register_engine",
    "registered_engines", "simulator_for", "steady_bandwidth_mb_s",
    "steady_channel_bandwidth_mb_s", "sweep_tables",
]
