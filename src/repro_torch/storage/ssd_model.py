"""SSD cost model: the paper's simulator as a capacity-planning service.

The port's copy of the JAX package's ``repro.storage.ssd_model``.  Every
storage-tier component (checkpoint engine, data pipeline, KV offload)
prices its I/O as an **op trace** (``repro_torch.core.trace``) simulated
jointly across channels against the shared controller: given an
interface (CONV / SYNC_ONLY / PROPOSED), cell type and channel/way
geometry, ``estimate_trace`` returns wall time, aggregate bandwidth and
controller energy for mixed read/write access patterns.  ``estimate_io``
keeps the bytes+mode interface (a homogeneous steady trace).  All
pricing goes through the memoised per-(design point, device)
``Simulator`` sessions on the ``scan`` engine, as in the JAX package, so
every estimate equals the JAX package's bit for bit; the rest is float64
host arithmetic.  ``plan_geometry`` inverts the model: the cheapest
(channels, ways) meeting a time budget for a workload (the paper's
§5.3.2 trade-off study); ``plan_checkpoint_tier`` and ``plan_refill``
are the storage tier's two planning flows (``examples/ssd_design_space.py``
in the JAX package).  ``ESTIMATES`` counts the ``estimate_trace`` calls,
the ops they fold and their wall seconds.

Every entry point takes ``device=``: ``None`` is the card
(``repro_torch.device.resolve_device``), ``"cpu"`` the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.api import Simulator, steady_bandwidth_mb_s
from repro_torch.core.energy import ControllerEnergyModel, EnergyBreakdown
from repro_torch.core.interface import InterfaceKind
from repro_torch.core.nand import CellType
from repro_torch.core.sim import SSDConfig
from repro_torch.core.trace import (OpTrace, READ, checkpoint_trace,
                                    datapipe_trace)

Device = torch.device | str | None

#: Candidate geometries for planning, cheapest first.  Area cost model per
#: the paper §2.2.1: a channel costs ~4x a way (NAND_IF + ECC block +
#: pins), so candidates sort by 4*channels + ways.
_CANDIDATES = sorted(
    [(c, w) for c in (1, 2, 4, 8) for w in (1, 2, 4, 8, 16)],
    key=lambda cw: (4 * cw[0] + cw[1], cw[0]))

#: ``estimate_trace`` calls, the ops they folded and their wall seconds.
ESTIMATES = {"calls": 0, "ops": 0, "seconds": 0.0}


def reset_estimates() -> None:
    ESTIMATES.update(calls=0, ops=0, seconds=0.0)


@dataclasses.dataclass(frozen=True)
class IOEstimate:
    seconds: float
    bandwidth_mb_s: float
    energy_joules: float
    config: SSDConfig
    read_bytes: int = 0
    write_bytes: int = 0
    n_ops: int = 0
    energy: EnergyBreakdown | None = None  # phase-resolved (trace paths)

    def describe(self) -> str:
        return (f"{self.config.describe()}: {self.bandwidth_mb_s:.0f} MB/s, "
                f"{self.seconds:.2f} s, {self.energy_joules * 1e3:.1f} mJ")


def estimate_trace(trace: OpTrace, cfg: SSDConfig, *,
                   total_bytes: int | None = None,
                   policy: str | None = None,
                   device: Device = None) -> IOEstimate:
    """Price an op trace on a design point (joint multi-channel sim).

    ``total_bytes``: when the trace is a truncated window of a longer
    steady workload, extrapolate wall time by bytes at the simulated
    sustained bandwidth.  The returned ``energy`` is the phase-resolved
    trace-level breakdown (DESIGN.md §2.4); ``energy_joules`` is its
    controller total — the paper's constant-power quantity."""
    if (trace.channels, trace.ways) != (cfg.channels, cfg.ways):
        raise ValueError(f"trace geometry {trace.channels}x{trace.ways} != "
                         f"config {cfg.channels}x{cfg.ways}")
    if trace.n_ops == 0:
        raise ValueError("empty trace: no ops to estimate")
    t0 = time.perf_counter()
    sim = Simulator.for_config(cfg, device)
    table = sim.table
    window_bytes = trace.total_bytes(table)
    if window_bytes <= 0:
        raise ValueError("trace delivers no payload bytes (every op is "
                         "payload-masked); nothing to price")
    breakdown = sim.run(trace, policy=policy or cfg.policy,
                        objective="all").energy
    end_us = breakdown.end_us
    bw = min(window_bytes / end_us, cfg.sata_mb_s)     # bytes/us == MB/s
    nbytes = window_bytes if total_bytes is None else int(total_bytes)
    seconds = nbytes / (bw * 1e6)
    scale = nbytes / window_bytes
    # per-op phases scale with the op count; idle re-derives from the
    # extrapolated wall time (a SATA-capped stream turns the extra
    # wall-clock into idle energy, not op energy)
    breakdown = breakdown.extrapolated(scale, end_us=seconds * 1e6)
    pay = trace.payload_mask()
    read_mask = (trace.cls == READ) & pay
    write_mask = (trace.cls != READ) & pay
    ESTIMATES["calls"] += 1
    ESTIMATES["ops"] += trace.n_ops
    ESTIMATES["seconds"] += time.perf_counter() - t0
    return IOEstimate(
        seconds=seconds, bandwidth_mb_s=bw,
        energy_joules=breakdown.controller_j, config=cfg,
        read_bytes=int(table.data_bytes[trace.cls[read_mask]].sum() * scale),
        write_bytes=int(table.data_bytes[trace.cls[write_mask]].sum() * scale),
        n_ops=trace.n_ops, energy=breakdown)


def estimate_io(nbytes: int, cfg: SSDConfig, mode: str, *,
                device: Device = None) -> IOEstimate:
    """Bytes+mode estimate — a homogeneous steady trace."""
    bw = steady_bandwidth_mb_s(cfg, mode, device=device)
    seconds = nbytes / (bw * 1e6)
    energy = ControllerEnergyModel(cfg.interface).energy_joules(nbytes, bw) \
        * cfg.channels
    return IOEstimate(
        seconds, bw, energy, cfg,
        read_bytes=nbytes if mode == "read" else 0,
        write_bytes=nbytes if mode == "write" else 0)


def _plan(estimator: Callable[[SSDConfig], IOEstimate], budget_s: float,
          interface: InterfaceKind, cell: CellType,
          objective: str) -> IOEstimate | None:
    """Shared planning loop: ``objective="area"`` returns the cheapest
    candidate (by the §2.2.1 area order) meeting the time budget;
    ``objective="energy"`` searches every candidate meeting the budget
    and returns the one with the lowest controller energy (the Fig. 10
    trade-off)."""
    if objective not in ("area", "energy"):
        raise ValueError(f"unknown objective {objective!r} "
                         "(one of 'area', 'energy')")
    fits = []
    for channels, ways in _CANDIDATES:
        cfg = SSDConfig(interface=interface, cell=cell,
                        channels=channels, ways=ways)
        est = estimator(cfg)
        if est.seconds <= budget_s:
            if objective == "area":
                return est
            fits.append(est)
    if fits:
        return min(fits, key=lambda e: e.energy_joules)
    return None


def plan_geometry(nbytes: int, budget_s: float, mode: str,
                  interface: InterfaceKind = InterfaceKind.PROPOSED,
                  cell: CellType = CellType.MLC,
                  objective: str = "area", *,
                  device: Device = None) -> IOEstimate | None:
    """Best (channels x ways) geometry meeting the time budget for a
    homogeneous byte stream — smallest area, or lowest controller energy
    with ``objective="energy"``."""
    return _plan(lambda cfg: estimate_io(nbytes, cfg, mode, device=device),
                 budget_s, interface, cell, objective)


def plan_geometry_for_trace(
        trace_builder: Callable[[SSDConfig], OpTrace],
        budget_s: float,
        interface: InterfaceKind = InterfaceKind.PROPOSED,
        cell: CellType = CellType.MLC,
        total_bytes: int | None = None,
        objective: str = "area", *,
        device: Device = None) -> IOEstimate | None:
    """Trace-aware geometry planning: the workload is re-striped onto
    each candidate geometry by ``trace_builder(cfg)`` and simulated
    jointly, so mixed read/write contention and shared-controller
    arbitration decide the verdict."""
    return _plan(
        lambda cfg: estimate_trace(trace_builder(cfg), cfg,
                                   total_bytes=total_bytes, device=device),
        budget_s, interface, cell, objective)


def plan_checkpoint_tier(nbytes: int, budget_s: float, *,
                         device: Device = None) -> IOEstimate | None:
    """Trace-planned geometry for a checkpoint write of ``nbytes`` within
    ``budget_s``: an MLC tier first, an SLC tier when contention-limited
    MLC writes miss the budget."""
    for cell in (CellType.MLC, CellType.SLC):
        plan = plan_geometry_for_trace(
            lambda cfg: checkpoint_trace(nbytes, cfg), budget_s, cell=cell,
            total_bytes=nbytes, device=device)
        if plan:
            return plan
    return None


def plan_refill(nbytes: int, budget_s: float, *,
                device: Device = None) -> dict[str, IOEstimate | None]:
    """A dataloader refill of ``nbytes`` within ``budget_s``, planned
    three ways: ``"trace"`` on the read trace with 5 % of reads hedged
    (smallest area), ``"bytes"`` on a pure read stream, ``"energy"`` on
    the trace with the lowest controller energy."""
    def build(cfg):
        return datapipe_trace(nbytes, cfg, hedge_fraction=0.05)
    return {"trace": plan_geometry_for_trace(
                build, budget_s, total_bytes=nbytes, device=device),
            "bytes": plan_geometry(nbytes, budget_s, "read", device=device),
            "energy": plan_geometry_for_trace(
                build, budget_s, total_bytes=nbytes, objective="energy",
                device=device)}


def estimate_trace_interfaces(trace: OpTrace, base_cfg: SSDConfig, *,
                              total_bytes: int | None = None,
                              device: Device = None
                              ) -> dict[str, IOEstimate]:
    """Price one trace under every interface kind at ``base_cfg``'s
    geometry/cell/policy — the per-interface fan-out the storage tier
    (checkpoint stall projection, KV-offload feasibility) runs on every
    save/plan."""
    return {
        kind.value: estimate_trace(
            trace, dataclasses.replace(base_cfg, interface=kind),
            total_bytes=total_bytes, device=device)
        for kind in InterfaceKind
    }


def compare_interfaces(nbytes: int, mode: str, *, channels: int = 4,
                       ways: int = 8, cell: CellType = CellType.MLC,
                       device: Device = None) -> dict[str, IOEstimate]:
    """CONV vs SYNC_ONLY vs PROPOSED at a fixed geometry (paper Fig. 8)."""
    return {
        kind.value: estimate_io(
            nbytes, SSDConfig(interface=kind, cell=cell,
                              channels=channels, ways=ways), mode,
            device=device)
        for kind in InterfaceKind
    }


def compare_interfaces_trace(trace: OpTrace, *, cell: CellType = CellType.MLC,
                             total_bytes: int | None = None,
                             device: Device = None
                             ) -> dict[str, IOEstimate]:
    """Interface comparison on an arbitrary op trace."""
    return estimate_trace_interfaces(
        trace,
        SSDConfig(cell=cell, channels=trace.channels, ways=trace.ways),
        total_bytes=total_bytes, device=device)
