"""Controller energy model (paper §5.3.3, Table 5 / Fig. 10).

The paper measures average SSD-controller power per interface design
(synthesised at 130 nm, worst case: IO 2.7 V / core 1.35 V / 125 C) and
reports energy-per-byte = power / bandwidth.  The three power draws are
recoverable exactly from Table 5 x Table 3 products (E/B * MB/s = mW) and
are constant per design across modes and way counts:

    CONV       22.67 mW @ 50 MHz  SDR
    SYNC_ONLY  42.27 mW @ 83 MHz  SDR
    PROPOSED   47.04 mW @ 83 MHz  DDR

We model them as P = C_eff * V^2 * f with an effective switched
capacitance fitted per design (the DDR datapath toggles the duplicated
FIFO pairs, hence C_eff(PROPOSED) > C_eff(SYNC_ONLY)).

Phase-resolved accounting (DESIGN.md §2.4)
------------------------------------------
``ControllerEnergyModel`` above is the paper's closed form: one constant
power divided by sustained bandwidth.  It cannot price mixed workloads
or say *where* the energy goes, so this module also exposes a
**trace-level decomposition**: every op of an ``OpTrace`` charges energy
to the phases

    cmd    command/address latch cycles on the NAND_IF
    io     data burst on the bus at the interface's toggle rate
           (DDR moves 2 bytes/cycle, so its io *time* halves)
    ecc    cycle-scaled per-channel ECC datapath
    ctrl   clock-independent FTL/firmware occupancy (+ arbitration)
    array  NAND cell array busy (t_R fetch / t_PROG program) — NAND-side
           power, *excluded* from the paper's controller-only metric
    idle   controller powered but not driving an op (derived from the
           simulated makespan, never accumulated per op)

Each controller phase is priced at the design's full power P: the 130 nm
controller is synchronous and never clock-gates, so the free-running
interface clock toggles the datapath whether or not data moves — which
is exactly why the paper measures a *constant* power across way counts
and utilisations.  The phase split therefore partitions the makespan,
not the power, and the controller total recovers the paper's
``P x wall-time`` by construction (up to a <0.5 % sliver where command
latching overlaps another way's data burst on a saturated bus; the idle
remainder is clamped at zero rather than charged negatively).

Per-op phase energies are scalar gathers from the op-class table, so
every simulation engine accumulates them alongside the (max,+) end-time
recurrence (``repro_torch.core.sim.trace_end_time_energy`` and the
(max,+) kernel fold of ``repro_torch.kernels.maxplus``) and the totals
are engine-independent.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.interface import InterfaceKind

V_CORE = 1.35        # volts (paper §5.1 worst-case corner)
FREQ_HZ = {
    InterfaceKind.CONV: 50e6,
    InterfaceKind.SYNC_ONLY: 83e6,
    InterfaceKind.PROPOSED: 83e6,
}

# Controller power (W), recovered from Table 5 x Table 3 (see module doc).
POWER_W = {
    InterfaceKind.CONV: 22.67e-3,
    InterfaceKind.SYNC_ONLY: 42.27e-3,
    InterfaceKind.PROPOSED: 47.04e-3,
}

# NAND array power while the cell array is busy (t_R fetch / t_PROG
# program).  Datasheet-typical active current ~15 mA at Vcc 3.3 V for the
# paper's chips (K9F1G08U0B / K9GAG08U0M); the paper measures controller
# power only, so these never enter the Table 5 metric — they let the
# storage tier price total device energy for mixed workloads.
NAND_ARRAY_READ_W = 0.050
NAND_ARRAY_PROG_W = 0.050

#: Per-op phases, in accumulator order; ``idle`` is derived from the
#: makespan afterwards and is deliberately NOT part of this tuple.
OP_PHASES = ("cmd", "io", "ecc", "ctrl", "array")
N_OP_PHASES = len(OP_PHASES)


@dataclasses.dataclass(frozen=True)
class ControllerEnergyModel:
    kind: InterfaceKind

    @property
    def power_w(self) -> float:
        return POWER_W[self.kind]

    @property
    def c_eff_farad(self) -> float:
        """Effective switched capacitance implied by P = C V^2 f."""
        return self.power_w / (V_CORE**2 * FREQ_HZ[self.kind])

    def energy_nj_per_byte(self, bandwidth_mb_s: float) -> float:
        """nJ per transferred byte at the given sustained bandwidth."""
        if bandwidth_mb_s <= 0:
            raise ValueError("bandwidth must be positive")
        joules_per_byte = self.power_w / (bandwidth_mb_s * 1e6)
        return joules_per_byte * 1e9

    def energy_joules(self, nbytes: int, bandwidth_mb_s: float) -> float:
        """Energy to move ``nbytes`` at the given bandwidth (controller only)."""
        if bandwidth_mb_s <= 0:
            raise ValueError("bandwidth must be positive")
        return self.power_w * (nbytes / (bandwidth_mb_s * 1e6))


def energy_nj_per_byte(kind: InterfaceKind | str, bandwidth_mb_s: float) -> float:
    return ControllerEnergyModel(InterfaceKind(kind)).energy_nj_per_byte(bandwidth_mb_s)


# ---------------------------------------------------------------------------
# Phase-resolved trace accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    """Phase-resolved energy of one simulated trace window (joules).

    ``cmd/io/ecc/ctrl`` are controller phases accumulated per op by the
    engines; ``idle_j`` is the remainder of the constant-power envelope
    ``channels * P * end_us``; ``array_j`` is NAND-side and excluded
    from the paper's controller-only metric."""

    cmd_j: float
    io_j: float
    ecc_j: float
    ctrl_j: float
    idle_j: float
    array_j: float
    end_us: float
    payload_bytes: int
    kind: InterfaceKind
    channels: int = 1

    @property
    def controller_j(self) -> float:
        """Controller energy — the paper's Table 5 / Fig. 10 quantity."""
        return self.cmd_j + self.io_j + self.ecc_j + self.ctrl_j + self.idle_j

    @property
    def total_j(self) -> float:
        return self.controller_j + self.array_j

    @property
    def nj_per_byte(self) -> float:
        """Controller nJ per *payload* byte (hedged duplicates burn
        energy but deliver no payload, so they raise this)."""
        if self.payload_bytes <= 0:
            raise ValueError("no payload bytes to amortise energy over")
        return self.controller_j / self.payload_bytes * 1e9

    def op_sums_uj(self) -> np.ndarray:
        """[N_OP_PHASES] accumulator the engines produced (microjoules)."""
        return np.array([self.cmd_j, self.io_j, self.ecc_j, self.ctrl_j,
                         self.array_j], np.float64) * 1e6

    def extrapolated(self, scale: float, end_us: float) -> "EnergyBreakdown":
        """Scale the simulated window to a longer steady run: per-op
        phases scale by op count (``scale``), idle re-derives from the
        extrapolated wall time ``end_us`` (so e.g. a SATA-capped stream
        converts the extra wall-clock into idle energy)."""
        if scale < 0 or end_us < 0:
            raise ValueError("extrapolation must be non-negative")
        return breakdown_from_sums(
            self.op_sums_uj() * scale, end_us=end_us,
            payload_bytes=int(round(self.payload_bytes * scale)),
            kind=self.kind, channels=self.channels)

    def describe(self) -> str:
        mj = 1e3
        return (f"{self.kind.value}: {self.controller_j * mj:.2f} mJ ctrl "
                f"(cmd {self.cmd_j * mj:.3f} / io {self.io_j * mj:.3f} / "
                f"ecc {self.ecc_j * mj:.3f} / fw {self.ctrl_j * mj:.3f} / "
                f"idle {self.idle_j * mj:.3f}) + {self.array_j * mj:.2f} mJ "
                f"array over {self.end_us / 1e3:.2f} ms")


def op_phase_energy_uj(table, kind: InterfaceKind | str) -> np.ndarray:
    """[K, 2, N_OP_PHASES] per-op phase energies (microjoules = W * us).

    Axis 1 is MLC page parity (lower/upper program time differ); only
    the ``array`` phase depends on it.  Requires the table's ``io_us``
    column (the bus data-burst time) to split the slot into
    io / cycle-scaled ecc / firmware parts:

        slot_us = io_us + ecc_scaled_us + ctrl_us      (both op classes)
    """
    kind = InterfaceKind(kind)
    p_w = POWER_W[kind]
    if getattr(table, "io_us", None) is None:
        raise ValueError(
            "op-class table carries no io_us column; build it with "
            "repro_torch.core.trace.op_class_table")
    cmd = np.asarray(table.cmd_us, np.float64)
    io = np.asarray(table.io_us, np.float64)
    slot = np.asarray(table.slot_us, np.float64)
    ctrl = np.asarray(table.ctrl_us, np.float64)
    arb = np.asarray(table.arb_us, np.float64)
    ecc_scaled = np.maximum(slot - io - ctrl, 0.0)
    pre = np.asarray(table.pre_us, np.float64)
    post = np.stack([np.asarray(table.post_lo_us, np.float64),
                     np.asarray(table.post_hi_us, np.float64)], axis=1)
    array = (NAND_ARRAY_READ_W * pre)[:, None] + NAND_ARRAY_PROG_W * post
    static = np.stack([p_w * cmd, p_w * io, p_w * ecc_scaled,
                       p_w * (ctrl + arb)], axis=1)          # [K, 4]
    e = np.concatenate(
        [np.broadcast_to(static[:, None, :], (len(cmd), 2, 4)),
         array[:, :, None]], axis=2)
    return np.ascontiguousarray(e, dtype=np.float32)


def breakdown_from_sums(op_sums_uj, end_us: float, payload_bytes: int,
                        kind: InterfaceKind | str,
                        channels: int = 1) -> EnergyBreakdown:
    """Assemble an ``EnergyBreakdown`` from engine accumulator sums.

    ``op_sums_uj`` is the [N_OP_PHASES] per-op accumulator (microjoules)
    every engine produces alongside the end-time recurrence; ``idle`` is
    the remainder of the constant-power envelope
    ``channels * P * end_us`` after the controller phases (clamped at
    zero for the saturated-bus overlap sliver, see module doc)."""
    kind = InterfaceKind(kind)
    s = np.asarray(op_sums_uj, np.float64)
    if s.shape != (N_OP_PHASES,):
        raise ValueError(f"expected [{N_OP_PHASES}] phase sums, got {s.shape}")
    cmd, io, ecc, ctrl, array = (float(x) for x in s)
    busy = cmd + io + ecc + ctrl
    idle = max(0.0, channels * POWER_W[kind] * float(end_us) - busy)
    uj = 1e-6
    return EnergyBreakdown(
        cmd_j=cmd * uj, io_j=io * uj, ecc_j=ecc * uj, ctrl_j=ctrl * uj,
        idle_j=idle * uj, array_j=array * uj,
        end_us=float(end_us), payload_bytes=int(payload_bytes),
        kind=kind, channels=channels)
