"""Multi-channel SSD timeline recurrence, in PyTorch.

The state needed to advance the simulation by one page operation is

    s = (bus_free[ch_0..ch_{C-1}],
         chip_free[ch, way_0..way_{W-1}],
         ctrl_free,                       # shared ECC/FTL controller
         round_start[ch])

and the per-op update is a (max, +) expression over that state.  Each op
of a trace carries (op-class, channel, way, page-parity, arrival,
surcharge); its timing is a gather from a small op-class table
(``repro_torch.core.trace.OpClassTable``).

This module holds the configuration layer (``SSDConfig``,
``page_op_params``, the controller-arbitration charge and the closed
forms) and the ``scan`` engine: a Python loop over the trace's ops that
updates state tensors on the session's device.  Op fields are host
integers read from the numpy trace, so a step never synchronises with
the device.  The state carries a leading design-point axis [B], which is
how ``trace_end_time_batch`` evaluates one trace under a batch of timing
tables.  The state tensors are updated in place (one allocation per
fold, not per op).

Model structure (C channels, W ways each)
-----------------------------------------
READ  page:  pre = t_CMD + t_R   (off-bus: command latch + array fetch)
             slot = t_DATA(page+spare) + t_ECC   (bus + ECC occupancy)
WRITE page:  slot = t_CMD + t_DATA + t_ECC + W*t_POLL, then the chip is
             busy for t_PROG (MLC lower/upper page times alternate with
             the page parity the trace carries).

One embedded controller arbitrates all channels: per op the
clock-independent firmware share ``ctrl_us`` occupies it serially, and
with more than one channel each bus grant pays
``arb_us = (CTRL_ARB_SWITCH_FRAC + CTRL_ARB_SCAN_FRAC*(C-1)) * ctrl_us``.

Policies: ``eager`` re-issues a chip's next command as soon as the chip
is idle; ``batched`` issues round r's commands only once the channel's
bus drained round r-1.

Units: microseconds / bytes / MB-per-second (1 MB = 1e6 bytes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

from repro_torch.core.interface import (WRITE_POLL_FIXED_US, InterfaceKind,
                                        InterfaceParams)
from repro_torch.core.nand import CellType, NandChipParams

MAX_WAYS = 16
MAX_CHANNELS = 8

# Firmware channel arbitration: with more than one active channel, each
# bus grant costs the single controller thread a context switch
# (CTRL_ARB_SWITCH_FRAC of the op's firmware occupancy) plus a status
# scan of every additional channel (CTRL_ARB_SCAN_FRAC each).  A
# dedicated single-channel loop pays neither.
CTRL_ARB_SWITCH_FRAC = 0.4
CTRL_ARB_SCAN_FRAC = 0.1

Policy = Literal["eager", "batched"]
Mode = Literal["read", "write"]

POLICIES: tuple[str, ...] = ("eager", "batched")


def policy_is_batched(policy: str) -> bool:
    """Validate the ``Policy`` literal once and return its batched-ness
    (a typo like ``"bathced"`` raises instead of simulating eager)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r} "
                         f"(one of {', '.join(map(repr, POLICIES))})")
    return policy == "batched"


def controller_arb_us(ctrl_us: float, channels: int) -> float:
    """Per-op firmware arbitration charge for a C-channel controller."""
    if channels <= 1:
        return 0.0
    return (CTRL_ARB_SWITCH_FRAC
            + CTRL_ARB_SCAN_FRAC * (channels - 1)) * ctrl_us


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """One SSD design point (paper §5.3 axes)."""

    interface: InterfaceKind = InterfaceKind.PROPOSED
    cell: CellType = CellType.SLC
    channels: int = 1
    ways: int = 1
    policy: Policy = "eager"
    sata_mb_s: float = 300.0  # SATA2 ("SATA 3 Gbit/s"), paper footnote 1

    def __post_init__(self):
        policy_is_batched(self.policy)   # reject typos at construction

    def describe(self) -> str:
        return (
            f"{self.interface.value}/{self.cell.value}"
            f" {self.channels}ch x {self.ways}way [{self.policy}]"
        )


@dataclasses.dataclass(frozen=True)
class PageOpParams:
    """Scalar timing of one page-operation class.

    Recurrence consumed by all engines, per op on channel c / way w
    (arb_us = controller_arb_us(ctrl_us, C)):

        ready          = chip_free[c,w] + cmd_us + pre_us           (eager)
                         round_start[c] + (w+1)*cmd_us + pre_us     (batched)
        start          = max(bus_free[c], ready, ctrl_free) + arb_us
        bus_free'[c]   = start + slot_us
        ctrl_free'     = start + ctrl_us
        chip_free'[c,w]= bus_free'[c] + post_us(page parity)
    """

    cmd_us: float        # command/address latch occupancy
    pre_us: float        # off-bus latency after cmd (t_R for reads, 0 writes)
    slot_us: float       # bus+controller occupancy (data burst + ECC [+ polls])
    post_lo_us: float    # chip busy after slot (t_PROG; 0 for reads)
    post_hi_us: float    # odd-numbered page on a chip (MLC upper page)
    data_bytes: int      # user payload per op
    ctrl_us: float = 0.0  # FTL/firmware share of slot_us (shared controller)
    io_us: float = 0.0   # bus data-burst share of slot_us (energy phase split)

    def post_mean_us(self) -> float:
        return 0.5 * (self.post_lo_us + self.post_hi_us)


def page_op_params(
    iface: InterfaceParams, nand: NandChipParams, mode: Mode, ways: int
) -> PageOpParams:
    io_us = iface.data_us(nand.page_total_bytes)
    if mode == "read":
        return PageOpParams(
            cmd_us=iface.cmd_us,
            pre_us=nand.t_r_us,
            slot_us=io_us + iface.ecc_us(nand.cell),
            post_lo_us=0.0,
            post_hi_us=0.0,
            data_bytes=nand.page_data_bytes,
            ctrl_us=iface.ecc_fixed_us(nand.cell),
            io_us=io_us,
        )
    poll_us = (ways * nand.t_poll_cycles * iface.cycle_ns * 1e-3
               + WRITE_POLL_FIXED_US)
    return PageOpParams(
        cmd_us=iface.cmd_us,
        pre_us=0.0,
        slot_us=io_us + iface.ecc_us(nand.cell) + poll_us,
        post_lo_us=nand.t_prog_lo_us,
        post_hi_us=nand.t_prog_hi_us,
        data_bytes=nand.page_data_bytes,
        ctrl_us=iface.ecc_fixed_us(nand.cell) + poll_us,
        io_us=io_us,
    )


# ---------------------------------------------------------------------------
# scan engine: one Python step per op over device state tensors
# ---------------------------------------------------------------------------


def _trace_step_fn(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                   ctrl_us, arb_us, batched):
    """Single per-op state update — the one recurrence every scan-engine
    entry point folds.  Table columns are [B, K] float32 tensors; the op
    tuple ``(k, c, w, par, arr, ext)`` holds host scalars.  ``arr`` (the
    request arrival) lower-bounds the ready base; ``ext`` (the sampled
    reliability surcharge) extends only the op's chip occupancy.  Both
    are float32 values or 0.0, and a zero skips its operation, which is
    exact: every state value is >= 0, so max(x, 0) = x and x + 0 = x."""

    def step(state, op):
        bus_free, chip_free, ctrl_free, round_start = state
        k, c, w, par, arr, ext = op
        if w == 0:
            round_start[:, c] = bus_free[:, c]
        if batched:
            base = round_start[:, c]
            if arr:
                base = base.clamp_min(arr)
            ready = base + (w + 1) * cmd_us[:, k] + pre_us[:, k]
        else:
            base = chip_free[:, c, w]
            if arr:
                base = base.clamp_min(arr)
            ready = base + cmd_us[:, k] + pre_us[:, k]
        start = (torch.maximum(torch.maximum(bus_free[:, c], ready),
                               ctrl_free) + arb_us[:, k])
        new_bus = start + slot_us[:, k]
        post = post_lo_us[:, k] if par % 2 == 0 else post_hi_us[:, k]
        bus_free[:, c] = new_bus
        chip = new_bus + post
        if ext:
            chip = chip + ext
        chip_free[:, c, w] = chip
        return (bus_free, chip_free, start + ctrl_us[:, k], round_start)

    return step


def _trace_scan_init(n_points: int, n_channels: int, device):
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return (zeros(n_points, n_channels), zeros(n_points, n_channels, MAX_WAYS),
            zeros(n_points), zeros(n_points, n_channels))


def _host_ops(cls, channel, way, parity, arrival_us, extra_us):
    """Per-op host scalars: ints for the indices, float32-valued Python
    floats for arrival/surcharge (0.0 where absent)."""
    n = len(cls)
    zeros = [0.0] * n
    arr = zeros if arrival_us is None else \
        np.asarray(arrival_us, np.float32).tolist()
    ext = zeros if extra_us is None else \
        np.asarray(extra_us, np.float32).tolist()
    return zip(np.asarray(cls).tolist(), np.asarray(channel).tolist(),
               np.asarray(way).tolist(), np.asarray(parity).tolist(),
               arr, ext)


def _fold(table, cls, channel, way, parity, arrival_us, extra_us,
          n_channels, batched, e_op_uj=None):
    """(end [B], energy sums [B, P] | None) of one trace under a [B, K]
    stack of table columns."""
    upd = _trace_step_fn(*table, batched)
    cmd = table[0]
    state = _trace_scan_init(cmd.shape[0], n_channels, cmd.device)
    acc = None
    if e_op_uj is not None:
        acc = torch.zeros((cmd.shape[0], e_op_uj.shape[-1]),
                          dtype=torch.float32, device=cmd.device)
    for op in _host_ops(cls, channel, way, parity, arrival_us, extra_us):
        state = upd(state, op)
        if acc is not None:
            acc = acc + e_op_uj[:, op[0], op[3] % 2]
    bus_free, chip_free = state[0], state[1]
    end = torch.maximum(bus_free.amax(dim=1), chip_free.flatten(1).amax(dim=1))
    return end, acc


def trace_end_time(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                   ctrl_us, arb_us, cls, channel, way, parity,
                   arrival_us=None, extra_us=None, *, n_channels: int,
                   batched: bool) -> torch.Tensor:
    """Completion time (us, 0-d tensor) of a heterogeneous op trace on C
    channels.  Table columns are [K] float32 tensors on the device that
    runs the fold; the trace arrays are host (numpy) arrays."""
    table = tuple(x[None] for x in (cmd_us, pre_us, slot_us, post_lo_us,
                                    post_hi_us, ctrl_us, arb_us))
    end, _ = _fold(table, cls, channel, way, parity, arrival_us, extra_us,
                   n_channels, batched)
    return end[0]


def trace_end_time_energy(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                          ctrl_us, arb_us, e_op_uj, cls, channel, way,
                          parity, arrival_us=None, extra_us=None, *,
                          n_channels: int, batched: bool
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(end_us, [P] phase-energy sums in uJ): the same recurrence carrying
    the per-op phase energies ``e_op_uj[k, parity % 2]`` ([K, 2, P]),
    summed in op order."""
    table = tuple(x[None] for x in (cmd_us, pre_us, slot_us, post_lo_us,
                                    post_hi_us, ctrl_us, arb_us))
    end, acc = _fold(table, cls, channel, way, parity, arrival_us, extra_us,
                     n_channels, batched, e_op_uj=e_op_uj[None])
    return end[0], acc[0]


def trace_end_time_batch(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                         ctrl_us, arb_us, cls, channel, way, parity,
                         arrival_us=None, extra_us=None, *, n_channels: int,
                         batched: bool) -> torch.Tensor:
    """[B] completion times of one trace under [B, K] stacked tables."""
    end, _ = _fold((cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                    ctrl_us, arb_us), cls, channel, way, parity, arrival_us,
                   extra_us, n_channels, batched)
    return end


# ---------------------------------------------------------------------------
# Closed-form steady-state model (tests & napkin math)
# ---------------------------------------------------------------------------


def steady_state_mb_s(op: PageOpParams, ways: int) -> float:
    """Ideal round-robin steady state: min(bus-bound, chip-bound) rate."""
    bus_rate = op.data_bytes / op.slot_us
    cycle = op.cmd_us + op.pre_us + op.slot_us + op.post_mean_us()
    chip_rate = ways * op.data_bytes / cycle
    return min(bus_rate, chip_rate)


def saturation_ways(op: PageOpParams) -> int:
    """Smallest W with W*slot >= full chip cycle (paper's saturation point)."""
    cycle = op.cmd_us + op.pre_us + op.slot_us + op.post_mean_us()
    return max(1, math.ceil(cycle / op.slot_us))
