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
the device.  ``trace_completions`` emits each op's completion for
request-latency percentiles, and ``dispatch_trace`` is the joint
dispatch+simulate fold behind the dynamic scheduling policies of
``repro_torch.core.sched``.  The state carries a leading design-point axis [B], which is
how ``trace_end_time_batch`` evaluates one trace under a batch of timing
tables.  The state tensors are updated in place (one allocation per
fold, not per op).

The log-depth engines evaluate the same recurrence as (max,+) products
(``repro_torch.core.maxplus_form``): ``trace_end_time_prefix[_energy,
_batch]`` (the ``prefix`` engine: segment products by the structured row
fold, combined by a matvec chain or a log-depth product tree) and
``_squaring_end_time`` / ``_sweep_squaring`` (the ``squaring`` engine:
one period block raised to the stream length by repeated squaring).

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
          n_channels, batched, e_op_uj=None, state=None, acc=None,
          comp=None):
    """(end [B], energy sums [B, P] | None, state) of one trace under a
    [B, K] stack of table columns.  ``state`` / ``acc`` start the fold
    from a carried state, which is updated in place; by default it
    starts from zero.  ``comp`` ([B, T], on the table's device) receives
    each op's ``chip_free[c, w]`` after its step: one device copy an op,
    read back by the caller once."""
    upd = _trace_step_fn(*table, batched)
    cmd = table[0]
    if state is None:
        state = _trace_scan_init(cmd.shape[0], n_channels, cmd.device)
    if e_op_uj is not None and acc is None:
        acc = torch.zeros((cmd.shape[0], e_op_uj.shape[-1]),
                          dtype=torch.float32, device=cmd.device)
    for t, op in enumerate(_host_ops(cls, channel, way, parity, arrival_us,
                                     extra_us)):
        state = upd(state, op)
        if e_op_uj is not None:
            acc = acc + e_op_uj[:, op[0], op[3] % 2]
        if comp is not None:
            comp[:, t] = state[1][:, op[1], op[2]]
    bus_free, chip_free = state[0], state[1]
    end = torch.maximum(bus_free.amax(dim=1), chip_free.flatten(1).amax(dim=1))
    return end, acc, state


def trace_end_time(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                   ctrl_us, arb_us, cls, channel, way, parity,
                   arrival_us=None, extra_us=None, *, n_channels: int,
                   batched: bool) -> torch.Tensor:
    """Completion time (us, 0-d tensor) of a heterogeneous op trace on C
    channels.  Table columns are [K] float32 tensors on the device that
    runs the fold; the trace arrays are host (numpy) arrays."""
    table = tuple(x[None] for x in (cmd_us, pre_us, slot_us, post_lo_us,
                                    post_hi_us, ctrl_us, arb_us))
    end, _, _ = _fold(table, cls, channel, way, parity, arrival_us,
                      extra_us, n_channels, batched)
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
    end, acc, _ = _fold(table, cls, channel, way, parity, arrival_us,
                        extra_us, n_channels, batched, e_op_uj=e_op_uj[None])
    return end[0], acc[0]


def trace_end_time_batch(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                         ctrl_us, arb_us, cls, channel, way, parity,
                         arrival_us=None, extra_us=None, *, n_channels: int,
                         batched: bool) -> torch.Tensor:
    """[B] completion times of one trace under [B, K] stacked tables."""
    end, _, _ = _fold((cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                       ctrl_us, arb_us), cls, channel, way, parity,
                      arrival_us, extra_us, n_channels, batched)
    return end


def trace_completions(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                      ctrl_us, arb_us, cls, channel, way, parity,
                      arrival_us=None, extra_us=None, *, n_channels: int,
                      batched: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(end_us, [T] per-op completion times), both on the table's device:
    the scan recurrence emitting each op's ``chip_free[c, w]`` after its
    step — bus drain for reads (data delivered), bus drain + t_PROG for
    writes (page durable).  The latency-extraction fold behind per-request
    percentiles; the end time is ``trace_end_time``'s."""
    table = tuple(x[None] for x in (cmd_us, pre_us, slot_us, post_lo_us,
                                    post_hi_us, ctrl_us, arb_us))
    comp = torch.empty((1, len(cls)), dtype=torch.float32,
                       device=cmd_us.device)
    end, _, _ = _fold(table, cls, channel, way, parity, arrival_us,
                      extra_us, n_channels, batched, comp=comp)
    return end[0], comp[0]


# ---------------------------------------------------------------------------
# lane-batched masked folds: B independent traces stepped together
# ---------------------------------------------------------------------------


def _trace_end_time_masked_impl(cmd_us, pre_us, slot_us, post_lo_us,
                                post_hi_us, ctrl_us, arb_us, cls, channel,
                                way, parity, arrival, extra, valid,
                                n_channels: int, batched: bool,
                                want_comp: bool = False):
    """[B] completion times of B lanes, each folding its own op sequence.

    Table columns are [K] (one table shared by every lane) or [B, K] (a
    table per lane); the op arrays are [B, T] tensors on the table's
    device.  Step t applies op t of every lane at once: the same float32
    operations, in the same order, as ``_trace_step_fn``.  ``valid``
    ([B, T] bool, or None for all valid) marks padding: an invalid op
    writes back the old values through ``torch.where``, so the lane's
    state stays bitwise unchanged.  The per-op table entries (and the
    batched policy's ``(w + 1) * cmd``) are gathered once before the
    loop; the state lives in [B, C] / [B, C * MAX_WAYS] tensors updated
    in place.  With ``want_comp`` it returns ``(end [B], comp [B, T])``,
    ``comp[:, t]`` the lane's ``chip_free[c, w]`` after step t (for a
    padding op, the unchanged value)."""
    table = (cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us,
             arb_us)
    b, t_len = cls.shape
    dev = cls.device
    cls = cls.long()
    channel = channel.long()
    way = way.long()
    cmd, pre, slot, lo, hi, ctrl, arb = (
        torch.gather(x.expand(b, -1), 1, cls) for x in table)
    if batched:
        cmd = (way + 1).to(torch.float32) * cmd
    post = torch.where(parity % 2 == 0, lo, hi)
    arrival = arrival.to(torch.float32)
    extra = extra.to(torch.float32)
    chip_ix = channel * MAX_WAYS + way
    first = way == 0

    bus = torch.zeros((b, n_channels), dtype=torch.float32, device=dev)
    chip = torch.zeros((b, n_channels * MAX_WAYS), dtype=torch.float32,
                       device=dev)
    ctrl_free = torch.zeros((b,), dtype=torch.float32, device=dev)
    round_start = torch.zeros((b, n_channels), dtype=torch.float32,
                              device=dev)

    comp = (torch.empty((b, t_len), dtype=torch.float32, device=dev)
            if want_comp else None)

    def put(dst, ix, new, old, ok):
        val = new if ok is None else torch.where(ok, new, old)
        dst.scatter_(1, ix, val[:, None])
        return val

    for t in range(t_len):
        c = channel[:, t, None]
        cw = chip_ix[:, t, None]
        ok = None if valid is None else valid[:, t]
        bus_c = torch.gather(bus, 1, c)[:, 0]
        chip_old = torch.gather(chip, 1, cw)[:, 0]
        if batched:
            rs_old = torch.gather(round_start, 1, c)[:, 0]
            rs = torch.where(first[:, t], bus_c, rs_old)
            put(round_start, c, rs, rs_old, ok)
            base = torch.maximum(rs, arrival[:, t])
        else:
            base = torch.maximum(chip_old, arrival[:, t])
        ready = base + cmd[:, t] + pre[:, t]
        start = (torch.maximum(torch.maximum(bus_c, ready), ctrl_free)
                 + arb[:, t])
        new_bus = start + slot[:, t]
        put(bus, c, new_bus, bus_c, ok)
        chip_new = put(chip, cw, new_bus + post[:, t] + extra[:, t],
                       chip_old, ok)
        if comp is not None:
            comp[:, t] = chip_new
        new_ctrl = start + ctrl[:, t]
        ctrl_free = new_ctrl if ok is None else torch.where(ok, new_ctrl,
                                                            ctrl_free)
    end = torch.maximum(bus.amax(dim=1), chip.amax(dim=1))
    return end if comp is None else (end, comp)


def _lane_tensors(device, *arrays):
    return tuple(torch.as_tensor(np.asarray(x), device=device)
                 for x in arrays)


def trace_end_time_masked(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                          ctrl_us, arb_us, cls, channel, way, parity,
                          arrival_us, extra_us, valid, *, n_channels: int,
                          batched: bool) -> torch.Tensor:
    """``trace_end_time`` with a validity mask over [T] op arrays:
    invalid (padding) ops leave the state bitwise unchanged, so a trace
    padded to a length bucket gives the identical end time (0-d)."""
    ops = _lane_tensors(cmd_us.device, cls, channel, way, parity,
                        arrival_us, extra_us, valid)
    return _trace_end_time_masked_impl(
        cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us, arb_us,
        *(x[None] for x in ops), n_channels, batched)[0]


def trace_end_time_masked_many(cmd_us, pre_us, slot_us, post_lo_us,
                               post_hi_us, ctrl_us, arb_us, cls, channel,
                               way, parity, arrival_us, extra_us, valid, *,
                               n_channels: int, batched: bool
                               ) -> torch.Tensor:
    """[B] completion times of a bucket of padded traces ([B, T] op
    arrays, host or device) under one [K] timing table — the packed
    serving path behind ``Simulator.run_many(engine="scan")``."""
    ops = _lane_tensors(cmd_us.device, cls, channel, way, parity,
                        arrival_us, extra_us, valid)
    return _trace_end_time_masked_impl(
        cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us, arb_us,
        *ops, n_channels, batched)


def trace_completions_masked(cmd_us, pre_us, slot_us, post_lo_us,
                             post_hi_us, ctrl_us, arb_us, cls, channel, way,
                             parity, arrival_us, extra_us, valid, *,
                             n_channels: int, batched: bool
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``trace_completions`` over a padded length bucket ([T] op arrays
    and a validity mask): padding ops leave the state bitwise unchanged
    and their emitted completions are trailing values the caller slices
    off."""
    ops = _lane_tensors(cmd_us.device, cls, channel, way, parity,
                        arrival_us, extra_us, valid)
    end, comp = _trace_end_time_masked_impl(
        cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us, arb_us,
        *(x[None] for x in ops), n_channels, batched, want_comp=True)
    return end[0], comp[0]


# ---------------------------------------------------------------------------
# streaming: one chunk of a trace from a carried state
# ---------------------------------------------------------------------------


def trace_chunk_init(n_channels: int, n_phases: int, device=None):
    """Initial carry for :func:`trace_chunk_fold`: the zero occupancy
    state ``(bus [C], chip [C, MAX_WAYS], ctrl [], round_start [C])``
    and a zero [P] phase-energy accumulator."""
    state = tuple(x[0] for x in _trace_scan_init(1, n_channels, device))
    return state, torch.zeros((n_phases,), dtype=torch.float32,
                              device=device)


def trace_chunk_fold(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                     ctrl_us, arb_us, e_op_uj, cls, channel, way, parity,
                     arrival_us, extra_us, bus_free, chip_free, ctrl_free,
                     round_start, energy_acc, *, n_channels: int,
                     batched: bool, want_comp: bool = False):
    """One chunk of the streaming engine: fold the chunk's ops starting
    from the carried occupancy state and energy accumulator, and return
    ``((bus, chip, ctrl, round_start), energy_acc, end_us, comp)``, where
    ``comp`` is the chunk's [L] per-op completions with ``want_comp`` and
    None without (a fold that needs none pays no copy an op).  Every op
    runs the scan engine's step, so chaining chunks of any size
    reproduces ``trace_end_time`` / ``trace_end_time_energy`` bit for
    bit.  The op arrays are host arrays of the chunk's real ops: chunks
    are not padded, since eager PyTorch has no compile to share.
    ``e_op_uj`` ([K, 2, P]) may be None for an end-time-only fold (the
    accumulator then passes through).  The carried tensors are not
    modified: the fold works on copies."""
    table = tuple(x[None] for x in (cmd_us, pre_us, slot_us, post_lo_us,
                                    post_hi_us, ctrl_us, arb_us))
    state = tuple(x[None].clone() for x in (bus_free, chip_free, ctrl_free,
                                            round_start))
    acc = energy_acc[None]
    comp = (torch.empty((1, len(cls)), dtype=torch.float32,
                        device=cmd_us.device) if want_comp else None)
    end, acc, state = _fold(
        table, cls, channel, way, parity, arrival_us, extra_us, n_channels,
        batched, e_op_uj=None if e_op_uj is None else e_op_uj[None],
        state=state, acc=acc, comp=comp)
    return (tuple(x[0] for x in state), acc[0], end[0],
            None if comp is None else comp[0])


# ---------------------------------------------------------------------------
# dynamic dispatch: the placement decided inside the fold
# ---------------------------------------------------------------------------

#: Dynamic dispatch rules evaluated inside the joint fold (sched-layer
#: names; the static policies lower offline in ``repro_torch.core.sched``).
DISPATCH_RULES: tuple[str, ...] = ("least_loaded", "earliest_ready")


def dispatch_trace(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us,
                   arb_us, cls, arrival_us, *, n_channels: int, n_ways: int,
                   rule: str = "least_loaded", extra_us=None, retired=None):
    """Joint dispatch + simulate fold (DESIGN.md §2.6): the carried
    occupancy row *drives* the channel/way assignment, one decision per
    op inside the same loop that advances the timeline.

    Rules:

    * ``least_loaded``  — the op goes to the chip with the smallest busy
      horizon ``max(bus_free[c], chip_free[c, w])`` (ties break to the
      lowest flat index);
    * ``earliest_ready`` — the op goes to the channel whose bus drains
      first, then to that channel's least-loaded way.

    Table columns are [K] float32 tensors on the device that runs the
    fold; ``cls``, ``arrival_us`` and ``extra_us`` are host arrays [T]
    (per-op host scalars, as in the scan engine), ``retired`` a [C, W]
    bool mask of bad-block chips.  The decision stays on the device: the
    chosen flat chip index is an ``argmin`` result that indexes the state
    tensors (``index_select`` / ``index_copy_``), so no step waits for
    the host.  Page parity comes from a carried per-chip op counter.

    Each op computes, in this float32 order (the JAX package's):
    ``ready = (max(chip_free[c, w], arr) + cmd) + pre``, ``start =
    max(max(bus_free[c], ready), ctrl_free) + arb``, ``new_bus = start +
    slot``, ``comp = (new_bus + post[parity]) + ext``.  ``extra_us``
    extends the chip's occupancy only, never the bus or the controller;
    a retired chip's horizon is +inf under ``least_loaded`` and its way
    is masked out of ``earliest_ready``'s choice (each channel keeps a
    live way, which the ``FaultSampler`` retirement draw guarantees).

    Returns ``(end_us, completion[T], channel[T], way[T], parity[T])``
    as tensors on the fold's device, filled in device buffers and meant
    to be read back once."""
    if rule not in DISPATCH_RULES:
        raise ValueError(f"unknown dispatch rule {rule!r} "
                         f"(one of {', '.join(DISPATCH_RULES)})")
    least_loaded = rule == "least_loaded"
    dev = cmd_us.device
    n_chips = n_channels * n_ways
    n = len(cls)
    cls_h = np.asarray(cls).tolist()
    arr_h = np.asarray(arrival_us, np.float32).tolist()
    ext_h = ([0.0] * n if extra_us is None
             else np.asarray(extra_us, np.float32).tolist())
    ret = None
    if retired is not None:
        mask = np.asarray(torch.as_tensor(retired).cpu(), bool)
        if mask.shape != (n_channels, n_ways):
            raise ValueError(f"retired must be [{n_channels}, {n_ways}], "
                             f"got {mask.shape}")
        if mask.any():
            ret = torch.as_tensor(mask, device=dev)
    # per-class [1] views of the table, and [2] post times by parity
    one = [[x[k:k + 1] for k in range(len(x))]
           for x in (cmd_us, pre_us, slot_us, ctrl_us, arb_us)]
    cmd, pre, slot, ctrl_k, arb = one
    post = torch.stack([post_lo_us, post_hi_us], dim=1)
    post_k = [post[k] for k in range(post.shape[0])]

    def zeros(size, dtype=torch.float32):
        return torch.zeros(size, dtype=dtype, device=dev)
    bus = zeros(n_channels)
    chip = zeros(n_chips)
    chip2 = chip.view(n_channels, n_ways)
    ctrl = zeros(1)
    counts = zeros(n_chips, torch.int64)
    inc = torch.ones(1, dtype=torch.int64, device=dev)
    comp_buf = zeros(n)
    flat_buf = zeros(n, torch.int64)
    par_buf = zeros(n, torch.int64)
    inf = float("inf")
    for t in range(n):
        k = cls_h[t]
        if least_loaded:
            horizon = torch.maximum(chip2, bus[:, None])
            if ret is not None:
                horizon.masked_fill_(ret, inf)
            flat = horizon.view(-1).argmin().view(1)
            c = torch.div(flat, n_ways, rounding_mode="floor")
        else:
            c = bus.argmin().view(1)
            row = chip2.index_select(0, c).view(-1)
            if ret is not None:
                row = row.masked_fill(ret.index_select(0, c).view(-1), inf)
            flat = c * n_ways + row.argmin()
        par = counts.index_select(0, flat) & 1
        ready = chip.index_select(0, flat)
        if arr_h[t]:
            ready = ready.clamp_min(arr_h[t])
        ready = ready + cmd[k] + pre[k]
        start = torch.maximum(torch.maximum(bus.index_select(0, c), ready),
                              ctrl) + arb[k]
        new_bus = start + slot[k]
        done = new_bus + post_k[k].index_select(0, par)
        if ext_h[t]:
            done = done + ext_h[t]
        bus.index_copy_(0, c, new_bus)
        chip.index_copy_(0, flat, done)
        ctrl = start + ctrl_k[k]
        counts.index_add_(0, flat, inc)
        comp_buf[t:t + 1] = done
        flat_buf[t:t + 1] = flat
        par_buf[t:t + 1] = par
    end = torch.maximum(bus.max(), chip.max())
    chan = torch.div(flat_buf, n_ways, rounding_mode="floor")
    return (end, comp_buf, chan.to(torch.int32),
            (flat_buf - chan * n_ways).to(torch.int32),
            par_buf.to(torch.int32))


# ---------------------------------------------------------------------------
# log-depth engines: segmented prefix and periodic squaring
# ---------------------------------------------------------------------------

COMBINES: tuple[str, ...] = ("chain", "assoc")


def _trace_end_time_prefix_impl(table, cls, channel, way, parity, arrival,
                                extra, n_channels: int, n_ways: int,
                                batched: bool, segment_len, combine: str,
                                valid=None) -> torch.Tensor:
    """[B] completion times of one trace under [B, K] table columns."""
    from repro_torch.core import maxplus_form as mf  # mf imports this module

    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r} "
                         "(one of 'chain', 'assoc')")
    prods = mf.structured_segment_products(
        *table, cls, channel, way, parity, arrival, extra,
        channels=n_channels, ways=n_ways, batched=batched,
        segment_len=segment_len if segment_len is not None else 1,
        valid=valid)                                   # [B, S, N, N]
    layout = mf.StateLayout(n_channels, n_ways)
    s0 = torch.zeros((prods.shape[0], layout.n_state), dtype=torch.float32,
                     device=prods.device)
    if combine == "assoc":        # log-depth dense combine
        final = mf.maxplus_fold_assoc(prods.movedim(1, 0), s0)
    else:                         # O(S) matvec chain: no dense matmuls
        final = s0
        for s in range(prods.shape[1]):
            final = mf.maxplus_matvec(prods[:, s], final)
    return final[:, :layout.n_completion_rows].amax(dim=1)


def trace_end_time_prefix(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                          ctrl_us, arb_us, cls, channel, way, parity,
                          arrival_us=None, extra_us=None, *, n_channels: int,
                          n_ways: int, batched: bool,
                          segment_len: int | None = 64,
                          combine: str = "chain",
                          valid=None) -> torch.Tensor:
    """Same recurrence as ``trace_end_time`` (0-d tensor), evaluated in
    O(L + S) depth (S = ceil(T/L)): the trace's S segment products come
    from the structured row fold of
    ``repro_torch.core.maxplus_form.structured_segment_products`` (the
    scan recurrence on N-row-valued resource times — O(T·N) work, depth
    L), then combine across segments.  ``combine="chain"`` folds the S
    products into the initial state with O(S) (max,+) matvecs;
    ``combine="assoc"`` combines them in a log-depth tree of dense
    matmuls — O(L + log S) total depth.  Table columns are [K] float32
    tensors on the device that runs the fold; the per-op arrays are host
    arrays or tensors.

    ``n_ways`` bounds the way indices and sets the state layout.
    ``segment_len=None`` folds each op as its own segment — with
    ``combine="assoc"`` the pure O(log T)-depth dense form, whose
    [T, N, N] products do not fit one card at sweep size (a 65536-op
    trace on 8 x 16 needs 5.6 GB a design point).  ``valid`` (optional
    [T] bool) masks ops out of the product exactly."""
    table = tuple(x[None] for x in (cmd_us, pre_us, slot_us, post_lo_us,
                                    post_hi_us, ctrl_us, arb_us))
    return _trace_end_time_prefix_impl(
        table, cls, channel, way, parity, arrival_us, extra_us, n_channels,
        n_ways, batched, segment_len, combine, valid)[0]


def trace_end_time_prefix_energy(cmd_us, pre_us, slot_us, post_lo_us,
                                 post_hi_us, ctrl_us, arb_us, e_op_uj, cls,
                                 channel, way, parity, arrival_us=None,
                                 extra_us=None, *, n_channels: int,
                                 n_ways: int, batched: bool,
                                 segment_len: int | None = 64,
                                 combine: str = "chain"
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(end_us, [P] phase-energy sums in uJ) via the segmented prefix
    engine: energy is (+, +)-linear in the ops, so it rides the same
    segment chunking as a plain per-segment sum combined across
    segments (``e_op_uj`` is [K, 2, P])."""
    from repro_torch.core import maxplus_form as mf

    end = trace_end_time_prefix(
        cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us, arb_us,
        cls, channel, way, parity, arrival_us, extra_us,
        n_channels=n_channels, n_ways=n_ways, batched=batched,
        segment_len=segment_len, combine=combine)
    seg = mf.structured_segment_energy(
        e_op_uj, cls, parity,
        segment_len=segment_len if segment_len is not None else 1)
    return end, seg.sum(dim=0)


def trace_end_time_prefix_batch(cmd_us, pre_us, slot_us, post_lo_us,
                                post_hi_us, ctrl_us, arb_us, cls, channel,
                                way, parity, arrival_us=None, extra_us=None,
                                *, n_channels: int, n_ways: int,
                                batched: bool, segment_len: int | None = 64,
                                combine: str = "chain") -> torch.Tensor:
    """[B] completion times: one trace under [B, K] stacked design-point
    tables.  The structured segment fold runs over B×S lanes in one pass
    (the per-op indices are shared by the batch) — the sweep-scaling form
    of the prefix engine.  At the 64-point, 65536-op 8 x 16 sweep it
    holds [64, 1024, 147, 146] products (5.6 GB) with ``segment_len=64``;
    ``segment_len=None`` there would need 64 times that."""
    return _trace_end_time_prefix_impl(
        (cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us, arb_us),
        cls, channel, way, parity, arrival_us, extra_us, n_channels, n_ways,
        batched, segment_len, combine)


def _squaring_end_time(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                       ctrl_us, ways: int, *, n_pages: int,
                       batched: bool) -> torch.Tensor:
    """[B] homogeneous single-channel completion times of B design points
    sharing one way count, via periodic matrix squaring: fold one
    2·MAX_WAYS-op period block with the structured row fold, then square
    to ``n_pages`` — O(log n_pages) dense (max,+) matmuls plus one
    structured remainder fold.  The op-class scalars are [B] float32
    tensors (or 0-d for one point).  Requires ways | MAX_WAYS so the block
    is a whole number of true periods (the paper's power-of-two grid)."""
    from repro_torch.core import maxplus_form as mf

    cols = tuple(x.reshape(-1, 1) for x in (cmd_us, pre_us, slot_us,
                                            post_lo_us, post_hi_us, ctrl_us))
    table = cols + (torch.zeros_like(cols[0]),)

    def block_product(n_ops: int) -> torch.Tensor:
        i = np.arange(n_ops)
        zeros = np.zeros(n_ops, np.int32)
        return mf.structured_segment_products(
            *table, zeros, zeros, (i % ways).astype(np.int32),
            ((i // ways) % 2).astype(np.int32), channels=1, ways=MAX_WAYS,
            batched=batched, segment_len=n_ops)[:, 0]

    q, r = divmod(int(n_pages), 2 * MAX_WAYS)
    if q:
        total = mf.maxplus_matrix_power(block_product(2 * MAX_WAYS), q)
        if r:
            total = mf.maxplus_matmul(block_product(r), total)
    else:
        total = block_product(r)
    s0 = torch.zeros((mf.N_STATE,), dtype=torch.float32, device=total.device)
    final = mf.maxplus_matvec(total, s0)
    return final[:, :mf.DEFAULT_LAYOUT.n_completion_rows].amax(dim=1)


def _validate_squaring_ways(ways) -> None:
    """engine="squaring" folds a 2·MAX_WAYS-op period block, which only
    tiles the stream when ways | MAX_WAYS (the paper's power-of-two
    grid) — reject anything else loudly rather than silently misalign."""
    arr = np.asarray(ways)
    if np.any(arr < 1) or np.any(MAX_WAYS % np.maximum(arr, 1) != 0):
        raise ValueError(
            f"engine='squaring' requires ways dividing {MAX_WAYS}, got "
            f"{arr.tolist()}")


# ---------------------------------------------------------------------------
# homogeneous design-point sweep
# ---------------------------------------------------------------------------


def _sweep_inputs(scalars, data_bytes, device):
    """[B] float32 op-class scalar tensors and the payload bytes, which
    keep an integer type as int32, as JAX does."""
    cols = tuple(torch.as_tensor(np.asarray(x, np.float32), device=device)
                 .reshape(-1) for x in scalars)
    nbytes = np.asarray(data_bytes)
    nbytes = torch.as_tensor(nbytes.astype(
        np.int32 if np.issubdtype(nbytes.dtype, np.integer) else np.float32),
        device=device)
    return cols, nbytes


def _sweep_squaring(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us,
                    ctrl_us, data_bytes, ways, *, n_pages: int, batched: bool,
                    device) -> torch.Tensor:
    """[B] single-channel steady bandwidths (MB/s) of B design points by
    periodic squaring, each point in O(log n_pages) (max,+) matmuls; the
    points are grouped by way count, one batched squaring a group.  Every
    entry of ``ways`` must divide MAX_WAYS (the caller validates)."""
    cols, nbytes = _sweep_inputs((cmd_us, pre_us, slot_us, post_lo_us,
                                  post_hi_us, ctrl_us), data_bytes, device)
    w = np.asarray(ways, np.int64).reshape(-1)
    end = torch.empty_like(cols[0])
    for ways_g in np.unique(w):
        sel = torch.as_tensor(np.flatnonzero(w == ways_g), device=device)
        end[sel] = _squaring_end_time(*(x[sel] for x in cols), int(ways_g),
                                      n_pages=n_pages, batched=batched)
    return (n_pages * nbytes) / end


def _sweep_scan(cmd_us, pre_us, slot_us, post_lo_us, post_hi_us, ctrl_us,
                data_bytes, ways, *, n_pages: int, batched: bool,
                device) -> torch.Tensor:
    """[B] single-channel steady bandwidths (MB/s) of B design points,
    each its own op-class scalars and way count, folded as B lanes of
    one ``n_pages`` round-robin stream.  Charges the shared-controller
    occupancy ``ctrl_us`` exactly like the per-point channel path; no
    arbitration (one channel)."""
    cols, nbytes = _sweep_inputs((cmd_us, pre_us, slot_us, post_lo_us,
                                  post_hi_us, ctrl_us), data_bytes, device)
    cols = tuple(x[:, None] for x in cols)
    b = cols[0].shape[0]
    arb = torch.zeros((b, 1), dtype=torch.float32, device=device)
    w = torch.as_tensor(np.asarray(ways, np.int32), device=device)
    i = torch.arange(n_pages, dtype=torch.int32, device=device)
    way = torch.remainder(i[None, :], w[:, None])
    parity = (i[None, :] // w[:, None]) % 2
    zeros_i = torch.zeros((b, n_pages), dtype=torch.int32, device=device)
    zeros_f = torch.zeros((b, n_pages), dtype=torch.float32, device=device)
    end = _trace_end_time_masked_impl(
        *cols, arb, zeros_i, zeros_i, way, parity, zeros_f, zeros_f, None,
        1, batched)
    return (n_pages * nbytes) / end


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
