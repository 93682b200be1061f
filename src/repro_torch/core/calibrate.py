"""Calibration of the four write-path parameters against paper Table 3.

What is calibrated and why
--------------------------
Read-path parameters are derived analytically: bus clocks come from the
paper's Eqs. (6)/(9), data bursts from page+spare sizes, and the
per-cell-type ECC occupancy is solved exactly from the 1-way and
saturated read cells.  That leaves the write path, where we fit:

* SLC: effective page program time ``t_prog`` (datasheet typ. 200 us) and
  per-way status-poll occupancy ``t_poll``;
* MLC: paired-page program times ``(t_prog_lo, t_prog_hi)`` (datasheet
  mean 800 us) and ``t_poll``.

The fit minimises mean |error| over the 15 write cells per cell type
(5 way counts x 3 interfaces) of Table 3 with the ``eager`` policy.  Each
candidate chip is one 15-point ``sweep_steady_bandwidth_mb_s`` on the
session device.  Run ``python -m repro_torch.core.calibrate`` to
reproduce the constants frozen in ``repro_torch.core.nand``.

``stripe_crosscheck`` verifies that the simulated joint multi-channel
path shows sub-linear power-law aggregate scaling (about C**0.95) near
the retired ``STRIPE_EFFICIENCY_EXP`` fudge of C**0.92.

Every function takes ``device`` (None = the card, raising without one).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import nand as nand_mod
from repro_torch.core.interface import InterfaceKind, make_interface
from repro_torch.core.nand import CellType, NandChipParams
from repro_torch.core.paper_tables import INTERFACE_ORDER, TABLE3
from repro_torch.core.sim import SSDConfig, page_op_params

WAYS = (1, 2, 4, 8, 16)

_OP_FIELDS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
              "ctrl_us", "data_bytes")


def _write_errors(chip: NandChipParams, n_pages: int = 512,
                  device=None) -> list[float]:
    """Relative write-bandwidth errors over the 15 Table 3 cells
    (5 way counts × 3 interfaces), evaluated as ONE batched
    ``sweep_steady_bandwidth_mb_s`` design-point sweep per candidate
    chip."""
    from repro_torch.core.api import sweep_steady_bandwidth_mb_s

    cell = chip.cell.value
    cols: dict[str, list[float]] = {f: [] for f in _OP_FIELDS}
    ways_col, paper = [], []
    for ways in WAYS:
        paper_row = TABLE3[cell]["write"][ways]
        for idx, kind in enumerate(INTERFACE_ORDER):
            op = page_op_params(make_interface(InterfaceKind(kind)),
                                chip, "write", ways)
            for f in _OP_FIELDS:
                cols[f].append(float(getattr(op, f)))
            ways_col.append(ways)
            paper.append(paper_row[idx])
    sim = np.asarray(sweep_steady_bandwidth_mb_s(
        *(np.asarray(cols[f]) for f in _OP_FIELDS),
        np.asarray(ways_col, np.int32), n_pages=n_pages, device=device),
        np.float64)
    paper_arr = np.asarray(paper, np.float64)
    return list((sim - paper_arr) / paper_arr)


def fit_slc(n_pages: int = 256, device=None) -> tuple[float, float, float]:
    """(t_prog, t_poll_cycles, write MAE) of the best SLC candidate on
    the 30 x 10 grid."""
    best = (1e9, None)
    for t_prog in np.arange(205, 235, 1.0):
        for t_poll_cycles in np.arange(0.0, 50.0, 5.0):
            chip = dataclasses.replace(
                nand_mod.SLC, t_prog_lo_us=t_prog, t_prog_hi_us=t_prog,
                t_poll_cycles=t_poll_cycles)
            mae = float(np.mean(np.abs(_write_errors(chip, n_pages,
                                                     device))))
            if mae < best[0]:
                best = (mae, (t_prog, t_poll_cycles))
    (t_prog, t_poll_cycles) = best[1]
    return t_prog, t_poll_cycles, best[0]


def fit_mlc(n_pages: int = 256,
            device=None) -> tuple[float, float, float, float]:
    """(t_prog_lo, t_prog_hi, t_poll_cycles, write MAE) of the best MLC
    candidate on the 12 x 24 x 30 grid."""
    best = (1e9, None)
    for lo in np.arange(150, 450, 25.0):
        for hi in np.arange(1100, 1700, 25.0):
            for t_poll_cycles in np.arange(0.0, 150.0, 5.0):
                chip = dataclasses.replace(
                    nand_mod.MLC, t_prog_lo_us=lo, t_prog_hi_us=hi,
                    t_poll_cycles=t_poll_cycles)
                mae = float(np.mean(np.abs(_write_errors(chip, n_pages,
                                                         device))))
                if mae < best[0]:
                    best = (mae, (lo, hi, t_poll_cycles))
    lo, hi, t_poll_cycles = best[1]
    return lo, hi, t_poll_cycles, best[0]


RETIRED_STRIPE_EFFICIENCY_EXP = 0.92  # the seed's calibrated fudge


def stripe_crosscheck(device=None) -> dict[tuple[str, str], float]:
    """Fit aggregate = per_channel * C**x to the *simulated* joint
    multi-channel path and report x per (cell, mode): the mean over the
    2 x 8 and 4 x 4 CONV geometries."""
    from repro_torch.core.api import steady_bandwidth_mb_s

    out = {}
    for cell in ("slc", "mlc"):
        for mode in ("read", "write"):
            xs = []
            for channels, ways in ((2, 8), (4, 4)):
                one = steady_bandwidth_mb_s(
                    SSDConfig(cell=CellType(cell), interface=InterfaceKind.CONV,
                              channels=1, ways=ways), mode, device=device)
                many = steady_bandwidth_mb_s(
                    SSDConfig(cell=CellType(cell), interface=InterfaceKind.CONV,
                              channels=channels, ways=ways), mode,
                    device=device)
                xs.append(np.log(many / one) / np.log(channels))
            out[(cell, mode)] = float(np.mean(xs))
    return out


def main() -> None:
    t_prog, t_poll, mae = fit_slc()
    print(f"SLC : t_prog={t_prog:.1f}us t_poll={t_poll:.0f}cyc  "
          f"write-MAE={mae*100:.2f}%")
    lo, hi, poll, mae = fit_mlc()
    print(f"MLC : t_prog_lo={lo:.0f}us t_prog_hi={hi:.0f}us (mean "
          f"{0.5*(lo+hi):.0f}) t_poll={poll:.0f}cyc  write-MAE={mae*100:.2f}%")
    print("Frozen constants live in repro_torch.core.nand — update them if "
          "these differ.")
    for (cell, mode), x in stripe_crosscheck().items():
        print(f"stripe cross-check {cell}/{mode}: simulated scaling ~ "
              f"C**{x:.3f} (retired fudge: C**{RETIRED_STRIPE_EFFICIENCY_EXP})")


if __name__ == "__main__":
    main()
