"""NAND flash chip models (behavioural timing level).

Datasheet-derived parameters for the two cell types used in the paper:

* SLC — modelled after Samsung K9F1G08U0B [26]: 2 KiB + 64 B pages,
  t_R = 25 us.
* MLC — modelled after Samsung K9GAG08U0M [27]: 4 KiB + 128 B pages,
  t_R = 60 us.

``t_prog_eff`` is the *effective* per-page program occupancy seen by the
interface (cell programming + program-verify + status handshake as one
lump).  Datasheet "typical" values (200 us SLC / 800 us MLC) underestimate
what the paper's RTL co-simulation charges per page; we calibrate one
scalar per cell type against Table 3 (see the JAX package's
``repro.core.calibrate``) and
disclose the fitted value here.  Everything else is straight datasheet.
"""

from __future__ import annotations

import dataclasses
import enum


class CellType(str, enum.Enum):
    SLC = "slc"
    MLC = "mlc"


@dataclasses.dataclass(frozen=True)
class NandChipParams:
    cell: CellType
    page_data_bytes: int      # user data per page
    page_spare_bytes: int     # spare (ECC/meta) bytes transferred with the page
    t_r_us: float             # cell array -> page register fetch time
    t_prog_lo_us: float       # effective program time, even pages (SLC: all)
    t_prog_hi_us: float       # effective program time, odd pages (MLC upper)
    t_poll_cycles: float      # per-way status-poll occupancy per write slot,
                              # charged in BUS CYCLES (ready/busy polling runs
                              # at the interface clock, so the DDR interface
                              # polls proportionally faster)
    t_byte_ns: float = 12.0   # page register <-> latch transfer time [28]
    t_bers_us: float = 1500.0  # block erase time (t_BERS) — consumed by the
                               # FTL stage's ERASE op class (DESIGN.md §2.10)

    @property
    def page_total_bytes(self) -> int:
        return self.page_data_bytes + self.page_spare_bytes

    @property
    def t_prog_eff_us(self) -> float:
        return 0.5 * (self.t_prog_lo_us + self.t_prog_hi_us)


# t_prog_*/t_poll calibrated on Table 3 (see calibrate.py; datasheet
# typicals are 200/800 us mean program time).  MLC programs paired pages
# with strongly asymmetric lower/upper times; the alternation (not just the
# mean) is what limits MLC write interleaving (paper §5.3.1 Case III).
SLC = NandChipParams(
    cell=CellType.SLC,
    page_data_bytes=2048,
    page_spare_bytes=64,
    t_r_us=25.0,
    t_prog_lo_us=218.0,
    t_prog_hi_us=218.0,
    t_poll_cycles=0.0,
)

MLC = NandChipParams(
    cell=CellType.MLC,
    page_data_bytes=4096,
    page_spare_bytes=128,
    t_r_us=60.0,
    t_prog_lo_us=200.0,
    t_prog_hi_us=1500.0,
    t_poll_cycles=65.0,
    t_bers_us=2000.0,
)

CHIPS = {CellType.SLC: SLC, CellType.MLC: MLC}


def chip(cell: CellType | str) -> NandChipParams:
    return CHIPS[CellType(cell)]
