"""Controller<->NAND interface models: CONV, SYNC_ONLY, PROPOSED.

Each interface is reduced to the parameters the SSD-level simulator needs:

* ``cycle_ns``          — bus clock period (from §5.2: 20 ns / 12 ns).
* ``bytes_per_cycle``   — 1 for SDR, 2 for DDR.
* ``cmd_cycles``        — command+address cycles per page op (2 CMD + 5 ADDR).
* ``ecc_cycles/ecc_fixed_us`` — controller-side ECC/FTL occupancy per page,
  modelled as ``cycles * t_P + fixed`` and calibrated per cell type on the
  paper's saturated-bandwidth cells (see calibrate.py).  MLC ECC is heavier
  (§2.2.1: "The ECC block is essential ... especially when the MLC flash is
  used").
* ``poll_fixed_us``     — constant per-page status/poll overhead charged in
  the write path (ready/busy handshake + firmware loop).

The derived per-page bus times are exact functions of these.
"""

from __future__ import annotations

import dataclasses
import enum

from repro_torch.core import timing
from repro_torch.core.nand import CellType, NandChipParams


class InterfaceKind(str, enum.Enum):
    CONV = "conv"            # asynchronous SDR (paper §3)
    SYNC_ONLY = "sync_only"  # synchronous SDR, DVS of [23] (paper §5.3)
    PROPOSED = "proposed"    # synchronous DDR (paper §4)


@dataclasses.dataclass(frozen=True)
class EccParams:
    cycles: float       # part of ECC occupancy that scales with the bus clock
    fixed_us: float     # clock-independent part (firmware / FTL per page)


# Calibrated on Table 3 saturated cells (see calibrate.py).
ECC = {
    CellType.SLC: EccParams(cycles=117.0, fixed_us=3.26),
    CellType.MLC: EccParams(cycles=312.0, fixed_us=7.86),
}

WRITE_POLL_FIXED_US = 3.7  # constant status-poll overhead per written page


@dataclasses.dataclass(frozen=True)
class InterfaceParams:
    kind: InterfaceKind
    cycle_ns: float
    bytes_per_cycle: int
    cmd_cycles: int = 7  # 2 command + 5 address latch cycles

    @property
    def cmd_us(self) -> float:
        return self.cmd_cycles * self.cycle_ns * 1e-3

    def data_us(self, nbytes: int) -> float:
        """Bus occupancy of an n-byte burst."""
        return nbytes * self.cycle_ns * 1e-3 / self.bytes_per_cycle

    def ecc_us(self, cell: CellType) -> float:
        e = ECC[cell]
        return e.cycles * self.cycle_ns * 1e-3 + e.fixed_us

    def ecc_fixed_us(self, cell: CellType) -> float:
        """Clock-independent FTL/firmware share of the ECC occupancy.

        The cycle-scaled part runs on the per-channel ECC block (§2.2.1:
        every channel carries its own NAND_IF + ECC hardware); only this
        fixed firmware part occupies the single shared controller thread
        in the multi-channel simulation (DESIGN.md §3)."""
        return ECC[cell].fixed_us

    def read_slot_us(self, chip: NandChipParams) -> float:
        """Bus+controller occupancy of one page read (excl. t_R)."""
        return self.cmd_us + self.data_us(chip.page_total_bytes) + self.ecc_us(chip.cell)

    def write_slot_us(self, chip: NandChipParams) -> float:
        """Bus+controller occupancy of one page write (excl. t_PROG)."""
        return (
            self.cmd_us
            + self.data_us(chip.page_total_bytes)
            + self.ecc_us(chip.cell)
            + WRITE_POLL_FIXED_US
        )


def make_interface(kind: InterfaceKind | str) -> InterfaceParams:
    """Build interface params at the paper's derived operating points.

    CONV runs at 50 MHz SDR, SYNC_ONLY at 83 MHz SDR, PROPOSED at 83 MHz
    DDR — exactly the §5.2 derivation (Eqs. 6 and 9 + 1 MHz flooring).
    """
    kind = InterfaceKind(kind)
    clocks = timing.derive_paper_clocks()
    if kind == InterfaceKind.CONV:
        return InterfaceParams(kind, cycle_ns=clocks.conv_cycle_ns, bytes_per_cycle=1)
    if kind == InterfaceKind.SYNC_ONLY:
        return InterfaceParams(kind, cycle_ns=clocks.prop_cycle_ns, bytes_per_cycle=1)
    return InterfaceParams(kind, cycle_ns=clocks.prop_cycle_ns, bytes_per_cycle=2)


ALL_INTERFACES = tuple(InterfaceKind)
