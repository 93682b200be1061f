"""Timing model of the conventional and proposed NAND flash interfaces.

Implements the closed-form timing analysis of the paper:

* Eq. (1):  t_D = alpha * t_P
* Eq. (2):  t_DLL = t_IOD_max - t_RWEBD_min + t_IOS
* Eq. (3)-(6): minimum clock period of the CONVentional asynchronous
  single-data-rate interface.
* Eq. (7)-(9): minimum clock period of the PROPOSED synchronous
  double-data-rate interface.

All times are expressed in **nanoseconds** in this module (the paper's
Table 2 unit).  The SSD-level simulator (`repro_torch.core.sim`) works in
microseconds and converts via the derived per-interface cycle times.
"""

from __future__ import annotations

import dataclasses
import math

NS = 1.0
US = 1e3  # ns per us


@dataclasses.dataclass(frozen=True)
class BoardTimings:
    """Measured / datasheet timing parameters (paper Table 2, ns)."""

    t_OUT: float = 7.82   # controller FF -> NAND strobe pad (CONV only)
    t_IN: float = 1.65    # controller IO pad -> W/RFIFO (CONV only)
    t_S: float = 0.25     # setup time of W/RFIFO
    t_H: float = 0.02     # hold  time of W/RFIFO
    t_DIFF: float = 4.69  # DVS-vs-IO board arrival-time difference (PROPOSED)
    t_REA: float = 20.0   # RLAT -> controller IO pad (CONV only)
    t_BYTE: float = 12.0  # page register <-> W/RLAT transfer time


PAPER_BOARD = BoardTimings()


def t_d(alpha: float, t_p: float) -> float:
    """Eq. (1): the D_CON delay of CLK."""
    if not 0.0 <= alpha <= 0.5:
        raise ValueError(f"alpha must be in [0, 1/2], got {alpha}")
    return alpha * t_p


def t_dll(t_iod_max: float, t_rwebd_min: float, t_ios: float) -> float:
    """Eq. (2): delay inserted by the in-chip DLL to generate DVS."""
    return t_iod_max - t_rwebd_min + t_ios


def t_p_min_conventional(b: BoardTimings = PAPER_BOARD, alpha: float = 0.5) -> float:
    """Eq. (6): minimum clock period of the conventional interface.

    t_P,min = max{ (t_OUT + t_REA + t_IN + t_S) / (1 + alpha), t_BYTE }

    With the paper's Table 2 values and alpha = 1/2 this evaluates to
    19.81 ns (the paper then sets the clock to a round 50 MHz).
    """
    serial_path = (b.t_OUT + b.t_REA + b.t_IN + b.t_S) / (1.0 + alpha)
    return max(serial_path, b.t_BYTE)


def t_p_min_proposed(b: BoardTimings = PAPER_BOARD) -> float:
    """Eq. (9): minimum clock period of the proposed DDR interface.

    t_P,min = max{ (t_S + t_H + t_DIFF) * 2, t_BYTE }

    With Table 2 values: max{9.92, 12} = 12 ns -> 83 MHz.  The cycle is
    limited purely by the device-level t_BYTE, as §6 of the paper notes.
    """
    return max((b.t_S + b.t_H + b.t_DIFF) * 2.0, b.t_BYTE)


def t_p_min_proposed_io(t_ios: float, t_ioh: float, t_byte: float) -> float:
    """Eq. (8): alternative form using pad-level setup/hold constraints."""
    return max((t_ios + t_ioh) * 2.0, t_byte)


def max_frequency_mhz(t_p_min_ns: float, granularity_mhz: float = 1.0) -> float:
    """Round the implied maximum frequency down to a realizable clock.

    The paper turns 19.81 ns into 50 MHz and 12 ns into 83 MHz; i.e. it
    floors 1/t_P,min (50.47 -> 50, 83.33 -> 83) at 1 MHz granularity.
    """
    f = 1e3 / t_p_min_ns  # MHz
    return math.floor(f / granularity_mhz) * granularity_mhz


@dataclasses.dataclass(frozen=True)
class DerivedClocks:
    """Operating points derived exactly as in paper §5.2."""

    conv_t_p_ns: float
    conv_mhz: float
    prop_t_p_ns: float
    prop_mhz: float

    @property
    def conv_cycle_ns(self) -> float:
        return 1e3 / self.conv_mhz

    @property
    def prop_cycle_ns(self) -> float:
        return 1e3 / self.prop_mhz


def derive_paper_clocks(b: BoardTimings = PAPER_BOARD) -> DerivedClocks:
    tc = t_p_min_conventional(b)
    tp = t_p_min_proposed(b)
    return DerivedClocks(
        conv_t_p_ns=tc,
        conv_mhz=max_frequency_mhz(tc),
        prop_t_p_ns=tp,
        prop_mhz=max_frequency_mhz(tp),
    )
