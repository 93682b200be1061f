"""The port's calibration against the JAX package's, on the CPU.

Each candidate chip's Table 3 write errors come from one 15-point
``sweep_steady_bandwidth_mb_s`` sweep, which is bit-equal to JAX's, so
the errors, the fitted SLC constants and the stripe exponents are equal
too.  (Both packages' ``fit_slc`` return t_prog = 217 us at their
default ``n_pages=256``, one microsecond below the 218 us frozen in
``nand.SLC``.)  The 8640-candidate MLC grid is left out: it is too slow
here, and its error function is the one checked below."""

import dataclasses

import pytest

from repro.core import calibrate as j_cal
from repro.core import nand as j_nand
from repro_torch.core import calibrate, nand


@pytest.mark.parametrize("cell", ("slc", "mlc"))
def test_write_errors_equal_jax(cell):
    chip, jchip = nand.chip(cell), j_nand.chip(cell)
    got = calibrate._write_errors(chip, n_pages=64, device="cpu")
    want = j_cal._write_errors(jchip, n_pages=64)
    assert len(got) == 15 and got == want
    moved = dataclasses.replace(chip, t_prog_lo_us=300.0, t_poll_cycles=40.0)
    jmoved = dataclasses.replace(jchip, t_prog_lo_us=300.0,
                                 t_poll_cycles=40.0)
    assert calibrate._write_errors(moved, n_pages=64, device="cpu") == \
        j_cal._write_errors(jmoved, n_pages=64)


def test_fit_slc_equals_jax():
    got = calibrate.fit_slc(device="cpu")
    assert got == j_cal.fit_slc()
    assert got[:2] == (217.0, 0.0)


def test_stripe_crosscheck_equals_jax():
    got = calibrate.stripe_crosscheck(device="cpu")
    assert got == j_cal.stripe_crosscheck()
    assert all(0.9 < x < 1.0 for x in got.values())
