"""Paper Tables 3/4/5 through the port, cell by cell against the JAX
``Simulator`` (within 1e-6 relative), and the paper pins of
``tests/test_sim_paper_tables.py`` held on the port."""

import numpy as np
import pytest

from repro import api as japi
from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro_torch import tables
from repro_torch.core.paper_tables import TABLE3, TABLE4

REL = 1e-6
# the same anomalous cell the JAX package's paper tests exclude
ANOMALIES = {("slc", "read", 2, "proposed")}


@pytest.fixture(scope="module")
def port_rows():
    return {r["name"]: r for run in (tables.run_table3, tables.run_table4)
            for r in run(device="cpu")}


def jax_bw(cell, mode, ways, kind, channels=1):
    return japi.steady_bandwidth_mb_s(
        j_sim.SSDConfig(interface=kind, cell=cell, channels=channels,
                        ways=ways), mode)


@pytest.mark.parametrize("cell", ("slc", "mlc"))
@pytest.mark.parametrize("mode", ("read", "write"))
def test_table3_cells_match_jax(port_rows, cell, mode):
    for ways in TABLE3[cell][mode]:
        for kind in ("conv", "sync_only", "proposed"):
            got = port_rows[f"t3/{cell}/{mode}/{ways}way/{kind}"]["value"]
            want = jax_bw(cell, mode, ways, kind)
            assert abs(got - want) <= REL * want, (ways, kind, got, want)


@pytest.mark.parametrize("cell", ("slc", "mlc"))
@pytest.mark.parametrize("mode", ("read", "write"))
def test_table4_cells_match_jax(port_rows, cell, mode):
    for channels, ways in TABLE4[cell][mode]:
        for kind in ("conv", "sync_only", "proposed"):
            got = port_rows[
                f"t4/{cell}/{mode}/{channels}ch{ways}way/{kind}"]["value"]
            want = jax_bw(cell, mode, ways, kind, channels)
            assert abs(got - want) <= REL * want, (channels, ways, kind)


@pytest.mark.parametrize("mode", ("read", "write"))
def test_table5_cells_match_jax(mode):
    rows = {r["name"]: r for r in tables.run_table5(small=True,
                                                    device="cpu")}
    assert rows["t5/energy_engine_max_rel_disagreement"]["value"] < 1e-3
    for ways in (1, 2, 4, 8, 16):
        for kind in ("conv", "sync_only", "proposed"):
            cfg = j_sim.SSDConfig(interface=kind, cell="slc", ways=ways)
            tr = j_trace.steady_trace(128, 1, ways, j_trace.READ
                                      if mode == "read" else j_trace.WRITE)
            want = japi.Simulator(cfg).run(tr, objective="energy").energy
            got = rows[f"t5/slc/{mode}/{ways}way/{kind}"]
            assert abs(got["value"] - want.nj_per_byte) <= \
                REL * want.nj_per_byte
            idle = want.idle_j / want.controller_j
            assert abs(got["idle_frac"] - idle) <= REL * idle + 1e-12


def test_paper_pins_hold_on_the_port(port_rows):
    errs = [abs(r["rel_err"]) for name, r in port_rows.items()
            if name.startswith("t3/") and tuple(
                name.split("/")[1:3]) + (int(name.split("/")[3][:-3]),
                                         name.split("/")[4]) not in ANOMALIES]
    assert len(errs) == 59
    assert np.mean(errs) < 0.04 and max(errs) < 0.16
    t4 = [r for name, r in port_rows.items() if name.startswith("t4/")]
    assert len(t4) == 36
    capped = [r for r in t4 if r["paper"] == "max(300)"]
    assert capped and all(r["value"] >= 299.0 for r in capped)
    assert np.mean([abs(r["rel_err"]) for r in t4
                    if r["paper"] != "max(300)"]) < 0.05


def test_scan_and_cuda_engines_agree_to_float32_drift():
    """The scan engine adds each op's offsets one float32 add at a time,
    the (max,+) dictionary pre-sums them in float64: on a T-op trace the
    two may drift apart by about T float32 half-ulps (T * 2**-24
    relative), and by no more."""
    from repro_torch.api import Simulator
    from repro_torch.core.trace import READ, WRITE, steady_trace
    from repro_torch.tables import cell_config
    grid = [(c, m, 1, w) for c in TABLE3 for m in TABLE3[c]
            for w in TABLE3[c][m]]
    grid += [(c, m, ch, w) for c in TABLE4 for m in TABLE4[c]
             for ch, w in TABLE4[c][m]]
    worst = 0.0
    for cell, mode, channels, ways in grid:
        for kind in ("conv", "sync_only", "proposed"):
            sim = Simulator.for_config(
                cell_config(cell, ways, kind, channels), "cpu")
            tr = steady_trace(512, channels, ways,
                              READ if mode == "read" else WRITE)
            a = sim.run(tr).end_us
            b = sim.run(tr, engine="cuda").end_us
            worst = max(worst, abs(a - b) / b / (tr.n_ops * 2.0 ** -24))
    assert worst <= 1.0
