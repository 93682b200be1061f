"""The port's configuration layer against the JAX package, and the rules
that keep the port standalone (no JAX, no ``repro`` imports, card by
default)."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import interface as j_interface
from repro.core import nand as j_nand
from repro.core import paper_tables as j_paper
from repro.core import sim as j_sim
from repro.core import timing as j_timing
from repro_torch.core import interface, nand, paper_tables, sim, timing
from repro_torch.device import resolve_device

PORT_SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CELLS = ("slc", "mlc")
KINDS = ("conv", "sync_only", "proposed")
WAYS = (1, 2, 4, 8, 16)


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch, repro_torch.api, repro_torch.tables\n"
            "import repro_torch.kernels.maxplus.ops\n"
            "import repro_torch.core.calibrate\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    src = str(PORT_SRC.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == ""


IMPORT_RE = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(PORT_SRC.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT_SRC)))
def test_port_source_imports_no_jax_and_no_repro(path):
    assert IMPORT_RE.search(path.read_text()) is None


def test_chip_smoke_imports_no_jax_and_no_repro():
    src = (PORT_SRC.parents[1] / "chip_smoke.py").read_text()
    assert IMPORT_RE.search(src) is None


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ("read", "write"))
def test_page_op_params_equal(cell, kind, mode):
    for ways in WAYS:
        got = sim.page_op_params(interface.make_interface(kind),
                                 nand.chip(cell), mode, ways)
        want = j_sim.page_op_params(j_interface.make_interface(kind),
                                    j_nand.chip(cell), mode, ways)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert sim.steady_state_mb_s(got, ways) == \
            j_sim.steady_state_mb_s(want, ways)
        assert sim.saturation_ways(got) == j_sim.saturation_ways(want)


def test_constants_and_arbitration_equal():
    assert (sim.MAX_WAYS, sim.MAX_CHANNELS) == (j_sim.MAX_WAYS,
                                                j_sim.MAX_CHANNELS)
    assert (sim.CTRL_ARB_SWITCH_FRAC, sim.CTRL_ARB_SCAN_FRAC) == (
        j_sim.CTRL_ARB_SWITCH_FRAC, j_sim.CTRL_ARB_SCAN_FRAC)
    for ctrl in (0.0, 3.26, 7.86, 11.5):
        for channels in range(1, 9):
            assert sim.controller_arb_us(ctrl, channels) == \
                j_sim.controller_arb_us(ctrl, channels)
    assert paper_tables.TABLE3 == j_paper.TABLE3
    assert paper_tables.TABLE4 == j_paper.TABLE4
    assert paper_tables.TABLE5 == j_paper.TABLE5
    assert dataclasses.asdict(timing.derive_paper_clocks()) == \
        dataclasses.asdict(j_timing.derive_paper_clocks())


def test_policy_validation():
    assert sim.policy_is_batched("batched") is True
    assert sim.policy_is_batched("eager") is False
    with pytest.raises(ValueError, match="bathced"):
        sim.policy_is_batched("bathced")
    with pytest.raises(ValueError):
        sim.SSDConfig(policy="bathced")
    cfg = sim.SSDConfig(interface=interface.InterfaceKind.CONV,
                        cell=nand.CellType.MLC, channels=4, ways=4)
    assert cfg.describe() == "conv/mlc 4ch x 4way [eager]"


def test_unported_paths_name_their_slice():
    from repro_torch import api
    from repro_torch.core import trace

    assert "streaming" not in api.UNPORTED_ENGINES
    assert set(api.UNPORTED_ENGINES) == {"prefix", "squaring"}
    s = api.Simulator(sim.SSDConfig(channels=1, ways=2), device="cpu")
    t = trace.steady_trace(8, 1, 2)
    with pytest.raises(api.CapabilityError, match="slice C"):
        s.run_many([t], engine="prefix")
    with pytest.raises(api.CapabilityError, match="slice E"):
        s.sweep(None, t, ftl=object())
    with pytest.raises(api.CapabilityError, match="slice E"):
        s.run_stream(iter([t]), ftl=object())
