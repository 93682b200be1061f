"""Paper Tables 3 / 4 / 5 reproduced through the port.

The counterpart of the JAX package's ``benchmarks/tables.py``
(``run_table3/4/5``): every cell goes through the normal entry points,
``steady_bandwidth_mb_s`` and the ``Simulator`` session, on ``device``
(None = the card).  Table 5 runs each steady SLC stream through the
``scan`` and ``cuda`` engines plus the numpy oracle, asserts that all
three agree on the controller energy to < 1e-3, and reports the
trace-derived nJ/B against the paper.
"""

from __future__ import annotations

from repro_torch.core.api import Simulator, steady_bandwidth_mb_s
from repro_torch.core.energy import breakdown_from_sums
from repro_torch.core.interface import InterfaceKind
from repro_torch.core.nand import CellType
from repro_torch.core.paper_tables import (INTERFACE_ORDER, TABLE3, TABLE4,
                                           TABLE5)
from repro_torch.core.sim import SSDConfig
from repro_torch.core.sim_ref import simulate_trace_energy_ref
from repro_torch.core.trace import READ, WRITE, steady_trace

#: Table 5 energy agreement bar between the engines and the oracle.
ENERGY_AGREEMENT = 1e-3


def cell_config(cell, ways, kind, channels=1) -> SSDConfig:
    return SSDConfig(interface=InterfaceKind(kind), cell=CellType(cell),
                     channels=channels, ways=ways)


def _sim(cell, mode, ways, kind, channels=1, device=None):
    return steady_bandwidth_mb_s(cell_config(cell, ways, kind, channels),
                                 mode, device=device)


def run_table3(device=None) -> list[dict]:
    rows = []
    for cell, by_mode in TABLE3.items():
        for mode, by_ways in by_mode.items():
            for ways, row in by_ways.items():
                for kind, paper in zip(INTERFACE_ORDER, row):
                    sim = _sim(cell, mode, ways, kind, device=device)
                    rows.append({
                        "name": f"t3/{cell}/{mode}/{ways}way/{kind}",
                        "value": sim, "paper": paper,
                        "rel_err": (sim - paper) / paper})
    return rows


def run_table4(device=None) -> list[dict]:
    rows = []
    for cell, by_mode in TABLE4.items():
        for mode, by_cw in by_mode.items():
            for (channels, ways), row in by_cw.items():
                for kind, paper in zip(INTERFACE_ORDER, row):
                    sim = _sim(cell, mode, ways, kind, channels,
                               device=device)
                    rows.append({
                        "name": f"t4/{cell}/{mode}/{channels}ch{ways}way/{kind}",
                        "value": sim,
                        "paper": paper if paper is not None else "max(300)",
                        "rel_err": ((sim - paper) / paper
                                    if paper is not None else 0.0)})
    return rows


def run_table5(small: bool = False, device=None) -> list[dict]:
    n_pages = 128 if small else 512
    rows, agree = [], 0.0
    for mode, by_ways in TABLE5.items():
        for ways, row in by_ways.items():
            for kind, paper in zip(INTERFACE_ORDER, row):
                sim = Simulator.for_config(cell_config("slc", ways, kind),
                                           device)
                trace = steady_trace(n_pages, 1, ways,
                                     READ if mode == "read" else WRITE)
                bds = {eng: sim.run(trace, objective="energy",
                                    engine=eng).energy
                       for eng in ("scan", "cuda")}
                end, sums = simulate_trace_energy_ref(sim.table, trace, kind)
                ref = breakdown_from_sums(sums, end,
                                          trace.total_bytes(sim.table), kind)
                agree = max(agree, *(
                    abs(bd.controller_j - ref.controller_j)
                    / ref.controller_j for bd in bds.values()))
                nj = bds["scan"].nj_per_byte
                rows.append({
                    "name": f"t5/slc/{mode}/{ways}way/{kind}",
                    "value": nj, "paper": paper,
                    "rel_err": (nj - paper) / paper,
                    "idle_frac": (bds["scan"].idle_j
                                  / bds["scan"].controller_j)})
    if not agree < ENERGY_AGREEMENT:
        raise AssertionError(
            f"energy engines disagree by {agree:.2e} on Table 5 traces")
    rows.append({"name": "t5/energy_engine_max_rel_disagreement",
                 "value": agree, "paper": f"<{ENERGY_AGREEMENT:g}"})
    return rows
