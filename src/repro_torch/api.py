"""``repro_torch.api`` — the port's simulation surface (re-export of
``repro_torch.core.api`` plus the types a query needs).

Quickstart::

    from repro_torch.api import (Simulator, SSDConfig, mixed_trace,
                                 mixed_trace_chunks)

    cfg = SSDConfig(channels=4, ways=8)
    sim = Simulator.for_config(cfg)            # on the card; device="cpu" too
    res = sim.run(mixed_trace(4096, 4, 8, read_fraction=0.7),
                  objective="all", engine="cuda")
    print(res.describe(), res.energy.nj_per_byte)

    # a fleet of traces: one many-trace kernel launch per geometry
    fleet = [mixed_trace(n, 4, 8, 0.7, seed=n) for n in (512, 2048, 700)]
    ends = [r.end_us for r in sim.run_many(fleet, engine="cuda")]
    # a stream that is never materialised
    res = sim.run_stream(mixed_trace_chunks(1 << 18, 4, 8, 0.7,
                                            chunk_len=1 << 15))

Engine names follow the JAX package's ``repro.api`` except that its
``pallas`` engine is ``cuda`` here.
"""

from repro_torch.core.api import (CapabilityError, Engine, EngineCaps,
                                  OBJECTIVES, Objective, Policy, SimRequest,
                                  SimResult, Simulator, UNPORTED_ENGINES,
                                  engine_capabilities, get_engine,
                                  register_engine, registered_engines,
                                  simulator_for, steady_bandwidth_mb_s,
                                  steady_channel_bandwidth_mb_s,
                                  sweep_steady_bandwidth_mb_s, sweep_tables)
from repro_torch.core.energy import EnergyBreakdown
from repro_torch.core.interface import InterfaceKind
from repro_torch.core.nand import CellType
from repro_torch.core.sim import SSDConfig
from repro_torch.core.trace import (OpClassTable, OpTrace,
                                    from_reference_table, hot_cold_trace,
                                    iter_trace_chunks, mixed_trace,
                                    mixed_trace_chunks, op_class_table,
                                    steady_trace)

__all__ = [
    "CapabilityError", "CellType", "Engine", "EngineCaps", "EnergyBreakdown",
    "InterfaceKind", "OBJECTIVES", "Objective", "OpClassTable", "OpTrace",
    "Policy", "SSDConfig", "SimRequest", "SimResult", "Simulator",
    "UNPORTED_ENGINES", "engine_capabilities", "from_reference_table",
    "get_engine", "hot_cold_trace", "iter_trace_chunks", "mixed_trace",
    "mixed_trace_chunks", "op_class_table", "register_engine",
    "registered_engines", "simulator_for", "steady_bandwidth_mb_s",
    "steady_channel_bandwidth_mb_s", "steady_trace",
    "sweep_steady_bandwidth_mb_s", "sweep_tables",
]
