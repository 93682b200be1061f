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

Latency under load and reliability (request-level workloads)::

    from repro_torch.api import FaultSpec, poisson_stream

    load = poisson_stream(512, mean_interarrival_us=40.0, seed=0)
    res = sim.run(load, sched_policy="least_loaded")   # dynamic dispatch
    print(res.p50_us, res.p99_us)
    worn = FaultSpec(wear=0.8, hedge_fraction=0.3, seed=7)
    res = sim.run(load, faults=worn)            # retries, remaps, hedges
    print(res.p99_9_us, res.n_remap_ops, res.retry_hist)

Aging and garbage collection (the FTL stage): the translation machine
runs on the session's device, the translated stream prices on every
engine but ``squaring``::

    from repro_torch.api import FTLSpec, overwrite_stream

    aged = sim.run(overwrite_stream(4096, footprint_pages=2048),
                   ftl=FTLSpec(overprovision=0.25, precondition=True))
    print(aged.waf, aged.mb_s, aged.fresh_mb_s)    # steady vs fresh
    points = [FTLSpec(overprovision=op, gc_policy=g, precondition=True)
              for op in (0.12, 0.25, 0.5) for g in ("greedy", "lru")]
    ends = sim.sweep(None, overwrite_stream(4096, 2048), ftl=points)

Design points split over a points mesh of two shards of one card (or
of every card, where a host has two or more) unless ``shard=False``::

    from repro_torch.launch.mesh import make_points_mesh

    with points_mesh(make_points_mesh(("cuda:0", "cuda:0"))):
        ends = sim.sweep(tables, trace, engine="scan")

Engine names follow the JAX package's ``repro.api`` except that its
``pallas`` engine is ``cuda`` here; ``sweep_tables`` and
``Simulator.sweep`` default to the log-depth ``prefix`` engine, as there.
"""

from repro_torch.core.api import (CacheInfo, CapabilityError, Engine,
                                  EngineCaps,
                                  OBJECTIVES, Objective, Policy, SimRequest,
                                  SimResult, Simulator, engine_capabilities,
                                  get_engine, points_mesh, register_engine,
                                  registered_engines,
                                  simulator_for, steady_bandwidth_mb_s,
                                  steady_channel_bandwidth_mb_s,
                                  sweep_steady_bandwidth_mb_s, sweep_tables)
from repro_torch.core.energy import EnergyBreakdown
from repro_torch.core.faults import FaultSampler, FaultSpec
from repro_torch.core.ftl import (FTL_LABELS, GC_POLICIES, FTLSpec, FTLStats,
                                  FTLTranslation, analytic_waf,
                                  ftl_op_class_table, precondition_lpns,
                                  select_victim)
from repro_torch.core.ftl import translate as ftl_translate
from repro_torch.core.ftl_scan import translate_scan as ftl_translate_scan
from repro_torch.core.interface import InterfaceKind
from repro_torch.core.nand import CellType
from repro_torch.core.sched import (DYNAMIC_POLICIES, LoweredWorkload,
                                    SCHED_POLICIES, STATIC_POLICIES,
                                    apply_faults, lower_ops, lower_ops_chunk,
                                    lower_static, policy_is_dynamic)
from repro_torch.core.sim import PageOpParams, SSDConfig
from repro_torch.core.trace import (READ, WRITE, OpClassTable, OpTrace,
                                    from_reference_table, hot_cold_trace,
                                    iter_trace_chunks, mixed_trace,
                                    mixed_trace_chunks, op_class_table,
                                    steady_trace)
from repro_torch.core.workload import (RequestStream, aging_stream,
                                       build_workload, bursty_stream,
                                       checkpoint_requests,
                                       closed_loop_stream, datapipe_requests,
                                       iter_request_chunks,
                                       kvoffload_requests, multi_tenant,
                                       overwrite_stream, poisson_stream,
                                       request_lpns, with_hedges)

__all__ = [
    # the session API proper
    "CacheInfo", "CapabilityError", "Engine", "EngineCaps", "OBJECTIVES", "Objective",
    "Policy", "SimRequest", "SimResult", "Simulator", "engine_capabilities",
    "get_engine", "points_mesh", "register_engine", "registered_engines",
    "simulator_for", "steady_bandwidth_mb_s", "steady_channel_bandwidth_mb_s",
    "sweep_steady_bandwidth_mb_s", "sweep_tables",
    # the request-level workload + scheduler layer
    "DYNAMIC_POLICIES", "LoweredWorkload", "RequestStream",
    "SCHED_POLICIES", "STATIC_POLICIES", "aging_stream", "build_workload",
    "bursty_stream", "checkpoint_requests", "closed_loop_stream",
    "datapipe_requests", "iter_request_chunks", "kvoffload_requests",
    "lower_ops", "lower_ops_chunk", "lower_static", "multi_tenant",
    "overwrite_stream", "poisson_stream", "policy_is_dynamic",
    "request_lpns",
    # the reliability layer
    "FaultSampler", "FaultSpec", "apply_faults", "with_hedges",
    # the FTL stage
    "FTLSpec", "FTLStats", "FTLTranslation", "FTL_LABELS", "GC_POLICIES",
    "analytic_waf", "ftl_op_class_table", "ftl_translate",
    "ftl_translate_scan", "precondition_lpns", "select_victim",
    # the types a request/result is made of, and the trace builders
    "CellType", "EnergyBreakdown", "InterfaceKind", "OpClassTable",
    "OpTrace", "PageOpParams", "READ", "SSDConfig", "WRITE",
    "from_reference_table", "hot_cold_trace", "iter_trace_chunks",
    "mixed_trace", "mixed_trace_chunks", "op_class_table", "steady_trace",
]
