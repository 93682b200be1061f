"""The port's ``Simulator`` session against the JAX package's: the same
request answers within 1e-6 relative on every field (the port's ``cuda``
engine against JAX ``pallas``, ``scan`` against ``scan``, ``oracle``
against ``oracle``), and the request fields of later slices validate
as the JAX package's do.  The log-depth engines
(``prefix``, ``squaring``) are held against JAX in
``test_torch_logdepth.py``.  Request-level workloads are
held against JAX in ``test_torch_sched_faults.py``, FTL queries in
``test_torch_ftl_api.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro_torch import api
from repro_torch.core import sim, trace

REL = 1e-6
ENGINES = (("scan", "scan"), ("cuda", "pallas"), ("oracle", "oracle"))
ENERGY_FIELDS = ("cmd_j", "io_j", "ecc_j", "ctrl_j", "idle_j", "array_j",
                 "end_us")


def close(a, b):
    return abs(a - b) <= REL * abs(b)


def traces(channels, ways, side, seed):
    t = trace.mixed_trace(200, channels, ways, 0.7, seed=seed)
    arr = ext = None
    if side:
        rng = np.random.default_rng(seed)
        arr = np.cumsum(rng.exponential(18.0, t.n_ops)).astype(np.float32)
        ext = np.where(rng.random(t.n_ops) < 0.15, 11.0, 0.0
                       ).astype(np.float32)
    kw = dict(cls=t.cls, channel=t.channel, way=t.way, parity=t.parity,
              channels=channels, ways=ways, arrival_us=arr, extra_us=ext)
    return trace.OpTrace(**kw), j_trace.OpTrace(**kw)


@pytest.mark.parametrize("engine,jengine", ENGINES)
@pytest.mark.parametrize("channels,ways,cell,kind", [
    (1, 4, "slc", "conv"), (2, 8, "mlc", "proposed"),
    (4, 2, "slc", "sync_only")])
@pytest.mark.parametrize("side", (False, True))
def test_run_all_matches_jax(engine, jengine, channels, ways, cell, kind,
                             side):
    cfg = dict(interface=kind, cell=cell, channels=channels, ways=ways)
    t, jt = traces(channels, ways, side, seed=channels + ways)
    got = api.Simulator(sim.SSDConfig(**cfg), device="cpu").run(
        t, objective="all", engine=engine)
    want = japi.Simulator(j_sim.SSDConfig(**cfg)).run(
        jt, objective="all", engine=jengine)
    assert got.engine == engine and want.engine == jengine
    assert close(got.end_us, want.end_us) and close(got.mb_s, want.mb_s)
    assert (got.n_ops, got.payload_bytes) == (want.n_ops, want.payload_bytes)
    assert np.array_equal(got.channel_busy_us, want.channel_busy_us)
    for f in ENERGY_FIELDS:
        assert close(getattr(got.energy, f), getattr(want.energy, f)), f
    assert got.energy.payload_bytes == want.energy.payload_bytes
    assert close(got.energy.nj_per_byte, want.energy.nj_per_byte)
    bare = api.Simulator(sim.SSDConfig(**cfg), device="cpu").run(
        t, engine=engine)
    assert bare.end_us == got.end_us and bare.energy is None


@pytest.mark.parametrize("engine,jengine", [("scan", "scan"),
                                            ("cuda", "pallas")])
@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_sweep_tables_matches_jax(engine, jengine, policy):
    t, jt = traces(2, 4, True, seed=9)
    tables, jtables = [], []
    for kind in ("conv", "sync_only", "proposed"):
        for cell in ("slc", "mlc"):
            cfg = dict(interface=kind, cell=cell, channels=2, ways=4)
            tables.append(trace.op_class_table(sim.SSDConfig(**cfg)))
            jtables.append(j_trace.op_class_table(j_sim.SSDConfig(**cfg)))
    got = api.sweep_tables(tables, t, policy=policy, engine=engine,
                           device="cpu")
    want = japi.sweep_tables(jtables, jt, policy=policy, engine=jengine,
                             shard=False)
    assert got.shape == (6,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=REL, atol=0)


@pytest.mark.parametrize("cell,kind,channels,ways,mode", [
    ("slc", "proposed", 1, 16, "read"), ("mlc", "conv", 2, 8, "write"),
    ("slc", "sync_only", 4, 4, "read"), ("mlc", "proposed", 4, 4, "write")])
def test_steady_bandwidth_matches_jax(cell, kind, channels, ways, mode):
    cfg = dict(interface=kind, cell=cell, channels=channels, ways=ways)
    got = api.steady_bandwidth_mb_s(sim.SSDConfig(**cfg), mode, n_pages=128,
                                    device="cpu")
    want = japi.steady_bandwidth_mb_s(j_sim.SSDConfig(**cfg), mode,
                                      n_pages=128)
    assert close(got, want)
    from repro.core.interface import make_interface as j_iface
    from repro.core.nand import chip as j_chip
    from repro_torch.core.interface import make_interface
    from repro_torch.core.nand import chip
    for policy in ("eager", "batched"):
        op = sim.page_op_params(make_interface(kind), chip(cell), mode, ways)
        jop = j_sim.page_op_params(j_iface(kind), j_chip(cell), mode, ways)
        got = api.steady_channel_bandwidth_mb_s(op, ways, policy=policy,
                                                n_pages=128, device="cpu")
        want = japi.steady_channel_bandwidth_mb_s(jop, ways, policy=policy,
                                                  n_pages=128)
        assert close(got, float(want))


def _request_field_query(field, pkg):
    """The request of one ``SimRequest`` field that slice B brought, in
    the port (``pkg == "torch"``) or the JAX package: a workload alone,
    a workload under a dynamic policy, or a fault spec on a trace."""
    if pkg == "torch":
        from repro_torch.core import workload as w
        mod, trace_mod = api, trace
    else:
        from repro.core import workload as w
        mod, trace_mod = japi, j_trace
    load = w.poisson_stream(64, 15.0, read_fraction=0.7,
                            pages_per_request=2, seed=4)
    if field == "workload":
        return mod.SimRequest(workload=load, objective="all")
    if field == "sched_policy":
        return mod.SimRequest(workload=load, sched_policy="least_loaded",
                              objective="all")
    return mod.SimRequest(trace=trace_mod.mixed_trace(200, 2, 4, 0.7, seed=1),
                          faults=mod.FaultSpec(wear=1.0, jitter_us=2.0,
                                               prog_fail_prob=0.1, seed=3),
                          objective="all")


@pytest.mark.parametrize("field,slice_", [
    ("workload", "slice B"), ("sched_policy", "slice B"),
    ("faults", "slice B"), ("ftl", "slice E")])
def test_unported_request_fields_raise(field, slice_):
    """Every field once refused now runs.  ``ftl`` (slice E) validates as
    the JAX package's request does: a placed trace has no logical
    addresses to translate, and only an ``FTLSpec`` is a spec.  The
    fields slice B brought (``workload``, ``sched_policy``, ``faults``)
    answer as the JAX package does, bit-equal on the scan engine."""
    t = trace.steady_trace(8, 1, 1)
    s = api.Simulator(sim.SSDConfig(channels=2, ways=4, cell="mlc"),
                      device="cpu")
    if slice_ == "slice E":
        from repro.core import ftl as j_ftl
        from repro.core import workload as j_wl
        from repro_torch.core import workload as w
        jt = japi.build_workload("mixed", j_sim.SSDConfig(channels=2,
                                                          ways=4))
        for got, want, match in (
                (lambda: api.SimRequest(trace=t, ftl=api.FTLSpec()),
                 lambda: japi.SimRequest(trace=jt, ftl=j_ftl.FTLSpec()),
                 "ftl= applies to workload requests"),
                (lambda: s.run(w.overwrite_stream(10, 8), ftl=object()),
                 lambda: japi.SimRequest(
                     workload=j_wl.overwrite_stream(10, 8), ftl=object()),
                 "ftl= takes an FTLSpec, got object")):
            with pytest.raises(ValueError, match=match) as e:
                got()
            with pytest.raises(ValueError) as j:
                want()
            assert str(e.value) == str(j.value)
        return
    got = s.run(_request_field_query(field, "torch"))
    want = japi.Simulator(j_sim.SSDConfig(channels=2, ways=4, cell="mlc")).run(
        _request_field_query(field, "jax"))
    assert got.end_us == want.end_us and got.n_ops == want.n_ops
    assert got.energy.total_j == want.energy.total_j
    assert (got.n_remap_ops, got.sched_policy) == (want.n_remap_ops,
                                                  want.sched_policy)
    for name in ("request_lat_us", "retry_hist"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        assert a is None or np.array_equal(a, b), name
    assert (got.request_lat_us is None) == (field == "faults")


def test_registry_and_validation():
    assert api.registered_engines() == ("cuda", "oracle", "prefix", "scan",
                                        "squaring", "streaming")
    caps = api.engine_capabilities()
    assert caps["cuda"].batched_tables and not caps["oracle"].batched_tables
    assert caps["scan"].describe() == ("scan: batched_tables, energy, "
                                       "arrivals, dispatch, ftl")
    assert [n for n, c in caps.items() if not c.ftl] == ["squaring"]
    assert [n for n, c in caps.items() if c.dispatch] == ["scan"]
    assert [n for n, c in caps.items() if not c.arrivals] == ["squaring"]
    assert [n for n, c in caps.items() if not c.heterogeneous] == [
        "squaring"]
    assert [n for n, c in caps.items() if c.batched_tables] == [
        "cuda", "prefix", "scan"]
    with pytest.raises(ValueError, match="registered engines: cuda"):
        api.get_engine("pallas")
    with pytest.raises(api.CapabilityError, match="engines that do: cuda"):
        api.sweep_tables([trace.op_class_table(sim.SSDConfig())],
                         trace.steady_trace(8, 1, 1), engine="oracle",
                         device="cpu")
    with pytest.raises(ValueError, match="objective"):
        api.SimRequest(trace=trace.steady_trace(8, 1, 1), objective="speed")
    with pytest.raises(ValueError, match="bathced"):
        api.SimRequest(trace=trace.steady_trace(8, 1, 1), policy="bathced")
    with pytest.raises(ValueError, match="trace="):
        api.SimRequest()
    s = api.Simulator(table=trace.op_class_table(sim.SSDConfig()),
                      device="cpu")
    with pytest.raises(ValueError, match="interface kind"):
        s.run(trace.steady_trace(8, 1, 1), objective="energy")
    with pytest.raises(ValueError, match="empty trace"):
        s.run(trace.OpTrace(cls=np.zeros(0, np.int32),
                            channel=np.zeros(0, np.int32),
                            way=np.zeros(0, np.int32),
                            parity=np.zeros(0, np.int32), channels=1,
                            ways=1))
    res = s.run(trace.steady_trace(8, 1, 1))
    assert res.describe().startswith("[scan] 8 ops")


def test_simulator_defaults_to_the_card():
    cfg = sim.SSDConfig(channels=2, ways=2)
    if torch.cuda.is_available():
        assert api.Simulator(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.Simulator(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.Simulator.for_config(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.steady_bandwidth_mb_s(cfg, "read")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.sweep_tables([trace.op_class_table(cfg)],
                         trace.steady_trace(8, 2, 2))
    s = api.Simulator.for_config(cfg, "cpu")
    assert s is api.Simulator.for_config(dataclasses.replace(cfg), "cpu")
    assert s.device.type == "cpu"
