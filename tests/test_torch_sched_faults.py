"""The port's scheduler and reliability layers (``repro_torch.core.sched``
and ``repro_torch.core.faults``) and its workload queries against the
JAX package's, on the CPU.

Tolerances, each stated where it is used:

* lowerings, fault draws and trace rewrites are numpy on the same PCG64
  streams: array equality, dtypes included;
* ``Simulator.run(RequestStream, ...)``: the port's ``scan``, ``oracle``,
  ``streaming`` and ``cuda`` (on the CPU, the kernel's plain version)
  run the same float32 (or, for the oracle, float64) operations in the
  same order as JAX's ``scan``, ``oracle``, ``streaming`` and ``pallas``:
  end times, latencies, percentiles and energies bit-equal;
* across engines (scan / cuda / oracle of the port): 1e-3 relative, the
  repo's cross-engine bar."""

import dataclasses
import warnings

import numpy as np
import pytest

from repro import api as japi
from repro.core import faults as j_fl
from repro.core import sched as j_sched
from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro.core import workload as j_wl
from repro_torch import api
from repro_torch.core import faults as fl
from repro_torch.core import sched, sim, trace
from repro_torch.core import workload as wl

GEOMETRIES = ((1, 1), (2, 4), (4, 8), (8, 16))
TRACE_FIELDS = ("cls", "channel", "way", "parity", "payload", "arrival_us",
                "extra_us")
ENGINES = (("scan", "scan"), ("cuda", "pallas"), ("oracle", "oracle"),
           ("streaming", "streaming"))
ENERGY_FIELDS = ("cmd_j", "io_j", "ecc_j", "ctrl_j", "idle_j", "array_j")
CROSS_ENGINE_REL = 1e-3
ZERO = dict(rber_fresh=0.0, rber_worn=0.0)
SPECS = {
    "zero": ZERO,
    "worn_jitter": dict(wear=0.9, jitter_us=3.0, seed=4),
    "ladder_faults": dict(wear=1.0, retry_step_us=(50.0, 120.0, 400.0),
                          max_retries=5, jitter_us=1.0, prog_fail_prob=0.2,
                          erase_fail_prob=0.3, seed=9),
    "reread_faults": dict(wear=1.0, rber_worn=5e-4, prog_fail_prob=0.1,
                          erase_fail_prob=0.5, seed=2),
}


def same_array(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def assert_same_trace(got, want):
    assert isinstance(got, trace.OpTrace)
    assert (got.channels, got.ways) == (want.channels, want.ways)
    for f in TRACE_FIELDS:
        assert same_array(getattr(got, f), getattr(want, f)), f


def tables(channels, ways, cell="mlc"):
    return (trace.op_class_table(sim.SSDConfig(cell=cell, channels=channels,
                                               ways=ways)),
            j_trace.op_class_table(j_sim.SSDConfig(cell=cell,
                                                   channels=channels,
                                                   ways=ways)))


def hedged_load(m, n=120):
    return m.with_hedges(m.poisson_stream(n, 20.0, read_fraction=0.6,
                                          pages_per_request=2, seed=5),
                         0.3, after_us=15.0, seed=1)


# --- spec and sampler ---------------------------------------------------------


def test_fault_constants_pin_trace_op_classes():
    assert (fl.READ, fl.WRITE) == (trace.READ, trace.WRITE)
    assert (fl.READ, fl.WRITE) == (j_fl.READ, j_fl.WRITE)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_fault_spec_equal_to_jax(name):
    got, want = fl.FaultSpec(**SPECS[name]), j_fl.FaultSpec(**SPECS[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.rber() == want.rber()
    assert got.p_retry_step() == want.p_retry_step()
    assert got.is_zero == want.is_zero


def test_fault_spec_validation_and_rber_curve():
    for bad, match in ((dict(wear=-0.1), "wear"),
                       (dict(prog_fail_prob=1.5), "prog_fail_prob"),
                       (dict(erase_fail_prob=-0.5), "erase_fail_prob"),
                       (dict(retry_step_us=(10.0, -1.0)), "retry_step_us"),
                       (dict(max_retries=-1), "max_retries"),
                       (dict(jitter_us=-1.0), "jitter_us"),
                       (dict(hedge_after_us=-5.0), "hedge_after_us")):
        with pytest.raises(ValueError, match=match):
            fl.FaultSpec(**bad)
    s = fl.FaultSpec(wear=0.0, rber_fresh=1e-8, rber_worn=1e-4)
    assert s.rber() == pytest.approx(1e-8)
    assert dataclasses.replace(s, wear=1.0).rber() == pytest.approx(1e-4)
    assert 1e-8 < dataclasses.replace(s, wear=0.5).rber() < 1e-4
    assert fl.FaultSpec(wear=5.0, rber_worn=1.0).p_retry_step() == 0.95
    assert not fl.FaultSpec().is_zero and fl.FaultSpec(**ZERO).is_zero
    assert not fl.FaultSpec(**ZERO, jitter_us=1.0).is_zero
    with pytest.raises(ValueError, match="OpClassTable"):
        fl.FaultSampler(fl.FaultSpec(wear=1.0), 2, 4)
    with pytest.raises(ValueError, match="channels and ways"):
        fl.FaultSampler(fl.FaultSpec(**ZERO), 0, 4)


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_sampler_draws_equal_to_jax_and_chunked_to_one_shot(name, channels,
                                                            ways):
    """The two packages' ``FaultSampler`` draw the same PCG64 streams: the
    retirement mask, the next-way map and every per-op draw equal, and a
    sampler fed in chunks draws what one fed at once draws."""
    table, jtable = tables(channels, ways)
    cls = trace.mixed_trace(400, channels, ways, 0.5, seed=ways).cls
    one = fl.FaultSampler(fl.FaultSpec(**SPECS[name]), channels, ways, table)
    jone = j_fl.FaultSampler(j_fl.FaultSpec(**SPECS[name]), channels, ways,
                             jtable)
    assert same_array(one.retired, jone.retired)
    assert (~one.retired).any(axis=1).all()
    assert same_array(one._next_way, jone._next_way)
    assert same_array(fl._cumcount(cls), j_fl._cumcount(cls))
    draws = one.sample(cls)
    for a, b in zip(draws, jone.sample(cls)):
        assert same_array(a, b)
    assert same_array(one.retry_hist, jone.retry_hist)
    assert int(one.retry_hist.sum()) == int(np.sum(cls == trace.READ))
    chunked = fl.FaultSampler(fl.FaultSpec(**SPECS[name]), channels, ways,
                              table)
    parts = [chunked.sample(cls[lo:lo + 77]) for lo in range(0, 400, 77)]
    for i in range(3):
        assert same_array(np.concatenate([p[i] for p in parts]), draws[i])
    assert same_array(chunked.retry_hist, one.retry_hist)


# --- lowerings ------------------------------------------------------------------


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("policy", sched.STATIC_POLICIES)
def test_lower_static_equal_to_jax(policy, channels, ways):
    for build in (lambda m, _: m.poisson_stream(90, 10.0, seed=3,
                                                pages_per_request=3),
                  lambda m, _: hedged_load(m),
                  lambda m, s: m.datapipe_requests(
                      2 << 20, s.SSDConfig(channels=channels, ways=ways),
                      hedge_fraction=0.4, seed=2)):
        got = sched.lower_static(build(wl, sim), channels, ways, policy)
        want = j_sched.lower_static(build(j_wl, j_sim), channels, ways,
                                    policy)
        assert_same_trace(got.trace, want.trace)
        assert same_array(got.request_id, want.request_id)
        assert same_array(got.request_arrival_us, want.request_arrival_us)
        comp = np.linspace(1.0, 99.0, got.trace.n_ops)
        assert same_array(got.request_latencies(comp),
                          want.request_latencies(comp))


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("policy", sched.STATIC_POLICIES)
def test_lower_ops_and_chunks_equal_to_jax(policy, channels, ways):
    rng = np.random.default_rng(channels * ways)
    n = 300
    cls = np.where(rng.random(n) < 0.6, trace.READ, trace.WRITE)
    arr = np.cumsum(rng.exponential(5.0, n)).astype(np.float32)
    pay = rng.random(n) < 0.9
    for a, p in ((arr, pay), (np.zeros(n, np.float32), None)):
        got = sched.lower_ops(cls, a, channels, ways, policy, payload=p)
        assert_same_trace(got, j_sched.lower_ops(cls, a, channels, ways,
                                                 policy, payload=p))
        off, parts = 0, []
        for lo in range(0, n, 71):
            part, off = sched.lower_ops_chunk(
                cls[lo:lo + 71], a[lo:lo + 71], channels, ways, policy,
                payload=None if p is None else p[lo:lo + 71],
                slot_offset=off)
            jpart, _ = j_sched.lower_ops_chunk(
                cls[lo:lo + 71], a[lo:lo + 71], channels, ways, policy,
                payload=None if p is None else p[lo:lo + 71],
                slot_offset=lo)
            assert_same_trace(part, jpart)
            parts.append(part)
        assert off == n
        for f in ("cls", "channel", "way", "parity"):
            assert np.array_equal(
                np.concatenate([getattr(x, f) for x in parts]),
                getattr(got, f))


def test_sched_policies_and_refusals():
    assert (sched.STATIC_POLICIES, sched.DYNAMIC_POLICIES,
            sched.SCHED_POLICIES) == (j_sched.STATIC_POLICIES,
                                      j_sched.DYNAMIC_POLICIES,
                                      j_sched.SCHED_POLICIES)
    assert sched.DYNAMIC_POLICIES == sim.DISPATCH_RULES
    assert not sched.policy_is_dynamic("stripe")
    assert sched.policy_is_dynamic("earliest_ready")
    s = wl.poisson_stream(24, 10.0, seed=3)
    low = sched.lower_static(s, 2, 4, policy="round_robin")
    t = np.arange(24)
    assert np.array_equal(low.trace.way, t % 4)
    assert np.array_equal(low.trace.channel, (t // 4) % 2)
    with pytest.raises(ValueError, match="unknown sched policy"):
        sched.lower_static(s, 2, 4, policy="striipe")
    for fn in (lambda: sched.lower_static(s, 2, 4, "least_loaded"),
               lambda: sched.lower_ops(np.zeros(4), np.zeros(4), 2, 4,
                                       "earliest_ready"),
               lambda: sched.lower_ops_chunk(np.zeros(4), np.zeros(4), 2, 4,
                                             "least_loaded")):
        with pytest.raises(ValueError, match="dynamic"):
            fn()
    assert sched.lower_static(wl.poisson_stream(0, 1.0), 2, 4).trace.n_ops == 0


# --- fault rewrites -------------------------------------------------------------


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_apply_faults_equal_to_jax(name, channels, ways):
    table, jtable = tables(channels, ways)
    low = sched.lower_static(hedged_load(wl), channels, ways)
    jlow = j_sched.lower_static(hedged_load(j_wl), channels, ways)
    got, rid, smp = sched.apply_faults(low.trace, fl.FaultSpec(**SPECS[name]),
                                       table, request_id=low.request_id)
    want, jrid, jsmp = j_sched.apply_faults(
        jlow.trace, j_fl.FaultSpec(**SPECS[name]), jtable,
        request_id=jlow.request_id)
    assert_same_trace(got, want)
    assert same_array(rid, jrid)
    assert smp.n_remap_ops == jsmp.n_remap_ops
    assert same_array(smp.retry_hist, jsmp.retry_hist)
    # byte conservation: remaps take the failed originals' credit
    assert got.total_bytes(table) == low.trace.total_bytes(table)
    assert got.n_ops == low.trace.n_ops + smp.n_remap_ops


@pytest.mark.parametrize("channels,ways", ((2, 4), (8, 16)))
def test_chunked_fault_rewrites_equal_jax_and_one_shot(channels, ways):
    table, jtable = tables(channels, ways)
    spec = SPECS["ladder_faults"]
    t = trace.mixed_trace(500, channels, ways, 0.4, seed=8)
    whole, _, _ = sched.apply_faults(t, fl.FaultSpec(**spec), table)
    for chunk_len in (33, 499, 1024):
        parts = list(trace.iter_trace_chunks(
            t, chunk_len, faults=fl.FaultSpec(**spec), table=table))
        jparts = list(j_trace.iter_trace_chunks(
            j_trace.mixed_trace(500, channels, ways, 0.4, seed=8), chunk_len,
            faults=j_fl.FaultSpec(**spec), table=jtable))
        assert [p.n_ops for p in parts] == [p.n_ops for p in jparts]
        for p, jp in zip(parts, jparts):
            assert_same_trace(p, jp)
        for f in ("cls", "channel", "way", "parity", "extra_us"):
            assert np.array_equal(np.concatenate([getattr(p, f)
                                                  for p in parts]),
                                  getattr(whole, f))
        assert np.array_equal(np.concatenate([p.payload_mask()
                                              for p in parts]),
                              whole.payload_mask())
    for chunk_len in (100, 1000):
        parts = list(trace.mixed_trace_chunks(
            500, channels, ways, 0.4, chunk_len=chunk_len, seed=8,
            faults=fl.FaultSpec(**spec), table=table))
        jparts = list(j_trace.mixed_trace_chunks(
            500, channels, ways, 0.4, chunk_len=chunk_len, seed=8,
            faults=j_fl.FaultSpec(**spec), table=jtable))
        for p, jp in zip(parts, jparts):
            assert_same_trace(p, jp)
        for f in ("cls", "channel", "way", "parity", "extra_us"):
            assert np.array_equal(np.concatenate([getattr(p, f)
                                                  for p in parts]),
                                  getattr(whole, f))


def test_faults_and_extra_us_compose_exclusively():
    table, _ = tables(2, 4)
    t = trace.mixed_trace(64, 2, 4, 0.5, seed=0)
    t2, _, _ = sched.apply_faults(t, fl.FaultSpec(wear=1.0), table)
    with pytest.raises(ValueError, match="already carries extra_us"):
        sched.apply_faults(t2, fl.FaultSpec(**ZERO), table)
    with pytest.raises(ValueError, match="already carries extra_us"):
        list(trace.iter_trace_chunks(t2, 16, faults=fl.FaultSpec(**ZERO),
                                     table=table))
    with pytest.raises(ValueError, match="already carries extra_us"):
        api.SimRequest(trace=t2, faults=fl.FaultSpec(**ZERO))
    with pytest.raises(ValueError, match="FaultSpec"):
        api.SimRequest(trace=t, faults="worn")


def test_program_fault_remaps_conserve_bytes_and_avoid_retired_ways():
    table, _ = tables(4, 4)
    spec = fl.FaultSpec(**ZERO, prog_fail_prob=1.0, erase_fail_prob=0.3,
                        seed=4)
    t = trace.mixed_trace(200, 4, 4, 0.5, seed=2)
    n_writes = int(np.sum(t.cls == trace.WRITE))
    t2, _, sampler = sched.apply_faults(t, spec, table)
    assert sampler.n_remap_ops == n_writes == t2.n_ops - t.n_ops
    assert t2.total_bytes(table) == t.total_bytes(table)
    fail = np.flatnonzero(~t2.payload_mask())
    assert np.array_equal(t2.channel[fail + 1], t2.channel[fail])
    assert not sampler.retired[t2.channel[fail + 1], t2.way[fail + 1]].any()
    for seed in range(8):
        s = fl.FaultSampler(dataclasses.replace(spec, erase_fail_prob=0.9,
                                                seed=seed), 4, 4)
        assert (~s.retired).any(axis=1).all(), seed


# --- workload queries through the Simulator -------------------------------------


def _loads(m, channels, ways):
    return {
        "poisson": m.poisson_stream(150, 12.0 * 4 / (channels * ways) + 2.0,
                                    read_fraction=0.7, pages_per_request=2,
                                    seed=channels + ways),
        "tenants": m.multi_tenant([
            m.bursty_stream(60, burst_len=12, gap_us=800.0,
                            read_fraction=0.2, seed=5),
            m.poisson_stream(60, 60.0, seed=6)]),
    }


def percentile(res, q):
    """(value, RuntimeWarning texts) of one guarded percentile."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        value = getattr(res, q)
    return value, [str(x.message) for x in w
                   if issubclass(x.category, RuntimeWarning)]


def assert_same_result(got, want, engine):
    """Bit-equal on every field the two packages both report."""
    assert got.engine == engine
    assert got.end_us == want.end_us
    assert got.mb_s == want.mb_s
    assert (got.n_ops, got.payload_bytes) == (want.n_ops, want.payload_bytes)
    assert np.array_equal(got.channel_busy_us, want.channel_busy_us)
    assert got.sched_policy == want.sched_policy
    assert got.n_remap_ops == want.n_remap_ops
    assert same_array(got.retry_hist, want.retry_hist)
    assert same_array(got.request_lat_us, want.request_lat_us)
    if got.request_lat_us is not None:
        for q in ("p50_us", "p99_us", "p99_9_us"):
            (a, wa), (b, wb) = (percentile(r, q) for r in (got, want))
            assert a == b, q
            assert wa == wb, q      # the guard's RuntimeWarning, or none
    if want.energy is None:
        assert got.energy is None
        return
    for f in ENERGY_FIELDS + ("end_us", "nj_per_byte", "total_j"):
        assert getattr(got.energy, f) == getattr(want.energy, f), f


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("engine,jengine", ENGINES)
@pytest.mark.parametrize("policy", sched.STATIC_POLICIES)
def test_static_workload_queries_equal_to_jax(policy, engine, jengine,
                                              channels, ways):
    """``Simulator.run(RequestStream)`` under a static policy with faults
    and hedges, objective "all", bit-equal to JAX's twin engine."""
    cfg = dict(cell="mlc", channels=channels, ways=ways)
    s = api.Simulator(sim.SSDConfig(**cfg), device="cpu")
    js = japi.Simulator(j_sim.SSDConfig(**cfg))
    spec = dict(SPECS["ladder_faults"], hedge_fraction=0.2,
                hedge_after_us=20.0)
    loads, jloads = _loads(wl, channels, ways), _loads(j_wl, channels, ways)
    for name in loads:
        got = s.run(loads[name], sched_policy=policy, engine=engine,
                    faults=fl.FaultSpec(**spec), objective="all",
                    segment_len=37)
        want = js.run(jloads[name], sched_policy=policy, engine=jengine,
                      faults=j_fl.FaultSpec(**spec), objective="all",
                      segment_len=37)
        assert_same_result(got, want, engine)
        assert (got.request_lat_us is None) == (engine == "cuda")
        bare = s.run(loads[name], sched_policy=policy, engine=engine,
                     segment_len=37)
        jbare = js.run(jloads[name], sched_policy=policy, engine=jengine,
                       segment_len=37)
        assert_same_result(bare, jbare, engine)
        assert bare.retry_hist is None and bare.n_remap_ops == 0


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
def test_workload_engines_agree(channels, ways):
    """The port's engines against each other on the same faulty workload:
    within 1e-3 relative (the repo's cross-engine bar); scan, oracle and
    streaming give the same latencies within it too."""
    s = api.Simulator(sim.SSDConfig(cell="mlc", channels=channels,
                                    ways=ways), device="cpu")
    load = _loads(wl, channels, ways)["poisson"]
    spec = fl.FaultSpec(**SPECS["worn_jitter"], hedge_fraction=0.3)
    res = {e: s.run(load, engine=e, faults=spec, objective="all")
           for e, _ in ENGINES}
    ref = res["oracle"]
    for e, r in res.items():
        assert abs(r.end_us - ref.end_us) <= CROSS_ENGINE_REL * ref.end_us, e
        assert abs(r.energy.total_j - ref.energy.total_j) <= \
            CROSS_ENGINE_REL * ref.energy.total_j, e
        if r.request_lat_us is not None:
            np.testing.assert_allclose(r.request_lat_us, ref.request_lat_us,
                                       rtol=CROSS_ENGINE_REL, atol=0)
    assert res["scan"].end_us == res["streaming"].end_us


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("policy", sched.DYNAMIC_POLICIES)
@pytest.mark.parametrize("name", ("zero", "worn_jitter", "ladder_faults"))
def test_dynamic_workload_queries_equal_to_jax(name, policy, channels, ways):
    """Dynamic dispatch with faults (remap inserts, retired ways) through
    ``Simulator.run``: bit-equal to JAX's scan."""
    cfg = dict(cell="mlc", channels=channels, ways=ways)
    s = api.Simulator(sim.SSDConfig(**cfg), device="cpu")
    js = japi.Simulator(j_sim.SSDConfig(**cfg))
    spec = dict(SPECS[name], hedge_fraction=0.2)
    load = _loads(wl, channels, ways)["poisson"]
    jload = _loads(j_wl, channels, ways)["poisson"]
    got = s.run(load, sched_policy=policy, faults=fl.FaultSpec(**spec),
                objective="all")
    want = js.run(jload, sched_policy=policy, faults=j_fl.FaultSpec(**spec),
                  objective="all")
    assert_same_result(got, want, "scan")
    assert len(got.request_lat_us) == load.n_requests


def test_plain_trace_faults_equal_to_jax():
    """``faults=`` on a placed ``OpTrace`` (``sched.apply_faults`` inside
    ``run``) on every engine, bit-equal to JAX's twin."""
    s = api.Simulator(sim.SSDConfig(cell="mlc", channels=2, ways=4),
                      device="cpu")
    js = japi.Simulator(j_sim.SSDConfig(cell="mlc", channels=2, ways=4))
    t = trace.mixed_trace(240, 2, 4, 0.7, seed=4)
    jt = j_trace.mixed_trace(240, 2, 4, 0.7, seed=4)
    for engine, jengine in ENGINES:
        got = s.run(t, engine=engine, faults=fl.FaultSpec(
            **SPECS["ladder_faults"]), objective="all")
        want = js.run(jt, engine=jengine, faults=j_fl.FaultSpec(
            **SPECS["ladder_faults"]), objective="all")
        assert_same_result(got, want, engine)
        assert got.n_remap_ops > 0 and got.request_lat_us is None
        zero = s.run(t, engine=engine, faults=fl.FaultSpec(**ZERO))
        assert zero.end_us == s.run(t, engine=engine).end_us


def test_workload_query_validation():
    s = api.Simulator(sim.SSDConfig(cell="mlc", channels=2, ways=4),
                      device="cpu")
    load = wl.poisson_stream(50, 20.0, seed=2)
    for engine in ("cuda", "oracle", "streaming"):
        with pytest.raises(api.CapabilityError, match="engines that do: scan"):
            s.run(load, sched_policy="least_loaded", engine=engine)
    with pytest.raises(ValueError, match="eager"):
        s.run(load, sched_policy="least_loaded", policy="batched")
    with pytest.raises(ValueError, match="exactly one"):
        api.SimRequest(trace=trace.mixed_trace(8, 2, 4, 0.5), workload=load)
    with pytest.raises(ValueError, match="sched_policy"):
        api.SimRequest(trace=trace.mixed_trace(8, 2, 4, 0.5),
                       sched_policy="stripe")
    with pytest.raises(ValueError, match="unknown sched policy"):
        api.SimRequest(workload=load, sched_policy="striipe")
    with pytest.raises(ValueError, match="empty workload"):
        s.run(wl.poisson_stream(0, 10.0))
    bad = dataclasses.replace(load, op_cls=np.full(50, 7, np.int32))
    for policy in ("stripe", "least_loaded"):
        with pytest.raises(ValueError, match="n_classes"):
            s.run(bad, sched_policy=policy)
    bare = api.Simulator(table=s.table, device="cpu")
    with pytest.raises(ValueError, match="SSDConfig"):
        bare.run(load)
    # run_stream / sweep take sched_policy= and faults=, which act only
    # with ftl=, as in the JAX package
    t = trace.mixed_trace(64, 2, 4, 0.5, seed=1)
    assert s.run_stream(iter([t]), sched_policy="least_loaded").end_us == \
        s.run(t).end_us
    assert s.sweep(None, t, sched_policy="round_robin")[0] == \
        s.run(t, engine="prefix").end_us == japi.Simulator(
            j_sim.SSDConfig(cell="mlc", channels=2, ways=4)).sweep(
                None, j_trace.mixed_trace(64, 2, 4, 0.5, seed=1),
                shard=False)[0]
    with pytest.raises(ValueError, match="needs ftl="):
        s.run_stream(iter([t]), faults=fl.FaultSpec(wear=1.0))
    # with ftl= both act (slice E), equal to JAX: the chunked stream's
    # surcharges, and the aged sweep's placement
    from repro.core import ftl as j_ftl
    from repro_torch.core import ftl
    kw = dict(blocks=32, pages_per_block=8, overprovision=0.3)
    aged = wl.overwrite_stream(150, 60, seed=3)
    j_aged = j_wl.overwrite_stream(150, 60, seed=3)
    js = japi.Simulator(j_sim.SSDConfig(cell="mlc", channels=2, ways=4))
    got = s.run_stream(wl.iter_request_chunks(aged, 40), ftl=ftl.FTLSpec(**kw),
                       faults=fl.FaultSpec(wear=1.0, seed=2))
    want = js.run_stream(j_wl.iter_request_chunks(j_aged, 40),
                         ftl=j_ftl.FTLSpec(**kw),
                         faults=j_fl.FaultSpec(wear=1.0, seed=2))
    assert got.end_us == want.end_us and got.waf == want.waf
    assert got.end_us == s.run(aged, ftl=ftl.FTLSpec(**kw),
                               faults=fl.FaultSpec(wear=1.0, seed=2)).end_us
    got = s.sweep(None, aged, ftl=[ftl.FTLSpec(**kw)],
                  sched_policy="round_robin")
    want = js.sweep(None, j_aged, ftl=[j_ftl.FTLSpec(**kw)],
                    sched_policy="round_robin", shard=False)
    assert np.array_equal(got, want)
    res = s.run(load, sched_policy="least_loaded")
    with pytest.warns(RuntimeWarning, match="p99 on 50"):
        text = res.describe()
    assert text.startswith("[scan] 50 ops") and "p50/p99" in text


def test_percentile_guard_clamps_warns_and_nans():
    s = api.Simulator(sim.SSDConfig(cell="mlc", channels=2, ways=4),
                      device="cpu")
    res = s.run(wl.poisson_stream(10, 50.0, seed=0), sched_policy="stripe")
    lat = np.asarray(res.request_lat_us)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert res.p50_us == pytest.approx(np.percentile(lat, 50))
    for q in ("p99_us", "p99_9_us"):
        with pytest.warns(RuntimeWarning, match="percentile resolution"):
            assert getattr(res, q) == float(np.max(lat))
    res100 = s.run(wl.poisson_stream(100, 50.0, seed=1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert res100.p99_us == pytest.approx(
            np.percentile(np.asarray(res100.request_lat_us), 99))
    with pytest.warns(RuntimeWarning):
        res100.p99_9_us
    empty = dataclasses.replace(res, request_lat_us=np.zeros(0))
    assert np.isnan(empty.p50_us) and np.isnan(empty.p99_9_us)
    none = dataclasses.replace(res, request_lat_us=None)
    assert none.p50_us is None and none.p99_us is None


def test_hedged_reads_credit_the_first_response():
    """A hedged duplicate's completion wins its primary's latency when it
    is earlier, and duplicates never appear among the latencies."""
    s = api.Simulator(sim.SSDConfig(cell="mlc", channels=4, ways=4),
                      device="cpu")
    storm = dict(wear=1.0, rber_worn=3e-5, max_retries=4,
                 retry_step_us=(500.0, 1000.0, 2000.0, 4000.0), seed=7)
    load = wl.poisson_stream(400, 600.0, seed=2)
    unhedged = s.run(load, faults=fl.FaultSpec(**storm))
    hedged = s.run(load, faults=fl.FaultSpec(hedge_fraction=1.0,
                                             hedge_after_us=250.0, **storm))
    assert int(unhedged.retry_hist[1:].sum()) > 0
    assert len(hedged.request_lat_us) == load.n_requests
    assert hedged.p99_us < 0.75 * unhedged.p99_us
