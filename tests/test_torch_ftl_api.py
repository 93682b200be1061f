"""The port's FTL query surface (``Simulator.run(..., ftl=)``,
``run_stream(ftl=)``, ``sweep(ftl=)``) against the JAX package's, on the
CPU (``device="cpu"``; JAX's ``sweep`` with ``shard=False``).

Tolerances, each stated where it is used:

* one engine against its JAX twin (``cuda`` against ``pallas``): the
  translation is op-for-op JAX's and every engine runs the same float32
  (the oracle float64) operations in the same order, so end times,
  latencies, WAF, stats and ``fresh_mb_s`` are bit-equal; energies are
  the engine-free float64 per-op sum, held to the repo's 1e-3 bar;
* across engines: 1e-3 relative of the oracle, the repo's bar;
* chunked against one-shot, and the aged sweep against JAX's: equal."""

import dataclasses

import numpy as np
import pytest

from repro import api as japi
from repro.core import ftl as j_ftl
from repro.core import sim as j_sim
from repro.core import workload as j_wl
from repro_torch import api
from repro_torch.core import ftl, ftl_scan, sim
from repro_torch.core import workload as wl

ENGINES = (("scan", "scan"), ("prefix", "prefix"), ("cuda", "pallas"),
           ("streaming", "streaming"), ("oracle", "oracle"))
SPEC_KW = dict(blocks=64, pages_per_block=32, overprovision=0.25,
               precondition=True)
ENERGY_REL = 1e-3
CROSS_ENGINE_REL = 1e-3


def sims(channels=2, ways=4, **kw):
    return (api.Simulator(sim.SSDConfig(cell="mlc", channels=channels,
                                        ways=ways), device="cpu", **kw),
            japi.Simulator(j_sim.SSDConfig(cell="mlc", channels=channels,
                                           ways=ways)))


def specs(**kw):
    kw = {**SPEC_KW, **kw}
    return ftl.FTLSpec(**kw), j_ftl.FTLSpec(**kw)


def streams(builder, *args, **kw):
    return (getattr(wl, builder)(*args, **kw),
            getattr(j_wl, builder)(*args, **kw))


def assert_same_ftl_result(got, want):
    assert got.end_us == want.end_us
    assert got.n_ops == want.n_ops and got.payload_bytes == want.payload_bytes
    assert got.mb_s == want.mb_s and got.fresh_mb_s == want.fresh_mb_s
    assert (got.waf, got.gc_op_count, got.free_page_low_watermark) == (
        want.waf, want.gc_op_count, want.free_page_low_watermark)
    assert dataclasses.asdict(got.ftl_stats) == dataclasses.asdict(
        want.ftl_stats)
    assert np.array_equal(got.channel_busy_us, want.channel_busy_us)
    if want.request_lat_us is None:
        assert got.request_lat_us is None
    else:
        assert np.array_equal(got.request_lat_us, want.request_lat_us)
    for a, b in ((got.retry_hist, want.retry_hist),):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)
    if want.energy is not None:
        assert abs(got.energy.total_j - want.energy.total_j) <= \
            ENERGY_REL * abs(want.energy.total_j)


# --- every engine against its JAX twin --------------------------------------


@pytest.mark.parametrize("policy", ("eager", "batched"))
@pytest.mark.parametrize("engine,jengine", ENGINES)
def test_engines_bit_equal_to_jax(engine, jengine, policy):
    s, js = sims()
    spec, jspec = specs()
    st, jst = streams("overwrite_stream", 600, 450, read_fraction=0.2,
                      mean_interarrival_us=30.0, seed=4)
    got = s.run(st, ftl=spec, engine=engine, policy=policy,
                objective="all")
    want = js.run(jst, ftl=jspec, engine=jengine, policy=policy,
                  objective="all")
    assert got.gc_op_count > 0 and got.engine == engine
    assert_same_ftl_result(got, want)


@pytest.mark.parametrize("channels,ways", [(1, 2), (4, 8)])
def test_gc_translated_engines_agree(channels, ways):
    """GC ops are ordinary trace ops: every ftl engine answers the
    translated stream within 1e-3 of the oracle, with one accounting."""
    s, _ = sims(channels, ways)
    spec, _ = specs()
    st = wl.overwrite_stream(800, 700, read_fraction=0.2,
                             mean_interarrival_us=30.0, seed=channels * 7)
    got = {e: s.run(st, ftl=spec, engine=e) for e, _ in ENGINES}
    ref = got["oracle"]
    for e, res in got.items():
        assert abs(res.end_us - ref.end_us) <= CROSS_ENGINE_REL * ref.end_us
        assert (res.waf, res.n_ops) == (ref.waf, ref.n_ops), e


def test_dynamic_dispatch_consumes_gc_ops():
    s, js = sims()
    spec, jspec = specs()
    st, jst = streams("overwrite_stream", 700, 600, seed=3)
    dyn = s.run(st, ftl=spec, sched_policy="least_loaded")
    assert_same_ftl_result(dyn, js.run(jst, ftl=jspec,
                                       sched_policy="least_loaded"))
    sta = s.run(st, ftl=spec)
    assert dyn.sched_policy == "least_loaded"
    assert dyn.waf == sta.waf and dyn.gc_op_count == sta.gc_op_count
    assert dyn.request_lat_us is not None
    with pytest.raises(ValueError, match="dynamic dispatch"):
        s.run(st, ftl=spec, sched_policy="least_loaded", policy="batched")


def test_faults_retire_blocks_and_price_retries():
    """Block failures take the host translator (bit-equal to JAX's), the
    per-op retries ride the scan path's sampler on the class view."""
    s, js = sims()
    spec, jspec = specs(blocks=128, pages_per_block=16, overprovision=0.3,
                        precondition=False)
    st, jst = streams("overwrite_stream", 4000, spec.logical_pages,
                      read_fraction=0.2, seed=2)
    kw = dict(wear=0.6, prog_fail_prob=0.002, erase_fail_prob=0.01, seed=3)
    got = s.run(st, ftl=spec, faults=api.FaultSpec(**kw), objective="all")
    want = js.run(jst, ftl=jspec, faults=japi.FaultSpec(**kw),
                  objective="all")
    assert_same_ftl_result(got, want)
    assert got.ftl_stats.blocks_retired > 0 and got.ftl_stats.prog_fails > 0
    assert got.retry_hist[1:].sum() > 0
    clean = s.run(st, ftl=spec)
    assert got.end_us > clean.end_us and clean.retry_hist is None
    jitter = dict(wear=0.6, jitter_us=0.4, seed=13)
    assert_same_ftl_result(
        s.run(st, ftl=spec, faults=api.FaultSpec(**jitter)),
        js.run(jst, ftl=jspec, faults=japi.FaultSpec(**jitter)))


def test_hedged_ftl_stream_equals_jax():
    s, js = sims()
    spec, jspec = specs(blocks=128, pages_per_block=32, overprovision=0.3,
                        precondition=False)
    st, jst = streams("overwrite_stream", 800, 1024, read_fraction=0.5,
                      seed=5)
    kw = dict(wear=0.5, hedge_fraction=0.3, seed=4)
    got = s.run(st, ftl=spec, faults=api.FaultSpec(**kw))
    assert_same_ftl_result(got, js.run(jst, ftl=jspec,
                                       faults=japi.FaultSpec(**kw)))
    assert len(got.request_lat_us) == st.n_requests


def test_default_path_is_scan_and_failures_take_the_host(monkeypatch):
    s, _ = sims()
    spec, _ = specs()
    st = wl.overwrite_stream(300, 250, seed=2)
    calls = {"scan": 0, "host": 0}
    real_scan, real_host = ftl_scan.translate_scan, ftl.translate

    def spy_scan(*a, **kw):
        calls["scan"] += 1
        assert kw["device"] == s.device
        return real_scan(*a, **kw)

    def spy_host(*a, **kw):
        calls["host"] += 1
        return real_host(*a, **kw)
    monkeypatch.setattr(ftl_scan, "translate_scan", spy_scan)
    monkeypatch.setattr(ftl, "translate", spy_host)
    s.run(st, ftl=spec)
    assert calls == {"scan": 1, "host": 0}
    s.run(st, ftl=dataclasses.replace(spec, overprovision=0.5,
                                      precondition=False),
          faults=api.FaultSpec(prog_fail_prob=0.002, seed=3))
    assert calls == {"scan": 1, "host": 1}
    s.run(st, ftl=spec, faults=api.FaultSpec(wear=0.5, seed=3))
    assert calls == {"scan": 2, "host": 1}


# --- results, validation, capability ----------------------------------------


def test_aged_slower_than_fresh_and_no_gc_no_cliff():
    s, _ = sims()
    spec, _ = specs()
    res = s.run(wl.overwrite_stream(1200, 1000, seed=1), ftl=spec)
    assert res.gc_op_count > 0 and res.fresh_mb_s is not None
    assert res.mb_s < res.fresh_mb_s and res.waf > 1.0
    assert res.ftl_stats.gc_pages_moved > 0
    assert "WAF" in res.describe()
    big = ftl.FTLSpec(blocks=128, pages_per_block=64, overprovision=0.5)
    res = s.run(wl.overwrite_stream(200, 150, seed=2), ftl=big)
    assert res.gc_op_count == 0 and res.fresh_mb_s is None
    assert res.waf == 1.0
    plain = s.run(wl.overwrite_stream(100, 64, seed=0))
    assert plain.waf is None and plain.gc_op_count is None
    assert plain.fresh_mb_s is None and plain.ftl_stats is None


def test_simrequest_ftl_validation_matches_jax():
    t = api.steady_trace(8, 1, 1)
    jt = japi.build_workload("mixed", j_sim.SSDConfig(channels=2, ways=4))
    spec, jspec = specs()
    for make, jmake, field in (
            (lambda: api.SimRequest(trace=t, ftl=spec),
             lambda: japi.SimRequest(trace=jt, ftl=jspec), "workload"),
            (lambda: api.SimRequest(workload=wl.overwrite_stream(10, 8),
                                    ftl="greedy"),
             lambda: japi.SimRequest(workload=j_wl.overwrite_stream(10, 8),
                                     ftl="greedy"), "FTLSpec")):
        with pytest.raises(ValueError, match=field) as got:
            make()
        with pytest.raises(ValueError) as want:
            jmake()
        assert str(got.value) == str(want.value)


def test_squaring_lacks_ftl_capability():
    s, js = sims()
    spec, jspec = specs()
    with pytest.raises(api.CapabilityError) as got:
        s.run(wl.overwrite_stream(50, 40, seed=0), ftl=spec,
              engine="squaring")
    with pytest.raises(japi.CapabilityError) as want:
        js.run(j_wl.overwrite_stream(50, 40, seed=0), ftl=jspec,
               engine="squaring")
    head = "engine 'squaring' cannot consume FTL-translated streams " \
        "(engines that can: "
    msg, jmsg = str(got.value), str(want.value)
    assert msg.startswith(head) and jmsg.startswith(head)
    names = msg[len(head):-1].split(", ")
    assert names == sorted(e for e, _ in ENGINES)
    assert sorted(jmsg[len(head):-1].split(", ")) == sorted(
        j for _, j in ENGINES)
    caps = api.engine_capabilities()
    assert not caps["squaring"].ftl
    assert all(caps[e].ftl for e, _ in ENGINES)
    assert "ftl" in caps["scan"].describe()


def test_ftl_session_cache_lru_eviction():
    s, _ = sims(2, 2, max_ftl_sessions=2)
    st = wl.overwrite_stream(120, 60, seed=1)
    base = ftl.FTLSpec(blocks=32, pages_per_block=8, overprovision=0.3)
    points = [dataclasses.replace(base, map_us=m) for m in (0.5, 0.7, 0.9)]
    first = s.run(st, ftl=points[0]).end_us
    info = s.ftl_cache_info()
    assert isinstance(info, api.CacheInfo)
    assert info.entries == 1 and info.max_entries == 2
    s.run(st, ftl=points[1])
    s.run(st, ftl=points[2])            # evicts points[0]'s session
    info = s.ftl_cache_info()
    assert info.entries == 2 and info.evictions == 1
    assert s.run(st, ftl=points[0]).end_us == first     # rebuilt
    assert s.ftl_cache_info().evictions == 2
    s.run(st, ftl=points[0])
    assert s.ftl_cache_info().hits >= 1
    a = s._ftl_session(base)
    assert a is s._ftl_session(dataclasses.replace(base, gc_policy="lru",
                                                   overprovision=0.4))
    assert a.device == s.device and a.table.n_classes == 7
    with pytest.raises(ValueError, match="max_ftl_sessions"):
        api.Simulator(sim.SSDConfig(channels=2, ways=2), device="cpu",
                      max_ftl_sessions=0)


# --- run_stream(ftl=) -------------------------------------------------------


def test_run_stream_ftl_matches_one_shot_and_jax():
    s, js = sims()
    spec, jspec = specs(pages_per_block=16, overprovision=0.28)
    st, jst = streams("overwrite_stream", 500, 200, seed=6)
    one = s.run(st, ftl=spec)
    for chunk in (64, 128, 500):
        res = s.run_stream(wl.iter_request_chunks(st, chunk), ftl=spec)
        assert res.end_us == one.end_us, chunk
        assert res.waf == one.waf and res.ftl_stats == one.ftl_stats
        assert (res.n_ops, res.payload_bytes) == (one.n_ops,
                                                  one.payload_bytes)
    want = js.run_stream(j_wl.iter_request_chunks(jst, 128), ftl=jspec,
                         objective="all")
    got = s.run_stream(wl.iter_request_chunks(st, 128), ftl=spec,
                       objective="all")
    assert got.end_us == want.end_us and got.waf == want.waf
    assert got.energy.total_j == pytest.approx(want.energy.total_j,
                                               rel=ENERGY_REL)


def test_run_stream_ftl_faults_composition():
    s, js = sims()
    spec, jspec = specs(pages_per_block=16, overprovision=0.3)
    faults = dict(wear=0.6, jitter_us=0.4, seed=13)
    st, jst = streams("overwrite_stream", 400, 160, seed=7)
    one = s.run(st, ftl=spec, faults=api.FaultSpec(**faults))
    res = s.run_stream(wl.iter_request_chunks(st, 96), ftl=spec,
                       faults=api.FaultSpec(**faults))
    assert res.end_us == one.end_us and res.waf == one.waf
    res2 = s.run_stream(wl.iter_request_chunks(st, 37), ftl=spec,
                        faults=api.FaultSpec(**faults))
    assert res2.end_us == res.end_us
    want = js.run_stream(j_wl.iter_request_chunks(jst, 96), ftl=jspec,
                         faults=japi.FaultSpec(**faults))
    assert res.end_us == want.end_us


def test_run_stream_ftl_validation():
    s, _ = sims()
    spec, _ = specs()
    st = wl.overwrite_stream(64, 32, seed=1)
    with pytest.raises(ValueError, match="needs ftl="):
        s.run_stream(iter([]), faults=api.FaultSpec(wear=0.5))
    with pytest.raises(ValueError, match="dynamic"):
        s.run_stream(wl.iter_request_chunks(st, 32), ftl=spec,
                     sched_policy="least_loaded")
    with pytest.raises(ValueError, match="one-shot"):
        s.run_stream(wl.iter_request_chunks(st, 32), ftl=spec,
                     faults=api.FaultSpec(prog_fail_prob=0.1))
    with pytest.raises(ValueError, match="empty workload"):
        s.run_stream(iter([]), ftl=spec)


# --- sweep(ftl=) ------------------------------------------------------------


@pytest.mark.parametrize("sched_policy", ("stripe", "round_robin"))
def test_sweep_ftl_bit_equal_to_jax_and_per_point(sched_policy):
    """The aged sweep: bit-equal to JAX's (vmap path), and each lane the
    per-point ``run`` on the scan engine; a warm second sweep (the
    memoised preconditioned states) equals the first."""
    s, js = sims()
    kw = [dict(pages_per_block=16, overprovision=op, gc_policy=pol)
          for op in (0.15, 0.3, 0.5) for pol in ftl.GC_POLICIES]
    kw.append(dict(pages_per_block=16, overprovision=0.4,
                   precondition=False, gc_free_blocks=3))
    pts = [specs(**k) for k in kw]
    st, jst = streams("overwrite_stream", 300, 150, read_fraction=0.1,
                      seed=5)
    ends = s.sweep(None, st, ftl=[p for p, _ in pts],
                   sched_policy=sched_policy)
    want = js.sweep(None, jst, ftl=[j for _, j in pts],
                    sched_policy=sched_policy, shard=False)
    assert ends.dtype == want.dtype and np.array_equal(ends, want)
    for i in (0, 3, 6):
        assert ends[i] == s.run(st, ftl=pts[i][0],
                                sched_policy=sched_policy).end_us
    assert tuple(p for p, _ in pts) in s._ftl_pre_states
    assert np.array_equal(s.sweep(None, st, ftl=[p for p, _ in pts],
                                  sched_policy=sched_policy), ends)


def test_sweep_ftl_validation_and_error_decode():
    s, _ = sims()
    spec, _ = specs()
    st = wl.overwrite_stream(64, 32, seed=1)
    with pytest.raises(ValueError, match="tables must be"):
        s.sweep([s.table], st, ftl=[spec])
    with pytest.raises(ValueError, match="share geometry"):
        s.sweep(None, st, ftl=[spec, dataclasses.replace(spec, blocks=32)])
    with pytest.raises(ValueError, match="dynamic"):
        s.sweep(None, st, ftl=[spec], sched_policy="least_loaded")
    with pytest.raises(ValueError, match="at least one"):
        s.sweep(None, st, ftl=[])
    bad = ftl.FTLSpec(blocks=8, pages_per_block=8, overprovision=0.15,
                      precondition=True)
    with pytest.raises(RuntimeError, match="fully valid"):
        s.sweep(None, wl.overwrite_stream(64, 24, seed=3), ftl=[bad])
