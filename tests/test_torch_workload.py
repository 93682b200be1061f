"""The port's request-level workload layer (``repro_torch.core.workload``)
against the JAX package's ``repro.core.workload``, on the CPU: every
stream builder, the request readers and every ``build_workload`` kind,
fed the same seeds at 1x1, 2x4, 4x8 and 8x16.  Both modules are numpy
on the same PCG64 streams, so the tolerance is array equality
(``np.array_equal``, dtypes included) throughout."""

import dataclasses

import numpy as np
import pytest

from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro.core import workload as j_wl
from repro_torch.core import sim, trace
from repro_torch.core import workload as wl

GEOMETRIES = ((1, 1), (2, 4), (4, 8), (8, 16))
STREAM_FIELDS = ("arrival_us", "op_cls", "n_pages", "stream", "payload",
                 "hedge_of", "lpn")
TRACE_FIELDS = ("cls", "channel", "way", "parity", "payload", "arrival_us",
                "extra_us")


def same_array(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def assert_same_stream(got, want):
    assert isinstance(got, wl.RequestStream)
    for f in STREAM_FIELDS:
        assert same_array(getattr(got, f), getattr(want, f)), f
    assert got.describe() == want.describe()
    assert got.total_pages == want.total_pages
    assert np.array_equal(got.payload_mask(), want.payload_mask())
    assert np.array_equal(got.hedge_mask(), want.hedge_mask())


def assert_same_trace(got, want):
    assert isinstance(got, trace.OpTrace)
    assert (got.channels, got.ways) == (want.channels, want.ways)
    for f in TRACE_FIELDS:
        assert same_array(getattr(got, f), getattr(want, f)), f


# one call per builder, the same arguments to both packages
BUILDERS = {
    "poisson": lambda m: m.poisson_stream(
        300, 25.0, read_fraction=0.6, pages_per_request=3, seed=4,
        stream=2),
    "poisson_empty": lambda m: m.poisson_stream(0, 10.0),
    "bursty": lambda m: m.bursty_stream(
        150, burst_len=16, gap_us=900.0, intra_us=2.5, read_fraction=0.3,
        pages_per_request=2, seed=7),
    "closed_loop": lambda m: m.closed_loop_stream(
        120, queue_depth=6, service_us=45.0, read_fraction=0.5, seed=8),
    "overwrite": lambda m: m.overwrite_stream(
        200, 512, read_fraction=0.25, pages_per_request=2, seed=5),
    "overwrite_poisson": lambda m: m.overwrite_stream(
        200, 64, mean_interarrival_us=30.0, seed=6),
    "aging": lambda m: m.aging_stream(
        250, 1024, hot_fraction=0.1, hot_traffic=0.9, read_fraction=0.2,
        mean_interarrival_us=12.0, seed=9),
    "hedged": lambda m: m.with_hedges(
        m.poisson_stream(200, 30.0, read_fraction=0.8, pages_per_request=2,
                         seed=1), 0.4, after_us=35.0, seed=2),
    "hedged_adjacent": lambda m: m.with_hedges(
        m.poisson_stream(200, 30.0, read_fraction=0.8, seed=1), 0.5),
    "hedged_twice": lambda m: m.with_hedges(m.with_hedges(
        m.poisson_stream(100, 30.0, seed=3), 0.3, after_us=5.0, seed=1),
        0.3, after_us=80.0, seed=2),
    "multi_tenant": lambda m: m.multi_tenant([
        m.poisson_stream(80, 40.0, read_fraction=0.5, seed=1),
        m.with_hedges(m.bursty_stream(60, 12, 500.0, seed=2), 0.5,
                      after_us=10.0, seed=3),
        m.closed_loop_stream(40, 4, 90.0, seed=4)]),
    "multi_tenant_lpn": lambda m: m.multi_tenant([
        m.overwrite_stream(50, 128, mean_interarrival_us=20.0, seed=1),
        m.aging_stream(50, 256, mean_interarrival_us=15.0, seed=2)]),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_stream_builders_array_equal_to_jax(name):
    assert_same_stream(BUILDERS[name](wl), BUILDERS[name](j_wl))


@pytest.mark.parametrize("name", ("poisson", "hedged", "multi_tenant",
                                  "aging"))
def test_request_readers_array_equal_to_jax(name):
    s, js = BUILDERS[name](wl), BUILDERS[name](j_wl)
    for a, b in zip(wl.request_ops(s), j_wl.request_ops(js)):
        assert same_array(a, b)
    for n_logical in (1, 7, 4096):
        assert same_array(wl.request_lpns(s, n_logical),
                          j_wl.request_lpns(js, n_logical))
    if s.hedge_of is not None:
        with pytest.raises(ValueError, match="hedged streams"):
            next(wl.iter_request_chunks(s, 8))
        return
    for size in (1, 33, 10_000):
        got = list(wl.iter_request_chunks(s, size))
        want = list(j_wl.iter_request_chunks(js, size))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_stream(g, w)


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
def test_storage_emitters_array_equal_to_jax(channels, ways):
    for cell in ("slc", "mlc"):
        cfg = sim.SSDConfig(cell=cell, channels=channels, ways=ways)
        jcfg = j_sim.SSDConfig(cell=cell, channels=channels, ways=ways)
        for call in (
                lambda m, c: m.checkpoint_requests(10 << 20, c),
                lambda m, c: m.checkpoint_requests(3000, c, max_ops=64),
                lambda m, c: m.datapipe_requests(
                    4 << 20, c, hedge_fraction=0.3, seed=2,
                    hedge_after_us=12.0),
                lambda m, c: m.kvoffload_requests(
                    1 << 20, c, n_tokens=4, append_bytes_per_token=8192),
                lambda m, c: m.kvoffload_requests(
                    1 << 30, c, append_bytes_per_token=1 << 24,
                    max_ops=512)):
            assert_same_stream(call(wl, cfg), call(j_wl, jcfg))
        for name, kw in (("checkpoint_trace", dict(nbytes=5 << 20)),
                         ("datapipe_trace", dict(nbytes=2 << 20,
                                                 hedge_fraction=0.25,
                                                 seed=1)),
                         ("kvoffload_trace", dict(read_bytes_per_token=
                                                  1 << 19, n_tokens=3,
                                                  append_bytes_per_token=
                                                  4096))):
            assert_same_trace(getattr(trace, name)(cfg=cfg, **kw),
                              getattr(j_trace, name)(cfg=jcfg, **kw))


KIND_ARGS = {
    "checkpoint": dict(nbytes=3 << 20),
    "datapipe": dict(nbytes=2 << 20, hedge_fraction=0.2, seed=3),
    "kvoffload": dict(read_bytes_per_token=1 << 20, n_tokens=2,
                      append_bytes_per_token=1 << 14),
    "mixed": dict(n_ops=700, read_fraction=0.4, seed=5),
    "hot_cold": dict(n_ops=500, seed=6),
    "steady_read": dict(n_pages=40),
    "steady_write": dict(n_pages=40),
    "poisson": dict(n_requests=300, mean_interarrival_us=20.0,
                    read_fraction=0.7, pages_per_request=2, seed=1),
    "bursty": dict(n_requests=256, burst_len=32, gap_us=700.0, seed=2),
    "closed_loop": dict(n_requests=200, queue_depth=4, service_us=30.0),
    "overwrite": dict(n_requests=256, footprint_pages=512, seed=3),
    "aging": dict(n_requests=256, footprint_pages=512, seed=4),
}


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("kind", sorted(KIND_ARGS))
def test_build_workload_kinds_array_equal_to_jax(kind, channels, ways):
    cfg = sim.SSDConfig(channels=channels, ways=ways)
    jcfg = j_sim.SSDConfig(channels=channels, ways=ways)
    assert_same_trace(wl.build_workload(kind, cfg, **KIND_ARGS[kind]),
                      j_wl.build_workload(kind, jcfg, **KIND_ARGS[kind]))


def test_workload_kinds_registry():
    assert wl.WORKLOAD_KINDS == j_wl.WORKLOAD_KINDS
    assert set(KIND_ARGS) == set(wl.WORKLOAD_KINDS)
    cfg = sim.SSDConfig(channels=2, ways=4)
    with pytest.raises(ValueError, match="unknown workload kind"):
        wl.build_workload("poison", cfg)
    with pytest.raises(TypeError):
        wl.build_workload("poisson", cfg, n_request=3)
    # the defaults of every kind build too, equal to JAX's
    jcfg = j_sim.SSDConfig(channels=2, ways=4)
    for kind in ("steady_read", "mixed", "hot_cold", "poisson", "bursty",
                 "closed_loop", "overwrite", "aging"):
        assert_same_trace(wl.build_workload(kind, cfg),
                          j_wl.build_workload(kind, jcfg))


def test_workload_builders_structure():
    """The JAX package's structural checks of the builders, on the
    port's."""
    p = wl.poisson_stream(200, 50.0, read_fraction=0.5, seed=1)
    assert p.n_requests == 200 and p.arrival_us[0] == 0.0
    assert np.all(np.diff(p.arrival_us) >= 0)
    assert 0.3 < np.mean(p.op_cls == trace.READ) < 0.7
    b = wl.bursty_stream(64, burst_len=16, gap_us=1000.0, intra_us=2.0)
    assert np.sum(np.diff(b.arrival_us.astype(np.float64)) > 100.0) == 3
    c = wl.closed_loop_stream(40, queue_depth=4, service_us=100.0)
    assert np.all(c.arrival_us[:4] == 0.0) and c.arrival_us[-1] > 0
    m = wl.multi_tenant([p, b, c])
    assert m.n_requests == 304 and set(np.unique(m.stream)) == {0, 1, 2}
    assert "3 stream(s)" in m.describe()
    with pytest.raises(ValueError, match="at least one"):
        wl.multi_tenant([])
    with pytest.raises(ValueError, match="lpn"):
        wl.multi_tenant([p, wl.overwrite_stream(4, 8)])
    cls, arr, req, payload = wl.request_ops(
        wl.poisson_stream(10, 5.0, pages_per_request=3))
    assert len(cls) == 30 and np.all(payload)
    assert np.array_equal(req, np.repeat(np.arange(10), 3))
    assert wl.with_hedges(wl.poisson_stream(0, 10.0), 0.5).n_requests == 0
    for bad, match in ((dict(burst_len=0), "burst_len"),):
        with pytest.raises(ValueError, match=match):
            wl.bursty_stream(8, gap_us=1.0, **bad)
    with pytest.raises(ValueError, match="queue_depth"):
        wl.closed_loop_stream(8, 0, 1.0)
    with pytest.raises(ValueError, match="footprint_pages"):
        wl.overwrite_stream(8, 0)
    with pytest.raises(ValueError, match="hot_fraction"):
        wl.aging_stream(8, 16, hot_fraction=1.0)
    with pytest.raises(ValueError, match="n_logical"):
        wl.request_lpns(p, 0)
    with pytest.raises(ValueError, match="chunk_requests"):
        next(wl.iter_request_chunks(p, 0))


def test_request_stream_validation():
    ok = dict(arrival_us=np.zeros(2, np.float32), op_cls=np.zeros(2, np.int32),
              n_pages=np.ones(2, np.int32), stream=np.zeros(2, np.int32))
    wl.RequestStream(**ok)
    for bad, match in (
            (dict(arrival_us=np.array([5.0, 1.0], np.float32)),
             "non-decreasing"),
            (dict(arrival_us=np.array([-1.0, 1.0], np.float32)),
             "non-negative"),
            (dict(n_pages=np.zeros(2, np.int32)), "n_pages"),
            (dict(op_cls=np.array([0, -1], np.int32)), "op_cls"),
            (dict(stream=np.zeros(3, np.int32)), "stream"),
            (dict(hedge_of=np.array([1, 1], np.int32)), "hedge_of"),
            (dict(hedge_of=np.array([-1, 0], np.int32),
                  n_pages=np.array([1, 2], np.int32)), "n_pages"),
            (dict(lpn=np.array([0, -3], np.int64)), "lpn")):
        with pytest.raises(ValueError, match=match):
            wl.RequestStream(**{**ok, **bad})
    hedged = dataclasses.replace(
        wl.RequestStream(**ok), hedge_of=np.array([-1, 0], np.int32))
    assert np.array_equal(hedged.hedge_mask(), [False, True])
