"""The port's dynamic dispatch fold and per-op completion folds
(``repro_torch.core.sim.dispatch_trace``, ``trace_completions``,
``trace_completions_masked``, the streaming chunk fold's completions and
``sim_ref.simulate_trace_completions_ref``) against the JAX package's,
on the CPU, at 1x1, 2x4, 4x8 and 8x16.

Tolerances: placements (channel, way, parity) equal; completions and end
times bit-equal (``np.array_equal`` on float32), since every fold runs
the JAX package's float32 operations in its order; the oracles (float64
event loops) equal; a placement replayed through another engine within
1e-3 relative, the repo's cross-engine bar."""

import numpy as np
import pytest
import torch

from repro.core import faults as j_fl
from repro.core import sim as j_sim
from repro.core import sim_ref as j_ref
from repro.core import trace as j_trace
from repro_torch import api
from repro_torch.core import faults as fl
from repro_torch.core import sim, sim_ref, trace
from repro_torch.core import workload as wl

GEOMETRIES = ((1, 1), (2, 4), (4, 8), (8, 16))
FIELDS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
          "ctrl_us", "arb_us")
CROSS_ENGINE_REL = 1e-3


def columns(channels, ways, cell="mlc"):
    table = trace.op_class_table(sim.SSDConfig(cell=cell, channels=channels,
                                               ways=ways))
    return table, tuple(np.asarray(getattr(table, f)) for f in FIELDS)


def workload(channels, ways, n=160, seed=0):
    """Placement-free ops of a loaded Poisson stream, plus surcharges and
    a retirement mask with at least one retired way where there is more
    than one way."""
    load = wl.poisson_stream(n, 6.0 * 8 / (channels * ways) + 1.0,
                             read_fraction=0.6, pages_per_request=2,
                             seed=seed)
    cls, arr, _, _ = wl.request_ops(load)
    rng = np.random.default_rng(seed + 1)
    ext = np.where(rng.random(len(cls)) < 0.1, rng.uniform(5, 400, len(cls)),
                   0.0).astype(np.float32)
    retired = np.zeros((channels, ways), bool)
    if ways > 1:
        retired[:, -1] = True
        retired[0, 0] = True
    return cls, arr, ext, retired


def torch_dispatch(cols, cls, arr, channels, ways, rule, ext, retired):
    out = sim.dispatch_trace(*(torch.as_tensor(c) for c in cols), cls, arr,
                             n_channels=channels, n_ways=ways, rule=rule,
                             extra_us=ext, retired=retired)
    return [x.numpy() for x in out]


def jax_dispatch(cols, cls, arr, channels, ways, rule, ext, retired):
    kw = {}
    if ext is not None:
        kw["extra_us"] = ext
    if retired is not None:
        kw["retired"] = retired
    out = j_sim.dispatch_trace(*cols, cls, arr, n_channels=channels,
                               n_ways=ways, rule=rule, **kw)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("rule", sim.DISPATCH_RULES)
@pytest.mark.parametrize("with_extra", (False, True))
@pytest.mark.parametrize("with_retired", (False, True))
def test_dispatch_trace_equal_to_jax(rule, channels, ways, with_extra,
                                     with_retired):
    _, cols = columns(channels, ways)
    cls, arr, ext, retired = workload(channels, ways, seed=channels + ways)
    ext = ext if with_extra else None
    retired = retired if with_retired else None
    got = torch_dispatch(cols, cls, arr, channels, ways, rule, ext, retired)
    want = jax_dispatch(cols, cls, arr, channels, ways, rule, ext, retired)
    end, comp, chan, way, par = got
    assert end.dtype == comp.dtype == np.float32
    assert float(end) == float(want[0])
    assert np.array_equal(comp, want[1])                 # bit-equal
    for a, b in zip((chan, way, par), want[2:]):
        assert a.dtype == np.int32 and np.array_equal(a, b)
    if retired is not None:
        assert not retired[chan, way].any()
    # parity is the per-chip occurrence count mod 2
    assert np.array_equal(par, fl._cumcount(chan * ways + way) % 2)


@pytest.mark.parametrize("rule", sim.DISPATCH_RULES)
def test_dispatch_survives_single_chip_and_burst_degeneracies(rule):
    """A 1x1 geometry (every op on the only chip), an all-at-once write
    burst (the greedy metric must spread over every chip), a one-op
    stream — each equal to JAX."""
    _, cols1 = columns(1, 1)
    cls, arr, _, _ = wl.request_ops(wl.poisson_stream(50, 20.0, seed=0))
    got = torch_dispatch(cols1, cls, arr, 1, 1, rule, None, None)
    want = jax_dispatch(cols1, cls, arr, 1, 1, rule, None, None)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert not got[2].any() and not got[3].any()
    _, cols = columns(2, 4)
    burst = wl.poisson_stream(48, 20.0, read_fraction=0.0, seed=0)
    cls, _, _, _ = wl.request_ops(burst)
    zeros = np.zeros(len(cls), np.float32)
    got = torch_dispatch(cols, cls, zeros, 2, 4, rule, None, None)
    want = jax_dispatch(cols, cls, zeros, 2, 4, rule, None, None)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    counts = np.bincount(got[2] * 4 + got[3], minlength=8)
    assert counts.min() >= 1 and counts.max() - counts.min() <= 2
    one = torch_dispatch(cols, cls[:1], zeros[:1], 2, 4, rule, None, None)
    assert (one[2][0], one[3][0], one[4][0]) == (0, 0, 0) and one[1][0] > 0
    with pytest.raises(ValueError, match="unknown dispatch rule"):
        sim.dispatch_trace(*(torch.zeros(1),) * 7, np.zeros(1, np.int32),
                           np.zeros(1, np.float32), n_channels=1, n_ways=1,
                           rule="bogus")
    with pytest.raises(ValueError, match="retired"):
        torch_dispatch(cols, cls, zeros, 2, 4, rule, None,
                       np.zeros((2, 3), bool))


def test_dispatch_never_lands_on_a_retired_way():
    """Over a seed grid of retirement draws, neither rule places an op on
    a retired (channel, way), and both equal JAX."""
    _, cols = columns(2, 4)
    for seed in range(5):
        sampler = fl.FaultSampler(fl.FaultSpec(rber_fresh=0.0,
                                               rber_worn=0.0,
                                               erase_fail_prob=0.45,
                                               seed=seed), 2, 4)
        jsampler = j_fl.FaultSampler(j_fl.FaultSpec(
            rber_fresh=0.0, rber_worn=0.0, erase_fail_prob=0.45, seed=seed),
            2, 4)
        assert np.array_equal(sampler.retired, jsampler.retired)
        if not sampler.retired.any():
            continue
        cls, arr, _, _ = wl.request_ops(wl.poisson_stream(120, 30.0,
                                                          seed=seed))
        for rule in sim.DISPATCH_RULES:
            got = torch_dispatch(cols, cls, arr, 2, 4, rule, None,
                                 sampler.retired)
            assert not sampler.retired[got[2], got[3]].any(), (seed, rule)
            want = jax_dispatch(cols, cls, arr, 2, 4, rule, None,
                                sampler.retired)
            for a, b in zip(got, want):
                assert np.array_equal(a, b)


@pytest.mark.parametrize("rule", sim.DISPATCH_RULES)
def test_dispatch_placement_replays_on_every_engine(rule):
    """The dispatched placement, replayed as a static trace, gives the
    same end time through the scan engine (bit-equal: the same float32
    operations) and the cuda engine's plain version and the oracle
    (within 1e-3 relative), and the same completions as the oracle."""
    cfg = sim.SSDConfig(cell="mlc", channels=2, ways=4)
    s = api.Simulator(cfg, device="cpu")
    load = wl.multi_tenant([
        wl.bursty_stream(60, burst_len=12, gap_us=800.0, read_fraction=0.2,
                         seed=5),
        wl.poisson_stream(60, 60.0, seed=6, stream=1)])
    cls, arr, _, _ = wl.request_ops(load)
    end, comp, chan, way, par = api.get_engine("scan").dispatch_run(
        s, cls, arr, n_channels=2, n_ways=4, rule=rule)
    replay = trace.OpTrace(cls=cls, channel=chan, way=way, parity=par,
                           channels=2, ways=4, arrival_us=arr)
    assert s.run(replay, engine="scan").end_us == end
    ref, comp_ref = sim_ref.simulate_trace_completions_ref(s.table, replay)
    for engine in ("cuda", "oracle"):
        assert abs(s.run(replay, engine=engine).end_us - ref) <= \
            CROSS_ENGINE_REL * ref, engine
    np.testing.assert_allclose(comp, comp_ref, rtol=CROSS_ENGINE_REL, atol=0)
    _, scan_comp = api.get_engine("scan").completions(s, replay,
                                                      batched=False)
    assert np.array_equal(scan_comp, comp)


def side_trace(channels, ways, seed, n=300):
    t = trace.mixed_trace(n, channels, ways, 0.6, seed=seed)
    rng = np.random.default_rng(seed)
    arr = np.cumsum(rng.exponential(4.0, n)).astype(np.float32)
    ext = np.where(rng.random(n) < 0.1, 33.0, 0.0).astype(np.float32)
    return t, arr, ext


@pytest.mark.parametrize("channels,ways", GEOMETRIES)
@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_trace_completions_equal_to_jax(policy, channels, ways):
    """``trace_completions`` and its masked twin bit-equal to JAX's, the
    masked one over a padded bucket too; the oracles equal."""
    table, cols = columns(channels, ways)
    batched = policy == "batched"
    t, arr, ext = side_trace(channels, ways, seed=channels * ways)
    ops = (t.cls, t.channel, t.way, t.parity)
    ends = []
    for a, e in ((arr, ext), (None, None)):
        end, comp = sim.trace_completions(
            *(torch.as_tensor(c) for c in cols), *ops, a, e,
            n_channels=channels, batched=batched)
        jend, jcomp = j_sim.trace_completions(
            *cols, *ops, np.zeros(t.n_ops, np.float32) if a is None else a,
            np.zeros(t.n_ops, np.float32) if e is None else e,
            n_channels=channels, batched=batched)
        assert float(end) == float(jend)
        assert np.array_equal(comp.numpy(), np.asarray(jcomp))
        assert float(end) == float(sim.trace_end_time(
            *(torch.as_tensor(c) for c in cols), *ops, a, e,
            n_channels=channels, batched=batched))
        ends.append(float(end))
    pad = 84
    padded = [np.pad(x, (0, pad)) for x in (*ops, arr, ext)]
    valid = np.arange(t.n_ops + pad) < t.n_ops
    mend, mcomp = sim.trace_completions_masked(
        *(torch.as_tensor(c) for c in cols), *padded, valid,
        n_channels=channels, batched=batched)
    jmend, jmcomp = j_sim.trace_completions_masked(
        *cols, *padded, valid, n_channels=channels, batched=batched)
    assert float(mend) == float(jmend) == ends[0]
    assert np.array_equal(mcomp.numpy(), np.asarray(jmcomp))
    side = trace.OpTrace(cls=t.cls, channel=t.channel, way=t.way,
                         parity=t.parity, channels=channels, ways=ways,
                         arrival_us=arr, extra_us=ext)
    jside = j_trace.OpTrace(cls=t.cls, channel=t.channel, way=t.way,
                            parity=t.parity, channels=channels, ways=ways,
                            arrival_us=arr, extra_us=ext)
    rend, rcomp = sim_ref.simulate_trace_completions_ref(table, side, policy)
    jrend, jrcomp = j_ref.simulate_trace_completions_ref(table, jside,
                                                         policy)
    assert rend == jrend and np.array_equal(rcomp, jrcomp)
    np.testing.assert_allclose(mcomp.numpy()[: t.n_ops], rcomp,
                               rtol=CROSS_ENGINE_REL, atol=0)


@pytest.mark.parametrize("chunk_len", (1, 37, 300))
def test_stream_completions_equal_scan_and_jax(chunk_len):
    """The streaming engine's completions, chunk by chunk from the
    carried state, bit-equal to the scan engine's and to JAX's."""
    from repro import api as japi
    cfg = dict(cell="mlc", channels=2, ways=4)
    s = api.Simulator(sim.SSDConfig(**cfg), device="cpu")
    js = japi.Simulator(j_sim.SSDConfig(**cfg))
    t, arr, ext = side_trace(2, 4, seed=3)
    side = trace.OpTrace(cls=t.cls, channel=t.channel, way=t.way,
                         parity=t.parity, channels=2, ways=4,
                         arrival_us=arr, extra_us=ext)
    jside = j_trace.OpTrace(cls=t.cls, channel=t.channel, way=t.way,
                            parity=t.parity, channels=2, ways=4,
                            arrival_us=arr, extra_us=ext)
    end, comp = api.get_engine("streaming").completions(
        s, side, batched=False, segment_len=chunk_len)
    jend, jcomp = japi.get_engine("streaming").completions(
        js, jside, batched=False, segment_len=chunk_len)
    send, scomp = api.get_engine("scan").completions(s, side, batched=False)
    assert end == jend == send
    assert np.array_equal(comp, jcomp) and np.array_equal(comp, scomp)
