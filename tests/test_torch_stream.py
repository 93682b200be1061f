"""The port's streaming path against its scan engine and the JAX
package's ``run_stream``, on the CPU: the chunk builders, the chunk fold
and ``Simulator.run_stream`` / the ``streaming`` engine.

Every chunk runs the scan engine's step from the carried state, so any
chunking is bit-equal to the one-shot scan, and to JAX, whose streaming
engine runs the same float32 operations."""

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro_torch import api
from repro_torch.core import sim, trace
from repro_torch.core.energy import op_phase_energy_uj

N_OPS, CHANNELS, WAYS = 600, 2, 4
CFG = dict(channels=CHANNELS, ways=WAYS, cell="mlc", interface="proposed")
FIELDS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
          "ctrl_us", "arb_us")


def with_side(t, cls_, seed=5):
    rng = np.random.default_rng(seed)
    return cls_(cls=t.cls, channel=t.channel, way=t.way, parity=t.parity,
                channels=t.channels, ways=t.ways,
                arrival_us=np.cumsum(rng.exponential(
                    10.0, t.n_ops)).astype(np.float32),
                extra_us=np.where(rng.random(t.n_ops) < 0.1, 40.0,
                                  0.0).astype(np.float32))


@pytest.mark.parametrize("chunk_len", (7, 64, 256))
@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_run_stream_bit_equal_to_scan_and_jax(chunk_len, policy):
    t = trace.mixed_trace(N_OPS, CHANNELS, WAYS, 0.7, seed=3)
    jt = j_trace.mixed_trace(N_OPS, CHANNELS, WAYS, 0.7, seed=3)
    s = api.Simulator(sim.SSDConfig(**CFG), device="cpu")
    js = japi.Simulator(j_sim.SSDConfig(**CFG))
    scan = s.run(t, objective="all", policy=policy)
    got = s.run_stream(trace.iter_trace_chunks(t, chunk_len),
                       objective="all", policy=policy)
    gen = s.run_stream(trace.mixed_trace_chunks(
        N_OPS, CHANNELS, WAYS, 0.7, chunk_len=chunk_len, seed=3),
        objective="all", policy=policy)
    want = js.run_stream(j_trace.iter_trace_chunks(jt, chunk_len),
                         objective="all", policy=policy)
    eng = s.run(t, engine="streaming", segment_len=chunk_len,
                objective="all", policy=policy)
    for r in (got, gen, eng):
        assert r.end_us == scan.end_us == want.end_us
        assert r.energy == scan.energy
        assert r.energy.total_j == want.energy.total_j
    for r in (got, gen):
        assert r.engine == "streaming" and r.n_ops == N_OPS
        assert r.payload_bytes == scan.payload_bytes == want.payload_bytes
        assert r.mb_s == want.mb_s
        assert np.array_equal(r.channel_busy_us, want.channel_busy_us)
    bare = s.run_stream(trace.iter_trace_chunks(t, chunk_len), policy=policy)
    assert bare.end_us == scan.end_us and bare.energy is None


@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_stream_with_arrivals_and_extras_equals_scan(policy):
    t = with_side(trace.mixed_trace(300, CHANNELS, WAYS, 0.6, seed=9),
                  trace.OpTrace)
    jt = with_side(j_trace.mixed_trace(300, CHANNELS, WAYS, 0.6, seed=9),
                   j_trace.OpTrace)
    s = api.Simulator(sim.SSDConfig(**CFG), device="cpu")
    want = japi.Simulator(j_sim.SSDConfig(**CFG)).run_stream(
        j_trace.iter_trace_chunks(jt, 50), policy=policy)
    for n in (1, 50, 300):
        got = s.run_stream(trace.iter_trace_chunks(t, n), policy=policy)
        assert got.end_us == s.run(t, policy=policy).end_us == want.end_us


def test_chunk_builders_match_jax_and_the_one_shot_trace():
    whole = trace.mixed_trace(N_OPS, CHANNELS, WAYS, 0.7, seed=11)
    jchunks = list(j_trace.mixed_trace_chunks(N_OPS, CHANNELS, WAYS, 0.7,
                                              chunk_len=64, seed=11))
    chunks = list(trace.mixed_trace_chunks(N_OPS, CHANNELS, WAYS, 0.7,
                                           chunk_len=64, seed=11))
    assert [c.n_ops for c in chunks] == [c.n_ops for c in jchunks]
    for f in ("cls", "channel", "way", "parity"):
        cat = np.concatenate([getattr(c, f) for c in chunks])
        assert np.array_equal(cat, getattr(whole, f))
        assert np.array_equal(cat, np.concatenate(
            [getattr(c, f) for c in jchunks]))
    side = with_side(whole, trace.OpTrace)
    parts = list(trace.iter_trace_chunks(side, 77))
    assert [p.n_ops for p in parts] == [77] * 7 + [61]
    for f in ("cls", "arrival_us", "extra_us"):
        assert np.array_equal(np.concatenate([getattr(p, f) for p in parts]),
                              getattr(side, f))
    with pytest.raises(ValueError, match="chunk_len"):
        next(trace.iter_trace_chunks(whole, 0))
    # faults= rewrites every chunk through one carried sampler, as JAX's
    spec = dict(wear=1.0, jitter_us=2.0, prog_fail_prob=0.1,
                erase_fail_prob=0.2, seed=5)
    table = trace.op_class_table(sim.SSDConfig(**CFG))
    for got, want in (
            (trace.mixed_trace_chunks(N_OPS, CHANNELS, WAYS, 0.7,
                                      chunk_len=64, seed=11,
                                      faults=api.FaultSpec(**spec),
                                      table=table),
             j_trace.mixed_trace_chunks(N_OPS, CHANNELS, WAYS, 0.7,
                                        chunk_len=64, seed=11,
                                        faults=japi.FaultSpec(**spec),
                                        table=table)),
            (trace.iter_trace_chunks(whole, 8, faults=api.FaultSpec(**spec),
                                     table=table),
             j_trace.iter_trace_chunks(j_trace.mixed_trace(
                 N_OPS, CHANNELS, WAYS, 0.7, seed=11), 8,
                 faults=japi.FaultSpec(**spec), table=table))):
        got, want = list(got), list(want)
        assert [c.n_ops for c in got] == [c.n_ops for c in want]
        assert sum(c.n_ops for c in got) > N_OPS          # remap inserts
        for f in ("cls", "channel", "way", "parity", "extra_us"):
            assert np.array_equal(
                np.concatenate([getattr(c, f) for c in got]),
                np.concatenate([getattr(c, f) for c in want]))
        assert np.array_equal(np.concatenate([c.payload_mask() for c in got]),
                              np.concatenate([c.payload_mask()
                                              for c in want]))


@pytest.mark.parametrize("batched", (False, True))
def test_chunk_fold_matches_jax_and_leaves_the_carry(batched):
    table = trace.op_class_table(sim.SSDConfig(**CFG))
    from repro.core.energy import op_phase_energy_uj as j_energy
    e = op_phase_energy_uj(table, "proposed")
    assert np.array_equal(e, j_energy(table, "proposed"))
    cols = tuple(np.asarray(getattr(table, f)) for f in FIELDS)
    t = with_side(trace.mixed_trace(90, CHANNELS, WAYS, 0.7, seed=2),
                  trace.OpTrace)
    carry = sim.trace_chunk_init(CHANNELS, e.shape[-1])
    jcarry = j_sim.trace_chunk_init(CHANNELS, e.shape[-1])
    for lo in (0, 40):
        hi = lo + (40 if lo == 0 else 50)
        ops = (t.cls[lo:hi], t.channel[lo:hi], t.way[lo:hi],
               t.parity[lo:hi], t.arrival_us[lo:hi], t.extra_us[lo:hi])
        before = [x.clone() for x in carry[0]]
        state, acc, end, comp = sim.trace_chunk_fold(
            *(torch.as_tensor(c) for c in cols), torch.as_tensor(e), *ops,
            *carry[0], carry[1], n_channels=CHANNELS, batched=batched,
            want_comp=True)
        assert all(torch.equal(a, b) for a, b in zip(before, carry[0]))
        jstate, jacc, jend, jcomp = j_sim.trace_chunk_fold(
            *cols, e, *ops, np.ones(hi - lo, bool), *jcarry[0], jcarry[1],
            n_channels=CHANNELS, batched=batched)
        for a, b in zip(state, jstate):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(acc.numpy(), np.asarray(jacc))
        assert float(end) == float(jend)
        assert np.array_equal(comp.numpy(), np.asarray(jcomp))
        assert sim.trace_chunk_fold(
            *(torch.as_tensor(c) for c in cols), torch.as_tensor(e), *ops,
            *carry[0], carry[1], n_channels=CHANNELS,
            batched=batched)[3] is None
        carry, jcarry = (state, acc), (jstate, jacc)


def test_run_stream_validates():
    s = api.Simulator(sim.SSDConfig(**CFG), device="cpu")
    a = trace.mixed_trace(20, 2, 4, 0.5, seed=0)
    b = trace.mixed_trace(20, 1, 4, 0.5, seed=0)
    with pytest.raises(ValueError, match="switched geometry"):
        s.run_stream(iter([a, b]))
    with pytest.raises(ValueError, match="empty trace"):
        s.run_stream(iter([]))
    with pytest.raises(ValueError, match="needs ftl="):
        s.run_stream(iter([a]), faults=object())
    with pytest.raises(ValueError, match="objective"):
        s.run_stream(iter([a]), objective="speed")
    s2 = api.Simulator(table=trace.op_class_table(sim.SSDConfig(**CFG)),
                       device="cpu")
    with pytest.raises(ValueError, match="interface kind"):
        s2.run_stream(iter([a]), objective="energy")
