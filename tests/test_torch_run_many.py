"""The port's fleet and fan-out paths against the JAX package's, on the
CPU: ``Simulator.run_many`` (scan against scan, cuda against pallas),
the masked lane folds behind it, the homogeneous design-point sweep and
``Simulator.sweep``.

End times are bit-equal: each port path runs the same float32
operations in the same order as its JAX twin.  Energies of ``run_many``
are per-op sums in float64 on the host in both packages; they are held
within 1e-12 relative (the phase tables agree bit for bit, so in
practice the sums do too).
"""

import numpy as np
import pytest

from repro import api as japi
from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro.core.calibrate import _OP_FIELDS
from repro.core.interface import make_interface as j_make_interface
from repro.core.nand import chip as j_chip
from repro_torch import api
from repro_torch.core import sim, trace
from repro_torch.core.api import _bucket_len, _pad_trace_np
from repro_torch.core.interface import make_interface
from repro_torch.core.nand import chip

LENGTHS = (33, 100, 257, 100, 64, 12)
ENERGY_REL = 1e-12
ENERGY_FIELDS = ("cmd_j", "io_j", "ecc_j", "ctrl_j", "idle_j", "array_j")
CFG = dict(channels=2, ways=4, cell="mlc", interface="proposed")
FIELDS = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
          "ctrl_us", "arb_us")


def fleet(seed=0, channels=2, ways=4, lengths=LENGTHS):
    """Port and JAX traces of mixed lengths; even lanes carry arrivals,
    every third lane fault surcharges."""
    out, jout = [], []
    for i, n in enumerate(lengths):
        rng = np.random.default_rng(seed * 100 + i)
        t = trace.mixed_trace(n, channels, ways, 0.7, seed=seed + i)
        arr = (np.cumsum(rng.exponential(14.0, n)).astype(np.float32)
               if i % 2 == 0 else None)
        ext = (np.where(rng.random(n) < 0.1, rng.uniform(30, 120, n),
                        0.0).astype(np.float32) if i % 3 == 1 else None)
        kw = dict(cls=t.cls, channel=t.channel, way=t.way, parity=t.parity,
                  channels=channels, ways=ways, arrival_us=arr, extra_us=ext)
        out.append(trace.OpTrace(**kw))
        jout.append(j_trace.OpTrace(**kw))
    return out, jout


def sessions(cfg=CFG):
    return (api.Simulator(sim.SSDConfig(**cfg), device="cpu"),
            japi.Simulator(j_sim.SSDConfig(**cfg)))


@pytest.mark.parametrize("engine,jengine", [("scan", "scan"),
                                            ("cuda", "pallas")])
@pytest.mark.parametrize("objective", ("end_time", "all"))
@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_run_many_matches_jax(engine, jengine, objective, policy):
    pt, jt = fleet()
    s, js = sessions()
    got = s.run_many(pt, engine=engine, objective=objective, policy=policy)
    want = js.run_many(jt, engine=jengine, objective=objective,
                       policy=policy, shard=False)
    assert [r.end_us for r in got] == [r.end_us for r in want]
    for g, w in zip(got, want):
        assert g.engine == engine and w.engine == jengine
        assert (g.n_ops, g.payload_bytes) == (w.n_ops, w.payload_bytes)
        assert g.mb_s == w.mb_s
        assert np.array_equal(g.channel_busy_us, w.channel_busy_us)
        if objective == "end_time":
            assert g.energy is None and w.energy is None
            continue
        for f in ENERGY_FIELDS:
            a, b = getattr(g.energy, f), getattr(w.energy, f)
            assert abs(a - b) <= ENERGY_REL * abs(b), f


@pytest.mark.parametrize("engine", ("scan", "cuda", "oracle"))
def test_run_many_equals_per_trace_run(engine):
    pt, _ = fleet(seed=4, lengths=(70, 9, 130))
    s, _ = sessions()
    many = s.run_many(pt, engine=engine, objective="all")
    for t, r in zip(pt, many):
        one = s.run(t, engine=engine, objective="all")
        assert r.end_us == one.end_us and r.engine == engine
        assert r.energy.total_j == pytest.approx(one.energy.total_j,
                                                 rel=1e-6)
    assert s.run_many([]) == [] and s.run_many([], engine="cuda") == []


def test_run_many_groups_geometries_and_validates():
    a, _ = fleet(seed=1, channels=2, ways=4, lengths=(50, 20))
    b, _ = fleet(seed=2, channels=1, ways=2, lengths=(40,))
    s, _ = sessions()
    mixed = a[:1] + b + a[1:]
    for engine in ("scan", "cuda"):
        got = [r.end_us for r in s.run_many(mixed, engine=engine)]
        assert got == [s.run(t, engine=engine).end_us for t in mixed]
    with pytest.raises(ValueError, match="objective"):
        s.run_many(a, objective="speed")
    with pytest.raises(ValueError, match="unknown engine"):
        s.run_many(a, engine="pallas")
    empty = trace.OpTrace(cls=np.zeros(0, np.int32),
                          channel=np.zeros(0, np.int32),
                          way=np.zeros(0, np.int32),
                          parity=np.zeros(0, np.int32), channels=2, ways=4)
    with pytest.raises(ValueError, match="empty trace"):
        s.run_many([empty])


@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_masked_many_bit_equal_to_jax_and_padding_is_a_no_op(policy):
    pt, _ = fleet(seed=6)
    batched = policy == "batched"
    table = trace.op_class_table(sim.SSDConfig(**CFG))
    cols = tuple(np.asarray(getattr(table, f)) for f in FIELDS)
    t_b = _bucket_len(max(t.n_ops for t in pt))
    stacked = [np.stack(c) for c in zip(*(_pad_trace_np(t, t_b)
                                          for t in pt))]
    import torch
    got = sim.trace_end_time_masked_many(
        *(torch.as_tensor(c) for c in cols), *stacked, n_channels=2,
        batched=batched).numpy()
    want = np.asarray(j_sim.trace_end_time_masked_many(
        *cols, *stacked, n_channels=2, batched=batched))
    assert np.array_equal(got, want)
    for lane, t in enumerate(pt):
        plain = sim.trace_end_time(
            *(torch.as_tensor(c) for c in cols), t.cls, t.channel, t.way,
            t.parity, t.arrival_us, t.extra_us, n_channels=2,
            batched=batched)
        one = sim.trace_end_time_masked(
            *(torch.as_tensor(c) for c in cols),
            *_pad_trace_np(t, 2 * t_b), n_channels=2, batched=batched)
        assert float(plain) == got[lane] == float(one)


def write_cells(cell):
    """Op-class columns of the 15 Table 3 write cells of a cell type."""
    cols, jcols = {f: [] for f in _OP_FIELDS}, {f: [] for f in _OP_FIELDS}
    ways = []
    for w in (1, 2, 4, 8, 16):
        for kind in ("conv", "sync_only", "proposed"):
            op = sim.page_op_params(make_interface(kind), chip(cell),
                                    "write", w)
            jop = j_sim.page_op_params(j_make_interface(kind), j_chip(cell),
                                       "write", w)
            for f in _OP_FIELDS:
                cols[f].append(float(getattr(op, f)))
                jcols[f].append(float(getattr(jop, f)))
            ways.append(w)
    assert cols == jcols
    return ([np.asarray(cols[f]) for f in _OP_FIELDS]
            + [np.asarray(ways, np.int32)])


@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_sweep_steady_bit_equal_to_jax(policy):
    args = write_cells("slc")
    batched = policy == "batched"
    got = api.sweep_steady_bandwidth_mb_s(*args, n_pages=128,
                                          batched=batched, device="cpu")
    want = np.asarray(japi.sweep_steady_bandwidth_mb_s(
        *args, n_pages=128, batched=batched, shard=False))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    # the same end times as the per-point channel path, which divides in
    # float64: equal once rounded to float32
    ways = args[-1]
    per = [api.steady_channel_bandwidth_mb_s(
        sim.page_op_params(make_interface(k), chip("slc"), "write", int(w)),
        int(w), policy=policy, n_pages=128, device="cpu")
        for w, k in zip(ways, ("conv", "sync_only", "proposed") * 5)]
    assert np.array_equal(np.asarray(per, np.float32), got)
    squaring = api.sweep_steady_bandwidth_mb_s(
        *args, n_pages=128, batched=batched, engine="squaring",
        device="cpu")
    want_sq = np.asarray(japi.sweep_steady_bandwidth_mb_s(
        *args, n_pages=128, batched=batched, engine="squaring",
        shard=False))
    assert squaring.dtype == np.float32
    assert np.array_equal(squaring, want_sq)
    with pytest.raises(api.CapabilityError, match="engines that do: scan"):
        api.sweep_steady_bandwidth_mb_s(*args, engine="cuda", device="cpu")


@pytest.mark.parametrize("engine,jengine", [("scan", "scan"),
                                            ("cuda", "pallas")])
def test_simulator_sweep_matches_jax(engine, jengine):
    pt, jt = fleet(seed=8, lengths=(150,))
    tables, jtables = [], []
    for kind in ("conv", "sync_only", "proposed"):
        for cell in ("slc", "mlc"):
            cfg = dict(CFG, interface=kind, cell=cell)
            tables.append(trace.op_class_table(sim.SSDConfig(**cfg)))
            jtables.append(j_trace.op_class_table(j_sim.SSDConfig(**cfg)))
    s, js = sessions()
    got = s.sweep(tables, pt[0], engine=engine)
    want = np.asarray(js.sweep(jtables, jt[0], engine=jengine, shard=False))
    assert got.shape == (6,) and np.array_equal(got, want)
    alone = s.sweep(None, pt[0], engine=engine)
    assert alone.shape == (1,)
    assert alone[0] == s.run(pt[0], engine=engine).end_us
    # the default engine is JAX's default, prefix
    assert np.array_equal(s.sweep(tables, pt[0]), np.asarray(
        js.sweep(jtables, jt[0], shard=False)))
    assert np.array_equal(s.sweep(tables, pt[0]),
                          s.sweep(tables, pt[0], engine="prefix"))
