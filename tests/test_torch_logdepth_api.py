"""The port's log-depth engines (``prefix``, ``squaring``) and strategies
against the JAX package's, on the CPU: ``Simulator.run`` on both engines
with ``objective="all"``, a fault-extended ``RequestStream`` on
``prefix``, ``sweep_tables`` and ``Simulator.sweep`` on their default
(``prefix``), the steady-stream entry points, the squaring engine's
refusals, the ``segmented`` / ``squaring`` strategies of
``kernels.maxplus.ops``, and the numpy oracles of the log-depth engines.

End times bit-equal to JAX's; energies within 1e-6 relative (the prefix
energy fold sums in float32 in an order XLA does not fix; the squaring
engine's per-op float64 sum is held bit-equal).  The oracles are float64
numpy on both sides: equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import api as japi
from repro.core import maxplus_form as jmf
from repro.core import sim as j_sim
from repro.core import sim_ref as j_sim_ref
from repro.core import trace as j_trace
from repro.core import workload as j_wl
from repro.core.interface import make_interface as j_iface
from repro.core.nand import chip as j_chip
from repro.kernels.maxplus import ops as j_ops
from repro.kernels.maxplus.ref import maxplus_product_ref as j_product_ref
from repro_torch import api
from repro_torch.core import maxplus_form as mf
from repro_torch.core import sim, sim_ref, trace
from repro_torch.core import workload as wl
from repro_torch.core.interface import make_interface
from repro_torch.core.nand import chip
from repro_torch.kernels.maxplus import ops
from repro_torch.kernels.maxplus.ref import maxplus_product_ref

ENERGY_REL = 1e-6
ENERGY_FIELDS = ("cmd_j", "io_j", "ecc_j", "ctrl_j", "idle_j", "array_j",
                 "end_us")


def paired_traces(channels, ways, side, seed, n=240):
    t = trace.mixed_trace(n, channels, ways, 0.6, seed=seed)
    arr = ext = None
    if side:
        rng = np.random.default_rng(seed)
        arr = np.cumsum(rng.exponential(14.0, n)).astype(np.float32)
        ext = np.where(rng.random(n) < 0.15, rng.uniform(3, 40, n),
                       0.0).astype(np.float32)
    kw = dict(cls=t.cls, channel=t.channel, way=t.way, parity=t.parity,
              channels=channels, ways=ways, arrival_us=arr, extra_us=ext)
    return trace.OpTrace(**kw), j_trace.OpTrace(**kw)


def sessions(**cfg):
    return (api.Simulator(sim.SSDConfig(**cfg), device="cpu"),
            japi.Simulator(j_sim.SSDConfig(**cfg)))


def assert_energy_close(got, want):
    for f in ENERGY_FIELDS:
        a, b = getattr(got.energy, f), getattr(want.energy, f)
        assert abs(a - b) <= ENERGY_REL * abs(b), (f, a, b)


def both_ops(cell, kind, mode, ways):
    return (sim.page_op_params(make_interface(kind), chip(cell), mode, ways),
            j_sim.page_op_params(j_iface(kind), j_chip(cell), mode, ways))


# --- Simulator.run on the log-depth engines ----------------------------------


@pytest.mark.parametrize("channels,ways,cell,kind", [
    (1, 4, "slc", "conv"), (2, 8, "mlc", "proposed"),
    (4, 2, "slc", "sync_only")])
@pytest.mark.parametrize("side", (False, True))
@pytest.mark.parametrize("segment_len", (None, 16, 64))
def test_prefix_run_all_matches_jax(channels, ways, cell, kind, side,
                                    segment_len):
    s, js = sessions(channels=channels, ways=ways, cell=cell, interface=kind)
    tr, jtr = paired_traces(channels, ways, side, seed=channels + ways)
    got = s.run(tr, objective="all", engine="prefix",
                segment_len=segment_len)
    want = js.run(jtr, objective="all", engine="prefix",
                  segment_len=segment_len)
    assert got.engine == want.engine == "prefix"
    assert got.end_us == want.end_us and got.mb_s == want.mb_s
    assert np.array_equal(got.channel_busy_us, want.channel_busy_us)
    assert_energy_close(got, want)
    bare = s.run(tr, engine="prefix", segment_len=segment_len)
    assert bare.end_us == got.end_us and bare.energy is None


@pytest.mark.parametrize("ways", (1, 2, 4, 8, 16))
@pytest.mark.parametrize("policy", ("eager", "batched"))
@pytest.mark.parametrize("mode", ("read", "write"))
def test_squaring_run_all_matches_jax(ways, policy, mode):
    s, js = sessions(channels=1, ways=ways, cell="mlc", policy=policy)
    op_cls = trace.READ if mode == "read" else trace.WRITE
    n = 97 + ways
    got = s.run(trace.steady_trace(n, 1, ways, op_cls), objective="all",
                engine="squaring")
    want = js.run(j_trace.steady_trace(n, 1, ways, op_cls), objective="all",
                  engine="squaring")
    assert got.end_us == want.end_us and got.mb_s == want.mb_s
    for f in ENERGY_FIELDS:
        assert getattr(got.energy, f) == getattr(want.energy, f), f
    scan = s.run(trace.steady_trace(n, 1, ways, op_cls)).end_us
    assert abs(got.end_us - scan) <= n * 2.0 ** -24 * scan


@pytest.mark.parametrize("hedge", (0.0, 0.2))
def test_request_stream_with_faults_on_prefix_matches_jax(hedge):
    """The makespan-only branch of workload queries: no latencies, the
    fault draws and the end time bit-equal, energies within 1e-6."""
    s, js = sessions(channels=2, ways=4, cell="mlc")
    spec = dict(wear=0.9, jitter_us=2.0, prog_fail_prob=0.05,
                hedge_fraction=hedge, seed=3)
    load = wl.poisson_stream(300, 12.0, read_fraction=0.7,
                             pages_per_request=2, seed=5)
    jload = j_wl.poisson_stream(300, 12.0, read_fraction=0.7,
                                pages_per_request=2, seed=5)
    got = s.run(load, faults=api.FaultSpec(**spec), engine="prefix",
                objective="all")
    want = js.run(jload, faults=japi.FaultSpec(**spec), engine="prefix",
                  objective="all")
    assert got.end_us == want.end_us and got.n_ops == want.n_ops
    assert got.request_lat_us is None and want.request_lat_us is None
    assert got.n_remap_ops == want.n_remap_ops > 0
    assert np.array_equal(got.retry_hist, want.retry_hist)
    assert_energy_close(got, want)
    cuda = s.run(load, faults=api.FaultSpec(**spec), engine="cuda")
    assert abs(got.end_us - cuda.end_us) <= got.n_ops * 2.0 ** -24 * \
        cuda.end_us


def test_run_many_on_the_log_depth_engines_is_per_trace_run():
    s, _ = sessions(channels=1, ways=4, cell="mlc")
    fleet = [trace.steady_trace(n, 1, 4) for n in (33, 64, 100)]
    for engine in ("prefix", "squaring"):
        many = s.run_many(fleet, engine=engine, objective="all")
        for t, r in zip(fleet, many):
            one = s.run(t, engine=engine, objective="all")
            assert (r.end_us, r.engine) == (one.end_us, engine)
            assert r.energy.total_j == one.energy.total_j


# --- the sweeps and steady-stream entry points -------------------------------


@pytest.mark.parametrize("policy", ("eager", "batched"))
@pytest.mark.parametrize("combine", ("chain", "assoc"))
def test_sweeps_default_to_prefix_as_jax_does(policy, combine):
    tr, jtr = paired_traces(2, 4, True, seed=9, n=200)
    tables, jtables = [], []
    for kind in ("conv", "sync_only", "proposed"):
        for cell in ("slc", "mlc"):
            cfg = dict(interface=kind, cell=cell, channels=2, ways=4)
            tables.append(trace.op_class_table(sim.SSDConfig(**cfg)))
            jtables.append(j_trace.op_class_table(j_sim.SSDConfig(**cfg)))
    kw = dict(policy=policy, combine=combine)
    got = api.sweep_tables(tables, tr, device="cpu", **kw)
    want = np.asarray(japi.sweep_tables(jtables, jtr, shard=False, **kw))
    assert got.shape == (6,) and np.array_equal(got, want)
    s, js = sessions(channels=2, ways=4, cell="mlc", policy=policy)
    got = s.sweep(tables, tr, combine=combine, segment_len=32)
    want = js.sweep(jtables, jtr, combine=combine, segment_len=32,
                    shard=False)
    assert np.array_equal(got, np.asarray(want))
    alone = s.sweep(None, tr, combine=combine, segment_len=32)
    assert alone[0] == s.run(tr, engine="prefix", segment_len=32).end_us


@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_steady_entry_points_on_the_log_depth_engines(policy):
    grid = [(c, k, m, w) for c in ("slc", "mlc") for k in ("conv", "proposed")
            for m in ("read", "write") for w in (1, 2, 4, 8, 16)]
    for cell, kind, mode, ways in grid[::3]:
        op, jop = both_ops(cell, kind, mode, ways)
        for engine in ("prefix", "squaring"):
            got = api.steady_channel_bandwidth_mb_s(
                op, ways, policy=policy, n_pages=96, engine=engine,
                device="cpu")
            want = japi.steady_channel_bandwidth_mb_s(
                jop, ways, policy=policy, n_pages=96, engine=engine)
            # JAX divides in float32, the port in float64 from the same
            # float32 end time: equal once rounded to float32
            assert np.float32(got) == want, (cell, kind, mode, ways, engine)
    pairs = [both_ops(c, k, m, w) for c, k, m, w in grid]
    fields = ("cmd_us", "pre_us", "slot_us", "post_lo_us", "post_hi_us",
              "ctrl_us", "data_bytes")
    args = tuple(np.asarray([getattr(p, f) for p, _ in pairs]) for f in fields)
    ways = np.asarray([w for *_, w in grid], np.int32)
    got = api.sweep_steady_bandwidth_mb_s(*args, ways, n_pages=200,
                                          batched=policy == "batched",
                                          engine="squaring", device="cpu")
    want = np.asarray(japi.sweep_steady_bandwidth_mb_s(
        *args, ways, n_pages=200, batched=policy == "batched",
        engine="squaring", shard=False))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="ways dividing 16"):
        api.sweep_steady_bandwidth_mb_s(*args, np.full_like(ways, 6),
                                        engine="squaring", device="cpu")
    with pytest.raises(ValueError, match="ways dividing 16"):
        api.steady_channel_bandwidth_mb_s(pairs[0][0], 12, engine="squaring",
                                          device="cpu")


# --- the squaring engine's refusals ------------------------------------------


def _refusal(pkg, what):
    s = (api.Simulator(sim.SSDConfig(channels=1, ways=4), device="cpu")
         if pkg == "torch" else japi.Simulator(j_sim.SSDConfig(channels=1,
                                                               ways=4)))
    mod = trace if pkg == "torch" else j_trace
    tr = mod.steady_trace(32, 1, 4)
    if what == "arrivals":
        tr = dataclasses.replace(tr, arrival_us=np.linspace(
            0, 50, 32, dtype=np.float32))
    elif what == "extras":
        tr = dataclasses.replace(tr, extra_us=np.full(32, 3.0, np.float32))
    elif what == "heterogeneous":
        tr = mod.mixed_trace(32, 1, 4, 0.5, seed=1)
    else:
        s = (api.Simulator(table=dataclasses.replace(
            s.table, arb_us=np.full_like(s.table.arb_us, 0.5)), device="cpu")
            if pkg == "torch" else japi.Simulator(table=dataclasses.replace(
                s.table, arb_us=np.full_like(s.table.arb_us, 0.5))))
    eng = (api if pkg == "torch" else japi).get_engine("squaring")
    with pytest.raises((api if pkg == "torch" else japi).CapabilityError) \
            as err:
        eng.end_time(s, tr, batched=False, segment_len=None)
    return str(err.value)


@pytest.mark.parametrize("what", ("arrivals", "extras", "heterogeneous",
                                  "arb"))
def test_squaring_refusals_match_jax(what):
    """Word for word, except the engine lists: JAX's ``pallas`` is
    ``cuda`` here, and the list is sorted."""
    got, want = _refusal("torch", what), _refusal("jax", what)
    if what == "arb":
        assert got == want
        return
    head, names = want.rsplit(": ", 1)
    names = sorted(names.rstrip(")").replace("pallas", "cuda").split(", "))
    assert got == f"{head}: {', '.join(names)})"


# --- kernels.maxplus.ops strategies ------------------------------------------


@pytest.mark.parametrize("side", (False, True))
@pytest.mark.parametrize("segment_len", (None, 1, 16, 64))
def test_segmented_strategy_matches_jax(side, segment_len):
    tr, jtr = paired_traces(2, 4, side, seed=4, n=150)
    tables = [trace.op_class_table(sim.SSDConfig(channels=2, ways=4,
                                                 cell=c))
              for c in ("slc", "mlc")]
    jtables = [j_trace.op_class_table(j_sim.SSDConfig(channels=2, ways=4,
                                                      cell=c))
               for c in ("slc", "mlc")]
    for policy in ("eager", "batched"):
        got = ops.trace_end_time_maxplus(
            tables, tr, policy=policy, strategy="segmented",
            segment_len=segment_len, device="cpu")
        want = j_ops.trace_end_time_maxplus(
            jtables, jtr, policy=policy, strategy="segmented",
            segment_len=segment_len)
        assert np.array_equal(got, np.asarray(want))
    end, acc = ops.trace_energy_maxplus(
        tables, tr, ["proposed", "conv"], strategy="segmented",
        segment_len=segment_len, device="cpu")
    j_end, j_acc = j_ops.trace_energy_maxplus(
        jtables, jtr, ["proposed", "conv"], strategy="segmented",
        segment_len=segment_len)
    assert np.array_equal(end, np.asarray(j_end))
    np.testing.assert_allclose(acc, np.asarray(j_acc), rtol=ENERGY_REL,
                               atol=0)
    with pytest.raises(ValueError, match="unknown trace energy strategy"):
        ops.trace_energy_maxplus(tables, tr, ["proposed", "conv"],
                                 strategy="squaring", device="cpu")


@pytest.mark.parametrize("strategy", ("segmented", "squaring"))
@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_periodic_strategies_match_jax(strategy, policy):
    grid = [both_ops(c, "proposed", m, w) for c in ("slc", "mlc")
            for m in ("read", "write") for w in (1, 4, 16)]
    ways = [1, 4, 16] * 4
    for n_pages in (7, 32, 300):
        got = ops.channel_end_time_maxplus(
            [p for p, _ in grid], ways, n_pages=n_pages, policy=policy,
            strategy=strategy, device="cpu")
        want = j_ops.channel_end_time_maxplus(
            [p for _, p in grid], ways, n_pages=n_pages, policy=policy,
            strategy=strategy)
        assert np.array_equal(got, np.asarray(want)), n_pages


# --- the oracles -------------------------------------------------------------


def test_product_and_matmul_oracles_equal_jax():
    rng = np.random.default_rng(2)
    mats = (rng.random((2, 4, 6, 6)) * 5).astype(np.float32)
    idx = rng.integers(0, 4, 23).astype(np.int32)
    got = maxplus_product_ref(torch.as_tensor(mats), idx)
    assert np.array_equal(got.numpy(), np.asarray(j_product_ref(
        jnp.asarray(mats), jnp.asarray(idx))))
    # the dense strategies fold to the same product
    s0 = np.zeros((2, 6), np.float32)
    dense = mf.maxplus_fold_segmented(torch.as_tensor(mats), idx,
                                      torch.as_tensor(s0), segment_len=5)
    assert np.allclose(dense.numpy(), got.numpy().max(axis=-1), rtol=1e-6)
    a = rng.random((3, 5, 5))
    b = rng.random((3, 5, 5))
    assert np.array_equal(sim_ref.maxplus_matmul_np(a, b),
                          j_sim_ref.maxplus_matmul_np(a, b))
    assert np.array_equal(jmf.maxplus_eye(5), mf.maxplus_eye(5))


@pytest.mark.parametrize("policy", ("eager", "batched"))
@pytest.mark.parametrize("side", (False, True))
def test_matfold_oracle_equals_jax(policy, side):
    tr, jtr = paired_traces(2, 4, side, seed=8, n=90)
    tab = trace.op_class_table(sim.SSDConfig(channels=2, ways=4, cell="mlc"))
    jtab = j_trace.op_class_table(j_sim.SSDConfig(channels=2, ways=4,
                                                  cell="mlc"))
    for seg in (1, 16, 64):
        got = sim_ref.simulate_trace_matfold_ref(tab, tr, policy, seg)
        assert got == j_sim_ref.simulate_trace_matfold_ref(jtab, jtr, policy,
                                                           seg)
    # the matrices round each op's summed offsets to float32 once
    ref = sim_ref.simulate_trace_ref(tab, tr, policy)
    assert abs(got - ref) <= tr.n_ops * 2.0 ** -24 * ref


@pytest.mark.parametrize("ways", (1, 3, 16))
@pytest.mark.parametrize("batched", (False, True))
def test_channel_oracles_equal_jax(ways, batched):
    for cell in ("slc", "mlc"):
        for mode in ("read", "write"):
            op, jop = both_ops(cell, "proposed", mode, ways)
            for n in (1, 50, 257):
                assert sim_ref.simulate_channel_ref(op, ways, n, batched) == \
                    j_sim_ref.simulate_channel_ref(jop, ways, n, batched)
            assert sim_ref.bandwidth_ref_mb_s(op, ways, 128, batched) == \
                j_sim_ref.bandwidth_ref_mb_s(jop, ways, 128, batched)
