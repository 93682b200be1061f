"""The sweeps sharded over a points mesh against the JAX package's
one-device (``shard=False``) calls, on the CPU.

A points mesh of 1, 2 or 3 CPU "devices" (``make_points_mesh(("cpu",) *
k)``, installed by ``api.points_mesh``) stands in for the JAX package's
forced host device count.  Every batch here is not a multiple of 2 or 3,
so the blocks pad.  The design points are independent and each block
runs the same float32 operations on its rows as the whole batch does, so
every sharded call is bit-equal to JAX's ``shard=False`` call on the
same seeded inputs: ``sweep_tables`` (``scan``, ``prefix``),
``sweep_steady_bandwidth_mb_s`` (``scan``, ``squaring``),
``Simulator.run_many(engine="scan")`` and the aged sweep
``Simulator.sweep(None, stream, ftl=specs)``.  ``shard=False``, the
``cuda`` and ``oracle`` engines and one-point calls do not shard."""

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import ftl as j_ftl
from repro.core import sim as j_sim
from repro.core import trace as j_trace
from repro.core import workload as j_wl
from repro.core.calibrate import _OP_FIELDS
from repro.core.interface import make_interface as j_make_interface
from repro.core.nand import chip as j_chip
from repro_torch import api
from repro_torch.core import api as core_api
from repro_torch.core import ftl, sim, trace
from repro_torch.core import workload as wl
from repro_torch.core.interface import make_interface
from repro_torch.core.nand import chip
from repro_torch.distributed.partitioning import shard_points
from repro_torch.launch.mesh import MeshSpec, make_points_mesh

MESHES = (1, 2, 3)
CFG = dict(channels=2, ways=4, cell="mlc", interface="proposed")
LENGTHS = (33, 100, 257, 100, 64, 12, 80)


def mesh(k: int) -> MeshSpec:
    return make_points_mesh(("cpu",) * k)


class CountShards:
    """Counts the sharded folds the api runs (one ``shard_points``
    wrapper each)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = core_api._shard_points

        def counted(*a, **kw):
            self.calls += 1
            return real(*a, **kw)
        monkeypatch.setattr(core_api, "_shard_points", counted)


def tables_pair(n: int):
    kinds = ("conv", "sync_only", "proposed")
    cells = [(k, c) for k in kinds for c in ("slc", "mlc")][:n]
    return ([trace.op_class_table(sim.SSDConfig(**dict(
                CFG, interface=k, cell=c))) for k, c in cells],
            [j_trace.op_class_table(j_sim.SSDConfig(**dict(
                CFG, interface=k, cell=c))) for k, c in cells])


def trace_pair(n: int, seed: int, arrivals: bool):
    t = trace.mixed_trace(n, 2, 4, 0.7, seed=seed)
    rng = np.random.default_rng(seed)
    arr = (np.cumsum(rng.exponential(14.0, n)).astype(np.float32)
           if arrivals else None)
    kw = dict(cls=t.cls, channel=t.channel, way=t.way, parity=t.parity,
              channels=2, ways=4, arrival_us=arr)
    return trace.OpTrace(**kw), j_trace.OpTrace(**kw)


def fleet():
    out, jout = [], []
    for i, n in enumerate(LENGTHS):
        rng = np.random.default_rng(i)
        t = trace.mixed_trace(n, 2, 4, 0.7, seed=i)
        arr = (np.cumsum(rng.exponential(14.0, n)).astype(np.float32)
               if i % 2 == 0 else None)
        ext = (np.where(rng.random(n) < 0.1, rng.uniform(30, 120, n),
                        0.0).astype(np.float32) if i % 3 == 1 else None)
        kw = dict(cls=t.cls, channel=t.channel, way=t.way, parity=t.parity,
                  channels=2, ways=4, arrival_us=arr, extra_us=ext)
        out.append(trace.OpTrace(**kw))
        jout.append(j_trace.OpTrace(**kw))
    return out, jout


def write_cells(n: int):
    """Op-class columns and way counts of the first ``n`` Table 3 SLC
    write cells, equal in both packages."""
    cols = {f: [] for f in _OP_FIELDS}
    ways = []
    for w in (1, 2, 4, 8, 16):
        for kind in ("conv", "sync_only", "proposed"):
            op = sim.page_op_params(make_interface(kind), chip("slc"),
                                    "write", w)
            jop = j_sim.page_op_params(j_make_interface(kind),
                                       j_chip("slc"), "write", w)
            for f in _OP_FIELDS:
                assert float(getattr(op, f)) == float(getattr(jop, f))
                cols[f].append(float(getattr(op, f)))
            ways.append(w)
    return ([np.asarray(cols[f][:n]) for f in _OP_FIELDS]
            + [np.asarray(ways[:n], np.int32)])


# --- the mesh and shard_points ----------------------------------------------


def test_points_mesh_construction():
    assert make_points_mesh() is None          # no card here
    m = mesh(3)
    assert m.axis_names == ("points",) and m.sizes == (3,)
    assert m.devices == (torch.device("cpu"),) * 3
    assert [m.coords(i) for i in range(3)] == [{"points": i}
                                               for i in range(3)]
    two = make_points_mesh(["cpu", torch.device("cpu")])
    assert two.size == 2 and hash(two) == hash(mesh(2)) and two == mesh(2)
    with pytest.raises(ValueError, match="at least one"):
        make_points_mesh(())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_points_mesh(("cuda:0", "cuda:0"))
    with pytest.raises(ValueError, match="devices for a mesh"):
        MeshSpec(("points",), (2,), devices=(torch.device("cpu"),))
    with pytest.raises(ValueError, match="needs a mesh with devices"):
        shard_points(MeshSpec(("points",), (2,)), lambda *a, device: a[0],
                     n_sharded=1)


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("n", (1, 5, 7))
def test_shard_points_pads_and_slices_back(k, n):
    """Blocks of equal rows, padded with row 0; tensors moved, numpy and
    lists split on the host, the rest whole to each block; tuples and
    numpy results joined; the padding sliced off."""
    seen = []

    def fn(x, names, arr, shared, *, device):
        seen.append((x.clone(), list(names), arr.copy(), shared))
        assert isinstance(arr, np.ndarray) and x.device == device
        return x * 2, arr + 1

    x = torch.arange(n, dtype=torch.float32) + 10
    names = [f"p{i}" for i in range(n)]
    arr = np.arange(n) * 3
    shared = object()
    got, got_np = shard_points(mesh(k), fn, n_sharded=3)(x, names, arr,
                                                         shared)
    assert torch.equal(got, x * 2) and np.array_equal(got_np, arr + 1)
    per = -(-n // k)
    pad = per * k - n
    assert len(seen) == k
    assert all(len(bx) == len(bn) == len(ba) == per
               for bx, bn, ba, _ in seen)
    assert sorted(v for bx, _, _, _ in seen for v in bx.tolist()) == \
        sorted(x.tolist() + [10.0] * pad)
    assert sorted(v for _, bn, _, _ in seen for v in bn) == \
        sorted(names + ["p0"] * pad)
    assert sorted(v for _, _, ba, _ in seen for v in ba.tolist()) == \
        sorted(arr.tolist() + [0] * pad)
    assert all(sh is shared for _, _, _, sh in seen)


# --- the sweeps against JAX's shard=False ------------------------------------


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("engine", ("scan", "prefix"))
@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_sweep_tables_sharded_bit_equal_to_jax(k, engine, policy,
                                               monkeypatch):
    shards = CountShards(monkeypatch)
    tables, jtables = tables_pair(5)
    tr, jtr = trace_pair(150, 3, arrivals=engine == "scan")
    want = np.asarray(japi.sweep_tables(jtables, jtr, engine=engine,
                                        policy=policy, shard=False))
    with api.points_mesh(mesh(k)):
        got = api.sweep_tables(tables, tr, engine=engine, policy=policy,
                               device="cpu")
        s = api.Simulator(sim.SSDConfig(**CFG), device="cpu")
        via_session = s.sweep(tables, tr, engine=engine, policy=policy)
    assert shards.calls == 2              # one sharded fold a call
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(via_session, want)


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("engine", ("scan", "squaring"))
@pytest.mark.parametrize("batched", (False, True))
def test_sweep_steady_sharded_bit_equal_to_jax(k, engine, batched,
                                               monkeypatch):
    shards = CountShards(monkeypatch)
    args = write_cells(13)
    want = np.asarray(japi.sweep_steady_bandwidth_mb_s(
        *args, n_pages=128, batched=batched, engine=engine, shard=False))
    with api.points_mesh(mesh(k)):
        got = api.sweep_steady_bandwidth_mb_s(
            *args, n_pages=128, batched=batched, engine=engine,
            device="cpu")
    assert shards.calls == 1
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("objective", ("end_time", "all"))
def test_run_many_scan_sharded_bit_equal_to_jax(k, objective, monkeypatch):
    shards = CountShards(monkeypatch)
    pt, jt = fleet()
    s = api.Simulator(sim.SSDConfig(**CFG), device="cpu")
    js = japi.Simulator(j_sim.SSDConfig(**CFG))
    want = js.run_many(jt, objective=objective, shard=False)
    with api.points_mesh(mesh(k)):
        got = s.run_many(pt, objective=objective)
    # one sharded fold a (channels, length bucket) group
    assert shards.calls == len({(t.channels, core_api._bucket_len(t.n_ops))
                                for t in pt})
    assert [r.end_us for r in got] == [r.end_us for r in want]
    for g, w in zip(got, want):
        assert g.mb_s == w.mb_s and g.n_ops == w.n_ops
        if objective == "all":
            assert g.energy.total_j == pytest.approx(w.energy.total_j,
                                                     rel=1e-12)


@pytest.mark.parametrize("k,sched_policy", ((1, "stripe"),
                                            (2, "round_robin"),
                                            (3, "stripe")))
def test_sweep_ftl_sharded_bit_equal_to_jax(k, sched_policy):
    """Both stages on each block's device, a cache of preconditioned
    states a device; a warm second sweep equals the first."""
    kw = [dict(overprovision=0.15, gc_policy="greedy"),
          dict(overprovision=0.3, gc_policy="lru"),
          dict(overprovision=0.5, gc_policy="greedy"),
          dict(overprovision=0.3, gc_policy="greedy"),
          dict(overprovision=0.4, precondition=False, gc_free_blocks=3)]
    base = dict(blocks=32, pages_per_block=16, precondition=True)
    pts = [ftl.FTLSpec(**{**base, **x}) for x in kw]
    jpts = [j_ftl.FTLSpec(**{**base, **x}) for x in kw]
    st = wl.overwrite_stream(160, 100, read_fraction=0.1, seed=5)
    jst = j_wl.overwrite_stream(160, 100, read_fraction=0.1, seed=5)
    s = api.Simulator(sim.SSDConfig(cell="mlc", channels=2, ways=4),
                      device="cpu")
    js = japi.Simulator(j_sim.SSDConfig(cell="mlc", channels=2, ways=4))
    want = js.sweep(None, jst, ftl=jpts, sched_policy=sched_policy,
                    shard=False)
    with api.points_mesh(mesh(k)):
        got = s.sweep(None, st, ftl=pts, sched_policy=sched_policy)
        warm = s.sweep(None, st, ftl=pts, sched_policy=sched_policy)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(warm, got)
    per = -(-len(pts) // k)
    blocks = [tuple((pts + [pts[0]] * (per * k - len(pts)))[i * per:
                                                            (i + 1) * per])
              for i in range(k)]
    # the session's device holds one cache, which its blocks share
    assert s._ftl_pre_by_device == {"cpu": s._ftl_pre_states}
    assert all(b in s._ftl_pre_states for b in blocks)


def test_shard_false_cuda_and_single_points_stay_on_one_device(monkeypatch):
    """``shard=False`` and the engines JAX does not shard (``cuda`` for
    ``pallas``, ``oracle``) keep one device under a mesh, as does a
    one-point steady sweep; results unchanged."""
    shards = CountShards(monkeypatch)
    tables, _ = tables_pair(4)
    tr, _ = trace_pair(90, 1, arrivals=True)
    s = api.Simulator(sim.SSDConfig(**CFG), device="cpu")
    args = write_cells(5)
    pt, _ = fleet()
    plain = (s.sweep(tables, tr, engine="scan"),
             s.sweep(tables, tr, engine="cuda"),
             api.sweep_steady_bandwidth_mb_s(*args, device="cpu"),
             [r.end_us for r in s.run_many(pt, engine="oracle")])
    with api.points_mesh(mesh(2)):
        got = (s.sweep(tables, tr, engine="scan", shard=False),
               s.sweep(tables, tr, engine="cuda"),
               api.sweep_steady_bandwidth_mb_s(*args, device="cpu",
                                               shard=False),
               [r.end_us for r in s.run_many(pt, engine="oracle")])
        one = api.sweep_steady_bandwidth_mb_s(*(a[:1] for a in args),
                                              device="cpu")
        s.run_many(pt, shard=False)
    assert shards.calls == 0
    for a, b in zip(plain[:3], got[:3]):
        assert np.array_equal(a, b)
    assert plain[3] == got[3]
    assert np.array_equal(one, plain[2][:1])
    # without a mesh (one device here) nothing shards either
    s.sweep(tables, tr, engine="prefix", shard=True)
    assert shards.calls == 0
