"""The port's data-parallel ``Trainer`` (a ``("data", "model")`` mesh over
``torch.distributed``, ZeRO-1) against the JAX package's
``make_train_step`` on the global batch, which is the function a jit of
the step over a data mesh computes.

Two gloo ranks are spawned once (processes meeting on a ``FileStore``,
as in ``test_torch_compression.py``) and run every case in turn from a
step-0 checkpoint of JAX's train state (so the restore goes through
``place_on_mesh``); rank 0 writes the histories and the gathered final
states to files.  Cases: qwen2-0.5b SMOKE at f32 with ragged masks (the
ranks hold unequal token counts, one row none), ``grad_accum`` 1 and 2,
ZeRO-1 on and off, int8 moments with ZeRO-1 (the final norm's moment is
one row, split over the two ranks: its absmax is an all-reduce MAX),
and granite-moe-3b-a800m SMOKE (the MoE aux loss, its routing means
summed over the ranks).

Bars, those of ``tests/test_torch_train_step.py`` (the ranks sum in
another order than XLA): loss, ce, grad norm, lr and the aux term within
1e-5 relative, tokens exact; after two steps the parameters' and
masters' updates by ``updates_agree`` (1e-3 of the leaf's largest JAX
update, 1/127 with int8 moments; twice the summed learning rates for
gradients that are rounding noise) and the moments by ``leafwise``
(1e-4, int8 codes within one step).  A one-rank mesh is bit-equal to the
mesh-less ``Trainer``; the two-rank save is the files a one-device save
of the same state writes, and restores exactly on one rank and on two;
a failure on one rank restarts both."""

import dataclasses
import filecmp
import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import registry as j_registry
from repro.launch import steps as j_steps
from repro.train.optimizer import OptConfig as JOptConfig
from repro_torch.configs import registry
from repro_torch.distributed import partitioning as part
from repro_torch.distributed.fault import FailureInjector
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshSpec, make_data_mesh
from repro_torch.models.convert import train_state_from_jax
from repro_torch.storage.checkpoint import (CheckpointEngine,
                                            gather_from_mesh, place_on_mesh)
from repro_torch.storage.datapipe import PipeState
from repro_torch.train.optimizer import OptConfig, tree_paths
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_train_step import leafwise, updates_agree

RANKS = 2
STEPS = 2
BATCH, SEQ = 4, 10
LR_SUM = STEPS * 3e-4            # two steps of the default constant lr
CASES = {
    "f32-ga1-zero1": dict(arch="qwen2-0.5b", accum=1, zero1=True,
                          moments="f32"),
    "f32-ga1": dict(arch="qwen2-0.5b", accum=1, zero1=False, moments="f32"),
    "f32-ga2": dict(arch="qwen2-0.5b", accum=2, zero1=False, moments="f32"),
    "int8-ga2-zero1": dict(arch="qwen2-0.5b", accum=2, zero1=True,
                           moments="int8"),
    "moe-ga1-zero1": dict(arch="granite-moe-3b-a800m", accum=1, zero1=True,
                          moments="f32"),
}
#: the cases a one-rank mesh is held bit-equal to the mesh-less Trainer on
ONE_RANK = ("int8-ga2-zero1", "moe-ga1-zero1", "f32-ga1")
CPU = torch.device("cpu")


def configs(arch):
    return (dataclasses.replace(j_registry.get_arch(arch).smoke,
                                compute_dtype="f32"),
            dataclasses.replace(registry.get_arch(arch).smoke,
                                compute_dtype="f32"))


def batches(vocab: int, ragged: bool) -> list[dict]:
    """STEPS global batches; with ``ragged`` the mask leaves row 0 two
    tokens, row 1 all, row 2 none and row 3 about 70 %, so that each rank
    holds another token count under either ``grad_accum``."""
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(30 + i)
        b = {"inputs": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
             "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}
        if ragged:
            mask = np.zeros((BATCH, SEQ), np.float32)
            mask[0, :2] = 1.0
            mask[1] = 1.0
            mask[3] = rng.random(SEQ) < 0.7
            b["mask"] = mask
        out.append(b)
    return out


class Batches:
    """The fixed batches as a resumable pipeline (cursor in the
    checkpoint, as ``SyntheticTokens``)."""

    def __init__(self, items):
        self.items, self.cursor = items, 0

    def state(self) -> PipeState:
        return PipeState(self.cursor)

    def restore(self, st: PipeState) -> None:
        self.cursor = st.cursor

    def __iter__(self):
        while True:
            b = self.items[self.cursor % len(self.items)]
            self.cursor += 1
            yield {k: torch.tensor(v) for k, v in b.items()}


def jax_state(case: dict):
    jcfg, _ = configs(case["arch"])
    return j_steps.init_train_state(
        jcfg, JOptConfig(moment_dtype=case["moments"]),
        jax.random.PRNGKey(5))


def write_start(directory, case: dict) -> None:
    """JAX's train state as the step-0 checkpoint a run resumes from."""
    start = jax.tree.map(np.asarray, jax_state(case))
    CheckpointEngine(directory, device="cpu").save(
        0, train_state_from_jax(start, "cpu"), extra={"pipe_cursor": 0},
        blocking=True)


def trainer(case: dict, ckpt_dir, mesh=None, injector=None, **kw):
    _, tcfg = configs(case["arch"])
    return Trainer(tcfg, TrainerConfig(
        steps=STEPS, log_every=1, ckpt_every=kw.pop("ckpt_every", 100),
        ckpt_dir=str(ckpt_dir), grad_accum=case["accum"],
        zero1=case["zero1"]), Batches(batches(
            tcfg.vocab_size, ragged=case["arch"] == "qwen2-0.5b")),
        ocfg=OptConfig(moment_dtype=case["moments"]), injector=injector,
        mesh=mesh, device=None if mesh is not None else "cpu", **kw)


def flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(p): x.detach().cpu().numpy()
            for p, x in tree_paths(tree)}


def _rank(rank: int, tmp: str) -> None:
    torch.set_num_threads(2)        # the suite's other workers share cores
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store",
                                                         RANKS),
                            rank=rank, world_size=RANKS)
    try:
        mesh = make_data_mesh(device="cpu")
        out = {}
        for name, case in CASES.items():
            tr = trainer(case, f"{tmp}/{name}", mesh)
            res = tr.run()
            whole = gather_from_mesh(tr.state, tr.state_shardings)
            out[name] = {"history": res["history"], "state": flat(whole),
                         "restarts": res["restarts"]}
            if name == "int8-ga2-zero1":
                # the final save restores on both ranks as they held it
                again = trainer(case, f"{tmp}/{name}", mesh)
                step, restored = again._resume_or_init()
                out["restore_step"] = step
                out["restore_equal"] = all(
                    torch.equal(a, b) for (_, a), (_, b) in zip(
                        tree_paths(restored), tree_paths(tr.state)))
                out["row_split"] = [
                    "/".join(p) for p, d in tr.shard.dim.items()
                    if d is not None and d == len(tr.shard.index[p]) - 1]
                if rank == 0:
                    CheckpointEngine(f"{tmp}/one-device", device="cpu").save(
                        STEPS, whole, extra={"pipe_cursor": STEPS},
                        blocking=True)
        # a failure on rank 0 alone, after the step-1 save
        case = CASES["f32-ga2"]
        tr = trainer(case, f"{tmp}/restart", mesh, ckpt_every=1,
                     injector=FailureInjector(
                         fail_at_steps=(1,) if rank == 0 else ()))
        res = tr.run()
        out["restart"] = {"history": res["history"],
                          "restarts": res["restarts"]}
        with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        _one_rank(tmp)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    for name, case in CASES.items():
        write_start(tmp / name, case)
    write_start(tmp / "restart", CASES["f32-ga2"])
    mp.start_processes(_rank, args=(str(tmp),), nprocs=RANKS, join=True,
                       start_method="spawn")
    ranks = []
    for r in range(RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return tmp, ranks


def nest(flat_leaves: dict) -> dict:
    tree: dict = {}
    for path, v in flat_leaves.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.as_tensor(v)
    return tree


@functools.lru_cache(maxsize=None)
def jax_run(name: str):
    """JAX's step on the global batches of case ``name`` from the same
    start: the metrics of each step, the final state and the first step's
    gradient."""
    case = CASES[name]
    jcfg, tcfg = configs(case["arch"])
    jstate = jax_state(case)
    start = jax.tree.map(np.asarray, jstate)
    data = batches(tcfg.vocab_size, ragged=case["arch"] == "qwen2-0.5b")
    from repro.models import transformer as j_tf
    # the first step's gradient: the mean of its microbatches' gradients
    acc = case["accum"]
    first = {k: jnp.asarray(v).reshape((acc, BATCH // acc) + v.shape[1:])
             for k, v in data[0].items()}
    grads = [jax.grad(lambda p: j_tf.loss_fn(
        jcfg, p, {k: v[i] for k, v in first.items()})[0])(jstate["params"])
        for i in range(acc)]
    jgrad = jax.tree.map(lambda *g: sum(g) / acc, *grads)
    step = jax.jit(j_steps.make_train_step(
        jcfg, JOptConfig(moment_dtype=case["moments"]),
        grad_accum=case["accum"]))
    metrics = []
    for b in data:
        jstate, m = step(jstate, jax.tree.map(jnp.asarray, b))
        metrics.append(m)
    return start, jstate, jgrad, metrics


@pytest.mark.parametrize("name", tuple(CASES))
def test_two_ranks_match_jax_on_the_global_batch(two_ranks, name):
    _, ranks = two_ranks
    case = CASES[name]
    start, jstate, jgrad, jm = jax_run(name)
    for got in (r[name] for r in ranks):   # each logs the global metrics
        assert got["restarts"] == 0
        hist = got["history"]
        assert [h["step"] for h in hist] == list(range(1, STEPS + 1))
        for h, m in zip(hist, jm):
            for k in ("loss", "ce", "grad_norm", "lr", "moe_aux"):
                assert abs(h[k] - float(m[k])) <= \
                    1e-5 * max(abs(float(m[k])), 1e-30), (name, k)
            assert h["tokens"] == int(m["tokens"])
    zero, one = ranks[0][name], ranks[1][name]
    assert zero["history"] == one["history"]
    for k in zero["state"]:
        assert np.array_equal(zero["state"][k], one["state"][k]), k
    if case["arch"] == "qwen2-0.5b" and case["accum"] == 1:
        # the ragged mask: 12 tokens on rank 0, fewer on rank 1
        assert zero["history"][0]["tokens"] < 2 * 12
    if case["arch"] != "qwen2-0.5b":
        assert zero["history"][0]["moe_aux"] > 0
    state = nest(zero["state"])
    int8 = case["moments"] == "int8"
    rel = 1.0 / 127 if int8 else 1e-3
    for tree in (lambda st: st["params"], lambda st: st["opt"]["master"]):
        updates_agree(start["params"], tree(state), tree(jstate), jgrad,
                      rel, 2 * LR_SUM)
    for mom in ("m", "v"):
        leafwise(state["opt"][mom], jstate["opt"][mom],
                 1.0 / 127 if int8 else 1e-4)
    assert int(state["opt"]["count"]) == STEPS


def test_zero1_split_rows_save_restore_and_manifest(two_ranks):
    """The int8 case: a moment row split over the ranks exists; the final
    save restores on each rank as it held it, and is the one-device
    save's files (manifest and every chunk, byte for byte)."""
    tmp, ranks = two_ranks
    for got in ranks:
        assert "final_norm/scale" in got["row_split"], got["row_split"]
        assert got["restore_step"] == STEPS and got["restore_equal"]
    two = tmp / "int8-ga2-zero1" / f"step_{STEPS:08d}"
    one = tmp / "one-device" / f"step_{STEPS:08d}"
    assert json.loads((two / "MANIFEST.json").read_text()) == json.loads(
        (one / "MANIFEST.json").read_text())
    files = sorted(p.relative_to(two) for p in two.rglob("*.npy"))
    assert files == sorted(p.relative_to(one) for p in one.rglob("*.npy"))
    _, mismatch, errors = filecmp.cmpfiles(two, one, files, shallow=False)
    assert not mismatch and not errors


def test_a_failure_on_one_rank_restarts_both(two_ranks):
    """Rank 0 alone fails before step 2 (after the step-1 save): both
    ranks restart once, and the history is the unbroken run's."""
    _, ranks = two_ranks
    for got in ranks:
        assert got["restart"]["restarts"] == 1
        assert got["restart"]["history"] == got["f32-ga2"]["history"]


def _one_rank(tmp: str) -> None:
    """Each one-rank case (rank 0 of the spawned pair, on a group of its
    own once the pair's is gone): a mesh-less and a one-rank-mesh run from
    a fresh state drawn from the seed (no checkpoint), and the one-rank
    mesh's final save restored with and without the mesh."""
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store1",
                                                         1),
                            rank=0, world_size=1)
    try:
        mesh = make_data_mesh(device="cpu")
        out = {}
        for name in ONE_RANK:
            case = CASES[name]
            plain = trainer(case, f"{tmp}/{name}/plain")
            meshed = trainer(case, f"{tmp}/{name}/mesh", mesh)
            a, b = plain.run(), meshed.run()
            restored = [trainer(case, f"{tmp}/{name}/mesh", m)
                        ._resume_or_init()[1] for m in (None, mesh)]
            out[name] = {
                "history": (a["history"], b["history"]),
                "states": [flat(x) for x in (plain.state, meshed.state,
                                             *restored)]}
        with open(f"{tmp}/one.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def one_rank_runs(two_ranks):
    with open(two_ranks[0] / "one.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_mesh_bit_equal_to_meshless(one_rank_runs, name):
    """Two steps from a fresh state drawn from the seed: the histories and
    final states equal bit for bit, and the one-rank mesh's final save
    restores, with and without the mesh, as the mesh-less run ended."""
    got = one_rank_runs[name]
    plain, meshed = got["history"]
    assert [h["step"] for h in plain] == list(range(1, STEPS + 1))
    assert plain == meshed
    want = got["states"][0]
    for other in got["states"][1:]:
        assert sorted(other) == sorted(want)
        for k, v in want.items():
            assert other[k].dtype == v.dtype, k
            assert np.array_equal(other[k], v), k


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_mesh_bit_equal_in_a_process_that_ran_jax(tmp_path, name):
    """The same check in the pytest process, after JAX's step has run in
    it: two mesh-less runs and a one-rank-mesh run end bit-equal."""
    case = CASES[name]
    jax_run(name)
    runs = [trainer(case, tmp_path / "a"), trainer(case, tmp_path / "b")]
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store1"), 1), rank=0, world_size=1)
    try:
        runs.append(trainer(case, tmp_path / "c",
                            make_data_mesh(device="cpu")))
        hist = [tr.run()["history"] for tr in runs]
    finally:
        dist.destroy_process_group()
    assert hist[0] == hist[1] == hist[2]
    want = flat(runs[0].state)
    for tr in runs[1:]:
        got = flat(tr.state)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(got[k], v), k


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store1"), 1), rank=0, world_size=1)
    try:
        yield make_data_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_two_rank_save_restores_on_one_rank(two_ranks, one_rank):
    tmp, ranks = two_ranks
    case = CASES["int8-ga2-zero1"]
    want = ranks[0]["int8-ga2-zero1"]["state"]
    for mesh in (None, one_rank):
        step, state = trainer(case, tmp / "int8-ga2-zero1",
                              mesh)._resume_or_init()
        assert step == STEPS
        got = flat(state)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


# --- meshes, shardings and refusals (no process group) -----------------------


def test_mesh_refusals(tmp_path):
    case = CASES["f32-ga1"]
    with pytest.raises(RuntimeError, match="process group"):
        make_data_mesh(device="cpu")
    tp = MeshSpec(("data", "model"), (1, 2), devices=(CPU, CPU))
    with pytest.raises(RuntimeError, match="process group"):
        trainer(case, tmp_path, tp)
    # the rules ported since (the MoE shard modes, fsdp_units over more
    # than one data rank) get past the rules to ask for the process group;
    # the one the multi-device step does not port (an RG-LRU's gate heads
    # straddling model ranks) is refused by name before it
    _, moe = configs("granite-moe-3b-a800m")
    for mesh in (tp, MeshSpec(("data", "model"), (2, 1), devices=(CPU, CPU))):
        for mode in ("f_model", "e_data_f_model"):
            with pytest.raises(RuntimeError, match="process group"):
                Trainer(dataclasses.replace(moe, moe_shard_mode=mode),
                        TrainerConfig(ckpt_dir=str(tmp_path)), [], mesh=mesh)
    llama = registry.get_arch("llama4-maverick-400b-a17b").config
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(llama, TrainerConfig(ckpt_dir=str(tmp_path)), [],
                mesh=MeshSpec(("data", "model"), (2, 1), devices=(CPU, CPU)))
    rg = registry.get_arch("recurrentgemma-9b").smoke
    odd = dataclasses.replace(rg, rglru=dataclasses.replace(rg.rglru,
                                                            n_heads=2))
    with pytest.raises(NotImplementedError, match="ROADMAP item 32"):
        Trainer(odd, TrainerConfig(ckpt_dir=str(tmp_path)), [],
                mesh=MeshSpec(("data", "model"), (1, 4), devices=(CPU,) * 4))
    dp = MeshSpec(("data", "model"), (2, 1), devices=(CPU, CPU))
    with pytest.raises(RuntimeError, match="process group"):
        trainer(case, tmp_path, dp)


def test_named_sharding_slices_and_gathers_back():
    """Each position's slice under single- and two-axis specs, and the
    slices put back together give the whole leaf."""
    mesh = MeshSpec(("data", "model"), (2, 3), devices=(CPU,) * 6)
    x = torch.arange(6 * 12 * 5, dtype=torch.float32).reshape(6, 12, 5)
    cases = {part.P("data", "model"): ((3, 4, 5), lambda c: (
                 slice(3 * c["data"], 3 * c["data"] + 3),
                 slice(4 * c["model"], 4 * c["model"] + 4))),
             part.P(None, ("data", "model")): ((6, 2, 5), lambda c: (
                 slice(0, 6), slice(2 * (3 * c["data"] + c["model"]),
                                    2 * (3 * c["data"] + c["model"]) + 2))),
             part.P(): ((6, 12, 5), lambda c: ())}
    for spec, (local, want) in cases.items():
        sh = part.shardings(mesh, {"a": {"b": spec}})["a"]["b"]
        assert sh.spec == spec and sh.device(4) == CPU
        whole = torch.zeros_like(x)
        for pos in range(mesh.size):
            piece = sh.shard(x, pos)
            assert piece.shape == local
            assert torch.equal(piece, x[want(mesh.coords(pos))])
            whole[sh.index(x.shape, pos)] = piece
        assert torch.equal(whole, x)
    placed = place_on_mesh({"w": x}, {"w": part.NamedSharding(
        mesh, part.P("data"))}, position=5)
    assert torch.equal(placed["w"], x[3:])
    assert mesh.coords(5) == {"data": 1, "model": 2}


def test_zero1_shard_covers_each_leaf_once():
    """``zero1_shard`` on qwen2-0.5b SMOKE over (2, 1): the two positions'
    slices of each parameter are disjoint and cover it; the final norm's
    one row is split."""
    _, tcfg = configs("qwen2-0.5b")
    ocfg = OptConfig(moment_dtype="int8")
    mesh = MeshSpec(("data", "model"), (2, 1), devices=(CPU, CPU))
    shape = steps.abstract_train_state(tcfg, ocfg)
    specs = steps.train_state_pspecs(tcfg, ocfg, mesh, shape, zero1=True)
    shares = [steps.zero1_shard(specs, shape["params"], mesh, r, None)
              for r in range(2)]
    assert shares[0].dim == shares[1].dim
    assert shares[0].dim[("final_norm", "scale")] == 0
    for path, p in tree_paths(shape["params"]):
        d = shares[0].dim[path]
        cover = torch.zeros(p.shape, dtype=torch.int32)
        for sh in shares:
            cover[sh.index[path]] += 1
        assert torch.equal(cover, torch.full(p.shape, 1 if d is not None
                                             else 2, dtype=torch.int32))
