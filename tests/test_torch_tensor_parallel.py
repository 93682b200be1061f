"""The port's tensor parallelism over ``model`` (the ``Trainer`` on
``(data, model)`` meshes over ``torch.distributed``) against the JAX
package's ``make_train_step`` on the global batch, which is the function
a jit of the step over such a mesh computes.

Two gloo ranks are spawned once as a ``(1, 2)`` mesh and run every case in
turn from a step-0 checkpoint of JAX's train state (so the restore goes
through ``place_on_mesh``, each rank taking its slices along ``model``);
four are spawned once as a ``(2, 2)`` mesh.  Rank 0 writes the histories
and the gathered final states to files.  Cases on ``(1, 2)``:

* qwen2-0.5b SMOKE: kv heads split, the tied vocabulary split, ragged
  masks, ZeRO-1;
* recurrentgemma-9b SMOKE: query groups split (one kv head), the RG-LRU's
  channels and gate heads split, int8 moments;
* granite-moe-3b-a800m SMOKE: experts split, the aux loss;
* the same with 3 experts in both packages: capacity slots split;
* qwen2-0.5b SMOKE with 3 query heads over 1 kv head in both packages:
  neither divides, so the sequence of attention is sharded (S = 10), or
  replicated where it does not divide (S = 9);
* xlstm-350m SMOKE: the mixers replicated, the untied head split.

On ``(2, 2)``: qwen2-0.5b SMOKE, ragged masks, ``grad_accum`` 2, ZeRO-1
over ``data`` with int8 moments.  The bars are ``test_torch_trainer_dp.py``'s
(the ranks sum in another order than XLA).  Also held: the replicated
leaves' gradients bit-equal on the two model ranks, a ``(1, 1)`` mesh
bit-equal to the mesh-less ``Trainer`` (in a spawned process, as
``test_torch_trainer_dp.py``'s one-rank cases), the ``(1, 2)`` save the files a
one-device save writes (restoring on one rank and on ``(2, 1)``), a
failure on one rank restarting both, and the rules the step does not
port refused by name."""

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
from repro_torch.storage.checkpoint import CheckpointEngine, gather_from_mesh
from repro_torch.train.optimizer import OptConfig, tree_paths
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_train_step import leafwise, updates_agree
from test_torch_trainer_dp import BATCH, LR_SUM, STEPS, Batches, nest

QWEN, RG, MOE, XL = ("qwen2-0.5b", "recurrentgemma-9b",
                     "granite-moe-3b-a800m", "xlstm-350m")
#: name -> (arch, grad_accum, zero1, moments, replaced fields, S)
CASES = {
    "qwen-kv": (QWEN, 1, True, "f32", (), 10),
    "rg-group-int8": (RG, 1, True, "int8", (), 10),
    "moe-experts": (MOE, 1, True, "f32", (), 10),
    "moe-slots": (MOE, 1, True, "f32", (("n_experts", 3),), 10),
    "qwen-seq": (QWEN, 1, True, "f32", (("n_heads", 3), ("n_kv_heads", 1)),
                 10),
    "qwen-seq-odd": (QWEN, 1, False, "f32",
                     (("n_heads", 3), ("n_kv_heads", 1)), 9),
    "xlstm-vocab": (XL, 1, True, "f32", (), 10),
}
#: the (2, 2) case
WIDE = {"qwen-2x2-int8": (QWEN, 2, True, "int8", (), 10)}
ALL = {**CASES, **WIDE}
#: the TPPlan each (1, 2) case runs (attention, then the MoE's split)
LAYOUT = {"qwen-kv": ("kv", None), "rg-group-int8": ("group", None),
          "moe-experts": ("kv", "expert"), "moe-slots": ("kv", "slot"),
          "qwen-seq": ("seq", None), "qwen-seq-odd": ("seq", None),
          "xlstm-vocab": ("kv", None)}
CPU = torch.device("cpu")


def configs(name):
    """(JAX's, the port's) SMOKE config of case ``name`` at f32 compute."""
    arch, *_, replaced, _ = ALL[name]
    out = []
    for reg in (j_registry, registry):
        cfg = dataclasses.replace(reg.get_arch(arch).smoke,
                                  compute_dtype="f32")
        for field, value in replaced:
            if field == "n_experts":
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, n_experts=value))
            else:
                cfg = dataclasses.replace(cfg, **{field: value})
        out.append(cfg)
    return tuple(out)


def batches(name) -> list[dict]:
    """STEPS global batches of case ``name``; qwen2's carry the ragged
    masks of ``test_torch_trainer_dp.batches`` (row 2 none, row 0 two
    tokens)."""
    arch, *_, seq = ALL[name]
    vocab = configs(name)[1].vocab_size
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(30 + i)
        b = {"inputs": rng.integers(0, vocab, (BATCH, seq)).astype(np.int32),
             "labels": rng.integers(0, vocab, (BATCH, seq)).astype(np.int32)}
        if arch == QWEN:
            mask = np.zeros((BATCH, seq), np.float32)
            mask[0, :2] = 1.0
            mask[1] = 1.0
            mask[3] = rng.random(seq) < 0.7
            b["mask"] = mask
        out.append(b)
    return out


def jax_state(name):
    jcfg, _ = configs(name)
    return j_steps.init_train_state(jcfg, JOptConfig(moment_dtype=ALL[name][3]),
                                    jax.random.PRNGKey(5))


def write_start(directory, name) -> None:
    """JAX's train state as the step-0 checkpoint a run resumes from."""
    start = jax.tree.map(np.asarray, jax_state(name))
    CheckpointEngine(directory, device="cpu").save(
        0, train_state_from_jax(start, "cpu"), extra={"pipe_cursor": 0},
        blocking=True)


def trainer(name, ckpt_dir, mesh=None, injector=None, **kw):
    _, accum, zero1, moments, _, _ = ALL[name]
    return Trainer(configs(name)[1], TrainerConfig(
        steps=STEPS, log_every=1, ckpt_every=kw.pop("ckpt_every", 100),
        ckpt_dir=str(ckpt_dir), grad_accum=accum, zero1=zero1),
        Batches(batches(name)), ocfg=OptConfig(moment_dtype=moments),
        injector=injector, mesh=mesh,
        device=None if mesh is not None else "cpu", **kw)


def flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(p): x.detach().cpu().numpy()
            for p, x in tree_paths(tree)}


def replicated_grads(name, mesh, state) -> dict[str, np.ndarray]:
    """One step's gradients of the leaves ``model`` does not split, as
    every model rank of ``mesh`` computes them from its slices."""
    cfg = configs(name)[1]
    batch = {k: torch.tensor(v) for k, v in batches(name)[0].items()}
    _, _, grads = steps.loss_and_grads(cfg, state["params"], batch, 1,
                                       mesh.data_group, mesh.model_group)
    specs = steps.train_state_pspecs(cfg, OptConfig(), mesh,
                                     steps.abstract_train_state(
                                         cfg, OptConfig()))["params"]
    split = part.model_sharded_paths(specs)
    return {"/".join(p): g.numpy() for p, g in tree_paths(grads)
            if p not in split}


def _ranks(rank: int, tmp: str, world: int, model: int, names) -> None:
    torch.set_num_threads(1)        # the suite's other workers share cores
    dist.init_process_group("gloo", store=dist.FileStore(
        f"{tmp}/store{world}", world), rank=rank, world_size=world)
    try:
        mesh = make_data_mesh(model=model, device="cpu")
        out = {}
        for name in names:
            tr = trainer(name, f"{tmp}/{name}", mesh)
            res = tr.run()
            whole = gather_from_mesh(tr.state, tr.state_shardings)
            out[name] = {"history": res["history"], "state": flat(whole),
                         "restarts": res["restarts"],
                         "layout": part.tp_layout(tr.cfg, model)}
        if world == 2:
            # the replicated leaves' gradients, from the step-0 state
            for name in ("qwen-kv", "moe-experts", "qwen-seq",
                         "rg-group-int8"):
                tr = trainer(name, f"{tmp}/{name}-start", mesh)
                _, state = tr._resume_or_init()
                out[f"grads/{name}"] = replicated_grads(name, mesh, state)
            # a failure on rank 0 alone, after the step-1 save
            tr = trainer("qwen-kv", f"{tmp}/restart", mesh, ckpt_every=1,
                         injector=FailureInjector(
                             fail_at_steps=(1,) if rank == 0 else ()))
            res = tr.run()
            out["restart"] = {"history": res["history"],
                              "restarts": res["restarts"]}
            # the (1, 2) save restored on a (2, 1) mesh of the same ranks
            tr = trainer("rg-group-int8", f"{tmp}/rg-group-int8",
                         make_data_mesh(model=1, device="cpu"))
            step, state = tr._resume_or_init()
            out["restore_2x1"] = (step, flat(gather_from_mesh(
                state, tr.state_shardings)))
        with open(f"{tmp}/mesh{world}-rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
    if world == 2 and rank == 0:
        _one_rank(tmp)


def _one_rank(tmp: str) -> None:
    """recurrentgemma-9b SMOKE mesh-less and on a (1, 1) mesh, from a fresh
    state drawn from the seed, in rank 0 of the spawned pair (on a group
    of its own once the pair's is gone)."""
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store1", 1),
                            rank=0, world_size=1)
    try:
        runs = [trainer("rg-group-int8", f"{tmp}/one/plain"),
                trainer("rg-group-int8", f"{tmp}/one/mesh",
                        make_data_mesh(device="cpu"))]
        out = [(tr.run()["history"], flat(tr.state)) for tr in runs]
        with open(f"{tmp}/one.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(tmp, world: int, model: int, names):
    for name in names:
        write_start(tmp / name, name)
    mp.start_processes(_ranks, args=(str(tmp), world, model, tuple(names)),
                       nprocs=world, join=True, start_method="spawn")
    ranks = []
    for r in range(world):
        with open(tmp / f"mesh{world}-rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The (1, 2) ranks' and the (2, 2) ranks' outputs, and their
    directory."""
    tmp = tmp_path_factory.mktemp("tp")
    for name in ("qwen-kv", "moe-experts", "qwen-seq", "rg-group-int8"):
        write_start(tmp / f"{name}-start", name)
    write_start(tmp / "restart", "qwen-kv")
    two = _spawn(tmp, 2, 2, CASES)
    four = _spawn(tmp, 4, 2, WIDE)
    return tmp, {"1x2": two, "2x2": four}


@functools.lru_cache(maxsize=None)
def jax_run(name: str):
    """JAX's step on the global batches of case ``name`` from the same
    start: the metrics of each step, the final state and the first step's
    gradient."""
    from repro.models import transformer as j_tf
    _, acc, _, moments, _, _ = ALL[name]
    jcfg, _ = configs(name)
    jstate = jax_state(name)
    start = jax.tree.map(np.asarray, jstate)
    data = batches(name)
    first = {k: jnp.asarray(v).reshape((acc, BATCH // acc) + v.shape[1:])
             for k, v in data[0].items()}
    grads = [jax.grad(lambda p: j_tf.loss_fn(
        jcfg, p, {k: v[i] for k, v in first.items()})[0])(jstate["params"])
        for i in range(acc)]
    jgrad = jax.tree.map(lambda *g: sum(g) / acc, *grads)
    step = jax.jit(j_steps.make_train_step(
        jcfg, JOptConfig(moment_dtype=moments), grad_accum=acc))
    metrics = []
    for b in data:
        jstate, m = step(jstate, jax.tree.map(jnp.asarray, b))
        metrics.append(m)
    return start, jstate, jgrad, metrics


@pytest.mark.parametrize("name", tuple(ALL))
def test_model_ranks_match_jax_on_the_global_batch(meshes, name):
    """Each rank logs JAX's metrics (1e-5 relative, tokens exact), the
    ranks agree bit for bit, and the gathered state's updates and moments
    are JAX's within test_torch_trainer_dp.py's bars."""
    _, runs = meshes
    ranks = runs["2x2" if name in WIDE else "1x2"]
    start, jstate, jgrad, jm = jax_run(name)
    for got in (r[name] for r in ranks):
        assert got["restarts"] == 0
        hist = got["history"]
        assert [h["step"] for h in hist] == list(range(1, STEPS + 1))
        for h, m in zip(hist, jm):
            for k in ("loss", "ce", "grad_norm", "lr", "moe_aux"):
                assert abs(h[k] - float(m[k])) <= \
                    1e-5 * max(abs(float(m[k])), 1e-30), (name, k)
            assert h["tokens"] == int(m["tokens"])
    zero = ranks[0][name]
    for other in ranks[1:]:
        assert other[name]["history"] == zero["history"]
        for k in zero["state"]:
            assert np.array_equal(zero["state"][k], other[name]["state"][k]), k
    if name in LAYOUT:
        layout = zero["layout"]
        assert (layout.attn, layout.moe) == LAYOUT[name]
    if ALL[name][0] == MOE:
        assert zero["history"][0]["moe_aux"] > 0
    state = nest(zero["state"])
    int8 = ALL[name][3] == "int8"
    rel = 1.0 / 127 if int8 else 1e-3
    for tree in (lambda st: st["params"], lambda st: st["opt"]["master"]):
        updates_agree(start["params"], tree(state), tree(jstate), jgrad,
                      rel, 2 * LR_SUM)
    for mom in ("m", "v"):
        leafwise(state["opt"][mom], jstate["opt"][mom],
                 1.0 / 127 if int8 else 1e-4)
    assert int(state["opt"]["count"]) == STEPS


@pytest.mark.parametrize("name", ("qwen-kv", "moe-experts", "qwen-seq",
                                  "rg-group-int8"))
def test_replicated_gradients_bit_equal_on_the_model_ranks(meshes, name):
    """A leaf ``model`` does not split (norms, the router, the replicated
    kv projections and every weight of the sequence-sharded attention)
    has the same gradient bits on both model ranks, and it is nonzero."""
    _, runs = meshes
    a, b = (r[f"grads/{name}"] for r in runs["1x2"])
    assert sorted(a) == sorted(b) and a
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert any(np.abs(g).max() > 0 for g in a.values())
    if name == "moe-experts":
        assert any(k.endswith("router") for k in a)
    if name == "rg-group-int8":
        assert any(k.endswith("mixer/wk") for k in a)


def test_save_is_the_one_device_files_and_restores_anywhere(meshes):
    """The (1, 2) run's final save is the files a one-device save of the
    gathered state writes (manifest and every chunk, byte for byte), and
    restores exactly on one rank, on a (1, 1) mesh and on (2, 1)."""
    tmp, runs = meshes
    name = "rg-group-int8"
    want = runs["1x2"][0][name]["state"]
    CheckpointEngine(tmp / "one-device", device="cpu").save(
        STEPS, nest(want), extra={"pipe_cursor": STEPS}, blocking=True)
    two = tmp / name / f"step_{STEPS:08d}"
    one = tmp / "one-device" / f"step_{STEPS:08d}"
    assert json.loads((two / "MANIFEST.json").read_text()) == json.loads(
        (one / "MANIFEST.json").read_text())
    files = sorted(p.relative_to(two) for p in two.rglob("*.npy"))
    assert files == sorted(p.relative_to(one) for p in one.rglob("*.npy"))
    _, mismatch, errors = filecmp.cmpfiles(two, one, files, shallow=False)
    assert not mismatch and not errors
    restored = [trainer(name, tmp / name)._resume_or_init()]
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store-one"), 1), rank=0, world_size=1)
    try:
        restored.append(trainer(name, tmp / name, make_data_mesh(
            device="cpu"))._resume_or_init())
    finally:
        dist.destroy_process_group()
    for r in runs["1x2"]:
        restored.append((r["restore_2x1"][0], nest(r["restore_2x1"][1])))
    for step, state in restored:
        assert step == STEPS
        got = flat(state)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_a_failure_on_one_rank_restarts_both(meshes):
    """Rank 0 alone fails before step 2 (after the step-1 save): both
    model ranks restart once, and the history is the unbroken run's."""
    _, runs = meshes
    for got in runs["1x2"]:
        assert got["restart"]["restarts"] == 1
        assert got["restart"]["history"] == got["qwen-kv"]["history"]


def test_one_by_one_mesh_bit_equal_to_meshless(meshes):
    """recurrentgemma-9b SMOKE (int8 moments, ZeRO-1) on a (1, 1) mesh:
    the histories and final states of the mesh-less Trainer, bit for
    bit."""
    tmp, _ = meshes
    with open(tmp / "one.pkl", "rb") as f:
        (plain, want), (meshed, got) = pickle.load(f)
    assert [h["step"] for h in plain] == list(range(1, STEPS + 1))
    assert plain == meshed
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


# --- refusals and the layout rules (no process group) -----------------------


def test_unported_rules_are_refused_by_name(tmp_path):
    """An RG-LRU whose width divides model while its head count does not
    raises NotImplementedError naming its ROADMAP item (32), before any
    process group is asked for.  The rules ported since plan and
    construct: fsdp_units over more than one data rank and the MoE shard
    modes (``f_model``: each expert's d_ff over model; the
    ``e_data_f_model`` experts own d_ff over model too), and a Trainer on
    such a mesh gets past them to ask for its process group."""
    cfg = registry.get_arch("llama4-maverick-400b-a17b").config
    assert cfg.fsdp_units
    two = MeshSpec(("data", "model"), (2, 1), devices=(CPU, CPU))
    assert part.tp_plan(cfg, two).tp == 1
    part.tp_plan(cfg, MeshSpec(("data", "model"), (1, 2)))   # no data axis
    moe = dataclasses.replace(configs("moe-experts")[1],
                              moe_shard_mode="f_model")
    wide = MeshSpec(("data", "model"), (2, 2), devices=(CPU,) * 4)
    assert part.tp_plan(moe, wide).moe == "f"
    assert part.tp_plan(dataclasses.replace(
        moe, moe_shard_mode="e_data_f_model"), wide).moe == "f"
    rg = configs("rg-group-int8")[1]
    odd = dataclasses.replace(rg, rglru=dataclasses.replace(rg.rglru,
                                                            n_heads=2))
    four = MeshSpec(("data", "model"), (1, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP item 32"):
        part.tp_plan(odd, four)
    assert part.tp_plan(rg, four).rglru
    with pytest.raises(NotImplementedError, match="ROADMAP item 32"):
        Trainer(odd, TrainerConfig(ckpt_dir=str(tmp_path)), [],
                mesh=dataclasses.replace(four, devices=(CPU,) * 4))
    for cfg_, mesh in ((moe, two), (cfg, two)):
        with pytest.raises(RuntimeError, match="process group"):
            Trainer(cfg_, TrainerConfig(ckpt_dir=str(tmp_path)), [],
                    mesh=mesh)


def test_model_sharded_paths_follow_param_pspecs():
    """The optimizer's view of (1, 2): the leaves model splits are those
    whose spec names it, the last-dim splits among them (int8 rows) those
    of the FFN's columns and the vocabulary's head; the norms are not."""
    _, cfg = configs("xlstm-vocab")
    mesh = MeshSpec(("data", "model"), (1, 2))
    shards = steps.model_shards(cfg, mesh, None)
    assert ("head", "w") in shards.sharded and ("head", "w") in shards.rows
    assert ("embed", "table") in shards.sharded
    assert ("embed", "table") not in shards.rows
    assert not any("norm" in "/".join(p) for p in shards.sharded)
    assert steps.model_shards(cfg, MeshSpec(("data", "model"), (2, 1)),
                              None) is None
