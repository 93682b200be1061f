"""The port's parameters split over ``data``: ``fsdp_units`` (ZeRO-3,
llama4's rule) and the MoE shard modes ``f_model`` / ``e_data_f_model``,
against the JAX package's mesh-less ``make_train_step``, ``prefill`` and
``decode_step`` on the global batch, which is what a jit of those steps
over the mesh computes (the rules move bytes and collectives, not the
math).

Gloo ranks are spawned once per process count: two as a ``(2, 1)`` mesh,
then four as ``(2, 2)``.  Each training case runs the ``Trainer`` for two
steps from a step-0 checkpoint of JAX's train state (the restore goes
through ``place_on_mesh``: each rank takes its blocks along ``data`` and
its slices along ``model``).  Cases:

* llama4 SMOKE with ``fsdp_units`` and int8 moments, on ``(2, 1)`` and
  ``(2, 2)``; with ``grad_accum`` 2 and ``remat="full"`` on ``(2, 1)`` (the
  backward gathers each unit again);
* granite-moe SMOKE under ``f_model`` (each expert's ``d_ff`` over
  ``model``) and ``e_data_f_model`` (experts over ``data``, the slots
  exchanged to their owners), and llama4 SMOKE with ``fsdp_units`` under
  each, on ``(2, 2)``.

Held: the metrics within ``test_torch_trainer_dp.py``'s bars of JAX's,
the gathered state's updates and moments; every rank's parameters and
moments exactly ``local_shape`` of their specs; each rank's first-step
gradients JAX's slices of them within 1e-4 of the leaf's largest (an
expert's gradient summed over ``data`` once too many is twice JAX's);
serving llama4 (prefill and decode fed JAX's greedy tokens) within 1e-5
of the largest logit; a failure on one rank restarting both, the final
save the files a one-device save writes, restored on ``(2, 1)``; and one
rank's meta plan (``plan_cell(rank=)`` on ``PlanGroup`` stand-ins)
logging the collectives (kind, calls, bytes) the gloo ranks issue,
gathers, reduce-scatters and all-to-alls included."""

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
from repro.models import transformer as j_tf
from repro.train.optimizer import OptConfig as JOptConfig
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import partitioning as part
from repro_torch.distributed.fault import FailureInjector
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import MeshSpec, make_data_mesh
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.storage.checkpoint import (CheckpointEngine,
                                            gather_from_mesh, place_on_mesh)
from repro_torch.train.optimizer import OptConfig, tree_paths
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_dryrun import Collectives
from test_torch_train_step import leafwise, updates_agree
from test_torch_trainer_dp import BATCH, LR_SUM, STEPS, Batches, nest

LLAMA, MOE = "llama4-maverick-400b-a17b", "granite-moe-3b-a800m"
FSDP = (("fsdp_units", True),)
#: name -> (arch, grad_accum, moments, replaced fields, meshes)
CASES = {
    "llama-fsdp": (LLAMA, 1, "int8", FSDP, ("2x1", "2x2")),
    "llama-fsdp-ga2-remat": (LLAMA, 2, "int8",
                             FSDP + (("remat", "full"),), ("2x1",)),
    "moe-f": (MOE, 1, "f32", (("moe_shard_mode", "f_model"),), ("2x2",)),
    "moe-edata": (MOE, 1, "f32", (("moe_shard_mode", "e_data_f_model"),),
                  ("2x2",)),
    "llama-f": (LLAMA, 1, "f32", FSDP + (("moe_shard_mode", "f_model"),),
                ("2x2",)),
    "llama-edata": (LLAMA, 1, "f32",
                    FSDP + (("moe_shard_mode", "e_data_f_model"),),
                    ("2x2",)),
}
#: mesh -> (data, model)
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
RUNS = [(name, m) for name, c in CASES.items() for m in c[4]]
SEQ = 10
#: the serving case: prompts of SERVE_S tokens, a cache of SERVE_MAX,
#: SERVE_STEPS decode steps fed JAX's greedy tokens
SERVE, SERVE_S, SERVE_MAX, SERVE_STEPS = "llama-fsdp", 12, 20, 4
#: the cases whose step a rank plan is held to on (2, 2), by the gloo
#: ranks' collectives
PLANNED = ("llama-fsdp", "moe-edata")
#: the (2, 1) run that fails once and whose save is checked
SAVED = "llama-fsdp"


def configs(name):
    """(JAX's, the port's) SMOKE config of case ``name`` at f32 compute."""
    arch, _, _, replaced, _ = CASES[name]
    return tuple(dataclasses.replace(reg.get_arch(arch).smoke,
                                     compute_dtype="f32", **dict(replaced))
                 for reg in (j_registry, registry))


def batches(name) -> list[dict]:
    vocab = configs(name)[1].vocab_size
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(40 + i)
        out.append({k: rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
                    for k in ("inputs", "labels")})
    return out


def jax_state(name):
    jcfg, _ = configs(name)
    return j_steps.init_train_state(jcfg, JOptConfig(moment_dtype=CASES[name][2]),
                                    jax.random.PRNGKey(6))


def write_start(directory, name) -> None:
    """JAX's train state as the step-0 checkpoint a run resumes from."""
    start = jax.tree.map(np.asarray, jax_state(name))
    CheckpointEngine(directory, device="cpu").save(
        0, train_state_from_jax(start, "cpu"), extra={"pipe_cursor": 0},
        blocking=True)


def trainer(name, ckpt_dir, mesh=None, injector=None, **kw):
    _, accum, moments, _, _ = CASES[name]
    return Trainer(configs(name)[1], TrainerConfig(
        steps=STEPS, log_every=1, ckpt_every=kw.pop("ckpt_every", 100),
        ckpt_dir=str(ckpt_dir), grad_accum=accum, zero1=True),
        Batches(batches(name)), ocfg=OptConfig(moment_dtype=moments),
        injector=injector, mesh=mesh,
        device=None if mesh is not None else "cpu", **kw)


def flat(tree) -> dict[str, np.ndarray]:
    return {"/".join(p): x.detach().cpu().numpy()
            for p, x in tree_paths(tree)}


def planned_step(name, mesh, position):
    """The train step the ``Trainer`` runs at ``position`` on ``mesh``
    (``mesh_train_step``), on its slices of a state drawn from seed 0,
    with its collectives counted."""
    cfg = configs(name)[1]
    ocfg = OptConfig(moment_dtype=CASES[name][2])
    specs = steps.train_state_pspecs(cfg, ocfg, mesh,
                                     steps.abstract_train_state(cfg, ocfg))
    state = place_on_mesh(steps.init_train_state(cfg, ocfg, 0, device="cpu"),
                          part.shardings(mesh, specs), position)
    step = steps.mesh_train_step(cfg, ocfg, mesh, position)[0]
    batch = {k: torch.tensor(v) for k, v in batches(name)[0].items()}
    log = Collectives()
    try:
        step(state, batch)
    finally:
        got = log.restore()
    return got


def serve_case(mesh, data):
    _, tcfg = configs(SERVE)
    g = {"group": mesh.data_group, "model_group": mesh.model_group,
         "shards": steps.param_shards(tcfg, mesh)}
    params = steps.serve_params(tcfg, mesh, data["params"])
    prefill = steps.make_serve_prefill(tcfg, SERVE_MAX, **g)
    decode = steps.make_serve_decode(tcfg, SERVE_MAX, **g)
    with torch.inference_mode():
        logits, cache = prefill(params, torch.as_tensor(data["x"]))
        out = [logits[:, -1].clone()]
        for i in range(SERVE_STEPS):
            logits, cache = decode(params, cache,
                                   torch.as_tensor(data["feed"][:, i:i + 1]),
                                   SERVE_S + i)
            out.append(logits[:, -1].clone())
    return {"logits": out, "shapes": {"/".join(p): tuple(x.shape)
                                      for p, x in tree_paths(params)}}


def _ranks(rank: int, tmp: str, world: int) -> None:
    torch.set_num_threads(1)        # the suite's other workers share cores
    dist.init_process_group("gloo", store=dist.FileStore(
        f"{tmp}/store{world}", world), rank=rank, world_size=world)
    try:
        label = "2x1" if world == 2 else "2x2"
        mesh = make_data_mesh(model=MESHES[label][1], device="cpu")
        out = {}
        for name in (n for n, m in RUNS if m == label):
            tr = trainer(name, f"{tmp}/{name}-{label}", mesh)
            res = tr.run()
            out[name] = {
                "history": res["history"], "restarts": res["restarts"],
                "state": flat(gather_from_mesh(tr.state, tr.state_shardings)),
                "shapes": {"/".join(p): tuple(x.shape)
                           for p, x in tree_paths(tr.state)}}
            # the first step's gradients on the step-0 state, this rank's
            again = trainer(name, f"{tmp}/{name}-{label}-start", mesh)
            _, state = again._resume_or_init()
            batch = {k: torch.tensor(v) for k, v in batches(name)[0].items()}
            shards = steps.param_shards(again.cfg, mesh)
            _, _, grads = steps.loss_and_grads(
                again.cfg, state["params"], batch, CASES[name][1],
                mesh.data_group, mesh.model_group, shards)
            out[name]["grads"] = flat(grads)
            for key in ("held", "owned"):
                out[name][key] = sorted("/".join(p) for p in (
                    getattr(shards, key) if shards is not None else ()))
        with open(f"{tmp}/serve.pkl", "rb") as f:
            out["serve"] = serve_case(mesh, pickle.load(f))
        if label == "2x1":
            # a failure on rank 0 alone, after the step-1 save
            tr = trainer(SAVED, f"{tmp}/restart", mesh, ckpt_every=1,
                         injector=FailureInjector(
                             fail_at_steps=(1,) if rank == 0 else ()))
            res = tr.run()
            out["restart"] = {"history": res["history"],
                              "restarts": res["restarts"]}
            step, state = trainer(SAVED, f"{tmp}/restart",
                                  mesh)._resume_or_init()
            out["restored"] = (step, flat(gather_from_mesh(
                state, tr.state_shardings)))
        else:
            for name in PLANNED:
                out[f"plan/{name}"] = planned_step(name, mesh, rank)
        with open(f"{tmp}/world{world}-rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def jax_serve():
    """JAX's llama4 parameters, prompts and mesh-less greedy run: the last
    logits of the prefill and each decode step, and the tokens fed."""
    jcfg, _ = configs(SERVE)
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(8))
    x = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (BATCH, SERVE_S)).astype(np.int32)
    logits, cache = jax.jit(j_tf.prefill, static_argnums=0,
                            static_argnames="max_seq")(
        jcfg, jp, jnp.asarray(x), max_seq=SERVE_MAX)
    decode = jax.jit(j_tf.decode_step, static_argnums=0)
    out, toks = [np.asarray(logits[:, -1])], []
    for i in range(SERVE_STEPS):
        toks.append(out[-1][:, :jcfg.vocab_size].argmax(-1).astype(np.int32))
        logits, cache = decode(jcfg, jp, cache, jnp.asarray(toks[-1][:, None]),
                               jnp.asarray(SERVE_S + i, jnp.int32))
        out.append(np.asarray(logits[:, -1]))
    return jax.tree.map(np.asarray, jp), x, np.stack(out), np.stack(toks, 1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results by mesh, and their directory."""
    tmp = tmp_path_factory.mktemp("fsdp")
    for name, label in RUNS:
        for suffix in ("", "-start"):
            write_start(tmp / f"{name}-{label}{suffix}", name)
    write_start(tmp / "restart", SAVED)
    jp, x, _, toks = jax_serve()
    with open(tmp / "serve.pkl", "wb") as f:
        pickle.dump({"params": params_from_jax(jp, "cpu"), "x": x,
                     "feed": toks}, f)
    out = {}
    for label, (data, model) in MESHES.items():
        world = data * model
        mp.start_processes(_ranks, args=(str(tmp), world), nprocs=world,
                           join=True, start_method="spawn")
        out[label] = []
        for r in range(world):
            with open(tmp / f"world{world}-rank{r}.pkl", "rb") as f:
                out[label].append(pickle.load(f))
    return tmp, out


@functools.lru_cache(maxsize=None)
def jax_run(name: str):
    """JAX's step on the global batches of case ``name`` from the same
    start: the start, the final state, the first step's gradient and each
    step's metrics."""
    _, acc, moments, _, _ = CASES[name]
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


def spec_mesh(label: str) -> MeshSpec:
    return MeshSpec(("data", "model"), MESHES[label])


@pytest.mark.parametrize("name,label", RUNS)
def test_ranks_match_jax_on_the_global_batch(ranks, name, label):
    """Each rank logs JAX's metrics (1e-5 relative, tokens exact), the
    ranks agree bit for bit, and the gathered state's updates and moments
    are JAX's within test_torch_trainer_dp.py's bars."""
    _, runs = ranks
    start, jstate, jgrad, jm = jax_run(name)
    got = [r[name] for r in runs[label]]
    for g in got:
        assert g["restarts"] == 0
        assert [h["step"] for h in g["history"]] == list(range(1, STEPS + 1))
        for h, m in zip(g["history"], jm):
            for k in ("loss", "ce", "grad_norm", "lr", "moe_aux"):
                assert abs(h[k] - float(m[k])) <= \
                    1e-5 * max(abs(float(m[k])), 1e-30), (name, k)
            assert h["tokens"] == int(m["tokens"])
        assert g["history"] == got[0]["history"]
        for k, v in got[0]["state"].items():
            assert np.array_equal(g["state"][k], v), k
    if CASES[name][1] == 1:       # microbatches log no aux term, as JAX
        assert got[0]["history"][0]["moe_aux"] > 0
    state = nest(got[0]["state"])
    int8 = CASES[name][2] == "int8"
    # an int8 code may flip by one at each of the two steps (a moment
    # whose code is 0 in v makes an update of m / eps, llama4 SMOKE's
    # largest): two codes of the leaf's largest update (the mesh-less
    # port against JAX is 1.02e-2 of it on head/w)
    rel = 2.0 / 127 if int8 else 1e-3
    for tree in (lambda st: st["params"], lambda st: st["opt"]["master"]):
        updates_agree(start["params"], tree(state), tree(jstate), jgrad,
                      rel, 2 * LR_SUM)
    for mom in ("m", "v"):
        leafwise(state["opt"][mom], jstate["opt"][mom],
                 1.0 / 127 if int8 else 1e-4)
    assert int(state["opt"]["count"]) == STEPS


@pytest.mark.parametrize("name,label", RUNS)
def test_each_rank_holds_its_blocks(ranks, name, label):
    """Every leaf of a rank's train state has exactly ``local_shape`` of
    its spec: the parameters ``data`` splits (every unit leaf and the
    final norm under ``fsdp_units``, the experts under
    ``e_data_f_model``) and their moments hold the rank's block."""
    _, runs = ranks
    _, cfg = configs(name)
    ocfg = OptConfig(moment_dtype=CASES[name][2])
    mesh = spec_mesh(label)
    shape = steps.abstract_train_state(cfg, ocfg)
    specs = dict(tree_paths(steps.train_state_pspecs(cfg, ocfg, mesh,
                                                     shape)))
    want = {"/".join(p): part.local_shape(x.shape, specs[p], mesh)
            for p, x in tree_paths(shape)}
    for r in runs[label]:
        assert r[name]["shapes"] == want
    held = runs[label][0][name]["held"]
    whole = dict(tree_paths(shape["params"]))
    for p in held:
        key = tuple(p.split("/"))
        assert want[f"params/{p}"] != tuple(whole[key].shape), p
    if cfg.fsdp_units:
        assert "final_norm/scale" in held
        assert all(p.startswith(("unit/", "final_norm/")) for p in held)
    owned = runs[label][0][name]["owned"]
    if cfg.moe_shard_mode == "e_data_f_model":
        assert owned == sorted(f"unit/layer{len(cfg.pattern) - 1}/ffn/{w}"
                               for w in ("wg", "wi", "wo"))
    else:
        assert owned == []


@pytest.mark.parametrize("name,label", RUNS)
def test_first_gradients_are_jax_slices(ranks, name, label):
    """Each rank's first-step gradients (after the reduce-scatters, the
    experts' exchanges and the data sums) are its slices of JAX's
    gradient within 1e-4 of the leaf's largest: a leaf summed over
    ``data`` once too often (an owned expert, a reduce-scattered block)
    would be a multiple of it."""
    _, runs = ranks
    _, _, jgrad, _ = jax_run(name)
    _, cfg = configs(name)
    mesh = spec_mesh(label)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jgrad)[0]}
    specs = part.param_pspecs(cfg, mesh, steps.abstract_train_state(
        cfg, OptConfig())["params"])
    for r, got in enumerate(runs[label]):
        grads = got[name]["grads"]
        assert sorted(grads) == sorted(jflat)
        for p, spec in tree_paths(specs):
            key = "/".join(p)
            want = jflat[key][part.NamedSharding(mesh, spec).index(
                jflat[key].shape, r)]
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(grads[key] - want).max())
            assert err <= 1e-4 * scale, (r, key, err, scale)


@pytest.mark.parametrize("label", tuple(MESHES))
def test_serving_matches_jax(ranks, label):
    """llama4 SMOKE with ``fsdp_units``, served on the mesh (each rank its
    blocks, a unit gathered at a time): every step's logits within 1e-5
    of the largest of JAX's, the greedy tokens JAX's."""
    _, runs = ranks
    jcfg, tcfg = configs(SERVE)
    v = jcfg.vocab_size
    _, _, want, toks = jax_serve()
    data, model = MESHES[label]
    got = runs[label]
    for step in range(SERVE_STEPS + 1):
        logits = torch.cat([torch.cat([got[d * model + m]["serve"]["logits"]
                                       [step] for m in range(model)], -1)
                            for d in range(data)], 0)
        scale = max(1.0, float(np.abs(want[step, :, :v]).max()))
        err = float(np.abs(logits[:, :v].numpy() - want[step, :, :v]).max())
        assert err <= 1e-5 * scale, (step, err)
        if step < SERVE_STEPS:
            assert np.array_equal(logits[:, :v].argmax(-1).numpy(),
                                  toks[:, step]), step
    mesh = spec_mesh(label)
    whole = transformer.init_params(tcfg, torch.Generator().manual_seed(0),
                                    device="meta")
    specs = dict(tree_paths(part.param_pspecs(tcfg, mesh, whole)))
    assert got[0]["serve"]["shapes"] == {
        "/".join(p): part.local_shape(x.shape, specs[p], mesh)
        for p, x in tree_paths(whole)}


def test_failure_restart_save_and_restore(ranks):
    """On (2, 1), rank 0 alone fails before step 2 (after the step-1
    save): both ranks restart once and log the unbroken run's history;
    the final save is the files a one-device save of the gathered state
    writes, and restores on both ranks to that state."""
    tmp, runs = ranks
    want = runs["2x1"][0][SAVED]["state"]
    for got in runs["2x1"]:
        assert got["restart"]["restarts"] == 1
        assert got["restart"]["history"] == got[SAVED]["history"]
        step, state = got["restored"]
        assert step == STEPS and sorted(state) == sorted(want)
        for k, v in want.items():
            assert state[k].dtype == v.dtype and np.array_equal(state[k], v), k
    CheckpointEngine(tmp / "one-device", device="cpu").save(
        STEPS, nest(want), extra={"pipe_cursor": STEPS}, blocking=True)
    two = tmp / "restart" / f"step_{STEPS:08d}"
    one = tmp / "one-device" / f"step_{STEPS:08d}"
    assert json.loads((two / "MANIFEST.json").read_text()) == json.loads(
        (one / "MANIFEST.json").read_text())
    files = sorted(p.relative_to(two) for p in two.rglob("*.npy"))
    assert files == sorted(p.relative_to(one) for p in one.rglob("*.npy"))
    _, mismatch, errors = filecmp.cmpfiles(two, one, files, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("name", PLANNED)
def test_rank_plan_logs_the_collectives_of_gloo_ranks(ranks, name):
    """``plan_cell(rank=)``'s meta run of the (2, 2) train step logs, on
    its stand-in groups, exactly the collectives each gloo rank issues:
    the unit gathers and their gradients' reduce-scatters (``fsdp_units``)
    or the experts' all-to-alls (``e_data_f_model``) among them."""
    _, runs = ranks
    cfg = configs(name)[1]
    mesh = spec_mesh("2x2")
    ocfg = OptConfig(moment_dtype=CASES[name][2])
    for r, got in enumerate(runs["2x2"]):
        plan = steps.plan_cell(cfg, ShapeSpec("t", "train", SEQ, BATCH), mesh,
                               ocfg=ocfg, rank=r)
        m = dryrun.run_meta(plan, mesh)
        assert m.collectives == got[f"plan/{name}"], (r, m.collectives)
        kinds = (("all_gather", "reduce_scatter") if cfg.fsdp_units
                 else ("all_to_all",))
        for kind in kinds:
            assert m.collectives[kind]["calls"] > 0, kind


# --- the plans without a process group ---------------------------------------


def test_data_split_follows_param_pspecs():
    """``partitioning.data_split`` on llama4 SMOKE: with ``fsdp_units``
    every unit leaf and the final norm are gathered, the embedding and
    head never; under ``e_data_f_model`` the experts are owned instead;
    one data rank splits nothing."""
    _, cfg = configs("llama-edata")
    shape = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="meta")
    gathered, owned = part.data_split(cfg, part.param_pspecs(
        cfg, spec_mesh("2x2"), shape))
    names = {"/".join(p) for p in gathered}
    assert "final_norm/scale" in names and names.isdisjoint(
        {"embed/table", "head/w"})
    assert {"/".join(p) for p in owned} == {
        f"unit/layer1/ffn/{w}" for w in ("wi", "wg", "wo")}
    assert all(d >= 1 for p, d in gathered.items() if p[0] == "unit")
    assert steps.param_shards(cfg, MeshSpec(("data", "model"), (1, 2))) \
        is None


def test_a_split_that_does_not_divide_names_the_leaf():
    """Three experts over two data ranks under ``e_data_f_model``: the
    rank plan raises ``ValueError`` naming the expert leaf, as the dry run
    records it."""
    _, cfg = configs("moe-edata")
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                          n_experts=3))
    with pytest.raises(ValueError, match="unit/layer0/ffn/w"):
        steps.plan_cell(odd, ShapeSpec("t", "train", SEQ, BATCH),
                        spec_mesh("2x2"), rank=0)
