"""The port's serving under ``model`` (``launch.steps.make_serve_prefill`` /
``make_serve_decode`` with a ``(data, model)`` mesh's groups) against the
JAX package's mesh-less ``prefill`` / ``decode_step`` on the global batch,
which is the function JAX's ``lower_cell`` jits for those cells.

Gloo ranks are spawned once per process count: two as a ``(1, 2)`` mesh,
four as ``(1, 4)`` and then ``(2, 2)``.  Each case takes its slices of
JAX's parameters (``serve_params``), runs ``prefill`` on the global
prompts and then ``STEPS`` decode steps fed JAX's greedy tokens, at f32
compute.  Cases:

* qwen2-0.5b SMOKE: kv heads split, the tied vocabulary split;
* recurrentgemma-9b SMOKE: query groups split over one kv head, the
  RG-LRU's channels and gate heads split, window 8 with a ring wrap;
* granite-moe-3b-a800m SMOKE (experts split; on ``(2, 2)`` a decode MoE
  layer gathers the global batch over ``data``) and a 3-expert variant
  (capacity slots split);
* qwen2-0.5b SMOKE with 3 query heads over 1 kv head: the sequence of
  the prefill's attention is sharded;
* xlstm-350m SMOKE: replicated mixers over states split by width;
* qwen2-vl-2b SMOKE: M-RoPE ``position_ids`` of an image's patch grid;
* qwen2-0.5b SMOKE with a ``max_seq`` of 19, which ``model`` does not
  divide: the KV cache replicates, by JAX's rule.

Held: the logits within ``test_torch_models.py``'s f32 bar (1e-5 of the
largest) at every step and the greedy tokens equal; each rank's cache
tensors exactly ``local_shape(cache_pspecs)``; the outputs that
replicate over ``model`` (the final norm's output, the caches ``model``
does not split) bit-equal across the model ranks; a ``(1, 1)`` mesh
bit-equal to mesh-less serving (in rank 0 of the pair, on a group of its
own once the pair's is gone); the decode combine's empty-rank trap; and
decode inside a model group refused without the cache's length."""

import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import registry as j_registry
from repro.models import transformer as j_tf
from repro_torch.configs import registry
from repro_torch.distributed import ctx
from repro_torch.distributed import partitioning as part
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshSpec, make_data_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.train.optimizer import tree_paths

QWEN, RG, MOE, XL, VL = ("qwen2-0.5b", "recurrentgemma-9b",
                         "granite-moe-3b-a800m", "xlstm-350m", "qwen2-vl-2b")
#: name -> (arch, replaced fields, prompt length S, max_seq, meshes)
CASES = {
    "qwen-kv": (QWEN, (), 12, 20, ("1x2", "2x2")),
    "rg-group": (RG, (), 12, 20, ("1x2", "1x4")),
    "moe-experts": (MOE, (), 12, 20, ("1x2", "2x2")),
    "moe-slots": (MOE, (("n_experts", 3),), 12, 20, ("1x2",)),
    "qwen-seq": (QWEN, (("n_heads", 3), ("n_kv_heads", 1)), 12, 20,
                 ("1x2", "1x4")),
    "xlstm": (XL, (), 12, 20, ("1x2", "2x2")),
    "vl-mrope": (VL, (), 12, 20, ("1x2",)),
    "qwen-odd-cache": (QWEN, (), 12, 19, ("1x2",)),
}
#: mesh -> (data, model)
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
#: the attention split and the MoE split each case runs, by mesh
LAYOUT = {("qwen-kv", "1x2"): ("kv", None), ("qwen-kv", "2x2"): ("kv", None),
          ("rg-group", "1x2"): ("group", None),
          ("rg-group", "1x4"): ("group", None),
          ("moe-experts", "1x2"): ("kv", "expert"),
          ("moe-experts", "2x2"): ("kv", "expert"),
          ("moe-slots", "1x2"): ("kv", "slot"),
          ("qwen-seq", "1x2"): ("seq", None), ("qwen-seq", "1x4"): ("seq", None),
          ("xlstm", "1x2"): ("kv", None), ("xlstm", "2x2"): ("kv", None),
          ("vl-mrope", "1x2"): ("kv", None),
          ("qwen-odd-cache", "1x2"): ("kv", None)}
RUNS = [(name, m) for name, c in CASES.items() for m in c[4]]
B, STEPS = 4, 6
REL = 1e-5
#: the (1, 1) mesh's cases, against mesh-less serving in the same process
ONE = ("qwen-kv", "rg-group")


def configs(name):
    """(JAX's, the port's) SMOKE config of case ``name`` at f32 compute."""
    arch, replaced, *_ = CASES[name]
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


def vl_ids(b: int) -> np.ndarray:
    """[3, B, 12] M-RoPE ids: 3 text tokens, a 2 x 2 patch grid at one
    temporal id, 5 text tokens from one past the largest id."""
    text = np.arange(3)
    rows, cols = np.divmod(np.arange(4), 2)
    image = np.stack([np.full(4, 3), 3 + rows, 3 + cols])
    after = image.max() + 1 + np.arange(5)
    ids = np.concatenate([np.stack([text] * 3), image,
                          np.stack([after] * 3)], axis=1)
    return np.ascontiguousarray(np.broadcast_to(
        ids[:, None], (3, b, ids.shape[1]))).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_run(name: str):
    """JAX's parameters, the prompts, their M-RoPE ids (or None), and the
    mesh-less greedy run: the last logits of the prefill and of each of
    STEPS decode steps, [B, V] each, and the tokens fed (each step's
    argmax)."""
    jcfg, _ = configs(name)
    _, _, s, max_seq, _ = CASES[name]
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(7))
    x = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (B, s)).astype(np.int32)
    ids = vl_ids(B) if jcfg.rope_kind == "mrope" else None
    prefill = jax.jit(j_tf.prefill, static_argnums=0,
                      static_argnames="max_seq")
    decode = jax.jit(j_tf.decode_step, static_argnums=0)
    logits, cache = prefill(
        jcfg, jp, jnp.asarray(x), max_seq=max_seq,
        position_ids=None if ids is None else jnp.asarray(ids))
    out, toks = [np.asarray(logits[:, -1])], []
    for i in range(STEPS):
        toks.append(out[-1][:, :jcfg.vocab_size].argmax(-1).astype(np.int32))
        logits, cache = decode(
            jcfg, jp, cache, jnp.asarray(toks[-1][:, None]),
            jnp.asarray(s + i, jnp.int32),
            position_ids=None if ids is None else jnp.asarray(step_ids(
                ids, i)))
        out.append(np.asarray(logits[:, -1]))
    return (jax.tree.map(np.asarray, jp), x, ids, np.stack(out),
            np.stack(toks, 1))


def step_ids(ids: np.ndarray, i: int) -> np.ndarray:
    """Decode step ``i``'s M-RoPE ids: one past the prompt's largest."""
    return ids[:, :, -1:] + 1 + i


def serve(cfg, params, x, ids, feed, max_seq, prefill_fn, decode_fn):
    """Prefill on ``x``, then a decode step for each column of ``feed``:
    the last logits of each, the final-norm outputs (``_head``'s input)
    and the final cache."""
    heads = []
    real = transformer._head

    def spy(cfg_, params_, h):
        heads.append(h.clone())
        return real(cfg_, params_, h)

    transformer._head = spy
    s = x.shape[1]
    try:
        with torch.inference_mode():
            logits, cache = prefill_fn(params, torch.as_tensor(x),
                                       None if ids is None
                                       else torch.as_tensor(ids))
            out = [logits[:, -1].clone()]
            for i in range(feed.shape[1]):
                logits, cache = decode_fn(
                    params, cache, torch.as_tensor(feed[:, i:i + 1]), s + i,
                    None if ids is None else torch.as_tensor(step_ids(ids,
                                                                      i)))
                out.append(logits[:, -1].clone())
    finally:
        transformer._head = real
    return out, heads, {"/".join(p): t.clone() for p, t in tree_paths(cache)}


def rank_case(name, mesh, data):
    _, tcfg = configs(name)
    max_seq = CASES[name][3]
    groups = {"group": mesh.data_group, "model_group": mesh.model_group}
    logits, heads, cache = serve(
        tcfg, steps.serve_params(tcfg, mesh, data["params"]), data["x"],
        data["ids"], data["feed"], max_seq,
        steps.make_serve_prefill(tcfg, max_seq, **groups),
        steps.make_serve_decode(tcfg, max_seq, **groups))
    layout = part.tp_layout(tcfg, mesh.shape["model"])
    return {"logits": logits, "heads": heads, "cache": cache,
            "layout": (layout.attn, layout.moe)}


def _ranks(rank: int, tmp: str, world: int) -> None:
    torch.set_num_threads(1)        # the suite's other workers share cores
    dist.init_process_group("gloo", store=dist.FileStore(
        f"{tmp}/store{world}", world), rank=rank, world_size=world)
    try:
        out = {}
        for label, (data, model) in MESHES.items():
            if data * model != world:
                continue
            mesh = make_data_mesh(model=model, device="cpu")
            for name in (n for n, m in RUNS if m == label):
                with open(f"{tmp}/{name}.pkl", "rb") as f:
                    out[(name, label)] = rank_case(name, mesh, pickle.load(f))
        with open(f"{tmp}/world{world}-rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
    if world == 2 and rank == 0:
        _one_rank(tmp)


def _one_rank(tmp: str) -> None:
    """ONE's cases on a (1, 1) mesh and mesh-less, in one process."""
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store1", 1),
                            rank=0, world_size=1)
    try:
        mesh = make_data_mesh(device="cpu")
        out = {}
        for name in ONE:
            with open(f"{tmp}/{name}.pkl", "rb") as f:
                data = pickle.load(f)
            _, tcfg = configs(name)
            max_seq = CASES[name][3]
            meshed = rank_case(name, mesh, data)
            plain = serve(tcfg, data["params"], data["x"], data["ids"],
                          data["feed"], max_seq,
                          lambda p, x, ids: transformer.prefill(
                              tcfg, p, x, max_seq=max_seq, position_ids=ids),
                          lambda p, c, x, i, ids: transformer.decode_step(
                              tcfg, p, c, x, i, ids))
            out[name] = (meshed, plain)
        with open(f"{tmp}/one.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results by (case, mesh), and the (1, 1) runs."""
    tmp = tmp_path_factory.mktemp("serve_tp")
    for name in CASES:
        jp, x, ids, _, toks = jax_run(name)
        with open(tmp / f"{name}.pkl", "wb") as f:
            pickle.dump({"params": params_from_jax(jp, "cpu"), "x": x,
                         "ids": ids, "feed": toks}, f)
    out = {}
    for world in (2, 4):
        mp.start_processes(_ranks, args=(str(tmp), world), nprocs=world,
                           join=True, start_method="spawn")
        for r in range(world):
            with open(tmp / f"world{world}-rank{r}.pkl", "rb") as f:
                for key, res in pickle.load(f).items():
                    out.setdefault(key, [None] * world)[r] = res
    with open(tmp / "one.pkl", "rb") as f:
        one = pickle.load(f)
    return out, one


def whole_logits(ranks_, step: int, mesh: str) -> torch.Tensor:
    """Step ``step``'s logits of the global batch from the ranks' parts:
    each rank's columns of its data row's rows."""
    data, model = MESHES[mesh]
    return torch.cat([torch.cat([ranks_[d * model + m]["logits"][step]
                                 for m in range(model)], dim=-1)
                      for d in range(data)], dim=0)


@pytest.mark.parametrize("name,mesh", RUNS)
def test_serving_on_a_mesh_matches_jax(ranks, name, mesh):
    """Every step's logits within 1e-5 of the largest of JAX's, the
    greedy tokens JAX's, and the split the case is meant to run."""
    got, _ = ranks
    jcfg, _ = configs(name)
    v = jcfg.vocab_size
    *_, want, toks = jax_run(name)
    for step in range(STEPS + 1):
        logits = whole_logits(got[(name, mesh)], step, mesh)
        assert logits.shape == (B, jcfg.padded_vocab)
        scale = max(1.0, float(np.abs(want[step, :, :v]).max()))
        err = float(np.abs(logits[:, :v].numpy() - want[step, :, :v]).max())
        assert err <= REL * scale, (step, err, scale)
        if step < STEPS:
            assert np.array_equal(logits[:, :v].argmax(-1).numpy(),
                                  toks[:, step]), step
    for r in got[(name, mesh)]:
        assert r["layout"] == LAYOUT[(name, mesh)]


@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_each_rank_holds_its_slices_of_the_cache(ranks, mesh):
    """Every rank's cache leaf has exactly the shape ``cache_pspecs``
    gives one device of the mesh; the odd max_seq's KV cache is whole."""
    got, _ = ranks
    data, model = MESHES[mesh]
    spec_mesh = MeshSpec(("data", "model"), (data, model))
    for name, m in RUNS:
        if m != mesh:
            continue
        _, tcfg = configs(name)
        whole = transformer.init_cache(tcfg, B, CASES[name][3],
                                       device="meta")
        specs = dict(tree_paths(part.cache_pspecs(tcfg, spec_mesh, whole)))
        for r in got[(name, mesh)]:
            shapes = {k: tuple(t.shape) for k, t in r["cache"].items()}
            assert shapes == {
                "/".join(p): part.local_shape(x.shape, specs[p], spec_mesh)
                for p, x in tree_paths(whole)}, name
            if name == "qwen-odd-cache":
                assert shapes["unit/layer0/k"][3] == 19


@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_replicated_outputs_bit_equal_across_model_ranks(ranks, mesh):
    """The final norm's outputs, and every cache leaf ``model`` does not
    split, are the same bits on the model ranks of each data row."""
    got, _ = ranks
    data, model = MESHES[mesh]
    spec_mesh = MeshSpec(("data", "model"), (data, model))
    for name, m in RUNS:
        if m != mesh:
            continue
        _, tcfg = configs(name)
        whole = transformer.init_cache(tcfg, B, CASES[name][3],
                                       device="meta")
        split = {"/".join(p) for p in part.model_sharded_paths(
            part.cache_pspecs(tcfg, spec_mesh, whole))}
        for d in range(data):
            row = got[(name, mesh)][d * model:(d + 1) * model]
            for other in row[1:]:
                assert len(other["heads"]) == STEPS + 1
                for a, b in zip(row[0]["heads"], other["heads"]):
                    assert torch.equal(a, b), name
                for k, t in row[0]["cache"].items():
                    if k not in split:
                        assert torch.equal(t, other["cache"][k]), (name, k)


def test_one_by_one_mesh_bit_equal_to_meshless(ranks):
    """On a (1, 1) mesh the serving steps are mesh-less serving, bit for
    bit: logits, final-norm outputs and cache."""
    _, one = ranks
    for name in ONE:
        meshed, (logits, heads, cache) = one[name]
        for a, b in zip(meshed["logits"], logits):
            assert torch.equal(a, b), name
        for a, b in zip(meshed["heads"], heads):
            assert torch.equal(a, b), name
        assert sorted(meshed["cache"]) == sorted(cache)
        for k, t in cache.items():
            assert torch.equal(meshed["cache"][k], t), (name, k)


def test_combine_ignores_a_rank_without_kept_keys(monkeypatch):
    """The decode's log-sum-exp join over two ranks, one of which holds
    no kept key (its m at -1e30, its sums 0): the other rank's softmax
    alone, finite, and the same as one softmax over both ranks' keys."""
    g = torch.Generator().manual_seed(0)
    s = torch.randn(3, 5, generator=g)
    v = torch.randn(5, 4, generator=g)
    m = s.amax(-1)
    e = torch.exp(s - m[:, None])
    parts = [(m, e.sum(-1), e @ v),
             (torch.full((3,), -1e30), torch.zeros(3), torch.zeros(3, 4))]

    def gather(out, x, group=None):
        for dst, (pm, pl, pa) in zip(out, parts):
            dst.copy_(torch.cat([pm[:, None], pl[:, None], pa], -1))
    monkeypatch.setattr(ctx, "all_gather", gather)
    with ctx.model_parallel(ctx.PlanGroup(1, 2)):
        got = ctx.combine_partials(torch.full((3,), -1e30), torch.zeros(3),
                                   torch.zeros(3, 4))
    want = torch.softmax(s, -1) @ v
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_decode_in_a_model_group_needs_max_seq():
    """A rank's slots do not show the cache's length, so decode inside a
    model group takes ``max_seq`` and refuses to run without it."""
    _, tcfg = configs("qwen-kv")
    aspec = tcfg.attn_spec(None)
    with ctx.model_parallel(ctx.PlanGroup(0, 2)):
        p = {k: v[0] for k, v in transformer.init_params(
            tcfg, torch.Generator().manual_seed(0),
            device="meta")["unit"]["layer0"]["mixer"].items()}
        cache = attn_mod.init_attn_cache(2, aspec, 10, device="meta")
        x = torch.empty((2, 1, tcfg.d_model), device="meta")
        with pytest.raises(ValueError, match="max_seq"):
            attn_mod.attn_decode(p, aspec, x, cache, 3)
