"""The port's partition rules (``distributed.partitioning``,
``launch.steps.train_state_pspecs``) against the JAX package's, path by
path, for all ten full configs on the production meshes (JAX's
``AbstractMesh``: no devices needed; the port's ``MeshSpec``), and the
properties ``tests/test_partitioning.py`` asserts of the JAX rules —
divisibility, the attention and MoE fallback chains, FSDP on llama4 only,
vocab padding, ZeRO-1 — held on the port.  The port's shapes come from
the meta device, JAX's from ``jax.eval_shape``."""

import dataclasses
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as j_base
from repro.configs import registry as j_registry
from repro.distributed import partitioning as j_part
from repro.launch import steps as j_steps
from repro.models.transformer import init_cache as j_init_cache
from repro.train.optimizer import OptConfig as JOptConfig
from repro_torch.configs import base, registry
from repro_torch.distributed import partitioning as part
from repro_torch.launch import steps
from repro_torch.launch.mesh import (H100_TOTAL_MEMORY, make_card_mesh,
                                     make_host_mesh, make_mesh,
                                     make_points_mesh, make_production_mesh,
                                     mesh_chip_count)
from repro_torch.train.optimizer import OptConfig, tree_paths

ARCHS = registry.ARCH_IDS
J_MESHES = {"single": AbstractMesh((16, 16), ("data", "model")),
            "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
MESHES = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}
MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b")


def j_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {j_part._path_str(kp): leaf for kp, leaf in flat}


def t_flat(tree) -> dict:
    return {"/".join(p): leaf for p, leaf in tree_paths(tree)}


def same_specs(got, want) -> None:
    g, w = t_flat(got), j_flat(want)
    assert sorted(g) == sorted(w)
    bad = {k: (g[k], w[k]) for k in w if tuple(g[k]) != tuple(w[k])}
    assert not bad, bad


def configs(arch, **kw):
    jcfg = j_registry.get_arch(arch).config
    tcfg = registry.get_arch(arch).config
    if kw:
        jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    return jcfg, tcfg


@functools.cache
def states(arch, md):
    """(JAX's abstract train state, the port's meta one)."""
    jcfg, tcfg = configs(arch)
    return (j_steps.abstract_train_state(jcfg, JOptConfig(moment_dtype=md)),
            steps.abstract_train_state(tcfg, OptConfig(moment_dtype=md)))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch, mesh):
    jcfg, tcfg = configs(arch)
    jst, tst = states(arch, "f32")
    same_specs(part.param_pspecs(tcfg, MESHES[mesh], tst["params"]),
               j_part.param_pspecs(jcfg, J_MESHES[mesh], jst["params"]))


@pytest.mark.parametrize("mode", ("e_data_f_model", "f_model"))
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mode_param_pspecs_match_jax(arch, mesh, mode):
    jcfg, tcfg = configs(arch, moe_shard_mode=mode)
    jst, tst = states(arch, "f32")
    same_specs(part.param_pspecs(tcfg, MESHES[mesh], tst["params"]),
               j_part.param_pspecs(jcfg, J_MESHES[mesh], jst["params"]))
    assert part.activation_rules(tcfg, MESHES[mesh], 256) == \
        j_part.activation_rules(jcfg, J_MESHES[mesh], 256)


@pytest.mark.parametrize("zero1", (True, False), ids=("zero1", "no_zero1"))
@pytest.mark.parametrize("md", ("f32", "int8"))
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_pspecs_match_jax(arch, mesh, md, zero1):
    jcfg, tcfg = configs(arch)
    jst, tst = states(arch, md)
    got = steps.train_state_pspecs(tcfg, OptConfig(moment_dtype=md),
                                   MESHES[mesh], tst, zero1=zero1)
    want = j_steps.train_state_pspecs(jcfg, JOptConfig(moment_dtype=md),
                                      J_MESHES[mesh], jst, zero1=zero1)
    same_specs(got, want)
    # every sharded dim divides: local_shape raises otherwise
    part.tree_local_nbytes(tst, got, MESHES[mesh])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_activation_specs_match_jax(arch, mesh):
    jarch, tarch = j_registry.get_arch(arch), registry.get_arch(arch)
    jcfg, tcfg = jarch.config, tarch.config
    jm, tm = J_MESHES[mesh], MESHES[mesh]
    for name in ("train_4k", "prefill_32k"):
        jshape, tshape = jarch.shape(name), tarch.shape(name)
        jin = j_base.input_specs(jcfg, jshape)
        tin = base.input_specs(tcfg, tshape)
        jb = jin["batch"] if "batch" in jin else jin
        tb = tin["batch"] if "batch" in tin else tin
        same_specs(part.batch_pspecs(tcfg, tm, tb),
                   j_part.batch_pspecs(jcfg, jm, jb))
        assert part.activation_rules(tcfg, tm, tshape.global_batch) == \
            j_part.activation_rules(jcfg, jm, jshape.global_batch)
    shape = tarch.shape("decode_32k")
    jcache = jax.eval_shape(lambda: j_init_cache(jcfg, shape.global_batch,
                                                 shape.seq_len))
    tcache = base.input_specs(tcfg, shape)["cache"]
    specs = part.cache_pspecs(tcfg, tm, tcache)
    same_specs(specs, j_part.cache_pspecs(jcfg, jm, jcache))
    part.tree_local_nbytes(tcache, specs, tm)
    for b in (1, 2, 16, 32, 128, 256, 512):
        assert part.batch_axes(tm, b) == j_part.batch_axes(jm, b)


# -- the JAX test file's properties, on the port ---------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divisible(arch, mesh):
    _, tcfg = configs(arch)
    params = states(arch, "f32")[1]["params"]
    specs = part.param_pspecs(tcfg, MESHES[mesh], params)
    sizes = MESHES[mesh].shape
    for path, spec in t_flat(specs).items():
        shape = t_flat(params)[path].shape
        for dim, entry in zip(shape, spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n = 1
            for a in axes:
                n *= sizes[a]
            assert dim % n == 0, (path, tuple(shape), spec)


def _wq(arch, mesh="single"):
    _, tcfg = configs(arch)
    specs = part.param_pspecs(tcfg, MESHES[mesh],
                              states(arch, "f32")[1]["params"])
    return [v for k, v in t_flat(specs).items() if k.endswith("mixer/wq")]


@pytest.mark.parametrize("arch,want", [
    # G = 16 divides: head parallel on the group axis [U, d, kvH, G, Dh]
    ("recurrentgemma-9b", (None, None, None, "model", None)),
    # kv = 2, G = 7: replicated weights (sequence-sharded activations)
    ("qwen2-0.5b", (None,) * 5)])
def test_attention_fallback_chain(arch, want):
    assert all(tuple(s) == want for s in _wq(arch))
    _, tcfg = configs(arch)
    rules = part.activation_rules(tcfg, MESHES["single"], 256)
    assert rules["seq"] == (None if arch == "recurrentgemma-9b" else "model")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_fallback_chain(arch):
    _, tcfg = configs(arch)
    specs = t_flat(part.param_pspecs(tcfg, MESHES["single"],
                                     states(arch, "f32")[1]["params"]))
    wi = [v for k, v in specs.items() if k.endswith("ffn/wi")
          and len(v) == 4][0]
    if arch.startswith("llama4"):   # E = 128 divides 16: expert parallel
        assert wi[1] == "model"
    else:                           # E = 40: capacity-slot parallel
        assert all(e is None for e in wi)
        assert part.activation_rules(tcfg, MESHES["single"],
                                     256)["moe_cap"] == "model"


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_units_only_llama4(arch):
    _, tcfg = configs(arch)
    specs = part.param_pspecs(tcfg, MESHES["single"],
                              states(arch, "f32")[1]["params"])
    used = [v for k, v in t_flat(specs).items() if k.startswith("unit/")]
    assert any("data" in str(tuple(s)) for s in used) == \
        arch.startswith("llama4")


@pytest.mark.parametrize("arch", ARCHS)
def test_vocab_padding(arch):
    _, tcfg = configs(arch)
    assert tcfg.padded_vocab % 256 == 0
    assert tcfg.vocab_size <= tcfg.padded_vocab < tcfg.vocab_size + 256


@pytest.mark.parametrize("arch", ("granite-3-2b", "qwen2-0.5b",
                                  "xlstm-350m"))
def test_zero1_moments_shard_over_data(arch):
    _, tcfg = configs(arch)
    st = states(arch, "f32")[1]
    specs = steps.train_state_pspecs(tcfg, OptConfig(), MESHES["single"], st)
    moments = {k: v for k, v in t_flat(specs["opt"]).items()
               if k.startswith("m/")}
    assert any("data" in str(tuple(v)) for v in moments.values())
    off = steps.train_state_pspecs(tcfg, OptConfig(), MESHES["single"], st,
                                   zero1=False)
    assert part.tree_local_nbytes(st, specs, MESHES["single"]) < \
        part.tree_local_nbytes(st, off, MESHES["single"])


def test_cache_specs_shard_seq_over_model():
    _, tcfg = configs("qwen2-0.5b")
    cache = base.input_specs(tcfg, registry.get_arch("qwen2-0.5b").shape(
        "decode_32k"))["cache"]
    specs = t_flat(part.cache_pspecs(tcfg, MESHES["single"], cache))
    kspec = [v for k, v in specs.items() if k.endswith("/k")][0]
    assert tuple(kspec)[3] == "model"        # [U, B, kvH, S, Dh]


def test_batch_axes():
    assert part.batch_axes(MESHES["single"], 1) is None
    assert part.batch_axes(MESHES["multi"], 256) == ("pod", "data")
    assert part.batch_axes(MESHES["multi"], 16) == ("data",)


# -- what one device holds --------------------------------------------------


def test_to_placements_hand_checked():
    single, multi = MESHES["single"], MESHES["multi"]
    assert part.to_placements(part.P("model", None), single) == \
        (Replicate(), Shard(0))
    assert part.to_placements(part.P(None, ("data",), None), single) == \
        (Shard(1), Replicate())
    assert part.to_placements(part.P(("pod", "data"), None, "model"),
                              multi) == (Shard(0), Shard(0), Shard(2))
    assert part.to_placements(part.P(), multi) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        part.to_placements(part.P(("data", "pod")), multi)   # minor first
    with pytest.raises(ValueError):
        part.to_placements(part.P("data", "data"), single)


def test_local_shape_and_nbytes_hand_checked():
    single, multi = MESHES["single"], MESHES["multi"]
    # qwen2-0.5b's embedding table: 151936 (padded) x 896 bf16, vocab split
    spec = part.P("model", None)
    assert part.local_shape((151936, 896), spec, single) == (9496, 896)
    assert part.local_nbytes((151936, 896), torch.bfloat16, spec, single) \
        == 9496 * 896 * 2
    # a [3, B, S] position-id batch over (pod, data) on 512 devices
    spec = part.P(None, ("pod", "data"), None)
    assert part.local_shape((3, 256, 4096), spec, multi) == (3, 8, 4096)
    assert part.local_nbytes((3, 256, 4096), torch.int32, spec, multi) == \
        3 * 8 * 4096 * 4
    # a replicated scalar and a trailing dim left out of the spec
    assert part.local_nbytes((), torch.int32, part.P(), single) == 4
    assert part.local_shape((32, 7), part.P("data"), single) == (2, 7)
    with pytest.raises(ValueError):
        part.local_shape((24, 896), part.P("data", None), single)


def test_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    multi = make_production_mesh(multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_chip_count(multi) == 512 and multi.device_memory is None
    assert make_mesh("single") == make_production_mesh()
    assert make_host_mesh(device="cpu").sizes == (1, 1)
    with pytest.raises(ValueError):
        make_host_mesh(model=2, device="cpu")
    card = make_card_mesh("meta")
    assert card.shape == {"data": 1, "model": 1}
    assert card.device_memory == H100_TOTAL_MEMORY
    with pytest.raises(ValueError):
        make_mesh("pod")
    if not torch.cuda.is_available():      # no card: the card's constant
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_host_mesh()
        assert make_points_mesh() is None
        assert make_mesh("card") == card
