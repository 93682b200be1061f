"""The port's shape-level launch helpers against the JAX package's, for
every architecture id: ``configs.base.input_specs`` (meta-device tensors
against ``jax.ShapeDtypeStruct``s, the decode cache leaf for leaf),
``launch.steps.abstract_train_state`` (meta-device train states against
``jax.eval_shape``, int8 moments included) and ``launch.dryrun``'s
``active_param_count`` / ``model_flops`` / ``opt_config_for`` — all
exact: they are shapes and integer arithmetic."""

import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import registry as j_registry
from repro.launch import steps as j_steps
from repro.train.optimizer import OptConfig as JOptConfig
from repro_torch.configs import base, registry
from repro_torch.launch import dryrun, steps
from repro_torch.train.optimizer import OptConfig, tree_paths

with mock.patch.dict(os.environ):    # it sets XLA_FLAGS when imported
    from repro.launch import dryrun as j_dryrun

ARCHS = j_registry.ARCH_IDS


def j_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path), tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in flat]


def t_leaves(tree):
    return [(path, tuple(x.shape), str(x.dtype).split(".")[-1])
            for path, x in tree_paths(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    jarch, tarch = j_registry.get_arch(arch), registry.get_arch(arch)
    for jshape, tshape in zip(jarch.shapes, tarch.shapes):
        assert (jshape.name, jshape.kind, jshape.seq_len) == \
            (tshape.name, tshape.kind, tshape.seq_len)
        want = j_base.input_specs(jarch.config, jshape)
        got = base.input_specs(tarch.config, tshape)
        assert all(x.device.type == "meta" for _, x in tree_paths(got))
        assert t_leaves(got) == j_leaves(want), (arch, jshape.name)


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m", "xlstm-350m"))
@pytest.mark.parametrize("md", ("f32", "int8"))
def test_abstract_train_state_matches_jax(arch, md):
    jcfg = j_registry.get_arch(arch).config
    tcfg = registry.get_arch(arch).config
    want = j_steps.abstract_train_state(jcfg, JOptConfig(moment_dtype=md))
    got = steps.abstract_train_state(tcfg, OptConfig(moment_dtype=md))
    assert all(x.device.type == "meta" for _, x in tree_paths(got))
    assert t_leaves(got) == j_leaves(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_match_jax(arch):
    jcfg = j_registry.get_arch(arch).config
    tcfg = registry.get_arch(arch).config
    assert dryrun.active_param_count(tcfg) == j_dryrun.active_param_count(jcfg)
    for kind, seq, batch in (("train", 4096, 256), ("prefill", 32768, 32),
                             ("decode", 32768, 128)):
        assert dryrun.model_flops(tcfg, kind, seq, batch) == \
            j_dryrun.model_flops(jcfg, kind, seq, batch)
    assert dryrun.opt_config_for(tcfg).moment_dtype == \
        j_dryrun.opt_config_for(jcfg).moment_dtype


def test_init_train_state_is_the_seeded_params_and_a_fresh_optimizer():
    cfg = registry.get_arch("qwen2-0.5b").smoke
    state = steps.init_train_state(cfg, OptConfig(moment_dtype="bf16"), 5,
                                   device="cpu")
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, 5, device="cpu")
    for (p, a), (q, b) in zip(tree_paths(state["params"]), tree_paths(params)):
        assert p == q and torch.equal(a, b)
    opt = state["opt"]
    assert opt["count"].dtype == torch.int32 and int(opt["count"]) == 0
    assert all(x.dtype == torch.bfloat16 and not x.any()
               for _, x in tree_paths(opt["m"]))
    for (_, m), (_, p) in zip(tree_paths(opt["master"]),
                              tree_paths(state["params"])):
        assert m.dtype == torch.float32 and torch.equal(m, p.float())
    assert np.isfinite(float(steps.loss_and_grads(
        cfg, state["params"], {k: v for k, v in base.smoke_batch(
            cfg, device="cpu").items() if k != "position_ids"})[0]))
