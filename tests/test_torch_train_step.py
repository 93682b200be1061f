"""The port's training path against the JAX package's on four SMOKE
configs (dense GQA, RG-LRU + local attention, MoE, xLSTM), with JAX's
parameters and train state carried across: ``loss_fn`` and its gradients
(``torch.autograd`` against ``jax.value_and_grad``), ``make_train_step``
with gradient accumulation 1 and 2, the remat modes, and ``forward``'s
default mode.

Bars.  At float32 compute: loss within 1e-5 relative and every gradient
leaf within 1e-4 of its largest magnitude (float32 sums in another
order).  At bf16 compute the two frameworks round activations to bf16 at
other places: the loss within 2^-8 relative, and the gradients as a whole
(the root of the summed squared differences over the root of the summed
squares) within 2^-5 — 2^-3 for xLSTM, whose exponential gates amplify
those roundings, and for the MoE config a token near a routing tie may
take another expert (``test_torch_arch_serve.py``).  After two AdamW
steps (f32 moments; int8 for RecurrentGemma, as on the card) the float32
moments within 1e-4 of each leaf's largest magnitude, int8 codes within
one step; the update of the masters and parameters (new minus old)
within 1e-3 of the leaf's largest JAX update (1/127 with int8 moments,
one code step) on the elements whose first gradient is above 1e-3 of
the leaf's largest.  The other elements' gradients are rounding noise
(the key bias, which the softmax cannot see, has a zero gradient up to
rounding), and Adam's first steps are about ±lr whatever the gradient's
size, so such an element may move by up to lr either way in each
package: its update within twice the summed learning rates."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.launch import steps as j_steps
from repro.models import transformer as j_tf
from repro.train.optimizer import OptConfig as JOptConfig
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.train.optimizer import OptConfig, tree_paths

ARCHS = ("qwen2-0.5b", "recurrentgemma-9b", "granite-moe-3b-a800m",
         "xlstm-350m")
BF16_GRAD = {"xlstm-350m": 2.0 ** -3}
MOMENTS = {"recurrentgemma-9b": "int8"}


def configs(arch, dt, **kw):
    jcfg = dataclasses.replace(j_registry.get_arch(arch).smoke,
                               compute_dtype=dt, **kw)
    tcfg = dataclasses.replace(registry.get_arch(arch).smoke,
                               compute_dtype=dt, **kw)
    return jcfg, tcfg


def batch(cfg, b, s, seed, mask=False):
    rng = np.random.default_rng(seed)
    out = {"inputs": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if mask:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def np_leaves(tree):
    return [(p, np.asarray(x).astype(np.float32)) for p, x in tree_paths(
        jax.tree.map(np.asarray, tree),
        is_leaf=lambda x: not isinstance(x, dict))]


def t_leaves(tree):
    return [(p, x.float().numpy()) for p, x in tree_paths(tree)]


def leafwise(got, want, rel, atol=0.0):
    got, want = t_leaves(got), np_leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        err = float(np.max(np.abs(g - w), initial=0.0))
        assert err <= atol + rel * max(float(np.max(np.abs(w), initial=0.0)),
                                       1e-30), (path, err)


def updates_agree(old, got, want, grad, rel, noise_atol):
    """``got - old`` (the port's) against ``want - old`` (JAX's), leaf by
    leaf, within ``rel`` of the leaf's largest JAX update where the JAX
    gradient ``grad`` is above 1e-3 of the leaf's largest magnitude, and
    within ``noise_atol`` elsewhere."""
    leaves = (np_leaves(old), t_leaves(got), np_leaves(want), np_leaves(grad))
    assert len({tuple(p for p, _ in ls) for ls in leaves}) == 1
    for (path, o), (_, g), (_, w), (_, gr) in zip(*leaves):
        dg, dw = g - o, w - o
        big = np.abs(gr) > 1e-3 * np.max(np.abs(gr), initial=0.0)
        if big.any():
            scale = float(np.max(np.abs(dw[big])))
            assert scale > 0, path
            err = float(np.max(np.abs(dg - dw)[big]))
            assert err <= rel * scale, (path, err, scale)
        err = float(np.max(np.abs(dg - dw)[~big], initial=0.0))
        assert err <= noise_atol, (path, err)


def global_rel(got, want) -> float:
    num = den = 0.0
    for (_, g), (_, w) in zip(t_leaves(got), np_leaves(want)):
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return (num / den) ** 0.5


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, dt):
    jcfg, tcfg = configs(arch, dt)
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    data = batch(tcfg, 2, 16, 1, mask=arch == "qwen2-0.5b")
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_tf.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, data)),
        has_aux=True)(jp)
    tl, tm, tg = steps.value_and_grad(
        tcfg, tp, {k: torch.as_tensor(v) for k, v in data.items()})
    assert tm["tokens"].dtype == torch.int32
    assert int(tm["tokens"]) == int(jm["tokens"])
    assert all(g.dtype == p.dtype for (_, g), (_, p) in
               zip(tree_paths(tg), tree_paths(tp)))
    rel = 1e-5 if dt == "f32" else 2.0 ** -8
    for got, want in ((tl, jl), (tm["ce"], jm["ce"])):
        assert abs(float(got) - float(want)) <= rel * abs(float(want))
    assert abs(float(tm["moe_aux"]) - float(jm["moe_aux"])) <= \
        rel * max(abs(float(jm["moe_aux"])), 1e-30)
    if arch == "granite-moe-3b-a800m":
        assert float(tm["moe_aux"]) > 0
    if dt == "f32":
        leafwise(tg, jg, 1e-4)
    else:
        assert global_rel(tg, jg) < BF16_GRAD.get(arch, 2.0 ** -5)


@pytest.mark.parametrize("accum", (1, 2))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, accum):
    jcfg, tcfg = configs(arch, "f32")
    md = MOMENTS.get(arch, "f32")
    jstate = j_steps.init_train_state(jcfg, JOptConfig(moment_dtype=md),
                                      jax.random.PRNGKey(1))
    start = jax.tree.map(np.asarray, jstate)
    tstate = train_state_from_jax(start, "cpu")
    first = jax.tree.map(jnp.asarray, batch(tcfg, 4, 12, 10))
    jgrad = jax.grad(lambda p: j_tf.loss_fn(jcfg, p, first)[0])(
        jstate["params"])
    assert tstate["opt"]["count"].dtype == torch.int32
    jstep = jax.jit(j_steps.make_train_step(
        jcfg, JOptConfig(moment_dtype=md), grad_accum=accum))
    tstep = steps.make_train_step(tcfg, OptConfig(moment_dtype=md),
                                  grad_accum=accum)
    for i in range(2):
        data = batch(tcfg, 4, 12, 10 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, data))
        tstate, tm = tstep(tstate, {k: torch.as_tensor(v)
                                    for k, v in data.items()})
    assert set(tm) == set(jm)
    for k in ("loss", "ce", "grad_norm", "lr", "moe_aux"):
        assert abs(float(tm[k]) - float(jm[k])) <= \
            1e-5 * max(abs(float(jm[k])), 1e-30), k
    assert tm["tokens"].dtype == torch.int32
    assert int(tm["tokens"]) == int(jm["tokens"])
    assert int(tstate["opt"]["count"]) == 2
    lr_sum = 2 * 3e-4                 # two steps of the default constant lr
    rel = 1.0 / 127 if md == "int8" else 1e-3
    for tree in (lambda st: st["params"], lambda st: st["opt"]["master"]):
        updates_agree(start["params"], tree(tstate), tree(jstate), jgrad,
                      rel, 2 * lr_sum)
    for mom in ("m", "v"):
        leafwise(tstate["opt"][mom], jstate["opt"][mom],
                 1.0 / 127 if md == "int8" else 1e-4)


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "recurrentgemma-9b"))
def test_remat_modes_give_the_same_loss_and_grads(arch):
    """``remat`` none / full / dots recompute the same operations: the
    loss and every gradient bit-equal."""
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(registry.get_arch(arch).smoke,
                                  compute_dtype="f32", remat=remat)
        params = transformer.init_params(cfg, 3, device="cpu")
        data = batch(cfg, 2, 16, 4)
        out[remat] = steps.value_and_grad(
            cfg, params, {k: torch.as_tensor(v) for k, v in data.items()})
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for (_, a), (_, b) in zip(tree_paths(out[remat][2]),
                                  tree_paths(out["none"][2])):
            assert torch.equal(a, b)
    cfg = dataclasses.replace(registry.get_arch(arch).smoke, remat="most")
    params = transformer.init_params(cfg, 3, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        steps.value_and_grad(cfg, params, {
            k: torch.as_tensor(v) for k, v in batch(cfg, 1, 4, 0).items()})


def test_forward_default_mode_computes_the_moe_aux_term():
    """``forward``'s default is JAX's ``mode="train"``: the MoE
    load-balance term is summed; ``mode="eval"`` leaves it at 0."""
    jcfg, tcfg = configs("granite-moe-3b-a800m", "f32")
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = batch(tcfg, 2, 10, 5)["inputs"]
    _, jaux = j_tf.forward(jcfg, jp, jnp.asarray(x))
    _, aux = transformer.forward(tcfg, tp, torch.as_tensor(x))
    assert float(jaux) > 0
    assert abs(float(aux) - float(jaux)) <= 1e-5 * float(jaux)
    _, eval_aux = transformer.forward(tcfg, tp, torch.as_tensor(x),
                                      mode="eval")
    assert float(eval_aux) == 0.0
