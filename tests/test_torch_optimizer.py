"""The port's schedules and AdamW against the JAX package's, on the same
seeded numpy inputs.

Schedules: the same float32 operations, so equal within 2^-21 relative
(a few float32 ulps: cos and exp come from two math libraries, and XLA
may contract a product).  AdamW over 3
steps with f32, bf16 and int8 moments, clipping on and off, master on
and off: masters, float32 moments and the new parameters within 2^-20
relative of each leaf's largest magnitude (float32 operations in JAX's
order; XLA may fuse a multiply-add, and the global norm sums in another
order); bf16 moments and parameters within one bf16 ulp (2^-8 relative);
int8 moments' codes within one step and their scales within 2^-20.  The
int32 ``count`` and the metrics' dtypes are held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as j_opt
from repro.train import schedules as j_sched
from repro_torch.models.convert import train_state_from_jax
from repro_torch.train import optimizer as opt
from repro_torch.train import schedules as sched

STEPS = np.arange(0, 40, dtype=np.int32)
SCHEDULES = [
    ("cosine", (3e-4, 5, 30), {}),
    ("cosine", (1e-3, 0, 17), {"min_ratio": 0.0}),
    ("wsd", (3e-4, 4, 20, 8), {}),
    ("wsd", (1e-2, 1, 5, 2), {"min_ratio": 1e-9}),
    ("constant", (3e-4,), {}),
]


@pytest.mark.parametrize("name,args,kw", SCHEDULES,
                         ids=[f"{s[0]}{i}" for i, s in enumerate(SCHEDULES)])
def test_schedule_matches_jax(name, args, kw):
    j_lr = j_sched.SCHEDULES[name](*args, **kw)
    t_lr = sched.SCHEDULES[name](*args, **kw)
    for step in STEPS:
        want = np.asarray(j_lr(jnp.asarray(step, jnp.int32)))
        got = t_lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= 2.0 ** -21 * abs(float(want))
        assert float(t_lr(int(step))) == float(got)    # a Python int too


def _tree(rng, dtype):
    """A parameter tree with JAX's key order to keep: nested dicts, a
    matrix, a stacked [U, a, b] leaf, a vector and a scalar."""
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "unit": {"b": rng.standard_normal((7,)).astype(dtype),
                     "a": rng.standard_normal((2, 3, 4)).astype(dtype)},
            "s": np.asarray(rng.standard_normal(), dtype=dtype)}


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x).astype(np.float32), tree)


def _torch_np(tree):
    if isinstance(tree, dict):
        return {k: _torch_np(v) for k, v in tree.items()}
    return tree.float().numpy()


def _close(got, want, rel, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], rel, f"{path}/{k}")
        return
    assert got.shape == want.shape, path
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= rel * max(float(np.max(np.abs(want))), 1e-30), (path, err)


CASES = [(md, clip, master) for md in ("f32", "bf16", "int8")
         for clip in (1.0, None) for master in (True, False)]


@pytest.mark.parametrize("md,clip,master", CASES,
                         ids=[f"{c[0]}-clip{c[1]}-master{c[2]}"
                              for c in CASES])
def test_adamw_update_matches_jax(md, clip, master):
    cfg = opt.OptConfig(moment_dtype=md, clip_norm=clip, master=master,
                        weight_decay=0.05)
    jcfg = j_opt.OptConfig(moment_dtype=md, clip_norm=clip, master=master,
                           weight_decay=0.05)
    rng = np.random.default_rng(11)
    p0 = _tree(rng, np.float32)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), p0)
    js = j_opt.adamw_init(jcfg, jp)
    tstate = train_state_from_jax(
        {"params": jax.tree.map(np.asarray, jp),
         "opt": jax.tree.map(np.asarray, js)}, "cpu")
    tp, ts = tstate["params"], tstate["opt"]
    assert ts["count"].dtype == torch.int32
    j_lr = j_sched.wsd(1e-2, 1, 1, 2)
    t_lr = sched.wsd(1e-2, 1, 1, 2)
    for _ in range(3):
        g = _tree(rng, np.float32)
        g = jax.tree.map(lambda x: 3.0 * x, g)     # the clip bites at 1.0
        jp, js, jinfo = j_opt.adamw_update(jcfg, j_lr, jp, g, js)
        tg = jax.tree.map(torch.as_tensor, g)
        tp, ts, tinfo = opt.adamw_update(cfg, t_lr, tp, tg, ts)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3
    assert int(js["count"]) == 3
    for k in ("lr", "grad_norm"):
        assert tinfo[k].dtype == torch.float32
        assert abs(float(tinfo[k]) - float(jinfo[k])) <= \
            2.0 ** -20 * abs(float(jinfo[k]))
    assert all(leaf.dtype == torch.bfloat16
               for _, leaf in opt.tree_paths(tp))
    _close(_torch_np(tp), _np(jp), 2.0 ** -8)
    if master:
        _close(_torch_np(ts["master"]), _np(js["master"]), 2.0 ** -20)
    else:
        assert "master" not in ts and "master" not in js
    for mom in ("m", "v"):
        if md == "int8":
            jq = jax.tree.map(np.asarray, js[mom])
            for path, leaf in opt.tree_paths(ts[mom], is_leaf=opt._is_q):
                want = jq
                for key in path:
                    want = want[key]
                assert leaf["q"].dtype == torch.int8
                assert leaf["q"].shape == want["q"].shape
                assert leaf["scale"].shape == want["scale"].shape
                dq = np.abs(leaf["q"].numpy().astype(np.int32)
                            - want["q"].astype(np.int32))
                assert dq.max() <= 1, (mom, path)
                _close(leaf["scale"].numpy(), want["scale"], 2.0 ** -20)
        else:
            rel = 2.0 ** -8 if md == "bf16" else 2.0 ** -20
            _close(_torch_np(ts[mom]), _np(js[mom]), rel)


@pytest.mark.parametrize("shape", ((), (5,), (3, 7), (2, 3, 4)))
def test_quantize_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    got = opt._quantize(torch.as_tensor(x))
    want = j_opt._quantize(jnp.asarray(x))
    for k in ("q", "scale"):
        assert got[k].shape == np.asarray(want[k]).shape
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(opt._dequantize(got).numpy(),
                                  np.asarray(j_opt._dequantize(want)))


def test_global_norm_sums_leaves_in_jax_order():
    rng = np.random.default_rng(5)
    tree = _tree(rng, np.float32)
    got = opt.global_norm(jax.tree.map(torch.as_tensor, tree))
    want = j_opt.global_norm(tree)
    assert abs(float(got) - float(want)) <= 2.0 ** -22 * float(want)
    assert [p for p, _ in opt.tree_paths(tree)] == [
        ("s",), ("unit", "a"), ("unit", "b"), ("w",)]


@pytest.mark.parametrize("md", ("f32", "bf16", "int8"))
def test_adamw_init_matches_jax_layout(md):
    rng = np.random.default_rng(2)
    p = _tree(rng, np.float32)
    js = j_opt.adamw_init(j_opt.OptConfig(moment_dtype=md), p)
    ts = opt.adamw_init(opt.OptConfig(moment_dtype=md),
                        jax.tree.map(torch.as_tensor, p))
    flat_j = jax.tree_util.tree_flatten_with_path(js)[0]
    flat_t = list(opt.tree_paths(ts))
    assert len(flat_j) == len(flat_t)
    for (jpath, jleaf), (tpath, tleaf) in zip(flat_j, flat_t):
        assert tuple(k.key for k in jpath) == tpath
        assert tuple(tleaf.shape) == jleaf.shape
        assert str(tleaf.dtype).split(".")[-1] == str(jleaf.dtype)
