"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's, on the same seeded inputs and parameters, and the mLSTM's
chunkwise form against its own step-by-step recurrence.

Bars: at float32 compute 1e-5 of the largest magnitude compared (sums in
another order: the state update's three-operand product, the sLSTM's
stacked recurrent product), at bf16 2^-5 (``tests/test_torch_models.py``'s
bars).  The forget-gate biases, which both packages draw as
``linspace(3, 6, n)``, agree within one float32 ulp."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.xlstm_350m import SMOKE as J_SMOKE
from repro.models import transformer as j_tf
from repro.models import xlstm as j_xlstm
from repro_torch.configs.xlstm_350m import SMOKE
from repro_torch.models import transformer, xlstm
from repro_torch.models.convert import cache_from_jax, params_from_jax

REL = {"f32": 1e-5, "bf16": 2.0 ** -5}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
D = 32
M_SPEC = dict(d_inner=64, n_heads=2, conv_width=4, chunk=8)
S_SPEC = dict(d=32, n_heads=2, conv_width=4, d_ff=48)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port(tree):
    return params_from_jax(to_np(tree), "cpu")


def assert_close(got, want, dt="f32"):
    if isinstance(want, (dict, tuple)):
        items = want.items() if isinstance(want, dict) else enumerate(want)
        for k, w in items:
            assert_close(got[k], w, dt)
        return
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    finite = want > -1e29            # the -1e30 "no state yet" sentinel
    assert np.array_equal(got > -1e29, finite)
    scale = max(1.0, float(np.max(np.abs(want[finite]), initial=0.0)))
    err = float(np.max(np.abs(got - want)[finite], initial=0.0))
    assert err <= REL[dt] * scale, (err, scale)


def rand(shape, seed, dt="f32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dt]), torch.as_tensor(x).to(TDT[dt])


def cell_inputs(b, s, h, d, seed):
    """q, k, v [B, S, H, D] and gates [B, S, H], both packages."""
    qkv = [rand((b, s, h, d), seed + i) for i in range(3)]
    i_raw = rand((b, s, h), seed + 3)
    f_raw = rand((b, s, h), seed + 4)
    f_raw = (f_raw[0] + 2.0, f_raw[1] + 2.0)
    return ([x[0] for x in qkv] + [i_raw[0], f_raw[0]],
            [x[1] for x in qkv] + [i_raw[1], f_raw[1]])


def state_inputs(b, h, d, seed):
    jC, tC = rand((b, h, d, d), seed)
    jn, tn = rand((b, h, d), seed + 1)
    jm, tm = rand((b, h), seed + 2)
    return (jC, jn, jm), (tC, tn, tm)


@pytest.mark.parametrize("n", (1, 2, 4, 7, 64, 1024))
def test_forget_bias_within_one_ulp(n):
    want = np.asarray(jnp.linspace(3.0, 6.0, n).astype(jnp.float32))
    got = xlstm.forget_bias(n).numpy()
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("s,chunk", [(1, 4), (13, 4), (16, 8), (29, 8),
                                     (5, 16)])
@pytest.mark.parametrize("initial", (False, True))
def test_mlstm_chunkwise_matches_jax(s, chunk, initial):
    """Ragged S (logf padded 0, logi padded -1e30), a fresh or a given
    state."""
    (jargs, targs) = cell_inputs(2, s, 2, 8, 10)
    kw_j = kw_t = {}
    if initial:
        js, ts = state_inputs(2, 2, 8, 20)
        kw_j, kw_t = {"initial": js}, {"initial": ts}
    jh, jst = j_xlstm.mlstm_chunkwise(*jargs, chunk=chunk, **kw_j)
    th, tst = xlstm.mlstm_chunkwise(*targs, chunk=chunk, **kw_t)
    assert th.dtype == torch.float32 and th.shape == (2, s, 2, 8)
    assert_close(th, jh)
    assert_close(tst, jst)


@pytest.mark.parametrize("s,chunk", [(13, 4), (29, 8), (3, 8)])
def test_mlstm_chunkwise_equals_step_by_step(s, chunk):
    """The chunkwise form and S single steps of ``mlstm_step`` from the
    same zero state: the same outputs and final state, in the port and
    against JAX's step-by-step run."""
    jargs, targs = cell_inputs(2, s, 2, 8, 30)
    th, (tC, tn, tm) = xlstm.mlstm_chunkwise(*targs, chunk=chunk)
    state = (torch.zeros(2, 2, 8, 8), torch.zeros(2, 2, 8),
             torch.full((2, 2), -1e30))
    jstate = (jnp.zeros((2, 2, 8, 8)), jnp.zeros((2, 2, 8)),
              jnp.full((2, 2), -1e30))
    steps, jsteps = [], []
    for t in range(s):
        h, state = xlstm.mlstm_step(*(a[:, t] for a in targs), state)
        jh, jstate = j_xlstm.mlstm_step(*(a[:, t] for a in jargs), jstate)
        steps.append(h)
        jsteps.append(jh)
    assert_close(th, np.stack([np.asarray(x) for x in jsteps], 1))
    assert_close(torch.stack(steps, 1), np.asarray(th))
    assert_close((tC, tn, tm), tuple(np.asarray(x) for x in state))
    assert_close(state, jstate)


def test_mlstm_step_matches_jax():
    jargs, targs = cell_inputs(3, 1, 2, 8, 40)
    js, ts = state_inputs(3, 2, 8, 50)
    jh, jst = j_xlstm.mlstm_step(*(a[:, 0] for a in jargs), js)
    th, tst = xlstm.mlstm_step(*(a[:, 0] for a in targs), ts)
    assert_close(th, jh)
    assert_close(tst, jst)


def blocks(kind, dt):
    if kind == "mlstm":
        jspec, spec = j_xlstm.MLSTMSpec(**M_SPEC), xlstm.MLSTMSpec(**M_SPEC)
        jp = j_xlstm.init_mlstm_block(jax.random.PRNGKey(1), D, jspec)
    else:
        jspec, spec = j_xlstm.SLSTMSpec(**S_SPEC), xlstm.SLSTMSpec(**S_SPEC)
        jp = j_xlstm.init_slstm_block(jax.random.PRNGKey(2), D, jspec)
    # non-zero biases, so each one is read where JAX reads it
    jp = {k: v + 0.1 if k.startswith(("b", "conv_b")) else v
          for k, v in jp.items()}
    if dt == "bf16":
        jp = {k: v.astype(jnp.bfloat16) if v.dtype == jnp.float32
              and k not in ("wi", "wf", "bi", "bf", "gn_scale", "bz", "bo")
              else v for k, v in jp.items()}
    return jspec, spec, jp, port(jp)


J_FNS = {"mlstm": (j_xlstm.mlstm_block, j_xlstm.mlstm_block_step,
                   j_xlstm.init_mlstm_cache),
         "slstm": (j_xlstm.slstm_block, j_xlstm.slstm_block_step,
                   j_xlstm.init_slstm_cache)}
T_FNS = {"mlstm": (xlstm.mlstm_block, xlstm.mlstm_block_step,
                   xlstm.init_mlstm_cache),
         "slstm": (xlstm.slstm_block, xlstm.slstm_block_step,
                   xlstm.init_slstm_cache)}


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("kind", ("mlstm", "slstm"))
def test_block_matches_jax(kind, dt):
    jspec, spec, jp, tp = blocks(kind, dt)
    jx, tx = rand((2, 19, D), 60, dt)
    want = J_FNS[kind][0](jp, jspec, jx, compute_dtype=JDT[dt])
    got = T_FNS[kind][0](tp, spec, tx, compute_dtype=TDT[dt])
    assert got.dtype == TDT[dt]
    assert_close(got, want, dt)


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("kind", ("mlstm", "slstm"))
def test_block_step_matches_jax_and_writes_the_cache_in_place(kind, dt):
    """Six steps from a fresh cache; the port's cache tensors are the
    ones it was given, updated in place."""
    jspec, spec, jp, tp = blocks(kind, dt)
    jc = J_FNS[kind][2](2, jspec, JDT[dt])
    tc = T_FNS[kind][2](2, spec, TDT[dt], "cpu")
    assert_close(tc, to_np(jc))
    ids = {k: id(v) for k, v in tc.items()}
    jx, tx = rand((2, 6, D), 61, dt)
    for t in range(6):
        jy, jc = J_FNS[kind][1](jp, jspec, jx[:, t:t + 1], jc,
                                compute_dtype=JDT[dt])
        ty, tc2 = T_FNS[kind][1](tp, spec, tx[:, t:t + 1], tc,
                                 compute_dtype=TDT[dt])
        assert tc2 is tc and {k: id(v) for k, v in tc.items()} == ids
        assert_close(ty, jy, dt)
    assert_close(tc, to_np(jc), dt)


@pytest.mark.parametrize("kind", ("mlstm", "slstm"))
def test_block_equals_its_steps(kind):
    """The full-sequence block and the step function from a fresh cache
    give the same outputs (chunkwise / scan against steps), in f32."""
    _, spec, _, tp = blocks(kind, "f32")
    _, tx = rand((2, 11, D), 62)
    full = T_FNS[kind][0](tp, spec, tx, compute_dtype=torch.float32)
    cache = T_FNS[kind][2](2, spec, torch.float32, "cpu")
    ys = [T_FNS[kind][1](tp, spec, tx[:, t:t + 1], cache,
                         compute_dtype=torch.float32)[0] for t in range(11)]
    assert_close(torch.cat(ys, 1), full.numpy())


@pytest.mark.parametrize("kind", ("mlstm", "slstm"))
def test_init_block_reads_as_jax(kind):
    """Keys, shapes and dtypes as JAX's at bf16 parameters (gates, biases
    and norm scales float32), and the forget bias within an ulp."""
    if kind == "mlstm":
        jspec, spec = j_xlstm.MLSTMSpec(**M_SPEC), xlstm.MLSTMSpec(**M_SPEC)
        jp = j_xlstm.init_mlstm_block(jax.random.PRNGKey(0), D, jspec,
                                      jnp.bfloat16)
        tp = xlstm.init_mlstm_block(torch.Generator().manual_seed(0), D,
                                    spec, torch.bfloat16)
    else:
        jspec, spec = j_xlstm.SLSTMSpec(**S_SPEC), xlstm.SLSTMSpec(**S_SPEC)
        jp = j_xlstm.init_slstm_block(jax.random.PRNGKey(0), D, jspec,
                                      jnp.bfloat16)
        tp = xlstm.init_slstm_block(torch.Generator().manual_seed(0), D,
                                    spec, torch.bfloat16)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(v.dtype), k
    for k in ("bf", "gn_scale", "conv_b"):
        want = np.asarray(jp[k]).astype(np.float32)
        got = tp[k].float().numpy()
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want))), k


@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(J_SMOKE, compute_dtype="f32")
    tcfg = dataclasses.replace(SMOKE, compute_dtype="f32")
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, tcfg, jp, port(jp)


def test_smoke_cache_carried_across_decodes_on(smoke):
    """JAX's prefill fills the mLSTM (C, n, m, pre-conv tail) and sLSTM
    (c, n, h, m, tail) caches; ``cache_from_jax`` carries them across and
    the port decodes on from them as JAX does; the port's own prefill
    fills the same cache."""
    jcfg, tcfg, jp, tp = smoke
    toks = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 17)).astype(np.int32)
    _, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks[:, :11]), max_seq=17)
    _, own = transformer.prefill(tcfg, tp, torch.as_tensor(toks[:, :11]),
                                 max_seq=17)
    assert_close(own, to_np(jc))
    tc = cache_from_jax(to_np(jc), "cpu")
    assert tc["unit"]["layer0"]["C"].shape == (1, 2, 2, 64, 64)
    assert tc["unit"]["layer3"]["h"].dtype == torch.float32
    for pos in range(11, 17):
        want, jc = j_tf.decode_step(jcfg, jp, jc,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.asarray(pos, jnp.int32))
        got, tc = transformer.decode_step(
            tcfg, tp, tc, torch.as_tensor(toks[:, pos:pos + 1]), pos)
        assert_close(got, want)
    assert_close(tc, to_np(jc))


def test_smoke_init_cache_matches_jax_layout(smoke):
    jcfg, tcfg, _, _ = smoke
    jc = to_np(j_tf.init_cache(jcfg, 3, 20))
    tc = transformer.init_cache(tcfg, 3, 20, device="cpu")
    assert jax.tree.structure(jc) == jax.tree.structure(
        jax.tree.map(lambda t: t.float().numpy(), tc))
    assert_close(tc, jc)
