"""The port's LM modules against the JAX package's, on the same inputs:
layers, rope, attention (plain, blockwise, decode through a ring wrap,
with and without the soft cap), the RG-LRU block, and the whole
RecurrentGemma SMOKE model (forward, prefill, decode; decode with the
attention and logit soft caps too), with parameters carried across by
``params_from_jax``.

Bars: at float32 compute, 1e-5 of the largest magnitude compared (sums in
another order; the port's RG-LRU scan steps in order where JAX's
associative scan pairs up); at bf16 compute, 2^-5 of it (four bf16
ulps: both packages round the same tensors to bf16, but their float32
sums differ and can flip a rounding)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.recurrentgemma_9b import SMOKE as J_SMOKE
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import rglru as j_rglru
from repro.models import rope as j_rope
from repro.models import transformer as j_tf
from repro_torch.configs.recurrentgemma_9b import SMOKE
from repro_torch.models import attention, layers, rglru, rope, transformer
from repro_torch.models.convert import cache_from_jax, params_from_jax

REL = {"f32": 1e-5, "bf16": 2.0 ** -5}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
KEY = jax.random.PRNGKey(0)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port(tree):
    return params_from_jax(to_np(tree), "cpu")


def assert_close(got, want, dt):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_close(got[k], want[k], dt)
        return
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= REL[dt] * scale, (err, scale)


def rand(shape, seed, dt="f32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dt]), torch.as_tensor(x).to(TDT[dt])


# ---------------------------------------------------------------------------
# layers and rope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("kind", ("rms", "layer"))
def test_norms(kind, dt):
    jx, tx = rand((2, 5, 64), 1, dt)
    p = j_layers.init_norm(kind, 64)
    p = jax.tree.map(lambda a: a * 1.5 + 0.25, p)
    want = j_layers.apply_norm(kind, p, jx)
    got = layers.apply_norm(kind, port(p), tx)
    assert got.dtype == TDT[dt]
    assert_close(got, want, dt)


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("act,gated,bias", [("gelu", True, False),
                                            ("silu", True, True),
                                            ("gelu_exact", False, False),
                                            ("relu", False, True)])
def test_mlp(act, gated, bias, dt):
    p = j_layers.init_mlp(KEY, 64, 128, gated=gated, bias=bias)
    if bias:
        p["bi"] = p["bi"] + 0.1
        p["bo"] = p["bo"] - 0.1
    jx, tx = rand((2, 7, 64), 2)
    want = j_layers.mlp(p, jx, act=act, compute_dtype=JDT[dt])
    got = layers.mlp(port(p), tx, act=act, compute_dtype=TDT[dt])
    assert_close(got, want, dt)


@pytest.mark.parametrize("tied", (True, False))
def test_embed_and_logits_head(tied):
    vocab, d = 256, 64
    table = j_layers.init_embedding(KEY, vocab, d)["table"]
    w = table if tied else j_layers.init_head(KEY, d, vocab)["w"]
    ids = np.random.default_rng(4).integers(0, vocab, (2, 9)).astype(np.int32)
    je = j_layers.embed({"table": table}, jnp.asarray(ids),
                        compute_dtype=jnp.float32)
    te = layers.embed({"table": port(table)}, torch.as_tensor(ids),
                      compute_dtype=torch.float32)
    assert_close(te, je, "f32")
    want = j_layers.logits_head(w, je, compute_dtype=jnp.float32,
                                valid_vocab=250)
    got = layers.logits_head(port(w), te, compute_dtype=torch.float32,
                             valid_vocab=250)
    assert_close(got[..., :250], want[..., :250], "f32")
    assert bool((got[..., 250:] == -1e30).all())
    want = j_layers.logits_head(w, je, softcap=30.0,
                                compute_dtype=jnp.float32)
    got = layers.logits_head(port(w), te, softcap=30.0,
                             compute_dtype=torch.float32)
    assert_close(got, want, "f32")


def test_rope_and_mrope():
    jx, tx = rand((2, 6, 3, 32), 5)
    pos = np.random.default_rng(6).integers(0, 500, (2, 6)).astype(np.int32)
    want = j_rope.apply_rope(jx, jnp.asarray(pos), theta=500.0)
    got = rope.apply_rope(tx, torch.as_tensor(pos), theta=500.0)
    assert_close(got, want, "f32")
    ids = np.random.default_rng(7).integers(0, 50, (3, 2, 6)).astype(np.int32)
    want = j_rope.apply_mrope(jx, jnp.asarray(ids), (4, 6, 6))
    got = rope.apply_mrope(tx, torch.as_tensor(ids), (4, 6, 6))
    assert_close(got, want, "f32")
    # pure text: M-RoPE degenerates to RoPE
    text = rope.text_mrope_positions(torch.as_tensor(pos))
    assert_close(rope.apply_mrope(tx, text, (4, 6, 6)),
                 j_rope.apply_rope(jx, jnp.asarray(pos)), "f32")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attn_case(window, blockwise, softcap=None, qkv_bias=False):
    spec_kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, window=window,
                   softcap=softcap, qkv_bias=qkv_bias, kv_block=8,
                   blockwise_threshold=8 if blockwise else 8192)
    jspec = j_attn.AttnSpec(**spec_kw)
    tspec = attention.AttnSpec(**spec_kw)
    p = j_attn.init_attention(KEY, 64, jspec)
    if qkv_bias:
        p = {k: (v + 0.05 if k.startswith("b") else v) for k, v in p.items()}
    return jspec, tspec, p


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("window", (None, 7))
@pytest.mark.parametrize("blockwise", (False, True), ids=("plain", "blockwise"))
def test_attn_full(blockwise, window, dt):
    """Both CPU branches; the blockwise one with a ragged last KV block
    (21 keys in blocks of 8)."""
    jspec, tspec, p = attn_case(window, blockwise, qkv_bias=True)
    jx, tx = rand((2, 21, 64), 8)
    pos = np.tile(np.arange(21, dtype=np.int32), (2, 1))
    want = j_attn.attn_full(p, jspec, jx, jnp.asarray(pos),
                            compute_dtype=JDT[dt])
    got = attention.attn_full(port(p), tspec, tx, torch.as_tensor(pos),
                              compute_dtype=TDT[dt])
    assert_close(got, want, dt)


def test_attn_full_softcap_and_offset_positions_on_cpu():
    """The CPU keeps JAX's general semantics: soft cap, custom positions."""
    jspec, tspec, p = attn_case(5, False, softcap=3.0)
    jx, tx = rand((2, 11, 64), 9)
    pos = np.tile(np.arange(11, dtype=np.int32) + 40, (2, 1))
    want = j_attn.attn_full(p, jspec, jx, jnp.asarray(pos),
                            compute_dtype=jnp.float32)
    got = attention.attn_full(port(p), tspec, tx, torch.as_tensor(pos),
                              compute_dtype=torch.float32)
    assert_close(got, want, "f32")


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_attn_decode_through_a_ring_wrap(dt):
    """A window-6 ring buffer of 6 slots filled over 15 steps."""
    jspec, tspec, p = attn_case(6, False)
    tp = port(p)
    jc = j_attn.init_attn_cache(2, jspec, 32, JDT[dt])
    tc = cache_from_jax(to_np(jc), "cpu")
    assert tc["k"].shape == (2, 2, 6, 16)
    for i in range(15):
        jx, tx = rand((2, 1, 64), 100 + i)
        want, jc = j_attn.attn_decode(p, jspec, jx, jc,
                                      jnp.asarray(i, jnp.int32),
                                      compute_dtype=JDT[dt])
        got, tc = attention.attn_decode(tp, tspec, tx, tc, i,
                                        compute_dtype=TDT[dt])
        assert_close(got, want, dt)
    assert_close(tc, to_np(jc), dt)


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("softcap", (2.0, 3.0))
def test_capped_attn_decode_through_a_ring_wrap(softcap, dt):
    """The soft cap on the decode path: caps 2 and 3, window 6 and a qkv
    bias, through a ring of 6 slots filled over 15 steps."""
    jspec, tspec, p = attn_case(6, False, softcap=softcap, qkv_bias=True)
    tp = port(p)
    jc = j_attn.init_attn_cache(2, jspec, 32, JDT[dt])
    tc = cache_from_jax(to_np(jc), "cpu")
    for i in range(15):
        jx, tx = rand((2, 1, 64), 300 + i)
        want, jc = j_attn.attn_decode(p, jspec, jx, jc,
                                      jnp.asarray(i, jnp.int32),
                                      compute_dtype=JDT[dt])
        got, tc = attention.attn_decode(tp, tspec, tx, tc, i,
                                        compute_dtype=TDT[dt])
        assert_close(got, want, dt)
    assert_close(tc, to_np(jc), dt)


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------


def rglru_params():
    spec = j_rglru.RGLRUSpec(d_rnn=64, n_heads=4, conv_width=4)
    p = j_rglru.init_rglru_block(KEY, 64, spec)
    p = {k: (v + 0.03 if k.endswith("bias") or k == "conv_b" else v)
         for k, v in p.items()}
    return spec, rglru.RGLRUSpec(64, 4, 4), p


def test_causal_conv():
    jx, tx = rand((2, 9, 64), 10)
    jw, tw = rand((4, 64), 11)
    jb, tb = rand((64,), 12)
    assert_close(rglru.causal_conv(tx, tw, tb),
                 j_rglru.causal_conv(jx, jw, jb), "f32")
    jt, tt = rand((2, 3, 64), 13)
    jy, jtail = j_rglru.causal_conv_step(jx[:, :1], jt, jw, jb)
    ty, ttail = rglru.causal_conv_step(tx[:, :1], tt, tw, tb)
    assert_close(ty, jy, "f32")
    assert_close(ttail, jtail, "f32")


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_rglru_scan_and_block(dt):
    jspec, tspec, p = rglru_params()
    tp = port(p)
    jx, tx = rand((2, 33, 64), 14, dt)
    assert_close(rglru.rglru_scan(tp, tspec, tx),
                 j_rglru.rglru_scan(p, jspec, jx), dt)
    jx, tx = rand((2, 33, 64), 15)
    want = j_rglru.rglru_block(p, jspec, jx, compute_dtype=JDT[dt])
    got = rglru.rglru_block(tp, tspec, tx, compute_dtype=TDT[dt])
    assert_close(got, want, dt)


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_rglru_block_step(dt):
    jspec, tspec, p = rglru_params()
    tp = port(p)
    jc = j_rglru.init_rglru_cache(2, jspec, JDT[dt])
    tc = cache_from_jax(to_np(jc), "cpu")
    for i in range(6):
        jx, tx = rand((2, 1, 64), 200 + i)
        want, jc = j_rglru.rglru_block_step(p, jspec, jx, jc,
                                            compute_dtype=JDT[dt])
        got, tc = rglru.rglru_block_step(tp, tspec, tx, tc,
                                         compute_dtype=TDT[dt])
        assert_close(got, want, dt)
    assert_close(tc, to_np(jc), dt)


# ---------------------------------------------------------------------------
# the whole SMOKE model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_models():
    out = {}
    for dt in ("f32", "bf16"):
        jcfg = dataclasses.replace(J_SMOKE, compute_dtype=dt)
        tcfg = dataclasses.replace(SMOKE, compute_dtype=dt)
        jp = j_tf.init_params(jcfg, KEY)
        out[dt] = (jcfg, tcfg, jp, port(jp))
    return out


def tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, SMOKE.vocab_size, (b, s)).astype(np.int32)


def test_params_carry_across_with_jax_key_paths(smoke_models):
    jcfg, tcfg, jp, tp = smoke_models["f32"]
    assert tp.keys() == jp.keys()
    assert tp["unit"]["layer2"]["mixer"]["wq"].shape == (1, 64, 1, 4, 16)
    assert set(tp["tail"]) == {"tail0", "tail1"}
    assert transformer.param_count(tp) == j_tf.param_count(jp)
    fresh = transformer.init_params(tcfg, 0, device="cpu")
    assert jax.tree.structure(to_np(jp)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), fresh))
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t, jp)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), fresh))):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_bf16_params_convert_bit_for_bit():
    x = jnp.asarray(np.linspace(-3, 3, 37, dtype=np.float32), jnp.bfloat16)
    t = params_from_jax({"w": np.asarray(x)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_forward(smoke_models, dt):
    jcfg, tcfg, jp, tp = smoke_models[dt]
    toks = tokens(2, 20, 16)
    want, _ = j_tf.forward(jcfg, jp, jnp.asarray(toks), mode="eval")
    got, aux = transformer.forward(tcfg, tp, torch.as_tensor(toks),
                                   mode="eval")
    assert got.shape == (2, 20, tcfg.padded_vocab) and float(aux) == 0.0
    assert_close(got, want, dt)


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_prefill_then_decode(smoke_models, dt):
    """Prefill of 14 tokens into an 8-slot ring (S > window: the wrap of
    ``_ring_align``), then 6 decode steps."""
    jcfg, tcfg, jp, tp = smoke_models[dt]
    toks = tokens(2, 20, 17)
    want, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks[:, :14]), max_seq=24)
    got, tc = transformer.prefill(tcfg, tp, torch.as_tensor(toks[:, :14]),
                                  max_seq=24)
    assert got.shape == (2, 1, tcfg.padded_vocab)
    assert_close(got, want, dt)
    assert_close(tc, to_np(jc), dt)
    for pos in range(14, 20):
        want, jc = j_tf.decode_step(jcfg, jp, jc,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.asarray(pos, jnp.int32))
        got, tc = transformer.decode_step(
            tcfg, tp, tc, torch.as_tensor(toks[:, pos:pos + 1]), pos)
        assert_close(got, want, dt)
    assert_close(tc, to_np(jc), dt)


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_capped_prefill_then_decode_step(dt):
    """The SMOKE model with ``attn_softcap=3.0`` and ``logit_softcap=20.0``:
    prefill of 14 tokens into its 8-slot rings, then 6 ``decode_step``s,
    logits and caches against JAX's."""
    kw = dict(compute_dtype=dt, attn_softcap=3.0, logit_softcap=20.0)
    jcfg = dataclasses.replace(J_SMOKE, **kw)
    tcfg = dataclasses.replace(SMOKE, **kw)
    jp = j_tf.init_params(jcfg, KEY)
    tp = port(jp)
    toks = tokens(2, 20, 19)
    want, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks[:, :14]), max_seq=24)
    got, tc = transformer.prefill(tcfg, tp, torch.as_tensor(toks[:, :14]),
                                  max_seq=24)
    assert_close(got, want, dt)
    for pos in range(14, 20):
        want, jc = j_tf.decode_step(jcfg, jp, jc,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.asarray(pos, jnp.int32))
        got, tc = transformer.decode_step(
            tcfg, tp, tc, torch.as_tensor(toks[:, pos:pos + 1]), pos)
        assert_close(got, want, dt)
    assert_close(tc, to_np(jc), dt)


def test_decode_from_a_converted_jax_cache(smoke_models):
    """A cache JAX filled carries across and decoding goes on from it."""
    jcfg, tcfg, jp, tp = smoke_models["f32"]
    toks = tokens(2, 12, 18)
    _, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks[:, :5]), max_seq=12)
    tc = cache_from_jax(to_np(jc), "cpu")
    assert tc["unit"]["layer2"]["pos"].dtype == torch.int32
    for pos in range(5, 12):
        want, jc = j_tf.decode_step(jcfg, jp, jc,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.asarray(pos, jnp.int32))
        got, tc = transformer.decode_step(
            tcfg, tp, tc, torch.as_tensor(toks[:, pos:pos + 1]), pos)
        assert_close(got, want, "f32")


def test_init_cache_matches_jax_layout():
    jc = to_np(j_tf.init_cache(J_SMOKE, 3, 20))
    tc = transformer.init_cache(SMOKE, 3, 20, device="cpu")
    assert jax.tree.structure(jc) == jax.tree.structure(
        jax.tree.map(lambda t: t.float().numpy(), tc))
    assert_close(tc, jc, "f32")


def test_unported_mixers_and_training_name_their_slice():
    """Every mixer and FFN of the JAX package is ported: the xLSTM and
    MoE layers initialise and run (``test_torch_xlstm.py`` and
    ``test_torch_moe.py`` hold them against JAX); unknown names raise;
    training is ported too (``test_torch_train_step.py`` holds it against
    JAX): ``mode="train"`` sums the MoE term and ``loss_fn`` runs."""
    from repro_torch.models.moe import MoESpec
    from repro_torch.models.xlstm import MLSTMSpec

    cfg = dataclasses.replace(
        SMOKE, pattern=(transformer.LayerSpec(mixer="mlstm", ffn="moe"),),
        tail=(), n_layers=2, compute_dtype="f32",
        mlstm=MLSTMSpec(d_inner=64, n_heads=2, chunk=4),
        moe=MoESpec(n_experts=4, top_k=2, d_ff=32))
    params = transformer.init_params(cfg, 0, device="cpu")
    assert params["unit"]["layer0"]["ffn"]["wi"].shape == (2, 4, 64, 32)
    logits, aux = transformer.forward(
        cfg, params, torch.as_tensor(tokens(2, 6, 3)), mode="eval")
    assert logits.shape == (2, 6, cfg.padded_vocab) and float(aux) == 0.0
    moe_cfg, moe_params = cfg, params
    for bad in (transformer.LayerSpec(mixer="mamba"),
                transformer.LayerSpec(ffn="glu")):
        cfg = dataclasses.replace(SMOKE, pattern=(bad,), tail=(),
                                  n_layers=2)
        with pytest.raises(ValueError, match="unknown"):
            transformer.init_params(cfg, 0, device="cpu")
    toks = torch.as_tensor(tokens(2, 6, 3))
    _, aux = transformer.forward(moe_cfg, moe_params, toks, mode="train")
    assert float(aux) > 0.0
    loss, metrics = transformer.loss_fn(moe_cfg, moe_params,
                                         {"inputs": toks, "labels": toks})
    assert torch.isfinite(loss) and int(metrics["tokens"]) == 12
    assert float(metrics["moe_aux"]) == float(aux)
