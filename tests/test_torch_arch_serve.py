"""The nine SMOKE models beside RecurrentGemma (whose own files are
``test_torch_models.py`` and ``test_torch_serve.py``) against the JAX
package, with JAX's parameters carried across: ``forward``, ``prefill``
then ``decode_step``, and greedy generation through ``ServingEngine``.
musicgen-medium takes frame embeddings, so it is served by ``prefill``
and ``decode_step`` on embeddings; qwen2-vl-2b also takes non-text
M-RoPE ids laid out as Qwen2-VL's frontend emits them (text, an image's
patch grid at one temporal id, text resuming after the largest id).

Bars: 1e-5 of the largest logit at float32 compute, tokens identical;
2^-5 at bf16 (``tests/test_torch_models.py``'s bars).  At bf16 the
residual stream that feeds an MoE router differs between the packages
by bf16 rounding, so a token whose k-th and (k+1)-th router logits are
that close may take another expert in one package: a jump in its FFN
output, not a rounding error.  The bf16 forward of the MoE configs is
therefore held on the tokens whose margin exceeds 2^-7 of the largest
|logit| in every MoE layer (bf16 rounds the router's input to 2^-8),
and the others must be under a quarter of all tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import transformer as j_tf
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import registry
from repro_torch.models import moe, transformer
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServingEngine

REL = {"f32": 1e-5, "bf16": 2.0 ** -5}
ARCHS = tuple(a for a in j_registry.ARCH_IDS if a != "recurrentgemma-9b")
TOKEN_ARCHS = tuple(a for a in ARCHS if a != "musicgen-medium")
PROMPTS = [[5, 17, 200, 3, 9, 41, 77, 12, 250, 8, 1, 66],
           [90, 14, 2, 33, 71, 19, 140, 5, 60],
           [7, 7, 7, 128, 255]]


def models(arch, dt="f32", seed=0):
    jcfg = dataclasses.replace(j_registry.get_arch(arch).smoke,
                               compute_dtype=dt)
    tcfg = dataclasses.replace(registry.get_arch(arch).smoke,
                               compute_dtype=dt)
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           "cpu")


def inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def vl_position_ids(b, n_text, grid, n_after):
    """[3, B, S] M-RoPE ids: ``n_text`` text tokens, a ``grid`` x ``grid``
    patch grid at temporal id ``n_text`` with its row and column added
    to the height and width ids, then ``n_after`` text tokens from one
    past the largest id."""
    text = np.arange(n_text)
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    image = np.stack([np.full(grid * grid, n_text), n_text + rows,
                      n_text + cols])
    after = image.max() + 1 + np.arange(n_after)
    ids = np.concatenate([np.stack([text] * 3), image,
                          np.stack([after] * 3)], axis=1)
    return np.ascontiguousarray(
        np.broadcast_to(ids[:, None], (3, b, ids.shape[1]))).astype(np.int32)


def close(got, want, dt="f32"):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= REL[dt] * scale, (err, scale)


def router_near_ties(monkeypatch, rel):
    """Records, for each ``apply_moe`` call, a [G, T] mask of tokens whose
    k-th and (k+1)-th router logits are within ``rel`` of the largest
    |logit|."""
    seen = []
    real = moe._route

    def spy(router_w, x, spec):
        logits = moe.router_logits(router_w, x)
        top = torch.sort(logits, dim=-1, descending=True).values
        gap = top[..., spec.top_k - 1] - top[..., spec.top_k]
        seen.append(gap <= rel * logits.abs().max())
        return real(router_w, x, spec)

    monkeypatch.setattr(moe, "_route", spy)
    return seen


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, dt, monkeypatch):
    jcfg, tcfg, jp, tp = models(arch, dt)
    x = inputs(tcfg, 2, 21, 1)
    ties = router_near_ties(monkeypatch, 2.0 ** -7)
    want, jaux = j_tf.forward(jcfg, jp, jnp.asarray(x), mode="eval")
    got, aux = transformer.forward(tcfg, tp, torch.as_tensor(x), mode="eval")
    assert float(aux) == float(jaux) == 0.0     # no aux outside training
    v = tcfg.vocab_size
    got, want = got[..., :v].numpy(), np.asarray(want)[..., :v]
    if dt == "f32" or not ties:
        close(got, want, dt)
        return
    tied = torch.stack(ties).any(0).numpy()            # [B, S]
    assert tied.sum() < 0.25 * tied.size, tied
    close(got[~tied], want[~tied], dt)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """Prefill 13 positions, then 7 decode steps fed the JAX argmax (or,
    for embeddings, the next seeded frame)."""
    jcfg, tcfg, jp, tp = models(arch)
    x = inputs(tcfg, 2, 20, 2)
    v = tcfg.vocab_size
    want, jc = j_tf.prefill(jcfg, jp, jnp.asarray(x[:, :13]), max_seq=20)
    got, tc = transformer.prefill(tcfg, tp, torch.as_tensor(x[:, :13]),
                                  max_seq=20)
    close(got[..., :v], np.asarray(want)[..., :v])
    for pos in range(13, 20):
        if tcfg.input_mode == "embeddings":
            nxt = x[:, pos:pos + 1]
        else:
            nxt = np.asarray(want[:, -1, :v].argmax(-1))[:, None].astype(
                np.int32)
        want, jc = j_tf.decode_step(jcfg, jp, jc, jnp.asarray(nxt),
                                    jnp.asarray(pos, jnp.int32))
        got, tc = transformer.decode_step(tcfg, tp, tc,
                                          torch.as_tensor(nxt), pos)
        close(got[..., :v], np.asarray(want)[..., :v])


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_greedy_generate_matches_jax(arch):
    jcfg, tcfg, jp, tp = models(arch, seed=1)
    want = JServingEngine(jcfg, jp, max_seq=24).generate(PROMPTS, n_new=10)
    got = ServingEngine(tcfg, tp, max_seq=24, device="cpu").generate(
        PROMPTS, n_new=10)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    close(got.prefill_logits, want.prefill_logits)


def greedy(cfg, params, prefill_fn, decode_fn, x, n_new, ids=None):
    """Greedy tokens and last logits: prefill, then ``n_new - 1`` steps;
    for embeddings each step feeds the next seeded frame."""
    v = cfg.vocab_size
    s = x.shape[1]
    logits, cache = prefill_fn(x[:, :s - n_new + 1], ids)
    toks = []
    for i in range(n_new):
        last = np.asarray(logits[:, -1, :v].float()
                          if isinstance(logits, torch.Tensor)
                          else logits[:, -1, :v])
        toks.append(last.argmax(-1))
        if i == n_new - 1:
            break
        pos = s - n_new + 1 + i
        nxt = (x[:, pos:pos + 1] if cfg.input_mode == "embeddings"
               else toks[-1][:, None].astype(np.int32))
        step_ids = None if ids is None else ids[:, :, -1:] + 1 + i
        logits, cache = decode_fn(cache, nxt, pos, step_ids)
    return np.stack(toks, 1), last


def jax_greedy(jcfg, jp, x, n_new, ids=None):
    return greedy(
        jcfg, jp,
        lambda xs, i: j_tf.prefill(
            jcfg, jp, jnp.asarray(xs), max_seq=x.shape[1],
            position_ids=None if i is None
            else jnp.asarray(i[:, :, :xs.shape[1]])),
        lambda c, nxt, pos, i: j_tf.decode_step(
            jcfg, jp, c, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32),
            position_ids=None if i is None else jnp.asarray(i)),
        x, n_new, ids)


def port_greedy(tcfg, tp, x, n_new, ids=None):
    return greedy(
        tcfg, tp,
        lambda xs, i: transformer.prefill(
            tcfg, tp, torch.as_tensor(xs), max_seq=x.shape[1],
            position_ids=None if i is None
            else torch.as_tensor(i[:, :, :xs.shape[1]])),
        lambda c, nxt, pos, i: transformer.decode_step(
            tcfg, tp, c, torch.as_tensor(nxt), pos,
            position_ids=None if i is None else torch.as_tensor(i)),
        x, n_new, ids)


def test_musicgen_greedy_on_embeddings_matches_jax():
    jcfg, tcfg, jp, tp = models("musicgen-medium", seed=1)
    x = inputs(tcfg, 3, 22, 3)
    want_t, want_l = jax_greedy(jcfg, jp, x, 10)
    got_t, got_l = port_greedy(tcfg, tp, x, 10)
    np.testing.assert_array_equal(got_t, want_t)
    close(got_l, want_l)


def test_qwen2_vl_non_text_ids_match_jax():
    """An image's patch ids in the prompt: forward, prefill and greedy
    decoding with the text ids resuming after the image."""
    jcfg, tcfg, jp, tp = models("qwen2-vl-2b", seed=1)
    ids = vl_position_ids(2, 5, 3, 9)              # S = 5 + 9 + 9 = 23
    x = inputs(tcfg, 2, ids.shape[2], 4)
    assert not np.array_equal(ids[0], ids[1])      # not text ids
    want, _ = j_tf.forward(jcfg, jp, jnp.asarray(x),
                           position_ids=jnp.asarray(ids), mode="eval")
    got, _ = transformer.forward(tcfg, tp, torch.as_tensor(x),
                                 position_ids=torch.as_tensor(ids),
                                 mode="eval")
    v = tcfg.vocab_size
    close(got[..., :v], np.asarray(want)[..., :v])
    text, _ = transformer.forward(tcfg, tp, torch.as_tensor(x), mode="eval")
    assert float((text - got).abs().max()) > 1e-3  # the ids matter
    want_t, want_l = jax_greedy(jcfg, jp, x, 8, ids)
    got_t, got_l = port_greedy(tcfg, tp, x, 8, ids)
    np.testing.assert_array_equal(got_t, want_t)
    close(got_l, want_l)
