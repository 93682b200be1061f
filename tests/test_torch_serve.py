"""The port's serving engine against the JAX package's on RecurrentGemma
SMOKE, with the JAX parameters carried across.

At float32 compute greedy generation must give identical tokens over an
aligned wave of left-padded prompts (the prompt widths wrap the local
attention's 8-slot ring), and ``prefill_logits`` and ``score`` agree
within 1e-5 of the largest magnitude (sums in another order).  Sampling
draws from a ``torch.Generator``, which cannot reproduce ``jax.random``'s
bits, so temperature and top-k are held to their properties:
deterministic per seed, never a masked or out-of-top-k token."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.recurrentgemma_9b import SMOKE as J_SMOKE
from repro.models.transformer import init_params as j_init_params
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs.recurrentgemma_9b import SMOKE
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_params
from repro_torch.serve import SamplerConfig, ServingEngine, sample

REL = 1e-5
PROMPTS = [[5, 17, 200, 3, 9, 41, 77, 12, 250, 8, 1, 66],
           [90, 14, 2, 33, 71, 19, 140, 5, 60],
           [7, 7, 7, 128, 255]]


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(J_SMOKE, compute_dtype="f32")
    tcfg = dataclasses.replace(SMOKE, compute_dtype="f32")
    jp = j_init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return (JServingEngine(jcfg, jp, max_seq=24),
            ServingEngine(tcfg, tp, max_seq=24, device="cpu"))


def close(got, want):
    scale = max(1.0, float(np.max(np.abs(want))))
    return float(np.max(np.abs(got - want))) <= REL * scale


def test_greedy_generate_matches_jax(engines):
    j_eng, t_eng = engines
    want = j_eng.generate(PROMPTS, n_new=10)
    got = t_eng.generate(PROMPTS, n_new=10)
    assert got.tokens.shape == (3, 10) and got.steps == 10
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert close(got.prefill_logits, want.prefill_logits)


def test_score_matches_jax(engines):
    j_eng, t_eng = engines
    toks = np.random.default_rng(2).integers(0, 256, (2, 19)).astype(np.int32)
    want = j_eng.score(toks)
    got = t_eng.score(toks)
    assert got.shape == (2, 18)
    assert close(got, want)


def test_generate_rejects_a_wave_past_max_seq(engines):
    with pytest.raises(ValueError, match="max_seq"):
        engines[1].generate(PROMPTS, n_new=13)


@pytest.mark.parametrize("sampler", [SamplerConfig(temperature=50.0),
                                     SamplerConfig(temperature=50.0,
                                                   top_k=5)])
def test_sampling_is_deterministic_per_seed(engines, sampler):
    _, t_eng = engines
    eng = ServingEngine(t_eng.cfg, t_eng.params, max_seq=24,
                        sampler=sampler, device="cpu")
    a = eng.generate(PROMPTS, n_new=8, seed=3).tokens
    b = eng.generate(PROMPTS, n_new=8, seed=3).tokens
    c = eng.generate(PROMPTS, n_new=8, seed=4).tokens
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_sampling_never_draws_a_padded_vocab_column():
    """vocab 200 padded to 256: the head masks columns 200.. to -1e30."""
    cfg = dataclasses.replace(SMOKE, vocab_size=200, compute_dtype="f32")
    params = init_params(cfg, 5, device="cpu")
    eng = ServingEngine(cfg, params, max_seq=24, device="cpu",
                        sampler=SamplerConfig(temperature=1e4))
    toks = eng.generate([[1, 2, 3, 4, 5, 6]] * 4, n_new=16, seed=0).tokens
    assert toks.max() < 200
    assert len(np.unique(toks)) > 8          # the temperature spreads draws


def test_sample_greedy_and_top_k_properties():
    rng = np.random.default_rng(9)
    logits = torch.as_tensor(rng.standard_normal((512, 64)).astype(np.float32))
    logits[:, 40:] = -1e30                   # masked columns
    greedy = sample(logits, None, SamplerConfig())
    assert greedy.dtype == torch.int32
    assert torch.equal(greedy.long(), logits.argmax(dim=-1))
    gen = torch.Generator().manual_seed(0)
    hot = sample(logits, gen, SamplerConfig(temperature=100.0))
    assert int(hot.max()) < 40
    top3 = torch.topk(logits, 3, dim=-1).indices
    picked = sample(logits, gen, SamplerConfig(temperature=100.0, top_k=3))
    assert bool((top3 == picked[:, None].long()).any(dim=-1).all())
    assert len(torch.unique(picked)) > 3
