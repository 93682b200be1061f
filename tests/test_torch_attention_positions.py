"""Caller positions and the attention logit soft cap: the port against the
JAX package on the CPU, and K4's positional tile schedule against the
mask it must cover.

* ``attn_full`` on packed documents (positions restarting at each
  document), shifted positions, a window and a soft cap, through both of
  JAX's CPU branches (``_attn_plain`` and ``_attn_blockwise``, on either
  side of ``blockwise_threshold``) and the port's, at f32 and bf16.
* K4's plain backward (``attention_backward_reference``) with positions
  and a cap against ``torch.autograd`` of ``attention_reference`` and
  against ``jax.vjp`` of JAX's ``_attn_plain``; ``ops.flash_attention``'s
  gradient on the CPU (the autograd Function carrying the positions).
* ``loss_fn`` and its gradient on the qwen2-0.5b SMOKE config (2 layers)
  with ``batch["positions"]`` and ``attn_softcap``, against JAX's
  ``loss_fn`` and ``jax.value_and_grad``, parameters carried across by
  ``models.convert``.
* ``tiles.pos_band`` (the twin of the plan's pre-pass) and
  ``pos_schedule`` / ``pos_dkdv_schedule`` (the kernels' walks in
  position order): the band is the mask in sorted order; every skipped
  tile holds no kept pair, every tile taken without the mask holds only
  kept pairs, every kept pair lies in a visited tile (once, for dk/dv);
  for positions ``arange`` the schedules are the index schedules; on
  phase 16's packed documents they visit at most 1.05x the index
  schedule's tiles.  ``PosPlan`` on the CPU and on meta tensors.

Bars: f32 outputs within 1e-5 of the largest magnitude compared, bf16
within 2^-5 (as ``test_torch_models.py``: both packages round the same
tensors to bf16, but their f32 sums differ and can flip a rounding); the
plain backward within 1e-5 of each gradient's largest magnitude against
autograd (the same f32 arithmetic in another order) and 1e-4 against
JAX (another framework's f32 sums); ``loss_fn`` as
``test_torch_train_step.py`` (f32: loss 1e-5 relative, every gradient
leaf 1e-4 of its largest magnitude; bf16: loss 2^-8, the gradients as a
whole 2^-5).

JAX adds the mask as a bias of -1e30 to the scores, so its gradient
reaches the scores of a row that keeps no key (the derivative of s + bias
is 1 even where the bias swamps s); the kernels and their plain versions
select with the mask and give such a row dS = 0.  Self-attention on
shared positions keeps every row's own key, so the comparisons with JAX
use such positions; rows without a kept key are held against autograd of
the plain forward, which selects as the kernels do."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import registry as j_registry
from repro.models import attention as j_attn
from repro.models import transformer as j_tf
from repro_torch.configs import registry
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import tiles
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.plan import PosPlan
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference, attention_lse_reference,
    attention_reference)
from repro_torch.launch import steps
from repro_torch.models import attention
from repro_torch.models.convert import params_from_jax
from repro_torch.train.optimizer import tree_paths

REL = {"f32": 1e-5, "bf16": 2.0 ** -5}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
KEY = jax.random.PRNGKey(0)


def packed_positions(b: int, s: int, seed: int, lo: int = 3,
                     hi: int = 9) -> np.ndarray:
    """[b, s] int32: documents of lo..hi tokens drawn from ``seed`` until
    s is filled (the last one cut), positions restarting at 0 in each."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        j = 0
        while j < s:
            n = int(rng.integers(lo, hi + 1))
            out[i, j:j + n] = np.arange(min(n, s - j))
            j += n
    return out


def positions(kind: str, b: int, s: int, seed: int = 5) -> np.ndarray:
    if kind == "packed":
        return packed_positions(b, s, seed)
    if kind == "shifted":
        return np.tile(np.arange(s, dtype=np.int32) + 40, (b, 1))
    return np.tile(np.arange(s, dtype=np.int32), (b, 1))


def assert_close(got: torch.Tensor, want, rel: float) -> None:
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# attn_full against JAX's, both CPU branches
# ---------------------------------------------------------------------------

ATTN_CASES = [("packed", None, None), ("shifted", None, None),
              ("packed", 7, None), ("arange", None, 3.0),
              ("packed", None, 3.0), ("packed", 7, 3.0)]


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("blockwise", (False, True),
                         ids=("plain", "blockwise"))
@pytest.mark.parametrize("kind,window,softcap", ATTN_CASES,
                         ids=[f"{k}-w{w}-cap{c}" for k, w, c in ATTN_CASES])
def test_attn_full_matches_jax(kind, window, softcap, blockwise, dt):
    """21 tokens (the blockwise branch in ragged blocks of 8)."""
    spec_kw = dict(n_heads=4, n_kv_heads=2, head_dim=16, window=window,
                   softcap=softcap, qkv_bias=True, kv_block=8,
                   blockwise_threshold=8 if blockwise else 8192)
    jspec = j_attn.AttnSpec(**spec_kw)
    tspec = attention.AttnSpec(**spec_kw)
    p = j_attn.init_attention(KEY, 64, jspec)
    p = {k: (v + 0.05 if k.startswith("b") else v) for k, v in p.items()}
    x = np.random.default_rng(8).standard_normal((2, 21, 64)).astype(
        np.float32) * 2.0
    pos = positions(kind, 2, 21)
    want = j_attn.attn_full(p, jspec, jnp.asarray(x, JDT[dt]),
                            jnp.asarray(pos), compute_dtype=JDT[dt])
    got = attention.attn_full(
        params_from_jax(jax.tree.map(np.asarray, p), "cpu"), tspec,
        torch.as_tensor(x).to(TDT[dt]), torch.as_tensor(pos),
        compute_dtype=TDT[dt])
    assert got.dtype == TDT[dt]
    assert_close(got, want, REL[dt])


def test_attn_full_default_positions_are_arange():
    """``positions`` None (the caller gave none) is ``arange(S)`` in every
    row, for RoPE and for the mask."""
    spec = attention.AttnSpec(n_heads=4, n_kv_heads=2, head_dim=16,
                              window=5, softcap=2.0)
    p = attention.init_attention(torch.Generator().manual_seed(1), 32, spec)
    x = torch.randn((3, 13, 32), generator=torch.Generator().manual_seed(2))
    pos = torch.arange(13, dtype=torch.int32)[None].expand(3, 13)
    got = attention.attn_full(p, spec, x, None, compute_dtype=torch.float32)
    want = attention.attn_full(p, spec, x, pos, compute_dtype=torch.float32)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the plain backward with positions and a cap
# ---------------------------------------------------------------------------

BWD_CASES = [  # (h, kvh, s, d, positions, window, softcap)
    (4, 2, 37, 16, "packed", None, None),
    (4, 2, 37, 16, "packed", 6, 2.0),
    (7, 1, 50, 8, "packed", None, 1.5),
    (2, 2, 29, 16, "shifted", 9, 2.5),
]


def bwd_inputs(case, seed=0):
    h, kvh, s, d, kind, window, softcap = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((2, h, s, d), (2, kvh, s, d), (2, kvh, s, d),
                                 (2, h, s, d)))
    return (q * 2.0, k * 2.0, v, do, positions(kind, 2, s, seed=s),
            dict(window=window, softcap=softcap))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", BWD_CASES + [
    (4, 2, 31, 16, "keyless", 5, 2.0), (3, 1, 40, 16, "keyless", None, None)],
    ids=lambda c: f"{c[4]}-h{c[0]}-kv{c[1]}-s{c[2]}-w{c[5]}-cap{c[6]}")
def test_backward_reference_matches_autograd(case):
    """Including rows that keep no key (queries 40 positions before every
    key of their window): P = 1 / Sk there, dS = 0."""
    *_, kind, window, softcap = case
    q, k, v, do, pos, kw = bwd_inputs(case)
    q_pos = k_pos = torch.as_tensor(pos)
    if kind == "keyless":
        k_pos = q_pos + 40 * (torch.arange(q_pos.shape[1]) % 3 == 0)
    q, k, v, do = (torch.as_tensor(x) for x in (q, k, v, do))
    kw.update(q_pos=q_pos, k_pos=k_pos)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = attention_reference(*xs, **kw)
    want = torch.autograd.grad(out, xs, do)
    got = attention_backward_reference(q, k, v, out.detach(), do, **kw)
    for g, w in zip(got, want):
        assert rel_err(g, w) <= 1e-5
    if kind == "keyless":     # the case has such rows
        lse = attention_lse_reference(q, k, **kw)
        assert bool((lse < -1e29).any())


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: f"{c[4]}-h{c[0]}-kv{c[1]}-s{c[2]}-"
                                       f"w{c[5]}-cap{c[6]}")
def test_backward_reference_matches_jax_vjp(case):
    """JAX's ``_attn_plain`` in the model's grouped layout, its vjp against
    the plain backward (GQA sums, the cap's 1 - tanh^2)."""
    h, kvh, s, d, _, window, softcap = case
    q, k, v, do, pos, kw = bwd_inputs(case)
    g = h // kvh
    spec = j_attn.AttnSpec(n_heads=h, n_kv_heads=kvh, head_dim=d,
                           window=window, softcap=softcap)

    def grouped(x):     # [B, H, S, D] -> [B, S, kvH, G, D]
        return jnp.asarray(x.reshape(2, kvh, g, s, d).transpose(0, 3, 1, 2, 4))

    jpos = jnp.asarray(pos)
    out, vjp = jax.vjp(
        lambda a, b_, c: j_attn._attn_plain(spec, a, b_, c, jpos, jpos),
        grouped(q), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)))
    jdq, jdk, jdv = vjp(grouped(do))
    tpos = torch.as_tensor(pos)
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    o = attention_reference(tq, tk, tv, q_pos=tpos, k_pos=tpos, **kw)
    assert_close(o.reshape(2, kvh, g, s, d).permute(0, 3, 1, 2, 4), out,
                 1e-5)
    dq, dk, dv = attention_backward_reference(tq, tk, tv, o, tdo, q_pos=tpos,
                                              k_pos=tpos, **kw)
    for got, want in ((dq.reshape(2, kvh, g, s, d).permute(0, 3, 1, 2, 4),
                       jdq), (dk.transpose(1, 2), jdk),
                      (dv.transpose(1, 2), jdv)):
        want = np.asarray(want)
        err = float(np.max(np.abs(got.numpy() - want)))
        assert err <= 1e-4 * float(np.max(np.abs(want))), err


@pytest.mark.parametrize("layout", ("bhsd", "grouped"))
def test_gradient_through_the_function_carries_positions(layout):
    """``ops.flash_attention`` under autograd on the CPU: the Function's
    saved positions and cap reach the plain backward; its gradients equal
    autograd of ``attention_reference``."""
    h, kvh, s, d = 6, 2, 33, 16
    q, k, v, do, pos, kw = bwd_inputs((h, kvh, s, d, "packed", 8, 2.0))
    tpos = torch.as_tensor(pos)
    q, k, v, do = (torch.as_tensor(x) for x in (q, k, v, do))
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(attention_reference(
        *xs, q_pos=tpos, k_pos=tpos, **kw), xs, do)
    if layout == "grouped":
        g = h // kvh
        ins = [q.reshape(2, kvh, g, s, d).permute(0, 3, 1, 2, 4),
               k.transpose(1, 2), v.transpose(1, 2)]
        gdo = do.reshape(2, kvh, g, s, d).permute(0, 3, 1, 2, 4)
    else:
        ins, gdo = [q, k, v], do
    ins = [x.contiguous().requires_grad_(True) for x in ins]
    out = flash_attention(*ins, window=kw["window"], q_pos=tpos, k_pos=tpos,
                          softcap=kw["softcap"])
    got = torch.autograd.grad(out, ins, gdo)
    if layout == "grouped":
        got = [got[0].permute(0, 2, 3, 1, 4).reshape(2, h, s, d),
               got[1].transpose(1, 2), got[2].transpose(1, 2)]
    for x, y in zip(got, want):
        assert rel_err(x, y) <= 1e-5


def test_wrapper_checks_positions_and_cap():
    """Integer [B, S] positions on q's device and a positive finite cap,
    else an error, on every device (meta here: the card's checks)."""
    q = torch.empty((2, 4, 10, 16), device="meta")
    k = torch.empty((2, 2, 10, 16), device="meta")
    pos = torch.zeros((2, 10), dtype=torch.int32, device="meta")
    FK.flash_attention_bhsd(q, k, k, q_pos=pos, k_pos=pos, softcap=30.0)
    with pytest.raises(ValueError, match="softcap"):
        FK.flash_attention_bhsd(q, k, k, softcap=0.0)
    with pytest.raises(ValueError, match="softcap"):
        FK.flash_attention_bhsd(q, k, k, softcap=float("inf"))
    with pytest.raises(TypeError, match="integer"):
        FK.flash_attention_bhsd(q, k, k, q_pos=pos.float(), k_pos=pos)
    with pytest.raises(ValueError, match="shape"):
        FK.flash_attention_bhsd(q, k, k, q_pos=pos[:, :9], k_pos=pos)
    with pytest.raises(ValueError, match="q_offset"):
        FK.flash_attention_bhsd(q, k, k, q_pos=pos, q_offset=3)
    with pytest.raises(ValueError, match="is on cpu"):
        FK.flash_attention_bwd_bhsd(
            q, k, k, q, q, torch.empty((2, 4, 10), device="meta"),
            q_pos=torch.zeros((2, 10), dtype=torch.int32), k_pos=pos)


def test_pos_scratch_matches_the_kernel_source():
    """The plan's band: its pad and layout, from the constants and
    ``band_ints`` of ``csrc/flash_attention.cuh``."""
    src = (build.CSRC_DIR / "flash_attention.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert tiles.POS_PAD == const("POS_PAD") == 128
    assert re.search(r"return 2LL \* pos_padded\(sq\) \+ 2LL \* "
                     r"pos_padded\(sk\) \+ 4;", src)
    # every tile of every kernel lies within the pad, so a block's rows
    # and keys are in bounds
    for d in FK.HEAD_DIMS:
        for n in (*tiles.tc_tile(d), *tiles.F32_TILE, *tiles.bwd_tiles(True, d),
                  *tiles.bwd_tiles(False, d)):
            assert tiles.POS_PAD % n == 0
    assert tiles.pos_scratch_ints(2, 100, 300) == 2 * (2 * 128 + 2 * 384 + 4)


# ---------------------------------------------------------------------------
# loss_fn on packed documents with a soft cap, against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ("f32", "bf16"))
def test_loss_and_grads_with_positions_and_softcap_match_jax(dt):
    arch = "qwen2-0.5b"
    kw = dict(compute_dtype=dt, attn_softcap=3.0)
    jcfg = dataclasses.replace(j_registry.get_arch(arch).smoke, **kw)
    tcfg = dataclasses.replace(registry.get_arch(arch).smoke, **kw)
    assert tcfg.n_layers == 2
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    data = {"inputs": rng.integers(0, tcfg.vocab_size, (2, 24)).astype(
                np.int32),
            "labels": rng.integers(0, tcfg.vocab_size, (2, 24)).astype(
                np.int32),
            "positions": packed_positions(2, 24, 7, lo=4, hi=12)}
    (jl, _), jg = jax.value_and_grad(
        lambda p: j_tf.loss_fn(jcfg, p, jax.tree.map(jnp.asarray, data)),
        has_aux=True)(jp)
    tl, _, tg = steps.value_and_grad(
        tcfg, tp, {k: torch.as_tensor(v) for k, v in data.items()})
    # the positions and the cap change the loss (they reach the mask)
    plain = {k: v for k, v in data.items() if k != "positions"}
    other, _, _ = steps.value_and_grad(
        dataclasses.replace(tcfg, attn_softcap=None), tp,
        {k: torch.as_tensor(v) for k, v in plain.items()})
    assert float(other) != float(tl)
    rel = 1e-5 if dt == "f32" else 2.0 ** -8
    assert abs(float(tl) - float(jl)) <= rel * abs(float(jl))
    got = [(p, x.float().numpy()) for p, x in tree_paths(tg)]
    want = [(p, np.asarray(x).astype(np.float32)) for p, x in tree_paths(
        jax.tree.map(np.asarray, jg), is_leaf=lambda x: not isinstance(
            x, dict))]
    assert [p for p, _ in got] == [p for p, _ in want]
    if dt == "f32":
        for (path, g), (_, w) in zip(got, want):
            err = float(np.max(np.abs(g - w)))
            assert err <= 1e-4 * max(float(np.max(np.abs(w))), 1e-30), path
    else:
        num = sum(float(((g - w) ** 2).sum()) for (_, g), (_, w)
                  in zip(got, want))
        den = sum(float((w ** 2).sum()) for _, w in want)
        assert (num / den) ** 0.5 < 2.0 ** -5


# ---------------------------------------------------------------------------
# the positional tile schedule
# ---------------------------------------------------------------------------

#: (query rows, keys) of the forward's tiles and the dq blocks', and the
#: dk/dv blocks' (keys, query rows)
FWD_TILES = ((128, 64), (64, 64), (64, 32), (32, 32))
DKDV_TILES = ((64, 64), (32, 64), (32, 32))


def kept_pairs(q_pos, k_pos, causal, window) -> torch.Tensor:
    q = torch.as_tensor(q_pos)[:, None].long()
    k = torch.as_tensor(k_pos)[None, :].long()
    ok = torch.ones((q.shape[0], k.shape[1]), dtype=torch.bool)
    if causal:
        ok &= q >= k
    if window:
        ok &= q - k < window
    return ok


@st.composite
def position_rows(draw):
    """(q_pos, k_pos, causal, window): self-attention on packed documents
    (shared positions), or two rows of random positions (unsorted,
    negative, with ties; heavy ties in a span of a few positions)."""
    sq = draw(st.integers(1, 200))
    causal = draw(st.booleans())
    window = draw(st.sampled_from((None, 1, 3, 17, 64, 150)))
    kind = draw(st.sampled_from(("packed", "random", "ties")))
    if kind == "packed":
        seed = draw(st.integers(0, 2 ** 16))
        lo = draw(st.integers(1, 40))
        pos = packed_positions(1, sq, seed, lo=lo, hi=lo + draw(
            st.integers(0, 60)))[0]
        return pos, pos, causal, window
    sk = draw(st.integers(1, 200))
    lo, hi = (-50, 300) if kind == "random" else (-3, draw(st.integers(-2, 5)))
    q = np.asarray(draw(st.lists(st.integers(lo, hi), min_size=sq,
                                 max_size=sq)), np.int32)
    k = np.asarray(draw(st.lists(st.integers(lo, hi), min_size=sk,
                                 max_size=sk)), np.int32)
    return q, k, causal, window


def sorted_mask(q_pos, k_pos, causal, window) -> torch.Tensor:
    """The kept pairs with rows and keys in the plan's sorted order."""
    ok = kept_pairs(q_pos, k_pos, causal, window)
    return ok[tiles.pos_sort(q_pos)[0]][:, tiles.pos_sort(k_pos)[0]]


def band_mask(p: tiles.PosBand) -> tuple[torch.Tensor, torch.Tensor]:
    """The pairs the band keeps, seen from the rows ([lo, hi)) and from
    the keys ([qlo, qhi))."""
    r = torch.arange(p.sq)[:, None]
    j = torch.arange(p.sk)[None, :]
    lo, hi, qlo, qhi = (torch.as_tensor(x) for x in (p.lo, p.hi, p.qlo,
                                                      p.qhi))
    return ((j >= lo[:, None]) & (j < hi[:, None]),
            (r >= qlo[None, :]) & (r < qhi[None, :]))


@settings(max_examples=60, deadline=None)
@given(rows=position_rows(), tile=st.sampled_from(FWD_TILES))
def test_positional_schedule_covers_the_mask(rows, tile):
    """In sorted order the band is the mask (rows [lo, hi), keys [qlo,
    qhi)), the hull spans the rows keeping no key, and each query block's
    tiles cover its kept pairs with the right tiles masked."""
    q_pos, k_pos, causal, window = rows
    bq, bk = tile
    sq, sk = len(q_pos), len(k_pos)
    ok = sorted_mask(q_pos, k_pos, causal, window)
    keyless = ~ok.any(1)
    p = tiles.pos_band(q_pos, k_pos, causal=causal, window=window)
    by_row, by_key = band_mask(p)
    assert torch.equal(by_row, ok) and torch.equal(by_key, ok)
    rows_without = torch.nonzero(keyless).flatten().tolist()
    assert p.hull == ((rows_without[0], rows_without[-1]) if rows_without
                      else (sq, -1))
    plan = tiles.pos_schedule(p, bq=bq, bk=bk)
    assert len(plan) == tiles.n_q_tiles(sq, bq)
    for t, row in enumerate(plan):
        rows_ = slice(t * bq, min(t * bq + bq, sq))
        visited = dict(row)
        if bool(keyless[rows_].any()):      # such a block visits every tile
            assert list(visited) == list(range(0, sk, bk))
            assert all(visited.values())
        for k0 in range(0, sk, bk):
            pairs = ok[rows_, k0:k0 + bk]
            if k0 not in visited:
                assert not bool(pairs.any()), (t, k0)
            elif not visited[k0]:          # taken without the mask
                assert k0 + bk <= sk and bool(pairs.all()), (t, k0)
            else:
                assert not (k0 + bk <= sk and bool(pairs.all())), (t, k0)


@settings(max_examples=60, deadline=None)
@given(rows=position_rows(), tile=st.sampled_from(DKDV_TILES))
def test_positional_dkdv_schedule_covers_the_mask(rows, tile):
    """Each key block's query tiles (its band and the hull's) cover every
    kept pair once, in sorted order, and every row keeping no key (P = 1 /
    S there) for every key block; a tile is masked unless every pair is
    kept."""
    q_pos, _, causal, window = rows      # self-attention: shared positions
    bk, bq = tile
    s = len(q_pos)
    ok = sorted_mask(q_pos, q_pos, causal, window)
    keyless = ~ok.any(1)
    visits = torch.zeros((s, s), dtype=torch.int64)
    p = tiles.pos_band(q_pos, q_pos, causal=causal, window=window)
    for t, row in enumerate(tiles.pos_dkdv_schedule(p, bk=bk, bq=bq)):
        k0 = t * bk
        for q0, masked in row:
            block = ok[q0:q0 + bq, k0:k0 + bk]
            full = q0 + bq <= s and k0 + bk <= s and bool(block.all())
            assert masked == (not full), (k0, q0)
            visits[q0:q0 + bq, k0:k0 + bk] += 1
    assert bool((visits[ok] == 1).all())
    assert bool((visits[keyless] == 1).all())
    assert int(visits.max()) <= 1


@settings(max_examples=40, deadline=None)
@given(sq=st.integers(1, 300), sk=st.integers(1, 300),
       causal=st.booleans(),
       window=st.sampled_from((None, 1, 5, 37, 64, 130, 2048)),
       offset=st.integers(0, 80), tile=st.sampled_from(FWD_TILES))
def test_positional_schedule_on_arange_is_the_index_schedule(
        sq, sk, causal, window, offset, tile):
    bq, bk = tile
    p = tiles.pos_band(offset + np.arange(sq), np.arange(sk), causal=causal,
                       window=window)
    assert tiles.pos_schedule(p, bq=bq, bk=bk) == tiles.schedule(
        sq=sq, sk=sk, causal=causal, window=window, q_offset=offset, bq=bq,
        bk=bk)
    if sq == sk and offset == 0:
        for bk2, bq2 in DKDV_TILES:
            assert tiles.pos_dkdv_schedule(p, bk=bk2, bq=bq2) == \
                tiles.dkdv_schedule(sq=sq, causal=causal, window=window,
                                    bk=bk2, bq=bq2)


def test_computed_flops_with_positions():
    """Packed documents visit the tiles of the sorted schedule; arange
    positions count as the index schedule."""
    s, (bq, bk) = 300, tiles.tc_tile(64)
    pos = torch.as_tensor(packed_positions(2, s, 3, lo=40, hi=90))
    kw = dict(sq=s, sk=s, causal=True, window=None, q_offset=0, bq=bq, bk=bk)
    n = sum(len(r) for i in range(2) for r in tiles.pos_schedule(
        tiles.pos_band(pos[i], pos[i], causal=True, window=None), bq=bq,
        bk=bk))
    assert tiles.computed_flops(2, 3, 64, q_pos=pos, k_pos=pos, **kw) == (
        4.0 * bq * bk * 64 * n * 3)
    ar = torch.arange(s)[None].expand(2, s)
    assert tiles.computed_flops(2, 3, 64, q_pos=ar, k_pos=ar, **kw) == \
        tiles.computed_flops(2, 3, 64, **kw)


#: phase 16's packed documents: 16a's row, then 16b's two rows
PHASE16_DOCS = ((1781, 1398, 917), (1104, 1173, 1610, 209),
                (318, 514, 1731, 1533))


@pytest.mark.parametrize("docs", PHASE16_DOCS,
                         ids=["16a", "16b-row0", "16b-row1"])
def test_sorted_schedule_visits_about_the_index_tiles(docs):
    """On phase 16's documents (S = 4096, causal, no window) the sorted
    schedules of the tensor-core forward / dq blocks and of the dk/dv
    blocks visit at most 1.05x the index schedules' tiles."""
    pos = np.concatenate([np.arange(n) for n in docs])
    s = pos.size
    assert s == 4096
    p = tiles.pos_band(pos, pos, causal=True, window=None)
    (bq, bk), (bk2, bq2) = tiles.tc_tile(64), tiles.BWD_KV_TILE
    fwd = sum(len(r) for r in tiles.pos_schedule(p, bq=bq, bk=bk))
    fwd_index = sum(len(r) for r in tiles.schedule(
        sq=s, sk=s, causal=True, window=None, q_offset=0, bq=bq, bk=bk))
    dkdv = sum(len(r) for r in tiles.pos_dkdv_schedule(p, bk=bk2, bq=bq2))
    dkdv_index = sum(len(r) for r in tiles.dkdv_schedule(
        sq=s, causal=True, window=None, bk=bk2, bq=bq2))
    assert fwd <= 1.05 * fwd_index and dkdv <= 1.05 * dkdv_index


def test_pos_plan_sorts_once_and_allocates_on_meta():
    """``PosPlan.build``: the stable sort of the twin (one sort where the
    keys share the queries' positions), int32 on the positions' device;
    the identity plan has no permutation; on meta tensors the same
    allocations, no values."""
    pos = torch.as_tensor(packed_positions(2, 37, 4, lo=3, hi=9))
    plan = PosPlan.build(pos)
    assert plan.k_perm is plan.q_perm and plan.k_sorted is plan.q_sorted
    for i in range(2):
        perm, values = tiles.pos_sort(pos[i])
        assert torch.equal(plan.q_perm[i].long(), perm)
        assert torch.equal(plan.q_sorted[i].long(), values)
    assert plan.q_perm.dtype == plan.q_sorted.dtype == torch.int32
    other = PosPlan.build(pos, pos.flip(1), sk=37)
    assert other.k_perm is not other.q_perm
    assert torch.equal(other.k_perm[0].long(), tiles.pos_sort(
        pos[0].flip(0))[0])
    ident = PosPlan.identity(2, 10, 30, 20, "cpu")
    assert ident.sorted_in_place and ident.q_sorted.tolist() == [
        list(range(20, 30))]
    meta = PosPlan.build(pos.to("meta"))
    assert meta.q_perm.device.type == "meta"
    assert meta.q_perm.shape == (2, 37)
