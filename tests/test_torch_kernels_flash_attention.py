"""The port's flash-attention op on the CPU (the plain version its CUDA
kernel is held to on the card) against the JAX package's Pallas kernel in
interpret mode and its ``attention_reference``, on the same seeded inputs.

Bars are those of ``tests/test_kernels.py``: 5e-5 in float32 (sums in
another order), 2.5e-2 in bfloat16 (outputs rounded to bf16, whose half
ulp near 1 is 4e-3, after sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import (attention_reference as
                                               j_reference)
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_reference

F32, BF16 = "f32", "bf16"
TOL = {F32: 5e-5, BF16: 2.5e-2}
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
TDT = {F32: torch.float32, BF16: torch.bfloat16}

CASES = [
    # b, h, kvh, sq, sk, d, causal, window, dtype, bq, bk
    # tests/test_kernels.py::FLASH_CASES
    (2, 4, 2, 128, 128, 64, True, None, F32, 64, 64),
    (1, 4, 1, 256, 256, 64, True, 64, F32, 64, 64),
    (2, 2, 2, 128, 128, 32, False, None, BF16, 64, 64),
    (1, 6, 2, 128, 256, 64, True, None, F32, 64, 64),   # q_offset
    (1, 8, 8, 64, 64, 128, True, None, F32, 32, 32),    # MHA
    (1, 2, 1, 64, 64, 16, True, 16, BF16, 64, 64),      # tiny window
    # RecurrentGemma's head dim (MQA, window), and S > window in bf16
    (1, 4, 1, 128, 128, 256, True, 48, F32, 64, 64),
    (1, 2, 1, 128, 128, 256, True, 48, BF16, 64, 64),
    (2, 4, 2, 256, 256, 32, True, 96, BF16, 64, 64),
]


def _inputs(case, seed):
    b, h, kvh, sq, sk, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, kvh, sk, d), (b, kvh, sk, d))]


def _port(xs, dt):
    return [torch.as_tensor(x).to(TDT[dt]) for x in xs]


def _err(got: torch.Tensor, want) -> float:
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want).astype(np.float32))))


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
@pytest.mark.parametrize("against", ("kernel", "reference"))
def test_plain_version_matches_jax(case, against):
    b, h, kvh, sq, sk, d, causal, window, dt, bq, bk = case
    xs = _inputs(case, seed=sq + sk + d)
    off = sk - sq
    jq, jk, jv = (jnp.asarray(x, JDT[dt]) for x in xs)
    if against == "kernel":
        want = j_flash(jq, jk, jv, causal=causal, window=window, block_q=bq,
                       block_k=bk, q_offset=off)
    else:
        want = j_reference(jq, jk, jv, causal=causal, window=window,
                           q_offset=off)
    before = dict(K.LAUNCHES)
    got = flash_attention(*_port(xs, dt), causal=causal, window=window,
                          q_offset=off)
    assert got.dtype == TDT[dt] and got.shape == (b, h, sq, d)
    assert K.LAUNCHES == before   # the CPU runs no kernel
    assert _err(got, want) < TOL[dt]


@pytest.mark.parametrize("dt", (F32, BF16))
def test_grouped_layout_matches_jax(dt):
    """The model-native [B, S, kvH, G, D] layout, as JAX's op takes it."""
    b, s, kvh, g, d = 2, 128, 2, 3, 32
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(shape).astype(np.float32)
          for shape in ((b, s, kvh, g, d), (b, s, kvh, d), (b, s, kvh, d))]
    want = j_flash(*(jnp.asarray(x, JDT[dt]) for x in xs), causal=True,
                   window=40, block_q=64, block_k=64)
    got = flash_attention(*_port(xs, dt), causal=True, window=40)
    assert got.shape == (b, s, kvh, g, d)
    assert _err(got, want) < TOL[dt]


def test_ragged_lengths_match_jax_reference():
    """Lengths the Pallas kernel cannot tile (it asserts S % block == 0);
    the port's op takes any length."""
    case = (2, 4, 1, 100, 100, 64, True, 37, F32, None, None)
    xs = _inputs(case, seed=5)
    want = j_reference(*(jnp.asarray(x) for x in xs), causal=True, window=37)
    got = attention_reference(*_port(xs, F32), causal=True, window=37)
    assert _err(got, want) < TOL[F32]


# --- the gradient: the plain backward (and lse) the kernels are held to -----
# bars relative to each gradient's largest magnitude: float32 sums in
# another order (1e-4); bfloat16 inputs and outputs rounded to bf16 (2.5e-2)
BWD_TOL = {F32: 1e-4, BF16: 2.5e-2}


def _rel(got, want) -> float:
    want = np.asarray(want).astype(np.float32)
    return float(np.max(np.abs(got.float().numpy() - want))
                 / max(float(np.max(np.abs(want))), 1e-30))


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_backward_plain_version_matches_jax_grad(case):
    """``attention_backward_reference`` against ``jax.vjp`` of the JAX
    package's ``attention_reference`` with the same output gradient."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference)
    b, h, kvh, sq, sk, d, causal, window, dt, _, _ = case
    xs = _inputs(case, seed=sq + sk + d + 1)
    do = np.random.default_rng(d).standard_normal((b, h, sq, d)).astype(
        np.float32)
    off = sk - sq
    jx = [jnp.asarray(x, JDT[dt]) for x in xs]
    jo, vjp = jax.vjp(lambda q, k, v: j_reference(
        q, k, v, causal=causal, window=window, q_offset=off), *jx)
    want = vjp(jnp.asarray(do, JDT[dt]))
    q, k, v = _port(xs, dt)
    o = attention_reference(q, k, v, causal=causal, window=window,
                            q_offset=off)
    got = attention_backward_reference(q, k, v, o, torch.as_tensor(do).to(
        TDT[dt]), causal=causal, window=window, q_offset=off)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TDT[dt] and tuple(g.shape) == w.shape
        assert _rel(g, w) < BWD_TOL[dt], (name, _rel(g, w))


@pytest.mark.parametrize("window", (None, 5, 40))
@pytest.mark.parametrize("q_offset", (0, 24))
def test_backward_plain_version_matches_autograd(window, q_offset):
    """The plain backward (lse from the forward's formula) against
    ``torch.autograd`` of the port's plain forward, GQA and rows without
    a kept key included (window 5 at q_offset 24 over 40 keys)."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference, attention_lse_reference)
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            requires_grad=True)
               for s in ((2, 6, 40 - q_offset, 16), (2, 2, 40, 16),
                         (2, 2, 40, 16)))
    do = torch.as_tensor(rng.standard_normal(q.shape).astype(np.float32))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    o = attention_reference(q, k, v, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    lse = attention_lse_reference(q.detach(), k.detach(), **kw)
    got = attention_backward_reference(q.detach(), k.detach(), v.detach(),
                                       o.detach(), do, lse, **kw)
    for g, w in zip(got, want):
        assert _rel(g, w.numpy()) < 1e-5


@pytest.mark.parametrize("layout", ("grouped", "bhsd"))
def test_gradient_goes_through_the_function(layout):
    """With gradients on, ``ops.flash_attention`` runs the autograd
    Function; on the CPU its backward is the plain backward, in the
    layout it was given, and no kernel is counted."""
    from repro_torch.kernels.flash_attention.ref import (
        attention_backward_reference)
    rng = np.random.default_rng(4)
    shapes = (((2, 50, 2, 3, 16), (2, 50, 2, 16), (2, 50, 2, 16))
              if layout == "grouped" else
              ((2, 6, 50, 16), (2, 2, 50, 16), (2, 2, 50, 16)))
    xs = [torch.tensor(rng.standard_normal(s).astype(np.float32),
                       requires_grad=True) for s in shapes]
    out = flash_attention(*xs, window=9)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    do = torch.as_tensor(rng.standard_normal(out.shape).astype(np.float32))
    before = (dict(K.LAUNCHES), dict(K.BACKWARD_LAUNCHES))
    got = torch.autograd.grad(out, xs, do)
    assert (dict(K.LAUNCHES), dict(K.BACKWARD_LAUNCHES)) == before
    if layout == "grouped":
        b, s, kvh, g, d = shapes[0]
        q = xs[0].detach().reshape(b, s, kvh * g, d).transpose(1, 2)
        k, v = (x.detach().transpose(1, 2) for x in xs[1:])
        o = out.detach().reshape(b, s, kvh * g, d).transpose(1, 2)
        dd = do.reshape(b, s, kvh * g, d).transpose(1, 2)
        want = attention_backward_reference(q, k, v, o, dd, window=9)
        want = (want[0].transpose(1, 2).reshape(shapes[0]),
                want[1].transpose(1, 2), want[2].transpose(1, 2))
    else:
        want = attention_backward_reference(
            *(x.detach() for x in xs), out.detach(), do, window=9)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.allclose(g, w, atol=1e-6)
