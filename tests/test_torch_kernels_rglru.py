"""The port's RG-LRU scan op on the CPU (the plain version its CUDA kernel
is held bit-equal to on the card) against the JAX package's Pallas kernel
in interpret mode and its associative-scan ``rglru_scan_ref``.

The port steps the recurrence in order; JAX's associative scan and the
Pallas Hillis-Steele tiles round in another order, so the bars are those
of ``tests/test_kernels.py``: 2e-4 in float32, 6e-2 in bfloat16 (outputs
rounded to bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ops import rglru_linear_scan as j_scan
from repro.kernels.rglru.ref import rglru_scan_ref as j_ref
from repro_torch.kernels.rglru import kernel as K
from repro_torch.kernels.rglru.ops import rglru_linear_scan
from repro_torch.kernels.rglru.ref import rglru_scan_ref

TOL = {"f32": 2e-4, "bf16": 6e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}

CASES = [  # tests/test_kernels.py's grid: b, s, r, block_s, dtype
    (2, 512, 128, 128, "f32"),
    (1, 256, 256, 64, "f32"),
    (2, 128, 128, 128, "bf16"),
    (1, 64, 128, 32, "f32"),
    (3, 96, 128, 96, "f32"),
]


def _inputs(b, s, r, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.85, 0.999, (b, s, r)).astype(np.float32)
    x = rng.standard_normal((b, s, r)).astype(np.float32)
    return a, x


@pytest.mark.parametrize("b,s,r,bs,dt", CASES)
@pytest.mark.parametrize("against", ("kernel", "reference"))
def test_plain_version_matches_jax(b, s, r, bs, dt, against):
    a, x = _inputs(b, s, r, seed=s + r)
    ja, jx = jnp.asarray(a, JDT[dt]), jnp.asarray(x, JDT[dt])
    want = (j_scan(ja, jx, block_s=bs) if against == "kernel"
            else j_ref(ja, jx))
    before = K.LAUNCHES["rglru_scan"]
    got = rglru_linear_scan(torch.as_tensor(a).to(TDT[dt]),
                            torch.as_tensor(x).to(TDT[dt]))
    assert K.LAUNCHES["rglru_scan"] == before    # the CPU runs no kernel
    assert got.dtype == TDT[dt]
    err = float(np.max(np.abs(got.float().numpy()
                              - np.asarray(want).astype(np.float32))))
    assert err < TOL[dt], err


def test_plain_version_is_the_sequential_f32_recurrence():
    """Ragged S, R not a multiple of 128: each step one float32 multiply
    and one add, carried in float32 (what the kernel computes)."""
    a, x = _inputs(2, 37, 100, seed=1)
    got = rglru_scan_ref(torch.as_tensor(a), torch.as_tensor(x)).numpy()
    h = np.zeros((2, 100), np.float32)
    for t in range(37):
        h = (a[:, t] * h).astype(np.float32) + x[:, t]
        np.testing.assert_array_equal(got[:, t], h)


# --- the gradient: K5 run backwards, in its plain version -------------------


@pytest.mark.parametrize("b,s,r,bs,dt", CASES)
def test_backward_plain_version_matches_jax_grad(b, s, r, bs, dt):
    """``rglru_scan_backward_ref`` against ``jax.vjp`` of the JAX
    package's ``rglru_scan_ref`` (an associative scan: bars relative to
    each gradient's largest magnitude, 2e-4 in float32, 6e-2 in bf16)."""
    from repro_torch.kernels.rglru.ref import rglru_scan_backward_ref
    a, x = _inputs(b, s, r, seed=s + r + 1)
    dh = np.random.default_rng(r).standard_normal((b, s, r)).astype(
        np.float32)
    _, vjp = jax.vjp(j_ref, jnp.asarray(a, JDT[dt]), jnp.asarray(x, JDT[dt]))
    want = vjp(jnp.asarray(dh, JDT[dt]))
    ta, tx = torch.as_tensor(a).to(TDT[dt]), torch.as_tensor(x).to(TDT[dt])
    h = rglru_scan_ref(ta, tx)
    got = rglru_scan_backward_ref(ta, h, torch.as_tensor(dh).to(TDT[dt]))
    for g, w in zip(got, want):
        w = np.asarray(w).astype(np.float32)
        assert g.dtype == TDT[dt]
        err = float(np.max(np.abs(g.float().numpy() - w)) / np.max(np.abs(w)))
        assert err < TOL[dt], err


@pytest.mark.parametrize("s", (1, 2, 37))
def test_backward_plain_version_is_autograd_of_the_plain_forward(s):
    """In float32 the plain backward equals ``torch.autograd`` of
    ``rglru_scan_ref`` bit for bit (one multiply and one add a step, in
    the same order), and the op's autograd Function gives the same."""
    from repro_torch.kernels.rglru.ops import rglru_linear_scan
    from repro_torch.kernels.rglru.ref import rglru_scan_backward_ref
    a, x = _inputs(2, s, 24, seed=s)
    dh = torch.as_tensor(np.random.default_rng(s).standard_normal(
        (2, s, 24)).astype(np.float32))
    ta = torch.tensor(a, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    want = torch.autograd.grad(rglru_scan_ref(ta, tx), (ta, tx), dh)
    h = rglru_scan_ref(ta.detach(), tx.detach())
    got = rglru_scan_backward_ref(ta.detach(), h, dh)
    out = rglru_linear_scan(ta, tx)
    assert type(out.grad_fn).__name__ == "LinearScanBackward"
    before = (dict(K.LAUNCHES), dict(K.BACKWARD_LAUNCHES))
    via_op = torch.autograd.grad(out, (ta, tx), dh)
    assert (dict(K.LAUNCHES), dict(K.BACKWARD_LAUNCHES)) == before
    for g, w, o in zip(got, want, via_op):
        assert torch.equal(g, w) and torch.equal(o, w)
