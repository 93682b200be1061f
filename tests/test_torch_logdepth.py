"""The port's log-depth (max,+) algebra and folds against the JAX
package's, on the CPU: the matmul / matvec / power / chain primitives,
the product tree of ``maxplus_fold_assoc`` and ``maxplus_fold_segmented``,
periodic squaring and the squaring end times.  The structured segment
fold and the prefix end-time folds are held in
``test_torch_logdepth_fold.py``, the engines behind ``Simulator`` in
``test_torch_logdepth_api.py``.

End times and products are bit-equal: each port function runs the same
float32 adds as its JAX twin (a (max,+) product is an exact max over
correctly rounded adds, so only the adds and the product tree matter,
and the tree is JAX's).  Energies, which XLA and torch sum in orders of
their own, are held within 1e-6 relative.  Inputs are non-dyadic random
floats, so a wrong product tree or add order shows."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import maxplus_form as jmf
from repro.core import sim as j_sim
from repro_torch.core import maxplus_form as mf
from repro_torch.core import sim

def rand_mats(rng, shape, neg_share=0.2):
    """Non-dyadic float32 entries in [-1, 6), a share of them NEG."""
    x = (rng.random(shape) * 7.0 - 1.0).astype(np.float32)
    return np.where(rng.random(shape) < neg_share, np.float32(mf.NEG), x)


def j(x):
    return jnp.asarray(x)


def t(x):
    return torch.as_tensor(x)


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want), np.max(np.abs(got - want))


# --- the (max,+) primitives --------------------------------------------------


@pytest.mark.parametrize("route", ("cube", "k-loop"))
@pytest.mark.parametrize("shape_a,shape_b", [
    ((6, 6), (6, 6)), ((3, 6, 6), (6, 6)), ((2, 3, 9, 9), (3, 9, 9))])
def test_matmul_and_matvec_bit_equal_to_jax(monkeypatch, route, shape_a,
                                            shape_b):
    if route == "k-loop":
        monkeypatch.setattr(mf, "MATMUL_CUBE_ELEMS", 0)
    rng = np.random.default_rng(len(shape_a))
    a, b = rand_mats(rng, shape_a), rand_mats(rng, shape_b)
    same(mf.maxplus_matmul(t(a), t(b)), jmf.maxplus_matmul(j(a), j(b)))
    s = rand_mats(rng, shape_a[:-1], 0.0)
    same(mf.maxplus_matvec(t(a), t(s)), jmf.maxplus_matvec(j(a), j(s)))


@pytest.mark.parametrize("n", (0, 1, 2, 7, 64))
def test_matrix_power_bit_equal_to_jax(n):
    rng = np.random.default_rng(n)
    a = rand_mats(rng, (3, 7, 7))
    same(mf.maxplus_matrix_power(t(a), n), jmf.maxplus_matrix_power(j(a), n))


@pytest.mark.parametrize("n", (1, 2, 5, 16))
def test_chain_product_bit_equal_to_jax(n):
    g = rand_mats(np.random.default_rng(n), (n, 2, 6, 6))
    same(mf._chain_product(t(g)), jmf._chain_product(j(g)))


@pytest.mark.parametrize("n", range(1, 18))
def test_fold_assoc_and_segmented_bit_equal_to_jax(n):
    """The product tree is JAX's ``associative_scan``'s, at every length
    (the sequential chain differs from it at most of them)."""
    rng = np.random.default_rng(100 + n)
    g = rand_mats(rng, (n, 2, 6, 6))
    s0 = rand_mats(rng, (2, 6), 0.0)
    same(mf.maxplus_fold_assoc(t(g), t(s0)),
         jmf.maxplus_fold_assoc(j(g), j(s0)))
    mats = rand_mats(rng, (2, 5, 6, 6))
    idx = rng.integers(0, 5, n).astype(np.int32)
    for seg in (None, 1, 4, 64, n + 3):
        same(mf.maxplus_fold_segmented(t(mats), idx, t(s0), segment_len=seg),
             jmf.maxplus_fold_segmented(j(mats), j(idx), j(s0),
                                        segment_len=seg))


def test_chain_and_tree_round_apart():
    """A left-to-right chain rounds differently from the tree on
    non-dyadic inputs, so the tree test above can tell them apart."""
    rng = np.random.default_rng(5)
    g = t(rand_mats(rng, (9, 1, 8, 8), 0.0))
    assert not torch.equal(mf._chain_product(g), mf._assoc_total(g))


@pytest.mark.parametrize("n_steps", (0, 2, 9, 10, 100))
def test_periodic_fold_squaring_bit_equal_to_jax(n_steps):
    """P = 3: n_steps 0 (q = r = 0), 2 (q = 0), 9 (r = 0), 10, 100."""
    rng = np.random.default_rng(n_steps)
    mats = rand_mats(rng, (2, 3, 6, 6))
    s0 = rand_mats(rng, (2, 6), 0.0)
    same(mf.periodic_fold_squaring(t(mats), t(s0), n_steps),
         jmf.periodic_fold_squaring(j(mats), j(s0), n_steps))


def test_neg_identity_rows_survive_squaring():
    """NEG identity rows are idempotent under repeated squaring: no
    drift, no float overflow — unused layout rows stay exact (the JAX
    package's pin), and the powers are JAX's bit for bit."""
    eye = mf.maxplus_eye(8)
    p = mf.maxplus_matrix_power(t(eye), 1 << 20)
    assert np.array_equal(p.numpy(), eye)
    layout = mf.StateLayout(1, 4)
    a = mf.op_matrix(layout, cmd_us=0.1, pre_us=5.0, slot_us=20.0,
                     ctrl_us=2.0, arb_us=0.0, post_us=100.0,
                     channel=0, way=1)
    p = mf.maxplus_matrix_power(t(a), 4096).numpy()
    same(p, jmf.maxplus_matrix_power(j(a), 4096))
    assert np.all(np.isfinite(p))
    unused = layout.chip(0, 3)
    assert p[unused, unused] == 0.0
    assert np.all(p[unused, np.arange(layout.n_state) != unused] <= mf.NEG)


# --- periodic squaring -------------------------------------------------------


@pytest.mark.parametrize("ways", (1, 2, 4, 8, 16))
@pytest.mark.parametrize("policy", ("eager", "batched"))
def test_squaring_end_time_bit_equal_to_jax(ways, policy):
    rng = np.random.default_rng(ways)
    scal = [(rng.random(3) * 40).astype(np.float32) for _ in range(6)]
    for n_pages in (1, 31, 32, 96, 513):
        got = sim._squaring_end_time(*(t(x) for x in scal), ways,
                                     n_pages=n_pages,
                                     batched=policy == "batched")
        want = [j_sim._squaring_end_time(
            *(jnp.float32(x[i]) for x in scal), jnp.asarray(ways, jnp.int32),
            n_pages=n_pages, batched=policy == "batched") for i in range(3)]
        same(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("bad", (0, 3, 6, 12, 32))
def test_squaring_rejects_ways_not_dividing_16(bad):
    for mod in (sim, j_sim):
        with pytest.raises(ValueError) as err:
            mod._validate_squaring_ways(np.asarray([4, bad]))
        assert str(err.value) == (
            f"engine='squaring' requires ways dividing 16, got [4, {bad}]")
