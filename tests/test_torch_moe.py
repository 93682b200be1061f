"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on the same seeded inputs and parameters.

Routing: ``_routing_tables`` is integer bookkeeping, so on the same
expert ids and weights its tables must be exactly equal to JAX's.  The
router itself is a float32 product whose sums run in another order, so
end to end (``_route`` then the tables) the margin rule holds: on tokens
whose k-th and (k+1)-th router logits differ by more than 1e-5 of the
largest |logit|, each token's experts and slots are equal and its
weights within 2^-18; groups without a near-tie have equal ``src``
tables; near-tie tokens are counted and must be under 1 %.

Outputs: at float32 compute within 1e-5 of the largest magnitude, at
bf16 within 2^-5 (the bars of ``tests/test_torch_models.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as j_moe
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax

REL = {"f32": 1e-5, "bf16": 2.0 ** -5}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TIE_REL = 1e-5
WEIGHT_TOL = 2.0 ** -18

SPECS = {
    # granite-moe's family: softmax top-k renormalised, capacity dropping
    "softmax": dict(n_experts=8, top_k=2, d_ff=32, capacity_factor=1.25),
    # granite-moe at its real expert count and k
    "softmax-40x8": dict(n_experts=40, top_k=8, d_ff=16,
                         capacity_factor=1.25),
    # llama4's: sigmoid of the top-1 logit, a shared expert
    "sigmoid-shared": dict(n_experts=8, top_k=1, d_ff=24, shared_d_ff=24,
                           capacity_factor=1.25, router_scale="sigmoid"),
    # dropless at smoke scale, ungated experts, gelu
    "dropless-ungated": dict(n_experts=4, top_k=2, d_ff=16,
                             capacity_factor=8.0, gated=False, act="gelu"),
}


def specs(name):
    return j_moe.MoESpec(**SPECS[name]), moe.MoESpec(**SPECS[name])


def rand(shape, seed, dt="f32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x, jnp.asarray(x, JDT[dt]), torch.as_tensor(x).to(TDT[dt])


def params(name, d=64, seed=0, dt="f32"):
    jspec, _ = specs(name)
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), d, jspec,
                        dtype=JDT["f32"])
    if dt == "bf16":
        jp = {k: v if k == "router" else v.astype(jnp.bfloat16)
              for k, v in jp.items()}
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def assert_close(got, want, dt):
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= REL[dt] * scale, (err, scale)


def near_ties(logits: np.ndarray, k: int) -> np.ndarray:
    """[G, T] True where the k-th and (k+1)-th logits differ by at most
    TIE_REL of the largest |logit|."""
    top = -np.sort(-logits, axis=-1)
    if k >= logits.shape[-1]:
        return np.zeros(logits.shape[:-1], bool)
    return top[..., k - 1] - top[..., k] <= TIE_REL * np.abs(logits).max()


def assignment(src: np.ndarray, wtab: np.ndarray, t: int):
    """[G, T, E] slot + 1 and weight of each token at each expert (0 where
    it was not placed)."""
    g, e, c = src.shape
    slot = np.zeros((g, t + 1, e), np.int64)
    w = np.zeros((g, t + 1, e), np.float32)
    gi, ei, ci = np.meshgrid(np.arange(g), np.arange(e), np.arange(c),
                             indexing="ij")
    slot[gi, src, ei] = ci + 1
    w[gi, src, ei] = wtab
    return slot[:, :t], w[:, :t]


def check_tables(logits, k, got, want) -> int:
    """The margin rule on two (src, wtab) pairs; returns the near-tie
    count."""
    (gs, gw), (ws, ww) = [(np.asarray(s).astype(np.int64), np.asarray(w))
                          for s, w in (got, want)]
    t = logits.shape[1]
    ties = near_ties(logits, k)
    for g in range(logits.shape[0]):
        if not ties[g].any():
            np.testing.assert_array_equal(gs[g], ws[g])
    gslot, gwt = assignment(gs, gw, t)
    wslot, wwt = assignment(ws, ww, t)
    ok = ~ties
    np.testing.assert_array_equal(gslot[ok], wslot[ok])
    assert np.max(np.abs(gwt[ok] - wwt[ok]), initial=0.0) <= WEIGHT_TOL
    n = int(ties.sum())
    assert n < 0.01 * ties.size, (n, ties.size)
    return n


@pytest.mark.parametrize("t", (1, 4, 7, 16, 100, 4096))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_capacity_per_group(name, t):
    jspec, spec = specs(name)
    assert moe.capacity_per_group(t, spec) == j_moe.capacity_per_group(
        t, jspec)


@pytest.mark.parametrize("name", ("softmax", "softmax-40x8",
                                  "sigmoid-shared"))
def test_route_matches_jax(name):
    jspec, spec = specs(name)
    jp, tp = params(name)
    x, jx, tx = rand((3, 200, 64), 1)
    jw, ji = j_moe._route(jp["router"], jx, jspec)
    tw, ti = moe._route(tp["router"], tx, spec)
    assert tw.dtype == torch.float32 and ti.shape == ji.shape
    logits = np.einsum("gtd,de->gte", x, np.asarray(jp["router"]))
    ok = ~near_ties(logits, spec.top_k)
    np.testing.assert_array_equal(np.sort(ti.numpy(), -1)[ok],
                                  np.sort(np.asarray(ji), -1)[ok])
    order_t, order_j = np.argsort(ti.numpy(), -1), np.argsort(ji, -1)
    wt = np.take_along_axis(tw.numpy(), order_t, -1)[ok]
    wj = np.take_along_axis(np.asarray(jw), order_j, -1)[ok]
    assert np.max(np.abs(wt - wj)) <= WEIGHT_TOL
    if spec.router_scale == "softmax":
        np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("capacity", (1, 3, 8, 40))
@pytest.mark.parametrize("name", ("softmax", "softmax-40x8",
                                  "sigmoid-shared"))
def test_routing_tables_exactly_equal_on_the_same_routes(name, capacity):
    """JAX's ids and weights into both: src and wtab exactly equal,
    dropped slots (capacity 1, 3) included."""
    jspec, spec = specs(name)
    jp, _ = params(name)
    _, jx, _ = rand((3, 50, 64), 2)
    jw, ji = j_moe._route(jp["router"], jx, jspec)
    js, jt = j_moe._routing_tables(ji, jw, jspec, capacity)
    ts, tt = moe._routing_tables(torch.as_tensor(np.array(ji)).long(),
                                 torch.as_tensor(np.array(jw)), spec,
                                 capacity)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("name", ("softmax", "softmax-40x8",
                                  "sigmoid-shared"))
def test_routing_tables_end_to_end_under_the_margin_rule(name):
    jspec, spec = specs(name)
    jp, tp = params(name)
    x, jx, tx = rand((4, 300, 64), 3)
    cap = moe.capacity_per_group(300, spec)
    want = j_moe._routing_tables(*reversed(j_moe._route(jp["router"], jx,
                                                        jspec)),
                                 jspec, cap)
    tw, ti = moe._route(tp["router"], tx, spec)
    got = moe._routing_tables(ti, tw, spec, cap)
    logits = np.einsum("gtd,de->gte", x, np.asarray(jp["router"]))
    check_tables(logits, spec.top_k, [g.numpy() for g in got], want)


def test_combine_index_lists_each_kept_pair_once_in_expert_order():
    _, spec = specs("softmax-40x8")
    ids = torch.stack([torch.randperm(40, generator=torch.Generator()
                                      .manual_seed(i))[:8]
                       for i in range(60)]).reshape(2, 30, 8)
    cap = 5
    idx = moe._combine_index(ids, spec, cap)
    assert idx.shape == (2, 30, 8)
    src, _ = moe._routing_tables(ids, torch.ones(ids.shape), spec, cap)
    for g in range(2):
        flat = src[g].reshape(-1)
        for t in range(30):
            rows = idx[g, t].tolist()
            kept = [r for r in rows if r < 40 * cap]
            assert kept == sorted(kept)
            assert sorted(kept) == sorted(
                int(r) for r in torch.nonzero(flat == t)[:, 0])


@pytest.mark.parametrize("dt", ("f32", "bf16"))
@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("grouping,shape", [("prefill", (3, 40, 64)),
                                            ("decode", (6, 1, 64))])
def test_apply_moe_matches_jax(name, grouping, shape, dt):
    """Rows as groups in prefill; the whole batch as one group in decode,
    with the 4·k slot floor capped at t·k."""
    jspec, spec = specs(name)
    jp, tp = params(name, dt=dt)
    _, jx, tx = rand(shape, 4, dt)
    want = j_moe.apply_moe(jp, jspec, jx, compute_dtype=JDT[dt])
    got = moe.apply_moe(tp, spec, tx, compute_dtype=TDT[dt])
    assert got.dtype == TDT[dt] and got.shape == shape
    assert_close(got, want, dt)


def test_decode_capacity_floor():
    _, spec = specs("softmax-40x8")
    assert moe.group_capacity(spec, 4, 1) == 32      # 4·k floor = t·k
    assert moe.group_capacity(spec, 64, 1) == 32     # the floor, above ceil
    assert moe.group_capacity(spec, 1, 1) == 8       # capped at t·k
    assert moe.group_capacity(spec, 4, 4096) == moe.capacity_per_group(
        4096, spec)


def test_dropped_tokens_fall_through_as_zeros():
    """Capacity 1 slot an expert at 1.25 x 8 / 8: most pairs drop, and a
    token with every pair dropped gets exactly zero."""
    jspec, spec = specs("softmax")
    jp, tp = params("softmax")
    _, jx, tx = rand((2, 3, 64), 5)
    want = j_moe.apply_moe(jp, jspec, jx, compute_dtype=jnp.float32)
    got = moe.apply_moe(tp, spec, tx, compute_dtype=torch.float32)
    assert_close(got, want, "f32")
    assert np.array_equal(got.numpy() == 0.0, np.asarray(want) == 0.0)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_aux_load_balance_loss_matches_jax(name):
    jspec, spec = specs(name)
    jp, tp = params(name)
    _, jx, tx = rand((2, 33, 64), 6)
    want = float(j_moe.aux_load_balance_loss(jp["router"], jx, jspec))
    got = moe.aux_load_balance_loss(tp["router"], tx, spec)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-5 * max(1.0, abs(want))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_init_moe_reads_as_jax(name):
    """Keys, shapes and dtypes as JAX's; the router float32 whatever the
    parameter dtype; the fan-in scaled truncated normal's spread."""
    jspec, spec = specs(name)
    jp = j_moe.init_moe(jax.random.PRNGKey(0), 64, jspec,
                        dtype=jnp.bfloat16)
    tp = moe.init_moe(torch.Generator().manual_seed(0), 64, spec,
                      dtype=torch.bfloat16)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype).split(".")[-1] == \
            {"bfloat16": "bfloat16", "float32": "float32"}[str(v.dtype)], k
    assert tp["router"].dtype == torch.float32
    fan_in = 64 ** -0.5
    for k in ("router", "wi"):
        std = float(tp[k].float().std())
        assert 0.7 * fan_in < std < 1.0 * fan_in, (k, std)
