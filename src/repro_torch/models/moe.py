"""Mixture-of-Experts FFN with capacity-based token dropping.

The JAX package's design, on one device:

* **Gather dispatch.**  An integer routing table ``src[g, e, c]`` (the
  token feeding expert e's slot c; ``t`` for an empty slot, which reads
  a zero row) gathers the expert inputs, and the batched expert FFN runs
  ``[G, E, C, d] x [E, d, f]`` as batched matrix products.
* **Deterministic combine.**  JAX scatter-adds the weighted expert
  outputs back to their tokens.  ``index_add_`` on the card sums with
  atomics, in an order that changes from run to run, so here each token
  gathers the (expert, slot) rows it was placed in — at most ``top_k`` —
  and adds them in ascending expert order, the order of JAX's e-major
  scatter.  A dropped (token, expert) pair reads a zero row.
* **Grouping.**  Capacity is allocated per token group: a sequence row
  in prefill and scoring, the whole batch in single-token decode (with a
  ``4·k`` slot floor, capped at ``t·k``).
* **Router.**  Softmax top-k with renormalised weights, or the sigmoid
  of the top-k logits (Llama-4), kept in float32; an optional always-on
  shared expert.  Dropped tokens fall through on the residual path.

The JAX package's sharding hints (``distributed.ctx.constrain``) are the
identity on one device and are not carried over.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ACTIVATIONS, Params, dense_init


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden width
    shared_d_ff: int = 0            # 0 = no shared expert
    capacity_factor: float = 1.25
    router_scale: str = "softmax"   # 'softmax' | 'sigmoid' (llama4-style)
    gated: bool = True
    act: str = "silu"


def init_moe(gen: torch.Generator, d: int, spec: MoESpec,
             dtype=torch.float32, device=None) -> Params:
    e, f = spec.n_experts, spec.d_ff
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "router": dense_init(gen, d, e, dtype=torch.float32,
                             device=device),          # router kept fp32
        "wi": dense_init(gen, d, f, shape=(e, d, f), **kw),
        "wo": dense_init(gen, f, d, shape=(e, f, d), **kw),
    }
    if spec.gated:
        p["wg"] = dense_init(gen, d, f, shape=(e, d, f), **kw)
    if spec.shared_d_ff:
        p["shared_wi"] = dense_init(gen, d, spec.shared_d_ff, **kw)
        p["shared_wg"] = dense_init(gen, d, spec.shared_d_ff, **kw)
        p["shared_wo"] = dense_init(gen, spec.shared_d_ff, d, **kw)
    return p


def capacity_per_group(group_tokens: int, spec: MoESpec) -> int:
    c = math.ceil(group_tokens * spec.top_k * spec.capacity_factor
                  / spec.n_experts)
    return max(1, c)


def router_logits(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: [G, T, d] -> float32 router logits [G, T, E]."""
    return torch.einsum("gtd,de->gte", x.float(), router_w.float())


def _route(router_w: torch.Tensor, x: torch.Tensor, spec: MoESpec):
    """x: [G, T, d] -> (weights [G, T, K] fp32, ids [G, T, K] int64)."""
    logits = router_logits(router_w, x)
    if spec.router_scale == "sigmoid":
        weights, ids = torch.topk(logits, spec.top_k, dim=-1)
        weights = torch.sigmoid(weights)
    else:
        probs = torch.softmax(logits, dim=-1)
        weights, ids = torch.topk(probs, spec.top_k, dim=-1)
        weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True),
                                            1e-9)
    return weights, ids


def _slots(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[G, T, K] expert ids -> [G, T·K] slot of each pair in its expert,
    counted in token order (a token reaches an expert at most once)."""
    g, t, k = ids.shape
    ids_f = ids.reshape(g, t * k)
    counts = F.one_hot(ids_f, n_experts).cumsum(dim=1)      # [G, TK, E]
    return counts.gather(-1, ids_f[..., None])[..., 0] - 1


def _routing_tables(ids, weights, spec: MoESpec, capacity: int):
    """Build src-token and weight tables per expert slot.

    ids/weights: [G, T, K]  ->  src [G, E, C] int64 (T = empty slot),
                               w   [G, E, C] fp32.
    """
    g, t, k = ids.shape
    e, c = spec.n_experts, capacity
    ids_f = ids.reshape(g, t * k)
    pos_f = _slots(ids, e)
    slot = torch.where(pos_f < c, pos_f, c)   # overflow -> column c (dropped)
    g_idx = torch.arange(g, device=ids.device)[:, None].expand(g, t * k)
    tok_f = torch.arange(t, device=ids.device).repeat_interleave(k)
    src = torch.full((g, e, c + 1), t, dtype=torch.int64, device=ids.device)
    src[g_idx, ids_f, slot] = tok_f.expand(g, t * k)
    wtab = torch.zeros((g, e, c + 1), dtype=torch.float32, device=ids.device)
    wtab[g_idx, ids_f, slot] = weights.reshape(g, t * k).float()
    return src[:, :, :c], wtab[:, :, :c]


def _combine_index(ids: torch.Tensor, spec: MoESpec,
                   capacity: int) -> torch.Tensor:
    """[G, T, K] flat row ``e·C + slot`` of each (token, expert) pair in
    the [G, E·C] expert outputs, in ascending expert order per token; a
    dropped pair points at row E·C (zeros)."""
    e, c = spec.n_experts, capacity
    ids, _ = torch.sort(ids, dim=-1)
    pos = _slots(ids, e).reshape(ids.shape)
    return torch.where(pos < c, ids * c + pos, e * c)


def _expert_ffn(p: Params, spec: MoESpec, xe: torch.Tensor,
                dtype) -> torch.Tensor:
    """xe: [G, E, C, d] -> [G, E, C, d]."""
    h = torch.einsum("gecd,edf->gecf", xe, p["wi"].to(dtype))
    h = ACTIVATIONS[spec.act](h)
    if spec.gated:
        h = h * torch.einsum("gecd,edf->gecf", xe, p["wg"].to(dtype))
    return torch.einsum("gecf,efd->gecd", h, p["wo"].to(dtype))


def group_capacity(spec: MoESpec, b: int, s: int) -> int:
    """Slots per expert of one group of ``apply_moe`` on [b, s, d]."""
    t = s if s > 1 else b
    cap = capacity_per_group(t, spec)
    if s == 1:
        # decode: near-dropless (serving must not drop whole FFN outputs;
        # a ≥4·k floor makes expert collisions at batch scale negligible)
        cap = min(t * spec.top_k, max(cap, 4 * spec.top_k))
    return cap


def apply_moe(p: Params, spec: MoESpec, x: torch.Tensor, *,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x: [B, S, d]. Groups = rows (S > 1) or the whole batch (decode)."""
    b, s, d = x.shape
    xg = x if s > 1 else x.reshape(1, b, d)           # [G, T, d]
    g, t, _ = xg.shape
    cap = group_capacity(spec, b, s)

    weights, ids = _route(p["router"], xg, spec)
    src, wtab = _routing_tables(ids, weights, spec, cap)

    x_pad = torch.cat([xg.to(compute_dtype),
                       xg.new_zeros((g, 1, d), dtype=compute_dtype)], dim=1)
    g_idx = torch.arange(g, device=x.device)[:, None, None]
    xe = x_pad[g_idx, src]                            # [G, E, C, d] gather
    ye = _expert_ffn(p, spec, xe, compute_dtype)
    ye = ye * wtab[..., None].to(compute_dtype)

    # combine: each token's rows, summed in ascending expert order
    rows = torch.cat([ye.reshape(g, -1, d), ye.new_zeros((g, 1, d))], dim=1)
    picked = rows[torch.arange(g, device=x.device)[:, None, None],
                  _combine_index(ids, spec, cap)]     # [G, T, K, d]
    out = picked[:, :, 0]
    for j in range(1, spec.top_k):
        out = out + picked[:, :, j]

    if spec.shared_d_ff:
        xc = xg.to(compute_dtype)
        hs = ACTIVATIONS[spec.act](xc @ p["shared_wi"].to(compute_dtype))
        hs = hs * (xc @ p["shared_wg"].to(compute_dtype))
        out = out + hs @ p["shared_wo"].to(compute_dtype)

    return out.reshape(b, s, d)


def aux_load_balance_loss(router_w: torch.Tensor, x: torch.Tensor,
                          spec: MoESpec) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (fraction · probability)."""
    probs = torch.softmax(router_logits(router_w, x), dim=-1)
    top1 = probs.argmax(dim=-1)
    frac = F.one_hot(top1, spec.n_experts).float().mean(dim=(0, 1))
    imp = probs.mean(dim=(0, 1))
    return spec.n_experts * (frac * imp).sum()
