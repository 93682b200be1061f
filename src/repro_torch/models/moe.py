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

Under tensor parallelism (``apply_moe(tp=...)`` inside a
``distributed.ctx.model_parallel`` context) the routing runs whole on
every rank (tokens are replicated over ``model``), and a rank runs its
part of the experts' slots: its E / tp experts on every token's slots
(expert-parallel), or, where E does not divide, every expert on its
contiguous C / tp capacity slots with the weights replicated (their
gradient summed over the group); where C does not divide either, the
routed experts run whole on every rank.  Under ``moe_shard_mode=
"f_model"`` a rank runs every expert on every slot with its d_ff / tp
columns of each expert.  The shared expert is column / row.  The ranks'
partial outputs are summed (``from_model``), and the gate weights'
gradient is summed over the group, so the router's gradient is the whole
one on every rank.  A decode step's group is the global batch: inside a
data group its rows are gathered first.

Under ``moe_shard_mode="e_data_f_model"`` on more than one data rank (a
``ctx.param_shards`` context whose ``owned`` leaves are the experts) a
rank holds E / n of the experts (``n`` the shard group's ranks), each on
its d_ff / tp columns.  The dispatch buffer's expert axis goes to the
experts' owners by one all-to-all over the shard group
(``ctx.exchange``), each owner runs its experts on every rank's slots of
them, the model group sums the partial outputs, and a second all-to-all
returns the slots, which the rank weights and combines as above.  The
experts' gradients are then whole on their owner.  Where every data rank
holds the same rows (a decode step's gathered batch) each owner runs its
experts on n copies of the same slots.

The JAX package's sharding hints are kept where it makes them:
``distributed.ctx.constrain`` on the dispatch tables and buffers, the
identity on one device, which records the specs a mesh would give them
inside the dry run's ``activation_sharding`` context.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import (constrain, dp_rank, dp_size,
                                         dp_sum, exchange, from_model,
                                         gather_data, group_size,
                                         installed_shards, mp_rank, mp_size,
                                         to_model)
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
              compute_dtype=torch.bfloat16, tp=None) -> torch.Tensor:
    """x: [B, S, d]. Groups = rows (S > 1) or the whole batch (decode).
    ``tp``: the config's ``partitioning.TPPlan`` inside a model group
    (``p`` then this rank's slices), else None.  Inside a data group a
    decode step's group is the global batch, as in JAX's jit over the
    mesh: the data ranks' rows are gathered (forward only: serving), the
    layer runs on all of them, and this rank keeps its own."""
    if x.shape[1] == 1 and dp_size() > 1:
        n = x.shape[0]
        out = _apply_moe(p, spec, gather_data(x, 0), compute_dtype, tp)
        return out[dp_rank() * n:(dp_rank() + 1) * n]
    return _apply_moe(p, spec, x, compute_dtype, tp)


def _owners():
    """The shard group whose ranks own the experts (``e_data_f_model`` on
    more than one data rank), or None."""
    shards = installed_shards()
    return shards.group if shards is not None and shards.owned else None


def _apply_moe(p: Params, spec: MoESpec, x: torch.Tensor, compute_dtype,
               tp) -> torch.Tensor:
    b, s, d = x.shape
    xg = x if s > 1 else x.reshape(1, b, d)           # [G, T, d]
    cap = group_capacity(spec, b, s)

    weights, ids = _route(p["router"], xg, spec)
    src, wtab = _routing_tables(ids, weights, spec, cap)
    # capacity-slot parallelism (non-divisible expert counts): the slot
    # axis of the dispatch buffers over 'model' (the identity on one
    # device; recorded inside an activation_sharding context)
    src = constrain(src, ("batch", None, "moe_cap"))
    wtab = constrain(wtab, ("batch", None, "moe_cap"))
    owners = _owners()
    if tp is not None or owners is not None:
        return _apply_moe_tp(p, spec, xg, ids, src, wtab, cap, compute_dtype,
                             tp, owners).reshape(b, s, d)
    out = _routed(p, spec, xg, ids, src, wtab, cap, compute_dtype,
                  slice(0, spec.n_experts), slice(0, cap))
    if spec.shared_d_ff:
        out = out + _shared(p, spec, xg, compute_dtype)
    return out.reshape(b, s, d)


def _dispatch(xg, src, compute_dtype) -> torch.Tensor:
    """The expert inputs [G, E, C, d] of the slots ``src`` [G, E, C]
    (token ``T``: a zero row)."""
    g, _, d = xg.shape
    x_pad = torch.cat([xg.to(compute_dtype),
                       xg.new_zeros((g, 1, d), dtype=compute_dtype)], dim=1)
    g_idx = torch.arange(g, device=xg.device)[:, None, None]
    return constrain(x_pad[g_idx, src], ("batch", None, "moe_cap", None))


def _combine(ye, ids, spec: MoESpec, cap: int, experts: slice,
             slots: slice) -> torch.Tensor:
    """[G, T, d]: each token's rows of the weighted expert outputs ``ye``
    [G, E', C', d] (the experts ``experts`` on their slots ``slots``),
    summed in ascending expert order; a pair outside them adds zeros."""
    ye = constrain(ye, ("batch", None, "moe_cap", None))
    g, e_n, c_n, d = ye.shape
    rows = torch.cat([ye.reshape(g, -1, d), ye.new_zeros((g, 1, d))], dim=1)
    flat = _combine_index(ids, spec, cap)
    e, c = flat // cap, flat % cap
    held = ((e >= experts.start) & (e < experts.stop)
            & (c >= slots.start) & (c < slots.stop))
    index = torch.where(held, (e - experts.start) * c_n + c - slots.start,
                        e_n * c_n)
    picked = rows[torch.arange(g, device=ye.device)[:, None, None], index]
    out = picked[:, :, 0]
    for j in range(1, spec.top_k):
        out = out + picked[:, :, j]
    return out


def _routed(p: Params, spec: MoESpec, xg, ids, src, wtab, cap: int,
            compute_dtype, experts: slice, slots: slice) -> torch.Tensor:
    """The routed experts' output [G, T, d] from the experts ``experts``
    on their slots ``slots`` alone (``p`` holding those experts), each
    token's rows summed in ascending expert order."""
    src, wtab = src[:, experts, slots], wtab[:, experts, slots]
    ye = _expert_ffn(p, spec, _dispatch(xg, src, compute_dtype),
                     compute_dtype)
    ye = ye * wtab[..., None].to(compute_dtype)
    return _combine(ye, ids, spec, cap, experts, slots)


def _owned(p: Params, spec: MoESpec, xg, ids, src, wtab, cap: int,
           compute_dtype, group) -> torch.Tensor:
    """The routed experts' output [G, T, d] where the ranks of ``group``
    own E / n experts each (``p`` holding this rank's, on its d_ff
    columns): the slots exchanged to their owners and back."""
    n = group_size(group)
    g, _, d = xg.shape
    e = spec.n_experts // n
    xe = _dispatch(xg, src, compute_dtype)            # [G, E, C, d]
    xe = exchange(xe.reshape(g, n, e, cap, d).transpose(0, 1), group)
    ye = _expert_ffn(p, spec, to_model(xe.reshape(n * g, e, cap, d)),
                     compute_dtype)
    ye = exchange(from_model(ye).reshape(n, g, e, cap, d), group)
    ye = ye.transpose(0, 1).reshape(g, n * e, cap, d)
    ye = ye * wtab[..., None].to(compute_dtype)
    return _combine(ye, ids, spec, cap, slice(0, spec.n_experts),
                    slice(0, cap))


def _apply_moe_tp(p: Params, spec: MoESpec, xg, ids, src, wtab, cap: int,
                  compute_dtype, tp, owners) -> torch.Tensor:
    """``apply_moe``'s output [G, T, d] on this rank of a model group
    (``tp``: its ``TPPlan``) and / or of a shard group that owns the
    experts (``owners``)."""
    n, r = mp_size(), mp_rank()
    e = spec.n_experts
    partial, whole = [], []
    if owners is not None:
        whole.append(_owned(p, spec, xg, ids, src, wtab, cap, compute_dtype,
                            owners))
    elif tp.moe in ("expert", "f") or cap % n == 0:
        xs, ws = to_model(xg), to_model(wtab)
        experts, slots = slice(0, e), slice(0, cap)
        pe = p
        if tp.moe == "expert":
            experts = slice(r * (e // n), (r + 1) * (e // n))
        elif tp.moe == "slot":      # capacity slots, weights replicated
            slots = slice(r * (cap // n), (r + 1) * (cap // n))
            pe = {k: to_model(v) for k, v in p.items()
                  if k in ("wi", "wg", "wo")}
        partial.append(_routed(pe, spec, xs, ids, src, ws, cap,
                               compute_dtype, experts, slots))
    else:                           # neither divides: whole on every rank
        whole.append(_routed(p, spec, xg, ids, src, wtab, cap,
                             compute_dtype, slice(0, e), slice(0, cap)))
    if spec.shared_d_ff:
        split = tp is not None and tp.moe_shared
        (partial if split else whole).append(
            _shared(p, spec, to_model(xg) if split else xg, compute_dtype))
    out = from_model(sum(partial[1:], partial[0])) if partial else None
    for y in whole:
        out = y if out is None else out + y
    return out


def _shared(p: Params, spec: MoESpec, xg, compute_dtype) -> torch.Tensor:
    """The always-on shared expert's output [G, T, d]."""
    xc = xg.to(compute_dtype)
    hs = ACTIVATIONS[spec.act](xc @ p["shared_wi"].to(compute_dtype))
    hs = hs * (xc @ p["shared_wg"].to(compute_dtype))
    return hs @ p["shared_wo"].to(compute_dtype)


def aux_load_balance_loss(router_w: torch.Tensor, x: torch.Tensor,
                          spec: MoESpec) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (fraction · probability).
    Inside a ``ctx.data_parallel`` context, ``x`` is this rank's rows and
    the means are the global batch's: sums over the data group's ranks
    (the importance's gradient carried to this rank's rows)."""
    probs = torch.softmax(router_logits(router_w, x), dim=-1)
    top1 = probs.argmax(dim=-1)
    # the ranks hold equal row counts, so the mean of their means is the
    # global mean; on one rank (or none) it is the local mean bit for bit
    frac = dp_sum(F.one_hot(top1, spec.n_experts).float().mean(
        dim=(0, 1))) / dp_size()
    imp = dp_sum(probs.mean(dim=(0, 1))) / dp_size()
    return spec.n_experts * (frac * imp).sum()
