"""Attention: GQA/MHA, RoPE/M-RoPE, sliding-window, prefill + decode paths.

Grouped-native projection layout, as in the JAX package: ``wq`` is
``[d, kvH, G, Dh]`` and K/V are ``[d, kvH, Dh]``, so parameters carry
across 1:1.

Full-sequence attention takes one of three routes:

* ``_attn_plain``     — materialises [B, kvH, G, Sq, Sk] scores (fp32
  softmax), on the CPU for short sequences;
* ``_attn_blockwise`` — streaming log-sum-exp over KV blocks, on the CPU
  from ``blockwise_threshold`` keys on; the flash-attention recurrence in
  plain torch;
* on a CUDA tensor, the hand-written flash-attention kernel
  (``repro_torch.kernels.flash_attention``): its index path where the
  caller gave no positions (``positions`` None: ``arange(S)`` in every
  row), its EXT path for caller positions (packed documents, shifted
  rows) and for the logit soft cap.  M-RoPE ids only rotate q and k
  before attention, so any ids go through it.  Meta tensors (the dry
  run's plan of the card's path) take the same route; the kernel's
  wrapper allocates its outputs and reports its work.

Under tensor parallelism (a ``distributed.ctx.model_parallel`` context)
``attn_full`` runs the split ``partitioning.attn_mode`` gives the heads:
``"kv"``, this rank's kv heads with their groups; ``"group"``, this
rank's query heads of every group, the kv projections replicated (their
gradient summed over the group); ``"seq"``, every weight replicated and
this rank's contiguous chunk of the queries (rows ``r S / tp`` on)
attending to every key — K4 at that ``q_offset``, or on its EXT path at
the chunk's caller positions — the chunks' outputs gathered back.  A
sequence that does not divide runs whole on every rank, as JAX's
``constrain`` then drops the axis.  ``wo`` is row-parallel: the ranks'
outputs are summed (``from_model``), the replicated ``bo`` added once.

Decode (``attn_decode``) is a single-token query against a KV cache laid
out ``[B, kvH, S_cache, Dh]``; sliding-window layers use a ring buffer
with an explicit per-slot absolute-position array so RoPE and masking
stay correct after wrap-around.  It updates the cache in place.

Serving inside a model group follows JAX's ``cache_pspecs``: a rank
holds every kv head of its contiguous share of the slots (all of them
where the group does not divide the slots).  ``attn_prefill`` gathers
the kv split's heads and keeps the rank's slots; a decode step gathers
the heads' queries, attends over the rank's slots and joins the ranks'
partial softmaxes (``ctx.combine_partials``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import partitioning as part
from repro_torch.distributed.ctx import (combine_partials, constrain,
                                         from_model, gather_model, mp_rank,
                                         mp_size, to_model)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import Params, dense_init

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    out_bias: bool = False
    rope_kind: str = "rope"           # 'rope' | 'mrope' | 'none'
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    window: int | None = None         # sliding-window size (None = global)
    softcap: float | None = None      # attention-logit soft cap
    kv_block: int = 1024              # blockwise KV tile
    blockwise_threshold: int = 8192   # use blockwise when Sk >= this

    @property
    def q_groups(self) -> int:
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.n_heads} heads are not a multiple of "
                             f"{self.n_kv_heads} kv heads")
        return self.n_heads // self.n_kv_heads


def init_attention(gen: torch.Generator, d: int, spec: AttnSpec,
                   dtype=torch.float32, device=None) -> Params:
    h, kvh, g, hd = spec.n_heads, spec.n_kv_heads, spec.q_groups, spec.head_dim
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "wq": dense_init(gen, d, h * hd, shape=(d, kvh, g, hd), **kw),
        "wk": dense_init(gen, d, kvh * hd, shape=(d, kvh, hd), **kw),
        "wv": dense_init(gen, d, kvh * hd, shape=(d, kvh, hd), **kw),
        "wo": dense_init(gen, h * hd, d, shape=(kvh, g, hd, d), **kw),
    }
    if spec.qkv_bias:
        p["bq"] = torch.zeros((kvh, g, hd), **kw)
        p["bk"] = torch.zeros((kvh, hd), **kw)
        p["bv"] = torch.zeros((kvh, hd), **kw)
    if spec.out_bias:
        p["bo"] = torch.zeros((d,), **kw)
    return p


def _project_qkv(p: Params, spec: AttnSpec, x: torch.Tensor, dtype):
    """q: [B, S, kvH, G, Dh]; k, v: [B, S, kvH, Dh]."""
    q = torch.einsum("bsd,dhgk->bshgk", x, p["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dtype))
    if spec.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return q, k, v


def _apply_positional(spec: AttnSpec, q, k, positions, position_ids):
    if spec.rope_kind == "rope":
        q = rope_mod.apply_rope(q, positions, theta=spec.rope_theta)
        k = rope_mod.apply_rope(k, positions, theta=spec.rope_theta)
    elif spec.rope_kind == "mrope":
        q = rope_mod.apply_mrope(q, position_ids, spec.mrope_sections,
                                 theta=spec.rope_theta)
        k = rope_mod.apply_mrope(k, position_ids, spec.mrope_sections,
                                 theta=spec.rope_theta)
    return q, k


def _mask_bias(q_pos, k_pos, window):
    """[B, Sq, Sk] additive bias from causal (+ optional window) mask."""
    ok = q_pos[:, :, None] >= k_pos[:, None, :]
    if window is not None:
        ok &= (q_pos[:, :, None] - k_pos[:, None, :]) < window
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def _softcap(scores, cap):
    return cap * torch.tanh(scores / cap) if cap is not None else scores


def _out_proj(p: Params, out: torch.Tensor, dtype) -> torch.Tensor:
    """out: [B, S, kvH, G, Dh] -> [B, S, d]."""
    y = torch.einsum("bshgk,hgkd->bsd", out.to(dtype), p["wo"].to(dtype))
    if "bo" in p:
        y = y + p["bo"].to(dtype)
    return y


def _attn_plain(spec: AttnSpec, q, k, v, q_pos, k_pos):
    hd = spec.head_dim
    scores = torch.einsum("bqhgk,bshk->bhgqs", q, k).float()
    scores = _softcap(scores * (1.0 / math.sqrt(hd)), spec.softcap)
    scores = scores + _mask_bias(q_pos, k_pos, spec.window)[:, None, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhgqs,bshk->bqhgk", probs, v)


def _attn_blockwise(spec: AttnSpec, q, k, v, q_pos, k_pos):
    """Streaming softmax over KV blocks; O(S·kv_block) live memory."""
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    blk = min(spec.kv_block, sk)
    pad = (-sk) % blk
    if pad:
        k = torch.cat([k, k.new_zeros((b, pad, kvh, hd))], dim=1)
        v = torch.cat([v, v.new_zeros((b, pad, kvh, hd))], dim=1)
        k_pos = torch.cat([k_pos, k_pos.new_full((b, pad), INT32_MAX)], dim=1)
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for start in range(0, k.shape[1], blk):
        kb, vb = k[:, start:start + blk], v[:, start:start + blk]
        pb = k_pos[:, start:start + blk]
        s = torch.einsum("bqhgk,bshk->bhgqs", q, kb).float() * scale
        s = _softcap(s, spec.softcap)
        s = s + _mask_bias(q_pos, pb, spec.window)[:, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqs,bshk->bhgqk", pexp.to(vb.dtype), vb).float()
        m = m_new
    out = acc / l.clamp_min(1e-37)[..., None]               # [B, kvH, G, Sq, Dh]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)           # [B, Sq, kvH, G, Dh]


def default_positions(b: int, s: int, device) -> torch.Tensor:
    """Positions ``arange(s)`` in each of b rows: [b, s] int32."""
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def attend(spec: AttnSpec, q, k, v, positions, plan=None):
    """Causal self-attention of projected, rotated q [B, S, kvH, G, Dh]
    against k, v [B, S, kvH, Dh] at ``positions`` [B, S], or at
    ``arange(S)`` in every row where ``positions`` is None (the caller
    gave none).

    On the CPU: the plain or blockwise path, as the JAX package picks them.
    On the card: the flash-attention kernel, on its index path for None
    (no read of positions) and its EXT path for caller positions or a
    soft cap, on ``plan`` (the positions' ``PosPlan``, made once a
    forward) when given.  M-RoPE ids have rotated q and k already and
    play no part in the mask, which reads ``positions`` alone, as in the
    JAX package."""
    if q.device.type == "cpu":
        if positions is None:
            positions = default_positions(q.shape[0], q.shape[1], q.device)
        if k.shape[1] >= spec.blockwise_threshold:
            return _attn_blockwise(spec, q, k, v, positions, positions)
        return _attn_plain(spec, q, k, v, positions, positions)
    if positions is None or plan is None:
        return flash_ops.flash_attention(
            q, k, v, causal=True, window=spec.window, q_pos=positions,
            k_pos=positions, softcap=spec.softcap)
    return flash_ops.flash_attention(q, k, v, causal=True, window=spec.window,
                                     plan=plan, softcap=spec.softcap)


def attn_full(
    p: Params,
    spec: AttnSpec,
    x: torch.Tensor,
    positions: torch.Tensor | None,
    *,
    position_ids: torch.Tensor | None = None,
    compute_dtype=torch.bfloat16,
    plan=None,
) -> torch.Tensor:
    """Full-sequence (scoring / prefill) attention. x: [B, S, d];
    positions [B, S], or None for ``arange(S)`` in every row (built here
    for RoPE; the mask then takes the kernel's index path); ``plan``:
    the positions' ``PosPlan`` for the card's kernels, if made.  Inside a
    model group, this rank's part of the split (see the module's
    docstring)."""
    return _attn_full(p, spec, x, positions, position_ids, compute_dtype,
                      plan)[0]


def _attn_full(p: Params, spec: AttnSpec, x, positions, position_ids,
               compute_dtype, plan=None, want_kv: bool = False):
    """``attn_full``'s output and, with ``want_kv``, the rotated k and v
    of every kv head at every position, [B, S, kvH, Dh] each (the kv
    split's heads gathered over the model group), else None, None."""
    tp = mp_size()
    mode = part.attn_mode(spec.n_heads, spec.n_kv_heads, tp) if tp > 1 \
        else None
    if mode == "seq":
        if x.shape[1] % tp == 0:
            return _attn_seq_chunk(p, spec, x, positions, position_ids,
                                   compute_dtype)
        mode = None        # JAX's constrain drops the axis: whole everywhere
    x = x.to(compute_dtype)
    if mode is not None:       # this rank's heads
        x = to_model(x)
        if mode == "group":    # replicated kv projections: sum their grads
            p = {k: to_model(v) if k in ("wk", "wv", "bk", "bv") else v
                 for k, v in p.items()}
    q, k, v = _project_qkv(p, spec, x, compute_dtype)
    pos = (default_positions(x.shape[0], x.shape[1], x.device)
           if positions is None else positions)
    q, k = _apply_positional(spec, q, k, pos, position_ids)
    # context-parallel fallback: where heads do not divide the TP axis the
    # planner's activation rules shard the *query sequence* instead (the
    # identity on one device; recorded inside an activation_sharding context)
    q = constrain(q, ("batch", "seq", None, None, None))
    pos = constrain(pos, ("batch", "seq"))
    out = attend(spec, q, k, v, None if positions is None else pos, plan)
    if not want_kv:
        k = v = None
    elif mode == "kv":         # every rank's kv heads, one all-gather
        k, v = gather_model(torch.cat([k, v], dim=-1), 2).split(
            spec.head_dim, dim=-1)
    if mode is None:
        return _out_proj(p, out, compute_dtype), k, v
    # wo's rows of this rank's heads: the ranks' outputs summed, bo once
    y = from_model(_out_proj({"wo": p["wo"]}, out, compute_dtype))
    return (y + p["bo"].to(compute_dtype) if "bo" in p else y), k, v


def _attn_seq_chunk(p: Params, spec: AttnSpec, x, positions, position_ids,
                    compute_dtype):
    """The sequence-sharded fallback: every weight replicated (its
    gradient summed over the group), this rank's chunk of S / tp queries
    against every key, the chunks' outputs gathered back in order.
    Returns (output, k, v), k and v whole on every rank."""
    b, s, _ = x.shape
    n = s // mp_size()
    c0 = mp_rank() * n
    x = to_model(x.to(compute_dtype))
    p = {k: to_model(v) for k, v in p.items()}
    xq = x[:, c0:c0 + n]
    q = torch.einsum("bsd,dhgk->bshgk", xq, p["wq"].to(compute_dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(compute_dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(compute_dtype))
    if spec.qkv_bias:
        q = q + p["bq"].to(compute_dtype)
        k = k + p["bk"].to(compute_dtype)
        v = v + p["bv"].to(compute_dtype)
    pos = (default_positions(b, s, x.device) if positions is None
           else positions)
    q_pos = pos[:, c0:c0 + n]
    if spec.rope_kind == "rope":
        q = rope_mod.apply_rope(q, q_pos, theta=spec.rope_theta)
        k = rope_mod.apply_rope(k, pos, theta=spec.rope_theta)
    elif spec.rope_kind == "mrope":
        q = rope_mod.apply_mrope(q, position_ids[:, :, c0:c0 + n],
                                 spec.mrope_sections, theta=spec.rope_theta)
        k = rope_mod.apply_mrope(k, position_ids, spec.mrope_sections,
                                 theta=spec.rope_theta)
    if q.device.type == "cpu":
        attn = (_attn_blockwise if s >= spec.blockwise_threshold
                else _attn_plain)
        out = attn(spec, q, k, v, q_pos, pos)
    elif positions is None:
        out = flash_ops.flash_attention(
            q, k, v, causal=True, window=spec.window, q_offset=c0,
            softcap=spec.softcap)
    else:
        out = flash_ops.flash_attention(
            q, k, v, causal=True, window=spec.window, q_pos=q_pos,
            k_pos=pos, softcap=spec.softcap)
    return gather_model(_out_proj(p, out, compute_dtype), 1), k, v


def cache_slots(spec: AttnSpec, max_seq: int) -> int:
    """Slots of a layer's KV cache: ``max_seq``, or a ring of ``window``."""
    return min(max_seq, spec.window) if spec.window is not None else max_seq


def slot_range(spec: AttnSpec, max_seq: int) -> tuple[int, int]:
    """(first slot, slots) of the cache this rank holds: its contiguous
    share where the model group divides the slots (``cache_pspecs``),
    every slot where it does not (JAX's fallback: replicated); all of
    them without a group."""
    slots, tp = cache_slots(spec, max_seq), mp_size()
    if tp == 1 or slots % tp:
        return 0, slots
    return mp_rank() * (slots // tp), slots // tp


def attn_prefill(p: Params, spec: AttnSpec, x: torch.Tensor, positions,
                 position_ids, max_seq: int, *, compute_dtype=torch.bfloat16
                 ) -> tuple[torch.Tensor, Params]:
    """Prefill of one attention layer: ``attn_full``'s output at
    ``arange(S)`` (the card's kernel on its index path) and the layer's
    cache, k / v re-laid out as ``[B, kvH, slots, Dh]``, ring-aligned for
    windowed layers.  Inside a model group the cache is this rank's slots
    (``slot_range``) of every kv head."""
    y, k, v = _attn_full(p, spec, x, None, position_ids, compute_dtype,
                         want_kv=True)
    kr, vr, pr = _ring_align(k, v, positions, cache_slots(spec, max_seq))
    lo, n = slot_range(spec, max_seq)
    if n != pr.shape[1]:       # copies: no view of the whole cache kept
        kr, vr = kr[:, lo:lo + n].clone(), vr[:, lo:lo + n].clone()
        pr = pr[:, lo:lo + n].clone()
    return y, {"k": kr.transpose(1, 2), "v": vr.transpose(1, 2), "pos": pr}


def _ring_align(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                slots: int):
    """Pack the last ≤slots (k, v) pairs into ring layout (pos % slots)."""
    b, s = positions.shape
    if s <= slots:
        padk = k.new_zeros((b, slots - s) + tuple(k.shape[2:]))
        kr = torch.cat([k, padk], dim=1)
        vr = torch.cat([v, padk], dim=1)
        pr = torch.cat([positions.to(torch.int32),
                        positions.new_full((b, slots - s), -1).to(
                            torch.int32)], dim=1)
        return kr, vr, pr
    ar = torch.arange(slots, device=k.device)
    idx = s - 1 - (s - 1 - ar) % slots              # source row per slot
    return k[:, idx], v[:, idx], positions[:, idx].to(torch.int32)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def init_attn_cache(batch: int, spec: AttnSpec, max_seq: int,
                    dtype=torch.bfloat16, device=None) -> Params:
    """KV cache. Windowed layers get a ring buffer of ``window`` slots with
    an absolute-position side array (-1 = empty)."""
    slots = cache_slots(spec, max_seq)
    shape = (batch, spec.n_kv_heads, slots, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, slots), -1, dtype=torch.int32,
                          device=device),
    }


def attn_decode(
    p: Params,
    spec: AttnSpec,
    x: torch.Tensor,
    cache: Params,
    index: int,
    *,
    position_ids: torch.Tensor | None = None,
    compute_dtype=torch.bfloat16,
    max_seq: int | None = None,
) -> tuple[torch.Tensor, Params]:
    """One decode step. x: [B, 1, d]; index: absolute position (int).
    Writes slot ``index % slots`` of ``cache`` in place and returns it.

    Inside a model group this is JAX's decode cell under ``param_pspecs``
    / ``cache_pspecs``, and ``cache`` is this rank's slots
    (``slot_range``) of a cache of ``max_seq`` positions (required
    there): the rank projects its heads (``"kv"``: its kv heads with
    their groups; ``"group"``: its query heads of every group, k / v
    whole; ``"seq"``: every head), and the heads' q (with the new k / v
    in ``"kv"`` mode) are gathered, one all-gather; the new token's k / v
    go to its slot's owner; each rank attends every head over its own
    slots and the partial softmaxes are joined
    (``ctx.combine_partials``), or, where the slots replicate, each rank
    attends over all of them; then the rank's heads go through ``wo``'s
    rows and the ranks' outputs are summed (``bo`` added once), or, in
    ``"seq"`` mode, the whole ``wo`` on every rank."""
    b, tp = x.shape[0], mp_size()
    mode = part.attn_mode(spec.n_heads, spec.n_kv_heads, tp) if tp > 1 \
        else None
    if mode is not None and max_seq is None:
        raise ValueError("decode inside a model group needs the cache's "
                         "max_seq")
    index = int(index)
    x = x.to(compute_dtype)
    q, k, v = _project_qkv(p, spec, x, compute_dtype)   # q: [B,1,kvH,G,Dh]
    positions = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q, k = _apply_positional(spec, q, k, positions, position_ids)
    g_local = q.shape[3]
    if mode == "kv":           # [B, 1, kvH / tp, G + 2, Dh]: q, k, v
        qkv = gather_model(torch.cat([q, k[:, :, :, None], v[:, :, :, None]],
                                     dim=3), 2)
        q, k, v = qkv[:, :, :, :-2], qkv[:, :, :, -2], qkv[:, :, :, -1]
    elif mode == "group":
        q = gather_model(q, 3)
    if mode is None:
        slots = cache["k"].shape[2]
        lo, n = 0, slots
    else:
        slots = cache_slots(spec, max_seq)
        lo, n = slot_range(spec, max_seq)
    slot = index % slots - lo
    if 0 <= slot < n:          # this rank owns the new token's slot
        cache["k"][:, :, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, :, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][:, slot] = index
    scores = _decode_scores(spec, q, cache, index)
    vc = cache["v"].to(compute_dtype)
    if n == slots:             # every slot on this rank
        probs = torch.softmax(scores, dim=-1).to(compute_dtype)
        out = torch.einsum("bhgqs,bhsk->bqhgk", probs, vc)
    else:
        m = scores.amax(dim=-1)                              # [B,kvH,G,1]
        ok = scores > 0.5 * NEG_INF
        e = torch.where(ok, torch.exp(scores - m[..., None]),
                        torch.zeros((), device=x.device))
        acc = torch.einsum("bhgqs,bhsk->bhgqk", e.to(compute_dtype),
                           vc).float()
        out = combine_partials(torch.where(ok.any(-1), m, NEG_INF),
                               e.sum(-1), acc)
        out = out.permute(0, 3, 1, 2, 4).to(compute_dtype)   # [B,1,kvH,G,Dh]
    if mode in (None, "seq"):
        return _out_proj(p, out, compute_dtype), cache
    r = mp_rank()
    if mode == "kv":
        h = spec.n_kv_heads // tp
        out = out[:, :, r * h:(r + 1) * h]
    else:
        out = out[:, :, :, r * g_local:(r + 1) * g_local]
    y = from_model(_out_proj({"wo": p["wo"]}, out, compute_dtype))
    return (y + p["bo"].to(compute_dtype) if "bo" in p else y), cache


def _decode_scores(spec: AttnSpec, q, cache: Params, index: int):
    """float32 scores [B, kvH, G, 1, slots] of the query q [B, 1, kvH, G,
    Dh] against the cache's slots, scaled, capped, and -1e30 added on the
    slots that are empty, in the future or out of the window."""
    scores = torch.einsum("bqhgk,bhsk->bhgqs", q, cache["k"].to(q.dtype))
    scores = scores.float() * (1.0 / math.sqrt(spec.head_dim))
    scores = _softcap(scores, spec.softcap)
    pos = cache["pos"]
    ok = (pos >= 0) & (pos <= index)
    if spec.window is not None:
        ok &= (index - pos) < spec.window
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    return scores + torch.where(ok, zero, NEG_INF)[:, None, None, None, :]
