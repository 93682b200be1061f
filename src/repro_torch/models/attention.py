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
  (``repro_torch.kernels.flash_attention``), whose mask is causal on
  positions ``arange(S)``: other positions on the card raise.  M-RoPE ids
  only rotate q and k before attention, so any ids go through it.

Decode (``attn_decode``) is a single-token query against a KV cache laid
out ``[B, kvH, S_cache, Dh]``; sliding-window layers use a ring buffer
with an explicit per-slot absolute-position array so RoPE and masking
stay correct after wrap-around.  It updates the cache in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch

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


def _is_arange(positions: torch.Tensor) -> bool:
    s = positions.shape[-1]
    want = torch.arange(s, device=positions.device)
    return bool((positions == want).all())


def attend(spec: AttnSpec, q, k, v, positions):
    """Causal self-attention of projected, rotated q [B, S, kvH, G, Dh]
    against k, v [B, S, kvH, Dh] at ``positions`` [B, S].

    On the CPU: the plain or blockwise path, as the JAX package picks them.
    On the card: the flash-attention kernel, which needs positions
    ``arange(S)`` in every row (prefill's and ``forward``'s default) and
    no logit soft cap; anything else raises.  M-RoPE ids have rotated q
    and k already and play no part in the mask, which reads ``positions``
    alone, as in the JAX package."""
    if q.device.type == "cpu":
        if k.shape[1] >= spec.blockwise_threshold:
            return _attn_blockwise(spec, q, k, v, positions, positions)
        return _attn_plain(spec, q, k, v, positions, positions)
    if spec.softcap is not None:
        raise NotImplementedError(
            "attention logit soft-capping on the card is not ported: the "
            "flash-attention kernel has no soft cap (a later slice H item)")
    if not _is_arange(positions):
        raise NotImplementedError(
            "custom positions on the card are not ported: the flash-"
            "attention kernel takes causal positions arange(S) only (a "
            "later slice H item)")
    return flash_ops.flash_attention(q, k, v, causal=True, window=spec.window,
                                     q_offset=0)


def attn_full(
    p: Params,
    spec: AttnSpec,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    position_ids: torch.Tensor | None = None,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Full-sequence (scoring / prefill) attention. x: [B, S, d]."""
    x = x.to(compute_dtype)
    q, k, v = _project_qkv(p, spec, x, compute_dtype)
    q, k = _apply_positional(spec, q, k, positions, position_ids)
    out = attend(spec, q, k, v, positions)
    return _out_proj(p, out, compute_dtype)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def init_attn_cache(batch: int, spec: AttnSpec, max_seq: int,
                    dtype=torch.bfloat16, device=None) -> Params:
    """KV cache. Windowed layers get a ring buffer of ``window`` slots with
    an absolute-position side array (-1 = empty)."""
    slots = min(max_seq, spec.window) if spec.window is not None else max_seq
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
) -> tuple[torch.Tensor, Params]:
    """One decode step. x: [B, 1, d]; index: absolute position (int).
    Writes slot ``index % slots`` of ``cache`` in place and returns it."""
    b = x.shape[0]
    index = int(index)
    x = x.to(compute_dtype)
    q, k, v = _project_qkv(p, spec, x, compute_dtype)   # q: [B,1,kvH,G,Dh]
    positions = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q, k = _apply_positional(spec, q, k, positions, position_ids)

    slots = cache["k"].shape[2]
    slot = index % slots
    cache["k"][:, :, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, :, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][:, slot] = index

    hd = spec.head_dim
    scores = torch.einsum("bqhgk,bhsk->bhgqs", q, cache["k"].to(q.dtype))
    scores = scores.float() * (1.0 / math.sqrt(hd))
    scores = _softcap(scores, spec.softcap)
    pos = cache["pos"]
    ok = (pos >= 0) & (pos <= index)
    if spec.window is not None:
        ok &= (index - pos) < spec.window
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    scores = scores + torch.where(ok, zero, NEG_INF)[:, None, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    out = torch.einsum("bhgqs,bhsk->bqhgk", probs,
                       cache["v"].to(compute_dtype))
    return _out_proj(p, out, compute_dtype), cache
