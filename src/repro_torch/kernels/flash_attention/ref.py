"""Plain PyTorch versions of the flash-attention kernels (GQA, causal,
window): the whole score matrix in float32, as the JAX package's
``attention_reference``; the rows' log-sum-exp the forward writes for the
backward; and the backward itself, in the kernels' formulas."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _masked_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                   window: int | None, q_offset: int):
    """(float32 scores q kᵀ / √D with NEG_INF where the mask drops the
    pair [B, H, Sq, Sk], the mask [Sq, Sk])."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return torch.where(mask, s, torch.tensor(NEG_INF, device=q.device)), mask


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, KVH, Sk, D] -> [B, H, Sq, D] in q.dtype."""
    h, kvh = q.shape[1], k.shape[1]
    s, _ = _masked_scores(q, k, causal=causal, window=window,
                          q_offset=q_offset)
    v = v.repeat_interleave(h // kvh, dim=1)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p_sum = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / p_sum.clamp_min(1e-30),
                       v.float())
    return out.to(q.dtype)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int | None = None,
                            q_offset: int = 0) -> torch.Tensor:
    """Each query row's log-sum-exp of its masked scores: [B, H, Sq]
    float32, what the forward kernels write with ``with_lse=True``."""
    s, _ = _masked_scores(q, k, causal=causal, window=window,
                          q_offset=q_offset)
    return torch.logsumexp(s, dim=-1)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 do: torch.Tensor,
                                 lse: torch.Tensor | None = None, *,
                                 causal: bool = True,
                                 window: int | None = None,
                                 q_offset: int = 0):
    """(dq, dk, dv) of ``attention_reference`` for the output gradient
    ``do``, in the backward kernels' formulas, float32 inside:
    P = exp(s - lse), delta = rowsum(do o), dS = P (do vᵀ - delta) on the
    kept pairs, dq = dS k / √D, dk = dSᵀ q / √D, dv = Pᵀ do (the GQA
    group summed).  ``lse`` None: computed here from q and k.  q, k, v,
    o, do: [B, H, Sq, D] / [B, KVH, Sk, D] as the forward's."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    s, mask = _masked_scores(q, k, causal=causal, window=window,
                             q_offset=q_offset)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None].float())
    # a row without a kept key averages v over every key (the forward's
    # uniform softmax of NEG_INF scores), which its lse cannot express
    p = torch.where(mask.any(-1)[:, None], p, 1.0 / k.shape[2])
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    vr = v.float().repeat_interleave(g, dim=1)
    kr = k.float().repeat_interleave(g, dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    ds = torch.where(mask, p * (dp - delta), 0.0)
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    sk = k.shape[2]
    dk = dk.reshape(b, kvh, g, sk, d).sum(2)
    dv = dv.reshape(b, kvh, g, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
