"""Plain PyTorch versions of the flash-attention kernels (GQA, causal,
window, logit soft cap, caller positions): the whole score matrix in
float32, as the JAX package's ``attention_reference`` and ``_attn_plain``;
the rows' log-sum-exp the forward writes for the backward; and the
backward itself, in the kernels' formulas.

Positions: ``q_pos`` [B, Sq] and ``k_pos`` [B, Sk] integer tensors, one row
a batch entry shared by every head; None means ``q_offset + arange(Sq)``
and ``arange(Sk)``.  A pair is kept iff ``q_pos >= k_pos`` (causal) and
``q_pos - k_pos < window`` (a window).  ``softcap``: the score is
``cap tanh(q·k / √D / cap)`` before the mask, as JAX's ``_softcap``."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _positions_or_arange(pos: torch.Tensor | None, n: int, offset: int,
                         device) -> torch.Tensor:
    """``pos`` [B, n] as int64, or ``offset + arange(n)`` as [1, n]."""
    if pos is None:
        return offset + torch.arange(n, device=device)[None]
    return pos.to(device=device, dtype=torch.int64)


def _masked_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
                   window: int | None, q_offset: int, q_pos=None, k_pos=None,
                   softcap: float | None = None):
    """(float32 scores q kᵀ / √D, soft-capped, with NEG_INF where the mask
    drops the pair [B, H, Sq, Sk]; the mask [B or 1, 1, Sq, Sk]; the soft
    cap's derivative 1 - tanh² [B, H, Sq, Sk], or None without a cap)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kvh, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    dcap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
        dcap = 1.0 - t * t
    qp = _positions_or_arange(q_pos, sq, q_offset, q.device)
    kp = _positions_or_arange(k_pos, sk, 0, q.device)
    qp, kp = qp[:, None, :, None], kp[:, None, None, :]
    mask = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qp >= kp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    return (torch.where(mask, s, torch.tensor(NEG_INF, device=q.device)),
            mask, dcap)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_offset: int = 0, q_pos=None, k_pos=None,
                        softcap: float | None = None) -> torch.Tensor:
    """q: [B, H, Sq, D]; k, v: [B, KVH, Sk, D] -> [B, H, Sq, D] in q.dtype."""
    h, kvh = q.shape[1], k.shape[1]
    s, _, _ = _masked_scores(q, k, causal=causal, window=window,
                             q_offset=q_offset, q_pos=q_pos, k_pos=k_pos,
                             softcap=softcap)
    v = v.repeat_interleave(h // kvh, dim=1)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p_sum = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / p_sum.clamp_min(1e-30),
                       v.float())
    return out.to(q.dtype)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor, *,
                            causal: bool = True, window: int | None = None,
                            q_offset: int = 0, q_pos=None, k_pos=None,
                            softcap: float | None = None) -> torch.Tensor:
    """Each query row's log-sum-exp of its masked scores: [B, H, Sq]
    float32, what the forward kernels write with ``with_lse=True``."""
    s, _, _ = _masked_scores(q, k, causal=causal, window=window,
                             q_offset=q_offset, q_pos=q_pos, k_pos=k_pos,
                             softcap=softcap)
    return torch.logsumexp(s, dim=-1)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 do: torch.Tensor,
                                 lse: torch.Tensor | None = None, *,
                                 causal: bool = True,
                                 window: int | None = None,
                                 q_offset: int = 0, q_pos=None, k_pos=None,
                                 softcap: float | None = None):
    """(dq, dk, dv) of ``attention_reference`` for the output gradient
    ``do``, in the backward kernels' formulas, float32 inside:
    P = exp(s - lse), delta = rowsum(do o), dS = P (do vᵀ - delta) on the
    kept pairs (times 1 - tanh² of the soft cap), dq = dS k / √D,
    dk = dSᵀ q / √D, dv = Pᵀ do (the GQA group summed).  ``lse`` None:
    computed here from q and k.  q, k, v, o, do: [B, H, Sq, D] /
    [B, KVH, Sk, D] as the forward's."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    s, mask, dcap = _masked_scores(q, k, causal=causal, window=window,
                                   q_offset=q_offset, q_pos=q_pos,
                                   k_pos=k_pos, softcap=softcap)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None].float())
    # a row without a kept key averages v over every key (the forward's
    # uniform softmax of NEG_INF scores), which its lse cannot express
    p = torch.where(mask.any(-1, keepdim=True), p, 1.0 / k.shape[2])
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    vr = v.float().repeat_interleave(g, dim=1)
    kr = k.float().repeat_interleave(g, dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    ds = torch.where(mask, p * (dp - delta), 0.0)
    if dcap is not None:
        ds = ds * dcap
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    sk = k.shape[2]
    dk = dk.reshape(b, kvh, g, sk, d).sum(2)
    dv = dv.reshape(b, kvh, g, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
