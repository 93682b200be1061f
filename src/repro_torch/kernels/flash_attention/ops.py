"""Public wrapper around the flash-attention kernel.

Accepts the model's grouped-query layout ``[B, S, kvH, G, D]`` (with k, v
``[B, S, kvH, D]``) and the plain ``[B, H, S, D]`` layout, as the JAX
package's ``flash_attention`` does.  The grouped layout is handed to the
kernel as strided views, so neither q nor the output is transposed in
memory.  The tensor's device picks the CUDA kernel or its plain version.

Where a gradient is wanted (grad mode on and q, k or v requiring it) the
call goes through ``FlashAttention``, a ``torch.autograd.Function``: its
forward launches the kernel with the rows' log-sum-exp and saves q, k, v,
the output and lse, and keeps the position plan (which takes no
gradient) and ``q_offset``; its backward launches the backward kernels on
that plan (the plain backward on the CPU) and hands back dq, dk, dv in
the layout it was given.  A query chunk (Sq < Sk at ``q_offset``, the
sequence-sharded attention of tensor parallelism) takes the gradient too:
the keys no query of the chunk sees get zeros.

``q_pos`` / ``k_pos`` ([B, Sq] / [B, Sk]) or their ``plan`` (made once a
model forward; built here from the positions otherwise) and ``softcap``
pass through to the kernels (see ``kernel.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bhsd, flash_attention_bwd_bhsd)
from repro_torch.kernels.flash_attention.plan import PosPlan


def _bhsd(q: torch.Tensor, k: torch.Tensor):
    """[B, H, S, D] and [B, KVH, S, D] views of grouped q [B,S,kvH,G,D]
    and k (or v) [B,S,kvH,D]; q must be contiguous."""
    b, s, kvh, g, d = q.shape
    return q.view(b, s, kvh * g, d).transpose(1, 2), k.transpose(1, 2)


def _ext(plan, softcap) -> dict:
    """The kernels' EXT arguments: the cap, and the plan where there is one
    (the index path's call then reads as it did without positions)."""
    return {"softcap": softcap} if plan is None else {"plan": plan,
                                                      "softcap": softcap}


def _forward(q, k, v, causal, window, q_offset, with_lse, ext):
    """``ext``: the kernels' plan and softcap arguments (``_ext``)."""
    if q.dim() != 5:
        return flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, with_lse=with_lse,
                                    **ext)
    qx, kx = _bhsd(q, k)
    vx = v.transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    res = flash_attention_bhsd(qx, kx, vx, causal=causal, window=window,
                               q_offset=q_offset, out=_bhsd(out, k)[0],
                               with_lse=with_lse, **ext)
    return (out, res[1]) if with_lse else out


class FlashAttention(torch.autograd.Function):
    """Attention with the kernels' gradient; q, k, v contiguous, in either
    layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, plan, softcap):
        out, lse = _forward(q, k, v, causal, window, q_offset, True,
                            _ext(plan, softcap))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        ctx.plan, ctx.softcap = plan, softcap
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        kw = dict(causal=ctx.causal, window=ctx.window,
                  q_offset=ctx.q_offset, plan=ctx.plan, softcap=ctx.softcap)
        none = (None,) * 5   # causal, window, q_offset, plan and softcap
        if q.dim() != 5:
            dq, dk, dv = flash_attention_bwd_bhsd(q, k, v, out, do, lse, **kw)
            return dq, dk, dv, *none
        dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                      for x in (q, k, v))
        qx, kx = _bhsd(q, k)
        flash_attention_bwd_bhsd(
            qx, kx, v.transpose(1, 2), _bhsd(out, k)[0], _bhsd(do, k)[0],
            lse, dq=_bhsd(dq, k)[0], dk=dk.transpose(1, 2),
            dv=dv.transpose(1, 2), **kw)
        return dq, dk, dv, *none


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, q_pos=None, k_pos=None,
                    softcap: float | None = None,
                    plan: PosPlan | None = None) -> torch.Tensor:
    """q: [B,S,kvH,G,D] or [B,H,S,D]; k/v: [B,S,kvH,D] or [B,KVH,S,D];
    q_pos / k_pos: None or [B, Sq] / [B, Sk] integer positions, or their
    ``plan``."""
    grouped = q.dim() == 5
    if plan is None and (q_pos is not None or k_pos is not None):
        b, sq = q.shape[0], q.shape[1 if grouped else 2]
        plan = PosPlan.build(q_pos, k_pos, b=b, sq=sq,
                             sk=k.shape[1 if grouped else 2],
                             q_offset=q_offset, device=q.device)
        q_offset = 0
    elif plan is not None and (q_pos is not None or k_pos is not None):
        raise ValueError("give positions or their plan, not both")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window, q_offset,
                                    plan, softcap)
    if grouped:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _forward(q, k, v, causal, window, q_offset, False,
                    _ext(plan, softcap))
