"""Public wrapper around the flash-attention kernel.

Accepts the model's grouped-query layout ``[B, S, kvH, G, D]`` (with k, v
``[B, S, kvH, D]``) and the plain ``[B, H, S, D]`` layout, as the JAX
package's ``flash_attention`` does.  The grouped layout is handed to the
kernel as strided views, so neither q nor the output is transposed in
memory.  The tensor's device picks the CUDA kernel or its plain version.

Where a gradient is wanted (grad mode on and q, k or v requiring it) the
call goes through ``FlashAttention``, a ``torch.autograd.Function``: its
forward launches the kernel with the rows' log-sum-exp and saves q, k, v,
the output and lse (and the positions, which take no gradient); its
backward launches the backward kernels (the plain backward on the CPU) and
hands back dq, dk, dv in the layout it was given.

``q_pos`` / ``k_pos`` ([B, Sq] / [B, Sk]) and ``softcap`` pass through
to the kernels (see ``kernel.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bhsd, flash_attention_bwd_bhsd)


def _bhsd(q: torch.Tensor, k: torch.Tensor):
    """[B, H, S, D] and [B, KVH, S, D] views of grouped q [B,S,kvH,G,D]
    and k (or v) [B,S,kvH,D]; q must be contiguous."""
    b, s, kvh, g, d = q.shape
    return q.view(b, s, kvh * g, d).transpose(1, 2), k.transpose(1, 2)


def _forward(q, k, v, causal, window, q_offset, with_lse, ext):
    """``ext``: the kernels' q_pos, k_pos and softcap arguments."""
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
    def forward(ctx, q, k, v, causal, window, q_pos, k_pos, softcap):
        ext = dict(q_pos=q_pos, k_pos=k_pos, softcap=softcap)
        out, lse = _forward(q, k, v, causal, window, 0, True, ext)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        do = do.contiguous()
        kw = dict(causal=ctx.causal, window=ctx.window, q_pos=q_pos,
                  k_pos=k_pos, softcap=ctx.softcap)
        none = (None,) * 5        # causal, window and the ext arguments
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
                    softcap: float | None = None) -> torch.Tensor:
    """q: [B,S,kvH,G,D] or [B,H,S,D]; k/v: [B,S,kvH,D] or [B,KVH,S,D];
    q_pos / k_pos: None or [B, Sq] / [B, Sk] integer positions."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if q_offset != 0:
            raise NotImplementedError("the attention gradient takes "
                                      "q_offset 0 (self-attention) only")
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window, q_pos,
                                    k_pos, softcap)
    if q.dim() == 5:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return _forward(q, k, v, causal, window, q_offset, False,
                    dict(q_pos=q_pos, k_pos=k_pos, softcap=softcap))
