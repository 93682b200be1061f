"""Public wrapper around the flash-attention kernel.

Accepts the model's grouped-query layout ``[B, S, kvH, G, D]`` (with k, v
``[B, S, kvH, D]``) and the plain ``[B, H, S, D]`` layout, as the JAX
package's ``flash_attention`` does.  The grouped layout is handed to the
kernel as strided views, so neither q nor the output is transposed in
memory.  The tensor's device picks the CUDA kernel or its plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B,S,kvH,G,D] or [B,H,S,D]; k/v: [B,S,kvH,D] or [B,KVH,S,D]."""
    if q.dim() != 5:
        return flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    b, s, kvh, g, d = q.shape
    qx = q.contiguous().view(b, s, kvh * g, d).transpose(1, 2)
    kx = k.contiguous().transpose(1, 2)
    vx = v.contiguous().transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention_bhsd(qx, kx, vx, causal=causal, window=window,
                         q_offset=q_offset,
                         out=out.view(b, s, kvh * g, d).transpose(1, 2))
    return out
