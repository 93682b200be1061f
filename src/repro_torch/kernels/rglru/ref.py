"""Plain PyTorch version of the RG-LRU scan kernel: the recurrence one step
at a time in float32, a multiply then an add (never one fused operation),
which is exactly what the CUDA kernel computes."""

from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t with h_0 = 0; a, b: [B, S, R] -> a.dtype."""
    bsz, s, r = a.shape
    out = torch.empty_like(a)
    h = torch.zeros((bsz, r), dtype=torch.float32, device=a.device)
    for t in range(s):
        h = torch.add(torch.mul(a[:, t].float(), h), b[:, t].float())
        out[:, t] = h.to(a.dtype)
    return out
