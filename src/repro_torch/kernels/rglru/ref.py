"""Plain PyTorch versions of the RG-LRU scan kernel and of its gradient:
the recurrence one step at a time in float32, a multiply then an add
(never one fused operation), which is exactly what the CUDA kernel
computes — forwards in time for h, backwards for the gradient."""

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


def rglru_scan_backward_ref(a: torch.Tensor, h: torch.Tensor,
                            dh: torch.Tensor):
    """(da, db) of h = rglru_scan_ref(a, b) for the output gradient dh:
    g_t = dh_t + a_{t+1} · g_{t+1} (carried in float32, stored in
    a.dtype), db = g, da_t = g_t · h_{t-1} with h_{-1} = 0."""
    bsz, s, r = a.shape
    g = torch.empty_like(a)
    da = torch.empty_like(a)
    zero = torch.zeros((bsz, r), dtype=torch.float32, device=a.device)
    carry = zero
    for t in range(s - 1, -1, -1):
        a_next = a[:, t + 1].float() if t + 1 < s else zero
        carry = torch.add(torch.mul(a_next, carry), dh[:, t].float())
        g[:, t] = carry.to(a.dtype)
        h_prev = h[:, t - 1].float() if t > 0 else zero
        da[:, t] = torch.mul(g[:, t].float(), h_prev).to(a.dtype)
    return da, g
