"""Public op for the RG-LRU linear scan: the tensor's device picks the
CUDA kernel or its plain version.  Where a gradient is wanted (grad mode
on and a or b requiring it) the call goes through ``LinearScan``, a
``torch.autograd.Function`` that saves a and h and whose backward is K5's
reverse mode, one launch (``kernel.rglru_scan_backward``; the plain
backward on the CPU)."""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru.kernel import (rglru_scan_backward,
                                              rglru_scan_kernel)


class LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan_kernel(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rglru_scan_backward(a, h, dh.contiguous())


def rglru_linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1; a, b: [B, S, R]."""
    a, b = a.contiguous(), b.contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return LinearScan.apply(a, b)
    return rglru_scan_kernel(a, b)
