"""Public op for the RG-LRU linear scan: the tensor's device picks the
CUDA kernel or its plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels.rglru.kernel import rglru_scan_kernel


def rglru_linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1; a, b: [B, S, R]."""
    return rglru_scan_kernel(a.contiguous(), b.contiguous())
