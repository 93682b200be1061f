"""RG-LRU linear recurrence ``h_t = a_t·h_{t-1} + b_t`` — the hand-written
CUDA kernel's wrapper.

The kernel, in ``src/repro_torch/csrc/rglru_scan.cu``, says which TPU
kernel it replaces and what bounds it.  For tensors on the CPU the wrapper
runs the plain version (``ref.rglru_scan_ref``), which the kernel equals
bit for bit; for CUDA tensors it launches the kernel on the current
stream or raises — never a fallback.  ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.rglru.ref import rglru_scan_ref

SOURCE = "rglru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last ``reset_launches()``.
LAUNCHES = {"rglru_scan": 0}


def reset_launches() -> None:
    LAUNCHES["rglru_scan"] = 0


def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        ptr = ctypes.c_void_p
        lib.rglru_scan_fwd.argtypes = [ptr] * 3 + [ctypes.c_int] * 4 + [ptr]
        lib.rglru_scan_fwd.restype = ctypes.c_int
        lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def rglru_scan_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h [B, S, R] in a.dtype for a, b [B, S, R] (float32 or bfloat16,
    contiguous, one dtype); the carry is float32."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_kernel runs on cuda or cpu tensors, "
                         f"got {a.device}")
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"a and b must be one [B, S, R] shape, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    bsz, s, r = a.shape
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                _DTYPES[a.dtype], bsz, s, r, stream)
    if rc != 0:
        msg = lib.rglru_scan_error_string(rc).decode()
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES["rglru_scan"] += 1
    return out
