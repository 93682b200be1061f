"""Causal / sliding-window GQA flash attention — the hand-written CUDA
kernel's wrapper.

``flash_attention_bhsd`` computes ``softmax(q kᵀ / √D + mask) v`` for
q [B, H, Sq, D] and k, v [B, KVH, Sk, D] (query head h reads kv head
``h // (H // KVH)``), with the causal mask on positions ``q_offset + i``
against ``j`` and an optional sliding window.  The kernel, in
``src/repro_torch/csrc/flash_attention.cu``, says which TPU kernel it
replaces and what bounds it.

For tensors on the CPU the wrapper runs the plain version
(``ref.attention_reference``); for CUDA tensors it launches the kernel on
the current stream or raises — a missing compiler or a refused launch is
an error, never a fallback.  ``LAUNCHES`` counts the launches, so a run
can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention.ref import attention_reference

SOURCE = "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since the last ``reset_launches()``.
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        ptr = ctypes.c_void_p
        lib.flash_attention_fwd.argtypes = (
            [ptr] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float, ptr, ptr])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         q_offset: int = 0,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """[B, H, Sq, D] attention output in q.dtype.

    q, k, v may be strided views (the grouped model layout is read in
    place) as long as the head dimension is contiguous; ``out`` is an
    optional [B, H, Sq, D] destination view of the same kind."""
    if q.device.type == "cpu":
        o = attention_reference(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
        if out is None:
            return o
        out.copy_(o)
        return out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd runs on cuda or cpu tensors, "
                         f"got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kvh, sk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} kv "
                         "heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS})")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if out is None:
        out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    for name, x in (("k", k), ("v", v), ("out", out)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if tuple(out.shape) != (b, h, sq, d):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected "
                         f"{(b, h, sq, d)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous head dimension")
    if b == 0 or h == 0 or sq == 0:
        return out
    if sk == 0:
        raise ValueError("attention over zero keys")
    strides = (ctypes.c_longlong * 12)(*(
        s for x in (q, k, v, out) for s in x.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, kvh, sq, sk, d, int(causal),
            0 if window is None else int(window), int(q_offset),
            1.0 / math.sqrt(d), strides, stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    LAUNCHES["flash_attention"] += 1
    return out
