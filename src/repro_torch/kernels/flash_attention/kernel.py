"""Causal / sliding-window GQA flash attention — the hand-written CUDA
kernels' wrapper.

``flash_attention_bhsd`` computes ``softmax(q kᵀ / √D + mask) v`` for
q [B, H, Sq, D] and k, v [B, KVH, Sk, D] (query head h reads kv head
``h // (H // KVH)``), with the causal mask on positions ``q_offset + i``
against ``j`` and an optional sliding window.  The kernels, in
``src/repro_torch/csrc/flash_attention.cu``, say which TPU kernel they
replace and what bounds them.

Two routes, picked by dtype (``route``): bfloat16 goes to the tensor-core
kernel (wgmma, TMA), float32 to the CUDA-core kernel, since a bf16 or TF32
tensor-core product cannot meet the float32 bar.  For tensors on the CPU
the wrapper runs the plain version (``ref.attention_reference``); for
CUDA tensors it launches the route's kernel on the current stream or
raises — a missing compiler or a refused launch is an error, never a
fallback.  ``LAUNCHES`` counts the launches of each route, so a run can
show which kernel its path went through.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention import tiles
from repro_torch.kernels.flash_attention.ref import attention_reference

SOURCE = "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
TC, F32 = "flash_attention_tc", "flash_attention_f32"
_KERNEL_IDS = {F32: 0, TC: 1}     # the route's number in the C interface

#: Kernel launches of each route since the last ``reset_launches()``.
LAUNCHES = {TC: 0, F32: 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def tile(name: str, d: int) -> tuple[int, int]:
    """(query rows, keys) of a block of route ``name`` at head dim d."""
    return tiles.tc_tile(d) if name == TC else tiles.F32_TILE


def route(dtype: torch.dtype) -> str:
    """The kernel a dtype takes: the tensor-core kernel for bfloat16, the
    CUDA-core kernel for float32."""
    if dtype == torch.bfloat16:
        return TC
    if dtype == torch.float32:
        return F32
    raise TypeError(f"q must be float32 or bfloat16, got {dtype}")


def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        ptr = ctypes.c_void_p
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_int] + [ptr] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float, ptr] + [ctypes.c_int] * 3 + [ptr])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
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
    name = route(q.dtype)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if out is None:
        out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    for arg, x in (("k", k), ("v", v), ("out", out)):
        if x.dtype != q.dtype:
            raise TypeError(f"{arg} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{arg} is on {x.device}, q on {q.device}")
    if tuple(out.shape) != (b, h, sq, d):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected "
                         f"{(b, h, sq, d)}")
    for arg, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if x.stride(3) != 1:
            raise ValueError(f"{arg} needs a contiguous head dimension")
    if b == 0 or h == 0 or sq == 0:
        return out
    if sk == 0:
        raise ValueError("attention over zero keys")
    strides = [s for x in (q, k, v, out) for s in _strides(x)]
    if name == TC:
        _check_tma(q, k, v, out, strides)
    bq, bk = tile(name, d)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            _KERNEL_IDS[name], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, kvh, sq, sk, d, int(causal),
            0 if window is None else int(window), int(q_offset),
            1.0 / math.sqrt(d), (ctypes.c_longlong * 12)(*strides), bq, bk,
            tiles.n_q_tiles(sq, bq), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: error {rc} "
                           f"({msg})")
    LAUNCHES[name] += 1
    return out


def smem_bytes(name: str, d: int) -> int:
    """Dynamic shared memory a block of route ``name`` takes at head dim d
    (builds the kernels)."""
    return _library().flash_attention_smem_bytes(_KERNEL_IDS[name], d)


def _strides(x: torch.Tensor) -> list[int]:
    """(batch, head, sequence) element strides; a dimension of size 1 is
    never stepped, so it gets 8 (16 bytes in bf16, as TMA asks)."""
    return [s if n > 1 else 8 for n, s in zip(x.shape[:3], x.stride()[:3])]


def _check_tma(q, k, v, out, strides) -> None:
    """The tensor-core kernel reads q, k and v through TMA, which needs
    16-byte aligned bases and strides, and stores bf16 pairs of out."""
    for i, (arg, x) in enumerate((("q", q), ("k", k), ("v", v))):
        if x.data_ptr() % 16 or any(s * 2 % 16 for s in strides[3 * i:
                                                                3 * i + 3]):
            raise ValueError(
                f"{arg} needs a 16-byte aligned base and (batch, head, "
                f"sequence) strides that are multiples of 8 elements for the "
                f"tensor-core kernel, got strides {tuple(x.stride())}")
    if out.data_ptr() % 4 or any(s % 2 for s in strides[9:]):
        raise ValueError(f"out needs a 4-byte aligned base and even strides, "
                         f"got {tuple(out.stride())}")
