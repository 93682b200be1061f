"""(max,+) matrix folds — the hand-written CUDA kernels' wrappers.

``maxplus_fold_kernel`` evaluates ``s_T = A_{idx[T-1]} ⊗ … ⊗ A_{idx[0]}
⊗ s_0`` for a batch of independent design points, where the A_i form a
per-combo matrix dictionary (``repro_torch.core.maxplus_form``) and
``idx`` is the combo index sequence of a trace; ``idx=None`` is the
periodic fold ``idx[t] = t mod M`` of a homogeneous stream.
``maxplus_fold_many_kernel`` folds a fleet of traces instead: each lane
its own index sequence and length against one shared dictionary.  The
kernels, in ``src/repro_torch/csrc/maxplus_fold.cu``, say which TPU
kernels they replace and what bounds them.

For tensors on the CPU a wrapper runs the plain version
(``ref.maxplus_fold_ref`` / ``ref.maxplus_fold_many_ref``); for CUDA
tensors it launches the kernel on the current stream or raises — a
missing compiler or a refused launch is an error, never a fallback.
``LAUNCHES`` counts the launches of each branch, so a run can show that
its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.maxplus_form import NEG
from repro_torch.kernels.build import load
from repro_torch.kernels.maxplus.ref import (maxplus_fold_many_ref,
                                             maxplus_fold_ref)

SOURCE = "maxplus_fold.cu"

#: Kernel launches per branch since the last ``reset_launches()``.
LAUNCHES = {"indexed": 0, "periodic": 0, "many": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        ptr = ctypes.c_void_p
        lib.maxplus_fold.argtypes = [ptr] * 10 + [ctypes.c_int] * 4 + [
            ctypes.c_longlong, ptr]
        lib.maxplus_fold.restype = ctypes.c_int
        lib.maxplus_fold_many.argtypes = [ptr] * 9 + [ctypes.c_int] * 2 + [
            ctypes.c_longlong, ptr]
        lib.maxplus_fold_many.restype = ctypes.c_int
        lib.maxplus_fold_max_n.argtypes = []
        lib.maxplus_fold_max_n.restype = ctypes.c_int
        lib.maxplus_fold_error_string.argtypes = [ctypes.c_int]
        lib.maxplus_fold_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device: torch.device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, mats on {device}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def maxplus_fold_kernel(mats: torch.Tensor, s0: torch.Tensor, *,
                        t_steps: int, idx: torch.Tensor | None = None,
                        energy: torch.Tensor | None = None,
                        arrivals: torch.Tensor | None = None,
                        gvec: torch.Tensor | None = None,
                        extras: torch.Tensor | None = None,
                        wvec: torch.Tensor | None = None):
    """Folded state [B, N]; with ``energy`` [B, M, P] also the [B, P]
    accumulator ``sum_t energy[:, idx[t]]``.

    mats [B, M, N, N] f32, s0 [B, N] f32, idx [t_steps] i32 (None =
    periodic), arrivals/extras [t_steps] f32, gvec/wvec [B, M, N] f32.
    ``arrivals``/``gvec``/``extras``/``wvec`` need the trace-indexed path;
    with any of them given the others default to their identities, as in
    ``maxplus_fold_ref``."""
    side = (arrivals, gvec, extras, wvec)
    if any(x is not None for x in side) and idx is None:
        raise ValueError("arrivals/gvec/extras/wvec need the trace-indexed "
                         "path (pass idx)")
    if mats.device.type == "cpu":
        return maxplus_fold_ref(mats, s0, t_steps=t_steps, idx=idx,
                                energy=energy, arrivals=arrivals, gvec=gvec,
                                extras=extras, wvec=wvec)
    if mats.device.type != "cuda":
        raise ValueError(f"maxplus_fold_kernel runs on cuda or cpu tensors, "
                         f"got {mats.device}")
    if mats.dim() != 4 or mats.shape[2] != mats.shape[3]:
        raise ValueError(f"mats must be [B, M, N, N], got {tuple(mats.shape)}")
    b, m, n, _ = mats.shape
    dev = mats.device
    t_steps = int(t_steps)
    if t_steps < 0:
        raise ValueError(f"t_steps must be >= 0, got {t_steps}")
    _check("mats", mats, torch.float32, (b, m, n, n), dev)
    _check("s0", s0, torch.float32, (b, n), dev)
    lib = _library()
    if n > lib.maxplus_fold_max_n():
        raise ValueError(f"state size {n} exceeds the kernel's "
                         f"{lib.maxplus_fold_max_n()}")
    if idx is not None:
        idx = idx[:t_steps]
        _check("idx", idx, torch.int32, (t_steps,), dev)
        if t_steps:
            lo, hi = torch.aminmax(idx)
            lo, hi = int(lo), int(hi)
            if lo < 0 or hi >= m:
                raise ValueError(f"idx out of range: [{lo}, {hi}] for "
                                 f"M = {m}")
    if any(x is not None for x in side):
        def zeros_t():
            return torch.zeros((t_steps,), dtype=torch.float32, device=dev)
        arrivals = zeros_t() if arrivals is None else arrivals[:t_steps]
        extras = zeros_t() if extras is None else extras[:t_steps]
        if gvec is None:
            gvec = torch.full((b, m, n), NEG, dtype=torch.float32, device=dev)
        if wvec is None:
            wvec = torch.zeros((b, m, n), dtype=torch.float32, device=dev)
        for name, x, shape in (("arrivals", arrivals, (t_steps,)),
                               ("extras", extras, (t_steps,)),
                               ("gvec", gvec, (b, m, n)),
                               ("wvec", wvec, (b, m, n))):
            _check(name, x, torch.float32, shape, dev)
    p = 0
    acc = None
    if energy is not None:
        p = energy.shape[-1]
        _check("energy", energy, torch.float32, (b, m, p), dev)
        acc = torch.empty((b, p), dtype=torch.float32, device=dev)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0:
        return out if acc is None else (out, acc)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.maxplus_fold(
            _ptr(mats), _ptr(s0), _ptr(idx), _ptr(gvec), _ptr(arrivals),
            _ptr(wvec), _ptr(extras), _ptr(energy), _ptr(out), _ptr(acc), b,
            m, n, p, t_steps, stream)
    _raise_on(lib, rc, "maxplus_fold")
    LAUNCHES["periodic" if idx is None else "indexed"] += 1
    return out if acc is None else (out, acc)


def maxplus_fold_many_kernel(mats: torch.Tensor, gvec: torch.Tensor,
                             idx: torch.Tensor, arrivals: torch.Tensor,
                             s0: torch.Tensor, lengths: torch.Tensor, *,
                             extras: torch.Tensor | None = None,
                             wvec: torch.Tensor | None = None,
                             with_arrivals: bool = True) -> torch.Tensor:
    """Folded states [B, N] of B traces in one launch, one block per lane.

    mats [M1, N, N] f32 (one dictionary shared by every lane), gvec [M1,
    N] f32, idx [B, T] i32, arrivals [B, T] f32, s0 [N] f32, lengths [B]
    i32 (each in [0, T]); ``extras`` [B, T] f32 with its ``wvec`` [M1, N]
    written-rows mask adds the fault shift, and ``with_arrivals=False``
    drops the arrival max-in.  Lane b folds its first ``lengths[b]``
    steps; lanes sorted longest-first start their long chains first."""
    if (extras is None) != (wvec is None):
        raise ValueError("extras and wvec go together")
    if mats.device.type == "cpu":
        return maxplus_fold_many_ref(mats, gvec, idx, arrivals, s0, lengths,
                                     extras=extras, wvec=wvec,
                                     with_arrivals=with_arrivals)
    if mats.device.type != "cuda":
        raise ValueError(f"maxplus_fold_many_kernel runs on cuda or cpu "
                         f"tensors, got {mats.device}")
    if mats.dim() != 3 or mats.shape[1] != mats.shape[2]:
        raise ValueError(f"mats must be [M1, N, N], got {tuple(mats.shape)}")
    if idx.dim() != 2:
        raise ValueError(f"idx must be [B, T], got {tuple(idx.shape)}")
    m1, n, _ = mats.shape
    b, t = idx.shape
    dev = mats.device
    _check("mats", mats, torch.float32, (m1, n, n), dev)
    _check("gvec", gvec, torch.float32, (m1, n), dev)
    _check("idx", idx, torch.int32, (b, t), dev)
    _check("arrivals", arrivals, torch.float32, (b, t), dev)
    _check("s0", s0, torch.float32, (n,), dev)
    _check("lengths", lengths, torch.int32, (b,), dev)
    if extras is not None:
        _check("extras", extras, torch.float32, (b, t), dev)
        _check("wvec", wvec, torch.float32, (m1, n), dev)
    lib = _library()
    if n > lib.maxplus_fold_max_n():
        raise ValueError(f"state size {n} exceeds the kernel's "
                         f"{lib.maxplus_fold_max_n()}")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lo, hi = (int(x) for x in torch.aminmax(lengths))
    if lo < 0 or hi > t:
        raise ValueError(f"lengths out of range: [{lo}, {hi}] for T = {t}")
    if t:
        lo, hi = (int(x) for x in torch.aminmax(idx))
        if lo < 0 or hi >= m1:
            raise ValueError(f"idx out of range: [{lo}, {hi}] for M1 = {m1}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.maxplus_fold_many(
            _ptr(mats), _ptr(gvec) if with_arrivals else None, _ptr(wvec),
            _ptr(idx), _ptr(arrivals) if with_arrivals else None,
            _ptr(extras), _ptr(s0), _ptr(lengths), _ptr(out), b, n, t,
            stream)
    _raise_on(lib, rc, "maxplus_fold_many")
    LAUNCHES["many"] += 1
    return out


def _ptr(x):
    return None if x is None else x.data_ptr()


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.maxplus_fold_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
