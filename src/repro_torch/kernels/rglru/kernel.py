"""RG-LRU linear recurrence ``h_t = a_t·h_{t-1} + b_t`` — the hand-written
CUDA kernels' wrapper.

The kernels, in ``src/repro_torch/csrc/rglru_scan.cu``, say which TPU
kernel they replace and what bounds them.  Two routes, chosen by the data
alone (``plan.plan``): the ring kernel (TMA-fed, one consumer thread a
channel) where TMA can read the tensors — 16-byte aligned bases and a
row pitch that is a multiple of 16 bytes — and the simple kernel for
every other input.  For tensors on the CPU the wrapper runs the plain
version (``ref.rglru_scan_ref``), which both kernels equal bit for bit;
for CUDA tensors it launches the route's kernel on the current stream or
raises — a refused plan, tensor map or launch is an error, never a
fallback to the other route.  ``LAUNCHES`` counts the launches, in all
(``"rglru_scan"``) and per route (``"rglru_scan/ring"``,
``"rglru_scan/simple"``).

The gradient is the same recurrence run backwards in time: with g_t =
dh_t + a_{t+1} g_{t+1}, db = g and da_t = g_t h_{t-1}.
``rglru_scan_backward`` launches the reverse mode of the route the data
picks (``plan.plan_bwd``): one launch that reads a, h and dh once and
writes da and db, counted in ``LAUNCHES`` like any launch and once more
in ``BACKWARD_LAUNCHES``.  It equals ``ref.rglru_scan_backward_ref`` bit
for bit, as the forward equals ``rglru_scan_ref``.

On meta tensors (the dry run's plan of the card's path) both wrappers
check their arguments and allocate their outputs as on the card (h; da
and db), then skip the launch and report the bytes it moves to
``kernels.work``.  No launch is counted.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import load
from repro_torch.kernels.rglru import plan as rglru_plan
from repro_torch.kernels.rglru.ref import (rglru_scan_backward_ref,
                                           rglru_scan_ref)

SOURCE = "rglru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TOTAL = "rglru_scan"
ROUTE_KEYS = {rglru_plan.RING: "rglru_scan/ring",
              rglru_plan.SIMPLE: "rglru_scan/simple"}

BWD = "rglru_scan_bwd"

#: Kernel launches since the last ``reset_launches()``: in all, and per
#: route.
LAUNCHES = {TOTAL: 0, **{key: 0 for key in ROUTE_KEYS.values()}}
#: Launches of the reverse kernel (``rglru_scan_backward`` on the card).
BACKWARD_LAUNCHES = {BWD: 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, BACKWARD_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        ptr = ctypes.c_void_p
        lib.rglru_scan_fwd.argtypes = [ptr] * 3 + [ctypes.c_int] * 4 + [ptr]
        lib.rglru_scan_fwd.restype = ctypes.c_int
        lib.rglru_scan_ring_fwd.argtypes = ([ptr] * 3 + [ctypes.c_int] * 10
                                            + [ptr])
        lib.rglru_scan_ring_fwd.restype = ctypes.c_int
        lib.rglru_scan_bwd.argtypes = [ptr] * 5 + [ctypes.c_int] * 4 + [ptr]
        lib.rglru_scan_bwd.restype = ctypes.c_int
        lib.rglru_scan_ring_bwd_launch.argtypes = (
            [ptr] * 5 + [ctypes.c_int] * 10 + [ptr])
        lib.rglru_scan_ring_bwd_launch.restype = ctypes.c_int
        lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
        lib.rglru_scan_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def rglru_scan_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h [B, S, R] in a.dtype for a, b [B, S, R] (float32 or bfloat16,
    contiguous, one dtype); the carry is float32."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan_kernel runs on cuda, cpu or meta "
                         f"tensors, got {a.device}")
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
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    if a.device.type == "meta":
        work.report(TOTAL, 0.0, work.tensor_bytes(a, b, out))
        return out
    p = rglru_plan.plan(*a.shape, a.element_size(),
                        (a.data_ptr(), b.data_ptr(), out.data_ptr()))
    return launch(a, b, out, p)


def rglru_scan_backward(a: torch.Tensor, h: torch.Tensor,
                        dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of h = scan(a, b) for the output gradient dh; a, h, dh
    [B, S, R] in one dtype, contiguous (h the forward's output)."""
    if a.device.type == "cpu":
        return rglru_scan_backward_ref(a, h, dh)
    if a.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru_scan_backward runs on cuda, cpu or meta "
                         f"tensors, got {a.device}")
    if (a.dim() != 3 or tuple(h.shape) != tuple(a.shape)
            or tuple(dh.shape) != tuple(a.shape)):
        raise ValueError(f"a, h and dh must be one [B, S, R] shape, got "
                         f"{tuple(a.shape)}, {tuple(h.shape)} and "
                         f"{tuple(dh.shape)}")
    if a.dtype not in _DTYPES or h.dtype != a.dtype or dh.dtype != a.dtype:
        raise TypeError(f"a, h and dh must be one dtype, float32 or "
                        f"bfloat16, got {a.dtype}, {h.dtype} and {dh.dtype}")
    if h.device != a.device or dh.device != a.device:
        raise ValueError(f"h is on {h.device}, dh on {dh.device}, a on "
                         f"{a.device}")
    if not (a.is_contiguous() and h.is_contiguous() and dh.is_contiguous()):
        raise ValueError("a, h and dh must be contiguous")
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    if a.device.type == "meta":
        work.report(BWD, 0.0, work.tensor_bytes(a, h, dh, da, db))
        return da, db
    p = rglru_plan.plan_bwd(*a.shape, a.element_size(),
                            tuple(x.data_ptr() for x in (a, h, dh, da, db)))
    return launch_bwd(a, h, dh, da, db, p)


def launch_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
               da: torch.Tensor, db: torch.Tensor,
               p: rglru_plan.Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the reverse kernel of plan ``p`` (``plan.plan_bwd``'s) on
    checked CUDA tensors, into da and db; raises where the kernel refuses
    the plan."""
    bsz, s, r = a.shape
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        args = (a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
                db.data_ptr(), _DTYPES[a.dtype], bsz, s, r)
        if p.route == rglru_plan.RING:
            rc = lib.rglru_scan_ring_bwd_launch(
                *args, p.channels, p.steps, p.stages, p.smem_bytes, *p.grid,
                stream)
        elif p.route == rglru_plan.SIMPLE:
            rc = lib.rglru_scan_bwd(*args, stream)
        else:
            raise ValueError(f"unknown route {p.route!r}")
    if rc != 0:
        msg = lib.rglru_scan_error_string(rc).decode()
        raise RuntimeError(f"rglru_scan {p.route} reverse kernel launch "
                           f"failed: error {rc} ({msg}); plan {p}")
    LAUNCHES[TOTAL] += 1
    LAUNCHES[ROUTE_KEYS[p.route]] += 1
    BACKWARD_LAUNCHES[BWD] += 1
    return da, db


def launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
           p: rglru_plan.Plan) -> torch.Tensor:
    """Launch the kernel of plan ``p`` on checked CUDA tensors a, b and
    out [B, S, R] (``rglru_scan_kernel`` checks them and picks ``p``; a
    caller may pass another plan of the same shape, as the timings do);
    raises where the kernel refuses the plan."""
    bsz, s, r = a.shape
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), _DTYPES[a.dtype],
                bsz, s, r)
        if p.route == rglru_plan.RING:
            rc = lib.rglru_scan_ring_fwd(
                *args, p.channels, p.steps, p.stages, p.smem_bytes, *p.grid,
                stream)
        elif p.route == rglru_plan.SIMPLE:
            rc = lib.rglru_scan_fwd(*args, stream)
        else:
            raise ValueError(f"unknown route {p.route!r}")
    if rc != 0:
        msg = lib.rglru_scan_error_string(rc).decode()
        raise RuntimeError(f"rglru_scan {p.route} kernel launch failed: "
                           f"error {rc} ({msg}); plan {p}")
    LAUNCHES[TOTAL] += 1
    LAUNCHES[ROUTE_KEYS[p.route]] += 1
    return out
