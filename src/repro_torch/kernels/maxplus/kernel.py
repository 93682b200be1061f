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

Each kernel has two routes on the card, chosen by the data.  The
compact route keeps only the rows an op rewrites: a pre-pass
(``maxplus_compact_kernel``) turns the dense dictionary into one record a
combo and says whether the inputs meet the route's precondition
(``compact.py`` is its CPU twin and states it); the wrapper reads that
flag where it synchronises for its range checks, and launches the compact
fold when it holds, the dense fold otherwise.  Where the shapes rule the
compact route out (more steps than ``compact.MAX_STEPS``, more than 32
energy phases, records beyond the card's shared memory) the pre-pass is
not run and the dense fold is launched.  Both give the same bits.

For tensors on the CPU a wrapper runs the plain version
(``ref.maxplus_fold_ref`` / ``ref.maxplus_fold_many_ref``, and the
twin's ``compact`` for the pre-pass); for CUDA tensors it launches the
kernels on the current stream or raises — a missing compiler or a refused
launch is an error, never a fallback.  ``LAUNCHES`` counts the fold
launches of each branch (``indexed``, ``periodic``, ``many``), of each
branch by route (``indexed/compact``, ``indexed/dense``, ...) and the
pre-pass launches (``prepass``), so a run can show that its path went
through the kernels and which route it took.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.maxplus_form import NEG
from repro_torch.kernels.build import load
from repro_torch.kernels.maxplus import compact
from repro_torch.kernels.maxplus.ref import (maxplus_fold_many_ref,
                                             maxplus_fold_ref)

SOURCE = "maxplus_fold.cu"
BRANCHES = ("indexed", "periodic", "many")
ROUTES = ("compact", "dense")

#: Kernel launches since the last ``reset_launches()``: folds per branch,
#: folds per branch and route (``"<branch>/<route>"``), pre-passes.
LAUNCHES = {**{b: 0 for b in BRANCHES},
            **{f"{b}/{r}": 0 for b in BRANCHES for r in ROUTES},
            "prepass": 0}


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
        ll, i32 = ctypes.c_longlong, ctypes.c_int
        lib.maxplus_compact.argtypes = [ptr] * 4 + [ll] + [ptr] * 3 + [
            ll, ll, ptr, ptr, ll, i32, ptr]
        lib.maxplus_compact.restype = i32
        lib.maxplus_fold_compact.argtypes = [ptr] * 8 + [i32] * 4 + [ll, ptr]
        lib.maxplus_fold_compact.restype = i32
        lib.maxplus_fold_many_compact.argtypes = [ptr] * 7 + [i32] * 3 + [
            ll, ptr]
        lib.maxplus_fold_many_compact.restype = i32
        lib.maxplus_smem_optin.argtypes = []
        lib.maxplus_smem_optin.restype = i32
        lib.maxplus_fold_compact_smem.argtypes = [i32] * 3
        lib.maxplus_fold_compact_smem.restype = ll
        lib.maxplus_fold_many_compact_smem.argtypes = [i32] * 3
        lib.maxplus_fold_many_compact_smem.restype = ll
        lib.maxplus_fold_many_lane_warps.argtypes = [i32]
        lib.maxplus_fold_many_lane_warps.restype = i32
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


def maxplus_compact_kernel(mats: torch.Tensor,
                           gvec: torch.Tensor | None = None,
                           wvec: torch.Tensor | None = None, *,
                           s0: torch.Tensor | None = None,
                           arrivals: torch.Tensor | None = None,
                           extras: torch.Tensor | None = None,
                           lengths: torch.Tensor | None = None):
    """The compact route's pre-pass: (records [C, compact.WORDS] int32 of
    the C combos of ``mats`` [..., N, N], in ``compact.pack``'s layout;
    the precondition's flag).  ``gvec`` / ``wvec`` hold
    the combos' [..., N] side rows; ``s0``, ``arrivals`` and ``extras``
    are checked as values, ``arrivals`` / ``extras`` [R, T] only up to
    ``lengths[r]`` in row r where ``lengths`` [R] is given.  The flag is
    a [1] int32 tensor on the inputs' device, nonzero where the inputs are
    refused, so the caller reads it with its other checks."""
    if mats.device.type == "cpu":
        comp, ok = compact.compact(mats, gvec, wvec)
        ok = ok and all(compact.values_in_range(x, lens) for x, lens in (
            (s0, None), (arrivals, lengths), (extras, lengths)))
        return compact.pack(comp), torch.tensor([0 if ok else 1],
                                                dtype=torch.int32)
    n = mats.shape[-1]
    combos = mats.numel() // (n * n) if n else 0
    dev = mats.device
    rec = torch.empty((combos, compact.WORDS), dtype=torch.int32, device=dev)
    refused = torch.empty((1,), dtype=torch.int32, device=dev)
    span = arrivals if arrivals is not None else extras
    rows, cols = ((0, 0) if span is None else
                  (1, span.numel()) if span.dim() == 1 else tuple(span.shape))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.maxplus_compact(
            _ptr(mats), _ptr(gvec), _ptr(wvec), _ptr(s0),
            0 if s0 is None else s0.numel(), _ptr(arrivals), _ptr(extras),
            _ptr(lengths), rows, cols, _ptr(rec), _ptr(refused), combos, n,
            stream)
    _raise_on(lib, rc, "maxplus_compact")
    LAUNCHES["prepass"] += 1
    return rec, refused


def _launched(branch: str, route: str) -> None:
    LAUNCHES[branch] += 1
    LAUNCHES[f"{branch}/{route}"] += 1


def _read_checks(checks: list[torch.Tensor]) -> list[int]:
    """The range checks' extremes and the route's flag (all int32) in one
    read."""
    if not checks:
        return []
    return torch.stack([c.reshape(()) for c in checks]).tolist()


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

    # the compact route where the shapes allow it: pre-pass, then one read
    # of the range check and the pre-pass's flag
    rec = refused = None
    if (t_steps < compact.MAX_STEPS and p <= 32 and m > 0
            and lib.maxplus_fold_compact_smem(m, n, p)
            <= lib.maxplus_smem_optin()):
        rec, refused = maxplus_compact_kernel(
            mats, gvec, wvec, s0=s0, arrivals=arrivals, extras=extras)
    checks = [refused] if refused is not None else []
    if idx is not None and t_steps:
        checks += list(torch.aminmax(idx))
    got = _read_checks(checks)
    if idx is not None and t_steps:
        lo, hi = got[-2:]
        if lo < 0 or hi >= m:
            raise ValueError(f"idx out of range: [{lo}, {hi}] for M = {m}")
    route = "compact" if refused is not None and got[0] == 0 else "dense"

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "compact":
            rc = lib.maxplus_fold_compact(
                _ptr(rec), _ptr(s0), _ptr(idx), _ptr(arrivals),
                _ptr(extras), _ptr(energy), _ptr(out), _ptr(acc), b, m, n,
                p, t_steps, stream)
        else:
            rc = lib.maxplus_fold(
                _ptr(mats), _ptr(s0), _ptr(idx), _ptr(gvec),
                _ptr(arrivals), _ptr(wvec), _ptr(extras), _ptr(energy),
                _ptr(out), _ptr(acc), b, m, n, p, t_steps, stream)
    _raise_on(lib, rc, f"maxplus_fold ({route} route)")
    _launched("periodic" if idx is None else "indexed", route)
    return out if acc is None else (out, acc)


def maxplus_fold_many_kernel(mats: torch.Tensor, gvec: torch.Tensor,
                             idx: torch.Tensor, arrivals: torch.Tensor,
                             s0: torch.Tensor, lengths: torch.Tensor, *,
                             extras: torch.Tensor | None = None,
                             wvec: torch.Tensor | None = None,
                             with_arrivals: bool = True) -> torch.Tensor:
    """Folded states [B, N] of B traces in one launch, one warp (compact
    route) or one block (dense route) per lane.

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
    g_arr = (gvec, arrivals) if with_arrivals else (None, None)

    # the compact route where the shapes allow it: pre-pass, then one read
    # of the range checks and the pre-pass's flag
    rec = refused = None
    if (t < compact.MAX_STEPS and m1 > 0
            and lib.maxplus_fold_many_compact_smem(m1, n, b)
            <= lib.maxplus_smem_optin()):
        rec, refused = maxplus_compact_kernel(
            mats, g_arr[0], wvec, s0=s0, arrivals=g_arr[1], extras=extras,
            lengths=lengths)
    checks = [refused] if refused is not None else []
    checks += list(torch.aminmax(lengths))
    if t:
        checks += list(torch.aminmax(idx))
    got = _read_checks(checks)
    flag, got = (got[0], got[1:]) if refused is not None else (1, got)
    lo, hi = got[:2]
    if lo < 0 or hi > t:
        raise ValueError(f"lengths out of range: [{lo}, {hi}] for T = {t}")
    if t:
        lo, hi = got[2:4]
        if lo < 0 or hi >= m1:
            raise ValueError(f"idx out of range: [{lo}, {hi}] for M1 = {m1}")
    route = "compact" if flag == 0 else "dense"

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "compact":
            rc = lib.maxplus_fold_many_compact(
                _ptr(rec), _ptr(idx), _ptr(g_arr[1]), _ptr(extras),
                _ptr(s0), _ptr(lengths), _ptr(out), b, m1, n, t, stream)
        else:
            rc = lib.maxplus_fold_many(
                _ptr(mats), _ptr(g_arr[0]), _ptr(wvec), _ptr(idx),
                _ptr(g_arr[1]), _ptr(extras), _ptr(s0), _ptr(lengths),
                _ptr(out), b, n, t, stream)
    _raise_on(lib, rc, f"maxplus_fold_many ({route} route)")
    _launched("many", route)
    return out


def smem_bytes(branch: str, m: int, n: int, *, p: int = 0,
               lanes: int = 1) -> int:
    """Dynamic shared memory of a compact-route launch (``branch`` "many"
    for K3 with ``lanes`` lanes, else K1/K2 with ``p`` energy phases)."""
    lib = _library()
    if branch == "many":
        return int(lib.maxplus_fold_many_compact_smem(m, n, lanes))
    return int(lib.maxplus_fold_compact_smem(m, n, p))


def _ptr(x):
    return None if x is None else x.data_ptr()


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.maxplus_fold_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
