"""Causal / sliding-window GQA flash attention — the hand-written CUDA
kernels' wrapper.

``flash_attention_bhsd`` computes ``softmax(q kᵀ / √D + mask) v`` for
q [B, H, Sq, D] and k, v [B, KVH, Sk, D] (query head h reads kv head
``h // (H // KVH)``), with the causal mask on positions ``q_offset + i``
against ``j`` and an optional sliding window.  The kernels, in
``src/repro_torch/csrc/flash_attention.cu``, say which TPU kernel they
replace and what bounds them.

Head dims below 16 (granite-3-2b's SMOKE config has 8) are zero-padded
to 16 and launched there with the scale of the real head dim: the zero
lanes add nothing to q·k, and the output's padded lanes are dropped.
The padding copies q, k and v; the kernel still computes.

Two routes, picked by dtype (``route``): bfloat16 goes to the tensor-core
kernel (wgmma, TMA), float32 to the CUDA-core kernel, since a bf16 or TF32
tensor-core product cannot meet the float32 bar.  For tensors on the CPU
the wrapper runs the plain version (``ref.attention_reference``); for
CUDA tensors it launches the route's kernel on the current stream or
raises — a missing compiler or a refused launch is an error, never a
fallback.  ``LAUNCHES`` counts the launches of each route, so a run can
show which kernel its path went through.

Asked for it (``with_lse=True``), the forward also writes each query
row's log-sum-exp ``m + log l`` [B, H, Sq] in float32, which
``flash_attention_bwd_bhsd`` takes with q, k, v, o and the output's
gradient to give dq, dk and dv, in two routes picked by dtype as the
forward's: bfloat16 through the tensor-core backward (wgmma, TMA),
float32 through the CUDA-core one.  ``BACKWARD_LAUNCHES`` counts its
calls in all (``BWD``) and per route; on the CPU it runs
``ref.attention_backward_reference``.

Both wrappers also take caller positions ``q_pos`` [B, Sq] and ``k_pos``
[B, Sk] (integer tensors, one row a batch entry; the mask then reads
them in place of ``q_offset + i`` and ``j``) and a logit ``softcap``
(``cap tanh(s / cap)`` on the scaled scores, as the JAX package's
``AttnSpec.softcap``).  Either sends the call to the kernels' EXT
instantiations (a cap alone with positions ``q_offset + arange`` /
``arange`` built on the device), after a pre-pass over the positions
into an int32 scratch; ``EXT_LAUNCHES`` counts those calls per route
beside the route totals.

On meta tensors (the dry run's plan of the card's path) both wrappers
check their arguments and make the allocations they make on the card —
the output, the lse when asked, the backward's delta / lse scratch and
its per-split dk / dv partial sums, the positions' scratch — then skip
the launch and report its flops and bytes to ``kernels.work``: the
forward ``tiles.computed_flops``, the backward ``bwd_flops``, both of
the index schedule (meta positions have no values).  No launch is
counted.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import work
from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention import tiles
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference, attention_lse_reference,
    attention_reference)

SOURCE = "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
TC, F32 = "flash_attention_tc", "flash_attention_f32"
_KERNEL_IDS = {F32: 0, TC: 1}     # the route's number in the C interface

BWD = "flash_attention_bwd"
#: the backward's route of each forward route
BWD_ROUTES = {TC: "flash_attention_bwd/tc", F32: "flash_attention_bwd/f32"}
_BWD_SMEM_IDS = {"dkdv": 2, "dq": 3}   # the tensor-core backward's kernels

#: Kernel launches of each route since the last ``reset_launches()``.
LAUNCHES = {TC: 0, F32: 0}
#: Calls of the backward kernels (a row pass, dk/dv, on the tensor cores
#: the sum of a split group's partials, dq), in all and per route.
BACKWARD_LAUNCHES = {BWD: 0, **{key: 0 for key in BWD_ROUTES.values()}}
#: Of those, the calls of the EXT instantiations (positions, soft cap),
#: per forward and backward route.
EXT_KEYS = {name: f"{name}/ext" for name in (TC, F32, *BWD_ROUTES.values())}
EXT_LAUNCHES = {key: 0 for key in EXT_KEYS.values()}


def reset_launches() -> None:
    for counts in (LAUNCHES, BACKWARD_LAUNCHES, EXT_LAUNCHES):
        for key in counts:
            counts[key] = 0


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
        # positions, their batch strides, their scratch, the soft cap
        ext = [ptr, ctypes.c_longlong, ptr, ctypes.c_longlong, ptr,
               ctypes.c_float]
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_int] + [ptr] * 4 + [ctypes.c_int] * 9
            + [ctypes.c_float, ptr] + [ctypes.c_int] * 3 + [ptr] + ext
            + [ptr])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_bwd.argtypes = (
            [ctypes.c_int] + [ptr] * 10 + [ctypes.c_int] * 7
            + [ctypes.c_float, ptr, ptr, ctypes.c_int, ctypes.c_int] + ext
            + [ptr])
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_pos_scratch_ints.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_pos_scratch_ints.restype = ctypes.c_longlong
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check_softcap(softcap) -> None:
    if softcap is not None and not (math.isfinite(softcap) and softcap > 0):
        raise ValueError(f"softcap must be a finite positive float or None, "
                         f"got {softcap}")


def _positions(q_pos, k_pos, softcap, b: int, sq: int, sk: int,
               q_offset: int, device):
    """The EXT instantiations' positions: int32 [B, Sq] and [B, Sk] views
    with a contiguous sequence on ``device`` (converted or built there,
    never read by the host), or (None, None) for the index path (no
    positions, no cap).  A missing one of the two is ``q_offset + arange``
    / ``arange``."""
    if q_pos is None and k_pos is None and softcap is None:
        return None, None
    out = []
    for arg, x, n, off in (("q_pos", q_pos, sq, q_offset),
                           ("k_pos", k_pos, sk, 0)):
        if x is None:
            x = (off + torch.arange(n, dtype=torch.int32, device=device)
                 )[None].expand(b, n)
        if x.dtype.is_floating_point or x.dtype.is_complex or \
                x.dtype == torch.bool:
            raise TypeError(f"{arg} must be an integer tensor, got {x.dtype}")
        if tuple(x.shape) != (b, n):
            raise ValueError(f"{arg} has shape {tuple(x.shape)}, expected "
                             f"{(b, n)}")
        if x.device != device:
            raise ValueError(f"{arg} is on {x.device}, q on {device}")
        x = x.to(torch.int32)
        if n > 1 and x.stride(1) != 1:
            x = x.contiguous()
        out.append(x)
    return tuple(out)


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         q_offset: int = 0,
                         out: torch.Tensor | None = None,
                         with_lse: bool = False, q_pos=None, k_pos=None,
                         softcap: float | None = None):
    """[B, H, Sq, D] attention output in q.dtype; with ``with_lse`` the
    pair (output, lse [B, H, Sq] float32).

    q, k, v may be strided views (the grouped model layout is read in
    place) as long as the head dimension is contiguous; ``out`` is an
    optional [B, H, Sq, D] destination view of the same kind.  D is one
    of ``HEAD_DIMS``, or below the first of them (then zero-padded to
    it, in copies).  ``q_pos`` [B, Sq], ``k_pos`` [B, Sk] (integers) and
    ``softcap``: see the module docstring; positions take q_offset 0."""
    _check_softcap(softcap)
    if q.device.type == "cpu":
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  q_pos=q_pos, k_pos=k_pos, softcap=softcap)
        o = attention_reference(q, k, v, **kw)
        if out is not None:
            out.copy_(o)
            o = out
        if not with_lse:
            return o
        return o, attention_lse_reference(q, k, **kw)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bhsd runs on cuda, cpu or meta "
                         f"tensors, got {q.device}")
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
    if d not in HEAD_DIMS and not 0 < d < HEAD_DIMS[0]:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS}, "
                         f"or below {HEAD_DIMS[0]}, zero-padded to it)")
    name = route(q.dtype)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q_pos is not None and q_offset:
        raise ValueError("q_pos replaces q_offset, which must then be 0")
    qp, kp = _positions(q_pos, k_pos, softcap, b, sq, sk, q_offset,
                        q.device)
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
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b == 0 or h == 0 or sq == 0:
        return (out, lse) if with_lse else out
    if sk == 0:
        raise ValueError("attention over zero keys")
    scale = 1.0 / math.sqrt(d)
    if d < HEAD_DIMS[0]:
        pad = HEAD_DIMS[0] - d
        qp_, kp_, vp_ = (F.pad(x, (0, pad)) for x in (q, k, v))
        op = torch.empty(qp_.shape, dtype=q.dtype, device=q.device)
        _launch(name, qp_, kp_, vp_, op, causal, window, q_offset, scale,
                lse, qp, kp, softcap)
        out.copy_(op[..., :d])
    else:
        _launch(name, q, k, v, out, causal, window, q_offset, scale, lse,
                qp, kp, softcap)
    return (out, lse) if with_lse else out


def _pos_scratch(qp, b: int, sq: int, sk: int, device):
    """The int32 scratch the pre-pass fills (None on the index path)."""
    if qp is None:
        return None
    return torch.empty((tiles.pos_scratch_ints(b, sq, sk),),
                       dtype=torch.int32, device=device)


def _ext_args(qp, kp, scratch, softcap) -> list:
    """The C entry points' trailing EXT arguments: positions, their batch
    strides, the scratch and the cap; null / 0 on the index path."""
    if qp is None:
        return [None, 0, None, 0, None, 0.0]
    return [qp.data_ptr(), qp.stride(0), kp.data_ptr(), kp.stride(0),
            scratch.data_ptr(), float(softcap or 0.0)]


def _launch(name, q, k, v, out, causal, window, q_offset, scale,
            lse=None, qp=None, kp=None, softcap=None) -> None:
    """One launch of route ``name``'s kernel on checked tensors (on meta
    tensors: its work reported, no launch); ``qp``, ``kp`` (int32, from
    ``_positions``) and ``softcap`` select the EXT instantiation."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    bq, bk = tile(name, d)
    scratch = _pos_scratch(qp, b, sq, sk, q.device)
    if q.device.type == "meta":
        work.report(name, tiles.computed_flops(
            b, h, d, sq=sq, sk=sk, causal=causal, window=window,
            q_offset=q_offset, bq=bq, bk=bk),
            work.tensor_bytes(q, k, v, out, *(() if lse is None else (lse,))))
        return
    strides = [s for x in (q, k, v, out) for s in _strides(x)]
    if name == TC:
        _check_tma((("q", q), ("k", k), ("v", v)), (("out", out),))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            _KERNEL_IDS[name], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, kvh, sq, sk, d, int(causal),
            0 if window is None else int(window),
            0 if qp is not None else int(q_offset),   # positions carry it
            scale, (ctypes.c_longlong * 12)(*strides), bq, bk,
            tiles.n_q_tiles(sq, bq), None if lse is None else lse.data_ptr(),
            *_ext_args(qp, kp, scratch, softcap), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: error {rc} "
                           f"({msg})")
    LAUNCHES[name] += 1
    if qp is not None:
        EXT_LAUNCHES[EXT_KEYS[name]] += 1


def flash_attention_bwd_bhsd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             dq: torch.Tensor | None = None,
                             dk: torch.Tensor | None = None,
                             dv: torch.Tensor | None = None, q_pos=None,
                             k_pos=None, softcap: float | None = None):
    """(dq, dk, dv) of ``flash_attention_bhsd`` for the output gradient
    ``do``, from its output ``o`` and ``lse`` (``with_lse=True``).

    q, o, do [B, H, S, D]; k, v [B, KVH, S, D]; lse [B, H, S] float32;
    all one dtype (float32 or bfloat16), strided views allowed as long as
    the head dimension is contiguous (``dq``, ``dk``, ``dv``: optional
    destination views of the same kind).  Self-attention only: queries
    at positions 0..S-1 over as many keys (Sq == Sk); anything else
    raises.  bfloat16 takes the tensor-core kernels, which read q, k, v
    and do through TMA: a layout TMA cannot read raises.  ``q_pos``,
    ``k_pos`` ([B, S] each) and ``softcap`` as the forward's."""
    _check_softcap(softcap)
    if q.device.type == "cpu":
        grads = attention_backward_reference(
            q, k, v, o, do, lse, causal=causal, window=window, q_pos=q_pos,
            k_pos=k_pos, softcap=softcap)
        return tuple(g if dst is None else dst.copy_(g)
                     for g, dst in zip(grads, (dq, dk, dv)))
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd_bhsd runs on cuda, cpu or "
                         f"meta tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k, v, o, do must be [B, H, S, D]")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if k.shape[2] != s:
        raise ValueError(f"the backward takes self-attention only (Sq == "
                         f"Sk), got Sq {s}, Sk {k.shape[2]}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} kv "
                         "heads")
    route(q.dtype)      # float32 or bfloat16, else TypeError
    if d not in HEAD_DIMS and not 0 < d < HEAD_DIMS[0]:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS}, "
                         f"or below {HEAD_DIMS[0]}, zero-padded to it)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    qp, kp = _positions(q_pos, k_pos, softcap, b, s, s, 0, q.device)
    if dq is None:
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dk is None:
        dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    if dv is None:
        dv = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    for arg, x, shape in (("k", k, (b, kvh, s, d)), ("v", v, (b, kvh, s, d)),
                          ("o", o, (b, h, s, d)), ("do", do, (b, h, s, d)),
                          ("dq", dq, (b, h, s, d)), ("dk", dk, (b, kvh, s, d)),
                          ("dv", dv, (b, kvh, s, d))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{arg} has shape {tuple(x.shape)}, expected "
                             f"{shape}")
        if x.dtype != q.dtype:
            raise TypeError(f"{arg} is {x.dtype}, q is {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"{arg} is on {x.device}, q on {q.device}")
    for arg, x in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                   ("dq", dq), ("dk", dk), ("dv", dv)):
        if x.stride(3) != 1:
            raise ValueError(f"{arg} needs a contiguous head dimension")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 {(b, h, s)} "
                         f"tensor on {q.device}")
    if b == 0 or h == 0 or s == 0:
        return dq, dk, dv
    scale = 1.0 / math.sqrt(d)
    if d < HEAD_DIMS[0]:
        pad = HEAD_DIMS[0] - d
        padded = [F.pad(x, (0, pad)) for x in (q, k, v, o, do)]
        outs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                for x in padded[:3]]
        _launch_bwd(*padded, lse, *outs, causal, window, scale, qp, kp,
                    softcap)
        for dst, src in zip((dq, dk, dv), outs):
            dst.copy_(src[..., :d])
    else:
        _launch_bwd(q, k, v, o, do, lse, dq, dk, dv, causal, window, scale,
                    qp, kp, softcap)
    return dq, dk, dv


def _launch_bwd(q, k, v, o, do, lse, dq, dk, dv, causal, window,
                scale, qp=None, kp=None, softcap=None) -> None:
    """One call of the route's backward kernels on checked tensors (on
    meta tensors: the scratch allocated and the work reported, no
    launch); ``qp``, ``kp`` and ``softcap`` select the EXT
    instantiations."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    name = route(q.dtype)
    tensor_cores = name == TC
    if tensor_cores and q.device.type != "meta":
        _check_tma((("q", q), ("k", k), ("v", v), ("do", do)),
                   (("dq", dq), ("dk", dk), ("dv", dv)))
    s_pad = tiles.bwd_pad_rows(s) if tensor_cores else s
    splits = tiles.dkdv_splits(b, kvh, s, h // kvh) if tensor_cores else 1
    # delta (and, for the tensor cores, lse log2 e before it; then the
    # dk/dv blocks' partial sums when a group is split)
    n = (2 if tensor_cores else 1) * b * h * s_pad
    if splits > 1:
        n += splits * 2 * b * kvh * s * d
    scratch = torch.empty((n,), dtype=torch.float32, device=q.device)
    pos_scratch = _pos_scratch(qp, b, s, s, q.device)
    if q.device.type == "meta":
        work.report(BWD_ROUTES[name], bwd_flops(b, h, s, d, causal, window,
                                                tensor_cores),
                    work.tensor_bytes(q, k, v, o, do, lse, dq, dk, dv))
        return
    strides = [st for x in (q, k, v, o, do, dq, dk, dv) for st in _strides(x)]
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            _KERNEL_IDS[name], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kvh, s, d,
            int(causal), 0 if window is None else int(window), scale,
            (ctypes.c_longlong * 24)(*strides),
            (ctypes.c_int * 4)(*tiles.bwd_tiles(tensor_cores, d)), s_pad,
            splits, *_ext_args(qp, kp, pos_scratch, softcap), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{BWD_ROUTES[name]} kernel launch failed: error "
                           f"{rc} ({msg})")
    BACKWARD_LAUNCHES[BWD] += 1
    BACKWARD_LAUNCHES[BWD_ROUTES[name]] += 1
    if qp is not None:
        EXT_LAUNCHES[EXT_KEYS[BWD_ROUTES[name]]] += 1


def bwd_flops(b: int, h: int, s: int, d: int, causal: bool,
              window: int | None, tensor_cores: bool) -> float:
    """Matrix-product flops of one backward call: 10 d for every (query,
    key) pair of the dk/dv blocks' visited tiles (q·kᵀ again, dO·vᵀ, pᵀ·dO,
    dsᵀ·q and ds·k), over batch and heads."""
    _, _, bk, bq = tiles.bwd_tiles(tensor_cores, d)
    visited = sum(len(row) for row in tiles.dkdv_schedule(
        s=s, causal=causal, window=window, bk=bk, bq=bq))
    return 10.0 * d * bk * bq * visited * b * h


def smem_bytes(name: str, d: int) -> int:
    """Dynamic shared memory a block of route ``name`` takes at head dim d
    (builds the kernels)."""
    return _library().flash_attention_smem_bytes(_KERNEL_IDS[name], d)


def bwd_smem_bytes(d: int) -> tuple[int, int]:
    """Dynamic shared memory of a dk/dv block and of a dq block of the
    tensor-core backward at head dim d (builds the kernels)."""
    lib = _library()
    return tuple(lib.flash_attention_smem_bytes(_BWD_SMEM_IDS[k], d)
                 for k in ("dkdv", "dq"))


def _strides(x: torch.Tensor) -> list[int]:
    """(batch, head, sequence) element strides; a dimension of size 1 is
    never stepped, so it gets 8 (16 bytes in bf16, as TMA asks)."""
    return [s if n > 1 else 8 for n, s in zip(x.shape[:3], x.stride()[:3])]


def _check_tma(read, written) -> None:
    """The tensor-core kernels read their inputs ``read`` ((name, tensor)
    pairs) through TMA, which needs 16-byte aligned bases and strides, and
    store bf16 pairs of their outputs ``written``."""
    for arg, x in read:
        if x.data_ptr() % 16 or any(s * 2 % 16 for s in _strides(x)):
            raise ValueError(
                f"{arg} needs a 16-byte aligned base and (batch, head, "
                f"sequence) strides that are multiples of 8 elements for the "
                f"tensor-core kernel, got strides {tuple(x.stride())}")
    for arg, x in written:
        if x.data_ptr() % 4 or any(s % 2 for s in _strides(x)):
            raise ValueError(f"{arg} needs a 4-byte aligned base and even "
                             f"strides, got {tuple(x.stride())}")
