"""Causal / sliding-window GQA flash attention — the hand-written CUDA
kernels' wrapper.

``flash_attention_bhsd`` computes ``softmax(q kᵀ / √D + mask) v`` for
q [B, H, Sq, D] and k, v [B, KVH, Sk, D] (query head h reads kv head
``h // (H // KVH)``), with the causal mask on positions ``q_offset + i``
against ``j`` and an optional sliding window.  The kernels, in
``src/repro_torch/csrc/flash_attention.cuh`` (built by ``flash_attention.cu``
and ``flash_attention_ext.cu``), say which TPU kernel they
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
them in place of ``q_offset + i`` and ``j``), or their ``plan``
(``plan.PosPlan``, made once a model forward), and a logit ``softcap``
(``cap tanh(s / cap)`` on the scaled scores, as the JAX package's
``AttnSpec.softcap``).  Either sends the call to the kernels' EXT
instantiations (``csrc/flash_attention_ext.cu``), which work in position
order: positions without a plan get one built here, a cap alone the
identity plan.  The band the kernels walk is made once a (plan, causal,
window) by the pre-pass ``flash_pos_band`` (``pos_band``); on the
tensor-core route a plan with permutations has ``flash_pos_gather`` write
sorted copies of q, k and v first.  ``EXT_LAUNCHES`` counts the EXT calls
per route beside the route totals, ``PREP_LAUNCHES`` the two pre-passes,
``CHUNK_LAUNCHES`` the index path's forward and backward calls on a query
chunk (``q_offset`` > 0 or Sq < Sk).

On meta tensors (the dry run's plan of the card's path) both wrappers
check their arguments and make the allocations they make on the card —
the output, the lse when asked, the backward's delta / lse scratch and
its per-split dk / dv partial sums, the plan's sort and band, the sorted
copies — then skip the launch and report its flops and bytes to
``kernels.work``: the forward ``tiles.computed_flops``, the backward
``bwd_flops``, both of the index schedule (meta positions have no
values).  No launch is counted.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import work
from repro_torch.kernels.build import load
from repro_torch.kernels.flash_attention import tiles
from repro_torch.kernels.flash_attention.plan import PosPlan
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference, attention_lse_reference,
    attention_reference)

SOURCE = "flash_attention.cu"
#: the EXT instantiations and the plan's pre-pass, built beside SOURCE
EXT_SOURCE = "flash_attention_ext.cu"
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
#: Launches of the EXT path's pre-passes: the plan's band (once a plan,
#: causal and window) and the sorted copies of the tensor-core route.
BAND, GATHER = "flash_pos_band", "flash_pos_gather"
PREP_LAUNCHES = {BAND: 0, GATHER: 0}
#: Of the index path's launches, those on a query chunk (q_offset > 0 or
#: Sq < Sk: the sequence-sharded attention of tensor parallelism), forward
#: and backward.
CHUNK_FWD, CHUNK_BWD = "flash_attention/chunk", "flash_attention_bwd/chunk"
CHUNK_LAUNCHES = {CHUNK_FWD: 0, CHUNK_BWD: 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, BACKWARD_LAUNCHES, EXT_LAUNCHES, PREP_LAUNCHES,
                   CHUNK_LAUNCHES):
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


_PTR = ctypes.c_void_p
#: the index entry points' arguments
_FWD_ARGS = ([ctypes.c_int] + [_PTR] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, _PTR] + [ctypes.c_int] * 3 + [_PTR])
_BWD_ARGS = ([ctypes.c_int] + [_PTR] * 10 + [ctypes.c_int] * 9
             + [ctypes.c_float, _PTR, _PTR, ctypes.c_int, ctypes.c_int])
#: the position of the backward's q_offset among them (the EXT entry point
#: takes none: the positions carry it)
_BWD_Q_OFFSET = 16
#: the EXT entry points': q_perm, k_perm, band, the sorted copies, the cap
_PLAN_ARGS = [_PTR] * 4 + [ctypes.c_float]


def _library() -> ctypes.CDLL:
    """The index kernels' library (``SOURCE``)."""
    lib = load(SOURCE)
    if not getattr(lib, "_repro_bound", False):
        lib.flash_attention_fwd.argtypes = _FWD_ARGS + [_PTR]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_bwd.argtypes = _BWD_ARGS + [_PTR]
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _ext_library() -> ctypes.CDLL:
    """The EXT instantiations' library (``EXT_SOURCE``)."""
    lib = load(EXT_SOURCE)
    if not getattr(lib, "_repro_bound", False):
        # the forward's arguments without q_offset
        fwd = _FWD_ARGS[:13] + _FWD_ARGS[14:]
        lib.flash_attention_ext_fwd.argtypes = fwd + _PLAN_ARGS + [_PTR]
        lib.flash_attention_ext_fwd.restype = ctypes.c_int
        bwd = _BWD_ARGS[:_BWD_Q_OFFSET] + _BWD_ARGS[_BWD_Q_OFFSET + 1:]
        lib.flash_attention_ext_bwd.argtypes = bwd + _PLAN_ARGS + [_PTR]
        lib.flash_attention_ext_bwd.restype = ctypes.c_int
        lib.flash_attention_pos_band.argtypes = (
            [_PTR, ctypes.c_longlong, _PTR, ctypes.c_longlong]
            + [ctypes.c_int] * 5 + [_PTR, _PTR])
        lib.flash_attention_pos_band.restype = ctypes.c_int
        lib.flash_attention_pos_gather.argtypes = (
            [ctypes.c_int] + [_PTR] * 6 + [ctypes.c_int] * 3 + [_PTR])
        lib.flash_attention_pos_gather.restype = ctypes.c_int
        lib.flash_attention_pos_scratch_ints.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_pos_scratch_ints.restype = ctypes.c_longlong
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check_rc(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: error {rc} "
                           f"({msg})")


def _check_softcap(softcap) -> None:
    if softcap is not None and not (math.isfinite(softcap) and softcap > 0):
        raise ValueError(f"softcap must be a finite positive float or None, "
                         f"got {softcap}")


def _plan(plan, q_pos, k_pos, softcap, b: int, sq: int, sk: int,
          q_offset: int, device):
    """The EXT instantiations' plan, or None for the index path (no
    positions, no cap): the caller's (checked against the call), one built
    from q_pos / k_pos (a missing one of the two is ``q_offset + arange``
    / ``arange``), or for a cap alone the identity plan."""
    if plan is not None:
        if q_pos is not None or k_pos is not None:
            raise ValueError("give positions or their plan, not both")
        if q_offset:
            raise ValueError("a plan's positions replace q_offset, which "
                             "must then be 0")
        if (plan.b, plan.sq, plan.sk) != (b, sq, sk) or plan.device != device:
            raise ValueError(f"the plan is of [{plan.b}, {plan.sq}] queries "
                             f"and {plan.sk} keys on {plan.device}, the call "
                             f"[{b}, {sq}] and {sk} on {device}")
        return plan
    if q_pos is None and k_pos is None:
        return None if softcap is None else PosPlan.identity(
            b, sq, sk, q_offset, device)
    return PosPlan.build(q_pos, k_pos, b=b, sq=sq, sk=sk, q_offset=q_offset,
                         device=device)


def pos_band(plan: PosPlan, causal: bool, window: int | None
             ) -> torch.Tensor:
    """The plan's band for (causal, window): int32, ``tiles.
    pos_scratch_ints(B, Sq, Sk)`` of them, made by ``flash_pos_band`` on
    the first call and kept in ``plan.bands`` (on meta tensors allocated
    only)."""
    key = (bool(causal), int(window or 0))
    band = plan.bands.get(key)
    if band is not None:
        return band
    # zeroed: the pre-pass's blocks add the hull to it by atomicMax
    band = torch.zeros((tiles.pos_scratch_ints(plan.b, plan.sq, plan.sk),),
                       dtype=torch.int32, device=plan.device)
    if plan.device.type != "meta":
        lib = _ext_library()
        qs, ks = plan.q_sorted, plan.k_sorted
        with torch.cuda.device(plan.device):
            rc = lib.flash_attention_pos_band(
                qs.data_ptr(), qs.stride(0) if qs.shape[0] > 1 else 0,
                ks.data_ptr(), ks.stride(0) if ks.shape[0] > 1 else 0,
                plan.b, plan.sq, plan.sk, key[0], key[1], band.data_ptr(),
                torch.cuda.current_stream(plan.device).cuda_stream)
        _check_rc(lib, rc, BAND)
        PREP_LAUNCHES[BAND] += 1
    plan.bands[key] = band
    return band


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         q_offset: int = 0,
                         out: torch.Tensor | None = None,
                         with_lse: bool = False, q_pos=None, k_pos=None,
                         softcap: float | None = None,
                         plan: PosPlan | None = None):
    """[B, H, Sq, D] attention output in q.dtype; with ``with_lse`` the
    pair (output, lse [B, H, Sq] float32).

    q, k, v may be strided views (the grouped model layout is read in
    place) as long as the head dimension is contiguous; ``out`` is an
    optional [B, H, Sq, D] destination view of the same kind.  D is one
    of ``HEAD_DIMS``, or below the first of them (then zero-padded to
    it, in copies).  ``q_pos`` [B, Sq], ``k_pos`` [B, Sk] (integers) or
    their ``plan``, and ``softcap``: see the module docstring; positions
    take q_offset 0."""
    _check_softcap(softcap)
    if q.device.type == "cpu":
        if plan is not None:
            q_pos, k_pos = plan.q_pos, plan.k_pos
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
    plan = _plan(plan, q_pos, k_pos, softcap, b, sq, sk, q_offset, q.device)
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
                lse, plan, softcap)
        out.copy_(op[..., :d])
    else:
        _launch(name, q, k, v, out, causal, window, q_offset, scale, lse,
                plan, softcap)
    return (out, lse) if with_lse else out


def _sorted_copies(plan, tensor_cores: bool, q, k, backward: bool):
    """Room for the sorted copies the C entry point writes before the
    tensor-core kernels (``flash_pos_gather``: q [B, H, Sq, D] and k, v
    [B, KVH, Sk, D]; the backward's row pass adds dO [B, H, S, D]), or None
    where the kernels read the operands in place: the CUDA-core route
    gathers in its loads, and an identity plan needs no copy."""
    if plan is None or not tensor_cores or plan.sorted_in_place:
        return None
    n = (2 if backward else 1) * q.numel() + 2 * k.numel()
    return torch.empty((n,), dtype=q.dtype, device=q.device)


def gather_sorted(plan: PosPlan, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Contiguous copies of q [B, H, Sq, D] and k, v [B, KVH, Sk, D] with
    their rows in the plan's sorted order (row r of batch b is row
    ``q_perm[b, r]``, ``k_perm[b, r]``): one launch of
    ``flash_pos_gather``, the kernel the tensor-core EXT calls run first
    (on meta tensors the copies only)."""
    outs = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device)
                 for x in (q, k, v))
    if q.device.type == "meta":
        return outs
    xs = (q, k, v)
    perms = (plan.q_perm, plan.k_perm, plan.k_perm)
    ptrs = ctypes.c_void_p * 3
    lib = _ext_library()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_pos_gather(
            3, ptrs(*(x.data_ptr() for x in xs)),
            ptrs(*(x.data_ptr() for x in outs)),
            ptrs(*(x.data_ptr() for x in perms)),
            (ctypes.c_longlong * 9)(*(st for x in xs for st in _strides(x))),
            (ctypes.c_int * 3)(*(x.shape[1] for x in xs)),
            (ctypes.c_int * 3)(*(x.shape[2] for x in xs)), q.shape[0],
            q.shape[3] * q.element_size(), q.element_size(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(lib, rc, GATHER)
    PREP_LAUNCHES[GATHER] += 1
    return outs


def _plan_args(plan, band, sorted_, softcap) -> list:
    """The EXT entry points' trailing arguments."""
    return [None if plan.q_perm is None else plan.q_perm.data_ptr(),
            None if plan.k_perm is None else plan.k_perm.data_ptr(),
            band.data_ptr(), None if sorted_ is None else sorted_.data_ptr(),
            float(softcap or 0.0)]


def _launch(name, q, k, v, out, causal, window, q_offset, scale,
            lse=None, plan=None, softcap=None) -> None:
    """One launch of route ``name``'s kernel on checked tensors (on meta
    tensors: its work reported, no launch); a ``plan`` (from ``_plan``)
    selects the EXT instantiation."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    bq, bk = tile(name, d)
    if plan is not None:
        band = pos_band(plan, causal, window)
        sorted_ = _sorted_copies(plan, name == TC, q, k, False)
    if q.device.type == "meta":
        work.report(name, tiles.computed_flops(
            b, h, d, sq=sq, sk=sk, causal=causal, window=window,
            q_offset=q_offset, bq=bq, bk=bk),
            work.tensor_bytes(q, k, v, out, *(() if lse is None else (lse,))))
        return
    strides = [s for x in (q, k, v, out) for s in _strides(x)]
    if name == TC:
        _check_tma((("q", q), ("k", k), ("v", v)), (("out", out),))
    lib = _library() if plan is None else _ext_library()
    args = [_KERNEL_IDS[name], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, kvh, sq, sk, d, int(causal),
            0 if window is None else int(window), int(q_offset), scale,
            (ctypes.c_longlong * 12)(*strides), bq, bk,
            tiles.n_q_tiles(sq, bq), None if lse is None else lse.data_ptr()]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if plan is None:
            rc = lib.flash_attention_fwd(*args, stream)
        else:
            del args[13]                   # the positions carry q_offset
            rc = lib.flash_attention_ext_fwd(
                *args, *_plan_args(plan, band, sorted_, softcap), stream)
    _check_rc(lib, rc, name)
    LAUNCHES[name] += 1
    if plan is None and (q_offset or sq < sk):
        CHUNK_LAUNCHES[CHUNK_FWD] += 1
    if plan is not None:
        EXT_LAUNCHES[EXT_KEYS[name]] += 1
        if sorted_ is not None:
            PREP_LAUNCHES[GATHER] += 1


def flash_attention_bwd_bhsd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             q_offset: int = 0,
                             dq: torch.Tensor | None = None,
                             dk: torch.Tensor | None = None,
                             dv: torch.Tensor | None = None, q_pos=None,
                             k_pos=None, softcap: float | None = None,
                             plan: PosPlan | None = None):
    """(dq, dk, dv) of ``flash_attention_bhsd`` for the output gradient
    ``do``, from its output ``o`` and ``lse`` (``with_lse=True``).

    q, o, do [B, H, Sq, D]; k, v [B, KVH, Sk, D]; lse [B, H, Sq]
    float32; all one dtype (float32 or bfloat16), strided views allowed
    as long as the head dimension is contiguous (``dq``, ``dk``, ``dv``:
    optional destination views of the same kind).  Queries at positions
    ``q_offset .. q_offset + Sq - 1`` over keys 0..Sk-1 with
    ``q_offset + Sq <= Sk``: self-attention (q_offset 0, Sq == Sk) or
    one chunk of its queries against every key (the sequence-sharded
    attention of tensor parallelism), where the keys no query of the
    chunk sees get dk = dv = 0; anything else raises.  bfloat16 takes
    the tensor-core kernels, which read q, k, v and do through TMA: a
    layout TMA cannot read raises.  ``q_pos`` [B, Sq], ``k_pos`` [B, Sk]
    or their ``plan``, and ``softcap``, as the forward's (positions take
    q_offset 0, and any Sq, Sk)."""
    _check_softcap(softcap)
    if q.device.type == "cpu":
        if plan is not None:
            q_pos, k_pos = plan.q_pos, plan.k_pos
        grads = attention_backward_reference(
            q, k, v, o, do, lse, causal=causal, window=window,
            q_offset=q_offset, q_pos=q_pos, k_pos=k_pos, softcap=softcap)
        return tuple(g if dst is None else dst.copy_(g)
                     for g, dst in zip(grads, (dq, dk, dv)))
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd_bhsd runs on cuda, cpu or "
                         f"meta tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k, v, o, do must be [B, H, S, D]")
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    positions = plan is not None or q_pos is not None or k_pos is not None
    if q_offset < 0 or (not positions and q_offset + sq > sk):
        raise ValueError(f"the backward takes queries at q_offset .. "
                         f"q_offset + Sq - 1 within the Sk keys (q_offset "
                         f">= 0, q_offset + Sq <= Sk), got q_offset "
                         f"{q_offset}, Sq {sq}, Sk {sk}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} kv "
                         "heads")
    route(q.dtype)      # float32 or bfloat16, else TypeError
    if d not in HEAD_DIMS and not 0 < d < HEAD_DIMS[0]:
        raise ValueError(f"head dim {d} not supported (one of {HEAD_DIMS}, "
                         f"or below {HEAD_DIMS[0]}, zero-padded to it)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q_pos is not None and q_offset:
        raise ValueError("q_pos replaces q_offset, which must then be 0")
    plan = _plan(plan, q_pos, k_pos, softcap, b, sq, sk, q_offset, q.device)
    if plan is not None:
        q_offset = 0                  # the plan's positions carry it
    if dq is None:
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dk is None:
        dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    if dv is None:
        dv = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    qs, ks = (b, h, sq, d), (b, kvh, sk, d)
    for arg, x, shape in (("k", k, ks), ("v", v, ks), ("o", o, qs),
                          ("do", do, qs), ("dq", dq, qs), ("dk", dk, ks),
                          ("dv", dv, ks)):
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
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 {(b, h, sq)} "
                         f"tensor on {q.device}")
    if b == 0 or h == 0 or sq == 0:
        return dq, dk, dv
    scale = 1.0 / math.sqrt(d)
    if d < HEAD_DIMS[0]:
        pad = HEAD_DIMS[0] - d
        padded = [F.pad(x, (0, pad)) for x in (q, k, v, o, do)]
        outs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                for x in padded[:3]]
        _launch_bwd(*padded, lse, *outs, causal, window, q_offset, scale,
                    plan, softcap)
        for dst, src in zip((dq, dk, dv), outs):
            dst.copy_(src[..., :d])
    else:
        _launch_bwd(q, k, v, o, do, lse, dq, dk, dv, causal, window,
                    q_offset, scale, plan, softcap)
    return dq, dk, dv


def _launch_bwd(q, k, v, o, do, lse, dq, dk, dv, causal, window, q_offset,
                scale, plan=None, softcap=None) -> None:
    """One call of the route's backward kernels on checked tensors (on
    meta tensors: the scratch allocated and the work reported, no
    launch); a ``plan`` selects the EXT instantiations."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    name = route(q.dtype)
    tensor_cores = name == TC
    if tensor_cores and q.device.type != "meta":
        _check_tma((("q", q), ("k", k), ("v", v), ("do", do)),
                   (("dq", dq), ("dk", dk), ("dv", dv)))
    s_pad = tiles.bwd_pad_rows(sq) if tensor_cores else sq
    splits = tiles.dkdv_splits(b, kvh, sk, h // kvh) if tensor_cores else 1
    # delta (and, for the tensor cores, lse log2 e before it) over the
    # query rows; then the dk/dv blocks' partial sums over the keys when a
    # group is split
    n = (2 if tensor_cores else 1) * b * h * s_pad
    if splits > 1:
        n += splits * 2 * b * kvh * sk * d
    scratch = torch.empty((n,), dtype=torch.float32, device=q.device)
    if plan is not None:
        band = pos_band(plan, causal, window)
        sorted_ = _sorted_copies(plan, tensor_cores, q, k, True)
    if q.device.type == "meta":
        work.report(BWD_ROUTES[name], bwd_flops(
            b, h, sq, d, causal, window, tensor_cores, sk=sk,
            q_offset=q_offset),
                    work.tensor_bytes(q, k, v, o, do, lse, dq, dk, dv))
        return
    strides = [st for x in (q, k, v, o, do, dq, dk, dv) for st in _strides(x)]
    lib = _library() if plan is None else _ext_library()
    args = [_KERNEL_IDS[name], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kvh, sq, sk,
            int(q_offset), d, int(causal),
            0 if window is None else int(window), scale,
            (ctypes.c_longlong * 24)(*strides),
            (ctypes.c_int * 4)(*tiles.bwd_tiles(tensor_cores, d)), s_pad,
            splits]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if plan is None:
            rc = lib.flash_attention_bwd(*args, stream)
        else:
            del args[_BWD_Q_OFFSET]        # the positions carry q_offset
            rc = lib.flash_attention_ext_bwd(
                *args, *_plan_args(plan, band, sorted_, softcap), stream)
    _check_rc(lib, rc, BWD_ROUTES[name])
    BACKWARD_LAUNCHES[BWD] += 1
    BACKWARD_LAUNCHES[BWD_ROUTES[name]] += 1
    if plan is None and (q_offset or sq < sk):
        CHUNK_LAUNCHES[CHUNK_BWD] += 1
    if plan is not None:
        EXT_LAUNCHES[EXT_KEYS[BWD_ROUTES[name]]] += 1
        if sorted_ is not None:
            PREP_LAUNCHES[GATHER] += 1


def bwd_flops(b: int, h: int, s: int, d: int, causal: bool,
              window: int | None, tensor_cores: bool, *,
              sk: int | None = None, q_offset: int = 0) -> float:
    """Matrix-product flops of one backward call of ``s`` query rows at
    ``q_offset`` over ``sk`` keys (``s``: self-attention): 10 d for every
    (query, key) pair of the dk/dv blocks' visited tiles (q·kᵀ again,
    dO·vᵀ, pᵀ·dO, dsᵀ·q and ds·k), over batch and heads."""
    _, _, bk, bq = tiles.bwd_tiles(tensor_cores, d)
    visited = sum(len(row) for row in tiles.dkdv_schedule(
        sq=s, sk=s if sk is None else sk, q_offset=q_offset, causal=causal,
        window=window, bk=bk, bq=bq))
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
