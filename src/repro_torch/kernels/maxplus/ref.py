"""Plain PyTorch versions of the (max,+) folds: per design point
(``maxplus_fold_ref``) and per trace of a fleet (``maxplus_fold_many_ref``),
and the sequential matrix product ``maxplus_product_ref`` that the
log-depth strategies are held against.

These are the CUDA kernels' plain versions: the wrappers in ``kernel.py``
run them for tensors on the CPU, the tests hold them against the JAX
package, and ``chip_smoke.py`` holds the kernels against them on the card.
Every step is one correctly rounded float32 add per element followed by
an exact max, and the energy accumulator sums in op order, so any
implementation that keeps those operations reproduces it bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.maxplus_form import NEG


def _host_indices(idx, t_steps: int, m: int) -> list[int]:
    """Per-step matrix indices as host ints (one transfer, not one per
    step); None = the periodic sequence t mod M."""
    if idx is None:
        return [t % m for t in range(t_steps)]
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    return np.asarray(idx)[:t_steps].astype(np.int64).tolist()


def maxplus_fold_ref(mats: torch.Tensor, s0: torch.Tensor, *, t_steps: int,
                     idx=None, energy: torch.Tensor | None = None,
                     arrivals: torch.Tensor | None = None,
                     gvec: torch.Tensor | None = None,
                     extras: torch.Tensor | None = None,
                     wvec: torch.Tensor | None = None):
    """mats: [B, M, N, N]; s0: [B, N] -> [B, N] after t_steps ops.

    ``idx`` [t_steps] selects the matrix per step; None = periodic.
    ``arrivals`` [t_steps] + ``gvec`` [B, M, N] add the per-op
    origin-column max-in of arrival-aware traces:
    ``s' = max(A_i (x) s, gvec[i] + arrivals[t])``.
    ``extras`` [t_steps] + ``wvec`` [B, M, N] add the per-op reliability
    surcharge on the op's written rows: ``s'' = s' + wvec[i] * extras[t]``.
    With either pair given, the other defaults to its identity (NEG
    templates / zero arrivals, zero masks / zero extras).
    ``energy`` [B, M, P] also returns the [B, P] accumulator
    ``sum_t energy[:, idx[t]]``, summed in t order."""
    b, m, n, _ = mats.shape
    steps = _host_indices(idx, t_steps, m)
    side = any(x is not None for x in (arrivals, gvec, extras, wvec))
    if side:
        def zeros_t():
            return torch.zeros((t_steps,), dtype=s0.dtype, device=s0.device)
        arr = zeros_t() if arrivals is None else arrivals[:t_steps]
        ext = zeros_t() if extras is None else extras[:t_steps]
        if gvec is None:
            gvec = torch.full((b, m, n), NEG, dtype=s0.dtype,
                              device=s0.device)
        if wvec is None:
            wvec = torch.zeros((b, m, n), dtype=s0.dtype, device=s0.device)
    s = s0
    acc = None
    if energy is not None:
        acc = torch.zeros((b, energy.shape[-1]), dtype=energy.dtype,
                          device=energy.device)
    for t, i in enumerate(steps):
        s = torch.amax(mats[:, i] + s[:, None, :], dim=-1)
        if side:
            s = torch.maximum(s, gvec[:, i] + arr[t])
            s = s + wvec[:, i] * ext[t]
        if acc is not None:
            acc = acc + energy[:, i]
    if s is s0:
        s = s0.clone()
    return s if acc is None else (s, acc)


def maxplus_fold_many_ref(mats: torch.Tensor, gvec: torch.Tensor,
                          idx: torch.Tensor, arrivals: torch.Tensor,
                          s0: torch.Tensor, lengths, *,
                          extras: torch.Tensor | None = None,
                          wvec: torch.Tensor | None = None,
                          with_arrivals: bool = True) -> torch.Tensor:
    """Many-trace fold: [B, N] states of B lanes, each folding its own
    sequence against one shared dictionary.

    mats [M1, N, N], gvec/wvec [M1, N], idx [B, T] int32, arrivals/extras
    [B, T] float32, s0 [N], lengths [B] int32.  Lane b folds steps
    ``t < lengths[b]``: ``s = max_c(mats[i, r, c] + s[c])`` with
    ``i = idx[b, t]``, then ``max(s, gvec[i] + arrivals[b, t])`` if
    ``with_arrivals``, then ``s + wvec[i] * extras[b, t]`` if ``extras``
    is given — the order of the JAX megakernel's gather branch.  Steps
    past a lane's length are not run: the JAX kernel folds the identity
    op there, which leaves the state bitwise unchanged.  Lanes are taken
    longest-first (inputs not already in that order are permuted once),
    so each step works on the prefix of lanes still running."""
    b = idx.shape[0]
    lens = np.asarray(torch.as_tensor(lengths).cpu(), np.int64)
    s = s0.to(torch.float32).expand(b, -1).clone()
    if b == 0:
        return s
    order = np.argsort(-lens, kind="stable")
    permuted = not np.array_equal(order, np.arange(b))
    if permuted:
        perm = torch.as_tensor(order, device=idx.device)
        idx, arrivals = idx[perm], arrivals[perm]
        extras = None if extras is None else extras[perm]
    ends = lens[order]
    for t in range(int(ends[0])):
        n = int(np.count_nonzero(ends > t))
        it = idx[:n, t].long()
        x = torch.amax(mats[it] + s[:n, None, :], dim=-1)
        if with_arrivals:
            x = torch.maximum(x, gvec[it] + arrivals[:n, t, None])
        if extras is not None:
            x = x + wvec[it] * extras[:n, t, None]
        s[:n] = x
    if permuted:
        out = torch.empty_like(s)
        out[perm] = s
        return out
    return s


def maxplus_product_ref(mats: torch.Tensor, idx) -> torch.Tensor:
    """Sequential (max,+) *matrix* fold P = A_{idx[-1]} ⊗ … ⊗ A_{idx[0]}.

    mats: [B, M, N, N] -> [B, N, N].  Independent reference for the
    segmented/squaring strategies' matmul algebra: the product is
    computed one matmul at a time, each as the full [B, N, N, N] sum
    tensor and its max, with no chunking or squaring tricks."""
    b, m, n, _ = mats.shape
    eye = torch.full((n, n), NEG, dtype=mats.dtype, device=mats.device)
    eye.fill_diagonal_(0.0)
    p = eye.expand(b, n, n)
    for i in _host_indices(idx, len(idx), m):
        a = mats[:, i]                                       # [B, N, N]
        p = torch.amax(a[:, :, :, None] + p[:, None, :, :], dim=-2)
    return p
