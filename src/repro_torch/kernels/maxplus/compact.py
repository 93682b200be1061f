"""The compact form of the (max,+) dictionaries, in plain PyTorch.

A step matrix of the SSD recurrence is the (max,+) identity except for
the at most ``MAX_ROWS`` rows an op rewrites, each with at most
``MAX_ENTRIES`` finite entries (``repro_torch.core.maxplus_form.op_matrix``).
The compact route of the fold kernels keeps only those: a pre-pass turns
each combo's dense matrix (and its arrival-offset and written-rows rows)
into one record, and the compact folds step over the records.

This module is the CPU twin of that route in
``src/repro_torch/csrc/maxplus_fold.cu``, as ``tiles.py`` is K4's:

* ``compact`` is the pre-pass: the records and the matrix part of the
  route's precondition, computed as the kernel computes them;
  ``values_in_range`` is the rest of the precondition;
* ``pack`` lays the records out as the kernel's 32-word records, so the
  card's pre-pass can be held against it bit for bit;
* ``fold_compact_ref`` and ``fold_many_compact_ref`` fold over the
  records, the plain versions of the compact K1/K2 and K3 folds.

The precondition, and why it makes the route exact, is written out in the
``.cu`` header.  In short: every kept matrix entry, ``s0``, every gvec
value above ``NEG``, every arrival and every surcharge lies in
``[+0, LIMIT]`` with its sign bit clear; every other entry and gvec value
is ``<= NEG``; every wvec value is ``+0`` or in ``(0, 1]``; a combo
rewrites at most ``MAX_ROWS`` rows, each keeping between 1 and
``MAX_ENTRIES`` entries; a lane folds fewer than ``MAX_STEPS`` steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.maxplus_form import NEG

MAX_ROWS = 4          # rows an op rewrites: bus, ctrl, chip, round_start
MAX_ENTRIES = 4       # finite entries of such a row: bus, chip/rs, ctrl, origin
WORDS = 32            # 32-bit words of one record (128 bytes)
LIMIT = 2.0 ** 60     # values of the precondition lie in [+0, LIMIT]
MAX_STEPS = 2 ** 24   # a lane folds fewer steps than this
NEG32 = float(np.float32(NEG))
NEG_BITS = int(np.float32(NEG).view(np.uint32))        # 0xF149F2CA
LIMIT_BITS = int(np.float32(LIMIT).view(np.uint32))    # 0x5D800000
ONE_BITS = int(np.float32(1.0).view(np.uint32))        # 0x3F800000


@dataclass(frozen=True)
class Compact:
    """The records of C combos.  Row slots past ``count`` hold row 0,
    columns 0, values NEG, g NEG and w +0; a kept row with fewer than
    ``MAX_ENTRIES`` entries repeats its first one."""

    rows: torch.Tensor    # [C, MAX_ROWS] int64, ascending
    count: torch.Tensor   # [C] int64, rows kept (capped at MAX_ROWS)
    cols: torch.Tensor    # [C, MAX_ROWS, MAX_ENTRIES] int64
    vals: torch.Tensor    # [C, MAX_ROWS, MAX_ENTRIES] float32
    g: torch.Tensor       # [C, MAX_ROWS] float32
    w: torch.Tensor       # [C, MAX_ROWS] float32

    def view(self, *lead: int) -> "Compact":
        """The records with the combo axis split into ``lead``."""
        return Compact(*(x.reshape(*lead, *x.shape[1:]) for x in (
            self.rows, self.count, self.cols, self.vals, self.g, self.w)))


def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 bit patterns as non-negative int64."""
    return (x.to(torch.float32).contiguous().view(torch.int32)
            .to(torch.int64) & 0xFFFFFFFF)


def _in_range(x: torch.Tensor) -> torch.Tensor:
    """[+0, LIMIT] with the sign bit clear: no -0.0, NaN or inf."""
    return _bits(x) <= LIMIT_BITS


def _first(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``k`` true positions along the last axis, in
    order; positions past the true count hold whatever follows."""
    order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
    if order.shape[-1] < k:
        order = torch.cat([order, order[..., :1].expand(
            *order.shape[:-1], k - order.shape[-1])], dim=-1)
    return order[..., :k]


def compact(mats: torch.Tensor, gvec: torch.Tensor | None = None,
            wvec: torch.Tensor | None = None) -> tuple[Compact, bool]:
    """(records of the combos of ``mats`` [..., N, N], flattened; whether
    the matrices, gvec [..., N] and wvec [..., N] meet the precondition).
    Where they do not, the records are not used."""
    n = mats.shape[-1]
    a = mats.reshape(-1, n, n).to(torch.float32)
    c = a.shape[0]
    bits = _bits(a)
    keep = bits <= LIMIT_BITS
    bad = bool((~keep & ~(a <= NEG32)).any())
    eye = torch.eye(n, dtype=torch.bool, device=a.device)
    differs = (bits != torch.where(eye, 0, NEG_BITS)).any(-1)       # [C, N]
    g = (torch.full((c, n), NEG32, device=a.device) if gvec is None
         else gvec.reshape(c, n).to(torch.float32))
    w = (torch.zeros((c, n), device=a.device) if wvec is None
         else wvec.reshape(c, n).to(torch.float32))
    g_kept = _in_range(g)
    wb = _bits(w)
    w_kept = (wb != 0) & (wb <= ONE_BITS)
    bad |= bool((~g_kept & ~(g <= NEG32)).any()
                | (~w_kept & (wb != 0)).any())
    keep_row = differs | g_kept | w_kept
    n_keep = keep.sum(-1)                                           # [C, N]
    bad |= bool((keep_row & ((n_keep == 0) | (n_keep > MAX_ENTRIES))).any())
    n_rows = keep_row.sum(-1)
    bad |= bool((n_rows > MAX_ROWS).any())
    count = n_rows.clamp(max=MAX_ROWS)
    slot = torch.arange(MAX_ROWS, device=a.device)
    valid = slot < count[:, None]                                   # [C, 4]
    rows = torch.where(valid, _first(keep_row, MAX_ROWS), 0)
    # kept entries of every row, a short row padded with its first one
    k = torch.arange(MAX_ENTRIES, device=a.device)
    ent = _first(keep, MAX_ENTRIES)                                 # [C, N, 4]
    ent = torch.where(k < n_keep.clamp(max=MAX_ENTRIES)[..., None], ent,
                      ent[..., :1])
    vals_all = a.gather(-1, ent)
    pick = rows[..., None].expand(-1, -1, MAX_ENTRIES)
    cols = torch.where(valid[..., None], ent.gather(1, pick), 0)
    vals = torch.where(valid[..., None], vals_all.gather(1, pick),
                       torch.tensor(NEG32, device=a.device))
    g_r = torch.where(valid, g.gather(1, rows),
                      torch.tensor(NEG32, device=a.device))
    w_r = torch.where(valid, w.gather(1, rows),
                      torch.tensor(0.0, device=a.device))
    return Compact(rows, count, cols, vals, g_r, w_r), not bad


def values_in_range(x: torch.Tensor | None, lengths=None) -> bool:
    """Whether every value of ``x`` lies in [+0, LIMIT]; with ``lengths``
    [R], row r of ``x`` [R, T] only up to ``lengths[r]``."""
    if x is None:
        return True
    ok = _in_range(x)
    if lengths is not None:
        t = torch.arange(x.shape[-1], device=x.device)
        ok |= t[None, :] >= torch.as_tensor(lengths, device=x.device)[:, None]
    return bool(ok.all())


def pack(comp: Compact) -> torch.Tensor:
    """The records as the kernel's [C, WORDS] int32 layout: values, g, w,
    columns (a byte each), rows (a byte each), the row count."""
    c = comp.count.shape[0]
    cols = comp.cols.reshape(c, MAX_ROWS * MAX_ENTRIES // 4, 4)
    shift = torch.tensor([0, 8, 16, 24], device=cols.device)
    words = torch.cat([
        _bits(comp.vals.reshape(c, -1)), _bits(comp.g), _bits(comp.w),
        (cols << shift).sum(-1),
        (torch.where(torch.arange(MAX_ROWS, device=cols.device)
                     < comp.count[:, None], comp.rows, 0) << shift).sum(
                         -1, keepdim=True),
        comp.count[:, None],
        torch.zeros((c, 2), dtype=torch.int64, device=cols.device)], dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _step(rec: Compact, s: torch.Tensor, active=None):
    """One step of the compact fold for the lanes of ``s`` [L, N + 1]
    (its last column a scratch slot): per-row max over the kept
    entries, read before any write.  Returns (v [L, MAX_ROWS], rows to
    write, the scratch slot where a row is absent)."""
    n1 = s.shape[1]
    lanes = s.shape[0]
    flat = rec.cols.reshape(lanes, -1)
    v = torch.amax(rec.vals + s.gather(1, flat).reshape(rec.vals.shape),
                   dim=-1)
    valid = torch.arange(MAX_ROWS, device=s.device) < rec.count[:, None]
    if active is not None:
        valid &= active[:, None]
    return v, torch.where(valid, rec.rows, n1 - 1)


def fold_compact_ref(comp: Compact, s0: torch.Tensor, *, t_steps: int,
                     idx=None, energy: torch.Tensor | None = None,
                     arrivals: torch.Tensor | None = None,
                     extras: torch.Tensor | None = None):
    """The compact K1/K2 fold: ``comp`` holds the records of [B, M]
    combos (flattened), s0 [B, N]; ``idx`` [T] (None = periodic),
    ``arrivals`` and ``extras`` [T] together apply the records' g and w,
    ``energy`` [B, M, P] adds ``energy[:, idx[t]]`` in t order.  Equal to
    ``maxplus_fold_ref`` on the dense operands wherever ``compact``
    accepts them."""
    from repro_torch.kernels.maxplus.ref import _host_indices
    b, n = s0.shape
    m = comp.count.shape[0] // b
    rec = comp.view(b, m)
    sides = arrivals is not None
    s = torch.cat([s0.to(torch.float32),
                   torch.zeros((b, 1), device=s0.device)], dim=1)
    acc = None
    if energy is not None:
        acc = torch.zeros((b, energy.shape[-1]), dtype=energy.dtype,
                          device=energy.device)
    for t, i in enumerate(_host_indices(idx, t_steps, m)):
        step = Compact(*(x[:, i] for x in (rec.rows, rec.count, rec.cols,
                                           rec.vals, rec.g, rec.w)))
        v, rows = _step(step, s)
        if sides:
            v = torch.maximum(v, step.g + arrivals[t])
            v = v + step.w * extras[t]
        s = s.scatter(1, rows, v)
        if acc is not None:
            acc = acc + energy[:, i]
    s = s[:, :n].contiguous()
    return s if acc is None else (s, acc)


def fold_many_compact_ref(comp: Compact, idx: torch.Tensor,
                          arrivals: torch.Tensor | None,
                          extras: torch.Tensor | None, s0: torch.Tensor,
                          lengths) -> torch.Tensor:
    """The compact K3 fold: every lane b of ``idx`` [B, T] folds its first
    ``lengths[b]`` steps against the records of one union dictionary
    (``comp``, [M1] combos); ``arrivals`` [B, T] applies the records' g,
    ``extras`` [B, T] their w (each optional).  Equal to
    ``maxplus_fold_many_ref`` wherever ``compact`` accepts the dense
    operands."""
    b = idx.shape[0]
    n = s0.shape[0]
    lens = torch.as_tensor(lengths, device=idx.device).to(torch.int64)
    s = torch.cat([s0.to(torch.float32).expand(b, n),
                   torch.zeros((b, 1), device=s0.device)], dim=1)
    for t in range(int(lens.max()) if b else 0):
        active = lens > t
        i = idx[:, t].long()
        step = Compact(*(x[i] for x in (comp.rows, comp.count, comp.cols,
                                        comp.vals, comp.g, comp.w)))
        v, rows = _step(step, s, active)
        if arrivals is not None:
            v = torch.maximum(v, step.g + arrivals[:, t, None])
        if extras is not None:
            v = v + step.w * extras[:, t, None]
        s = s.scatter(1, rows, v)
    return s[:, :n].contiguous()
