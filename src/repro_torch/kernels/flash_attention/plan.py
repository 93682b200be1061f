"""The position plan of K4's EXT kernels (caller positions, the soft cap).

The mask reads positions alone, so the EXT kernels work in position order
(``csrc/flash_attention.cuh``, "caller positions"): a ``PosPlan`` holds,
for each batch row, the stable sort permutation of the query and of the key
positions and the sorted positions themselves.  It is made once a model
forward (``transformer.forward``) and handed to every attention call and
its backward; the band each (causal, window) needs is made from it once, by
the kernels' pre-pass, and kept in ``bands`` (``kernel.py``).

``PosPlan.build`` sorts with ``torch.sort(stable=True)`` on the positions'
device, a layout step; when the queries and keys share one positions
tensor it sorts once.  ``PosPlan.identity`` is the plan of positions known
sorted (``q_offset + arange`` / ``arange``: a soft cap without caller
positions): no permutation, the operands read in place, the index band.
On meta tensors the plan allocates what it allocates on the card.
"""

from __future__ import annotations

import torch


def _check(arg: str, x, n: int, b: int, device) -> torch.Tensor:
    """``x`` as an int32 [b, n] tensor on ``device`` (not read here)."""
    if x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool:
        raise TypeError(f"{arg} must be an integer tensor, got {x.dtype}")
    if tuple(x.shape) != (b, n):
        raise ValueError(f"{arg} has shape {tuple(x.shape)}, expected "
                         f"{(b, n)}")
    if x.device != device:
        raise ValueError(f"{arg} is on {x.device}, q on {device}")
    return x.to(torch.int32)


def _sort(pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the stable sort permutation, the sorted positions), int32
    contiguous [B, S]."""
    values, perm = torch.sort(pos, dim=1, stable=True)
    return perm.to(torch.int32), values.contiguous()


class PosPlan:
    """One set of caller positions in the EXT kernels' sorted order.

    ``q_pos`` / ``k_pos``: the caller's positions ([B, Sq] / [B, Sk]; None
    for an identity plan, whose positions are ``q_offset + arange`` /
    ``arange``).  ``q_perm`` / ``k_perm``: int32 [B, S], sorted row r is
    query ``q_perm[b, r]`` (None: the identity).  ``q_sorted`` /
    ``k_sorted``: the sorted positions, int32 with a contiguous sequence.
    ``bands``: (causal, window) -> the pre-pass's band."""

    def __init__(self, *, q_pos, k_pos, q_perm, k_perm, q_sorted, k_sorted,
                 b: int, sq: int, sk: int, device):
        self.q_pos, self.k_pos = q_pos, k_pos
        self.q_perm, self.k_perm = q_perm, k_perm
        self.q_sorted, self.k_sorted = q_sorted, k_sorted
        self.b, self.sq, self.sk, self.device = b, sq, sk, device
        self.bands: dict = {}

    @property
    def sorted_in_place(self) -> bool:
        """No permutation: the kernels read the operands in place."""
        return self.q_perm is None

    @classmethod
    def build(cls, q_pos, k_pos=None, *, b: int | None = None,
              sq: int | None = None, sk: int | None = None,
              q_offset: int = 0, device=None) -> "PosPlan":
        """The plan of q_pos [B, Sq] and k_pos [B, Sk] (integer tensors on
        one device; a missing one is ``q_offset + arange`` / ``arange``;
        ``k_pos`` None with no ``sk`` given: the keys share ``q_pos``)."""
        ref = q_pos if q_pos is not None else k_pos
        if ref is None:
            raise ValueError("PosPlan.build needs q_pos or k_pos")
        device = ref.device if device is None else device
        b = ref.shape[0] if b is None else b
        if sq is None:
            sq = q_pos.shape[1] if q_pos is not None else k_pos.shape[1]
        shared = k_pos is None and sk is None or k_pos is q_pos
        if sk is None:
            sk = sq if k_pos is None else k_pos.shape[1]
        if q_pos is None:
            q_pos = (q_offset + torch.arange(sq, dtype=torch.int32,
                                             device=device))[None].expand(b, sq)
        elif q_offset:
            raise ValueError("q_pos replaces q_offset, which must then be 0")
        qp = _check("q_pos", q_pos, sq, b, device)
        q_perm, q_sorted = _sort(qp)
        if shared:
            k_pos, k_perm, k_sorted = q_pos, q_perm, q_sorted
        else:
            if k_pos is None:
                k_pos = torch.arange(sk, dtype=torch.int32,
                                     device=device)[None].expand(b, sk)
            k_perm, k_sorted = _sort(_check("k_pos", k_pos, sk, b, device))
        return cls(q_pos=q_pos, k_pos=k_pos, q_perm=q_perm, k_perm=k_perm,
                   q_sorted=q_sorted, k_sorted=k_sorted, b=b, sq=sq, sk=sk,
                   device=device)

    @classmethod
    def identity(cls, b: int, sq: int, sk: int, q_offset: int,
                 device) -> "PosPlan":
        """Positions ``q_offset + arange(sq)`` / ``arange(sk)``, already
        sorted: no permutation (the rows, [1, S], repeat over the batch)."""
        q = (q_offset + torch.arange(sq, dtype=torch.int32,
                                     device=device))[None]
        k = q if q_offset == 0 and sq == sk else torch.arange(
            sk, dtype=torch.int32, device=device)[None]
        return cls(q_pos=None, k_pos=None, q_perm=None, k_perm=None,
                   q_sorted=q, k_sorted=k, b=b, sq=sq, sk=sk, device=device)
