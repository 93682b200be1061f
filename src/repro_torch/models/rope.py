"""Rotary position embeddings: classic RoPE and Qwen2-VL M-RoPE.

M-RoPE (multimodal RoPE, arXiv:2409.12191) splits the head dimension into
``sections`` (temporal / height / width); each section consumes a different
row of a ``[3, B, S]`` position-id tensor.  Text tokens carry identical
(t, h, w) ids, so M-RoPE degenerates to RoPE for pure-text inputs.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _expand(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Insert singleton head axes: [B, S, D/2] -> [B, S, 1..., D/2]."""
    return a.reshape(a.shape[:2] + (1,) * (ndim - 3) + a.shape[-1:])


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, ..., D] (any head axes); positions: [B, S] int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # [D/2]
    angles = positions.float()[..., None] * freqs            # [B, S, D/2]
    cos = _expand(torch.cos(angles), x.dim())
    sin = _expand(torch.sin(angles), x.dim())
    return _rotate(x.float(), cos, sin).to(x.dtype)


def apply_mrope(x: torch.Tensor, position_ids: torch.Tensor,
                sections: tuple[int, int, int], *,
                theta: float = 10000.0) -> torch.Tensor:
    """M-RoPE. x: [B, S, H, D]; position_ids: [3, B, S] (t, h, w).

    ``sections`` gives the number of *frequency pairs* per modality section
    (sum == D // 2), mirroring HF's ``mrope_section``."""
    d_half = x.shape[-1] // 2
    if sum(sections) != d_half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {d_half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # [D/2]
    angles = position_ids.float()[..., None] * freqs          # [3, B, S, D/2]
    sec_id = torch.repeat_interleave(                        # [D/2]
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device), output_size=d_half)
    angles = torch.gather(
        angles.movedim(0, -1),                                 # [B, S, D/2, 3]
        -1, sec_id[None, None, :, None].expand(
            angles.shape[1], angles.shape[2], d_half, 1))[..., 0]
    cos = _expand(torch.cos(angles), x.dim())
    sin = _expand(torch.sin(angles), x.dim())
    return _rotate(x.float(), cos, sin).to(x.dtype)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Degenerate (t == h == w) M-RoPE ids for pure-text tokens: [3, B, S]."""
    return positions[None].expand((3,) + tuple(positions.shape))
