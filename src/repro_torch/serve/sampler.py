"""Token samplers: greedy / temperature / top-k.

Greedy is exact.  Temperature and top-k sampling draw Gumbel noise from an
explicit ``torch.Generator``; the draws differ from ``jax.random``'s, so
only their properties (determinism per seed, masked tokens never drawn)
compare across the two packages.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0     # 0 = greedy
    top_k: int = 0               # 0 = full softmax


def sample(logits: torch.Tensor, gen: torch.Generator | None,
           cfg: SamplerConfig) -> torch.Tensor:
    """logits: [B, V] fp32 -> tokens [B] int32."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = torch.where(logits >= kth, logits, -1e30)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
