"""LR schedules: linear-warmup cosine and MiniCPM's WSD (warmup-stable-decay).

The port of the JAX package's ``repro.train.schedules``: each schedule maps
a step (an int or an int32 tensor, such as the optimizer's ``count``) to a
float32 0-d tensor on the step's device, evaluated as JAX evaluates it —
the step cast to float32, every operation in float32."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd(base_lr: float, warmup: int, stable: int, decay: int,
        min_ratio: float = 0.1):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395 §4): flat plateau then
    a short exponential-ish decay to min_ratio·lr."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        floor = torch.tensor(max(min_ratio, 1e-6), dtype=torch.float32,
                             device=step.device)
        dec = base_lr * torch.exp(torch.log(floor) * frac)
        base = torch.tensor(base_lr, dtype=torch.float32, device=step.device)
        return torch.where(step < warmup, warm,
                           torch.where(step < warmup + stable, base, dec))
    return lr


def constant(base_lr: float):
    def lr(step):
        device = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), base_lr, dtype=torch.float32, device=device)
    return lr


SCHEDULES = {"cosine": warmup_cosine, "wsd": wsd, "constant": constant}
