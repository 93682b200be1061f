"""Batched serving engine: prefill + decode with a persistent cache.

Wave-batched execution: requests are grouped into aligned waves (one
shared position counter per wave); prompts are left-padded into the wave
so it admits mixed prompt lengths.  Everything runs under
``torch.inference_mode()``; on the card the prefill's attention and RG-LRU
layers go through the hand-written CUDA kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            forward, prefill)
from repro_torch.serve.sampler import SamplerConfig, sample


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # [B, n_new]
    prefill_logits: np.ndarray   # [B, vocab]
    steps: int


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_seq: int,
                 sampler: SamplerConfig | None = None, device=None):
        self.cfg, self.params, self.max_seq = cfg, params, max_seq
        self.sampler = sampler or SamplerConfig()
        self.device = resolve_device(device)

    def _pad_prompts(self, prompts: Sequence[Sequence[int]]) -> np.ndarray:
        width = max(len(p) for p in prompts)
        out = np.zeros((len(prompts), width), np.int32)
        for r, p in enumerate(prompts):
            out[r, width - len(p):] = p        # left-pad (aligned wave)
        return out

    def generate(self, prompts: Sequence[Sequence[int]], n_new: int,
                 seed: int = 0) -> GenerationResult:
        """Greedy/temperature generation for one aligned wave."""
        toks = self._pad_prompts(prompts)
        b, s = toks.shape
        if s + n_new > self.max_seq:
            raise ValueError(f"prompt width {s} + {n_new} new tokens exceed "
                             f"max_seq {self.max_seq}")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            logits, cache = prefill(self.cfg, self.params,
                                    torch.as_tensor(toks, device=self.device),
                                    max_seq=self.max_seq)
            last = sample(logits[:, -1], gen, self.sampler)
            out = [last]
            for i in range(n_new - 1):
                step_logits, cache = decode_step(self.cfg, self.params, cache,
                                                 last[:, None], s + i)
                last = sample(step_logits[:, -1], gen, self.sampler)
                out.append(last)
            return GenerationResult(
                tokens=torch.stack(out, dim=1).cpu().numpy(),
                prefill_logits=logits[:, -1].cpu().numpy(),
                steps=n_new)

    def score(self, tokens: np.ndarray) -> np.ndarray:
        """Log-prob of each next token under the model (batch scoring)."""
        toks = torch.as_tensor(np.asarray(tokens, np.int32),
                               device=self.device)
        with torch.inference_mode():
            logits, _ = forward(self.cfg, self.params, toks, mode="eval")
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            gold = torch.gather(logp, -1, toks[:, 1:, None].long())[..., 0]
            return gold.cpu().numpy()
