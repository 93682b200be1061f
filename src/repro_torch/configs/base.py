"""Config substrate: shape grid, arch bundles and smoke batches.

Every ported architecture file exposes:

* ``CONFIG``  — the exact published configuration (full scale),
* ``SMOKE``   — a reduced same-family config for CPU smoke tests,
* ``ARCH``    — an :class:`Arch` bundle tying config + shape grid + notes.

``input_specs`` gives the inputs of an (arch x shape) cell as tensors on
the meta device (shapes and dtypes, no data), where the JAX package gives
``jax.ShapeDtypeStruct`` stand-ins for its dry run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import ModelConfig, init_cache

# The assigned LM shape grid (seq_len, global_batch).
TRAIN_4K = ("train_4k", "train", 4096, 256)
PREFILL_32K = ("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ("decode_32k", "decode", 32768, 128)
LONG_500K = ("long_500k", "decode", 524288, 1)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int
    skip: str | None = None  # reason string when the cell is N/A


@dataclasses.dataclass(frozen=True)
class Arch:
    config: ModelConfig
    smoke: ModelConfig
    shapes: tuple[ShapeSpec, ...]
    source: str = ""
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.config.name} has no shape {name}")


def lm_shapes(*, long_context: bool, skip_reason: str = "full-attention O(S²) "
              "— long_500k scoped to SSM/hybrid archs per assignment"
              ) -> tuple[ShapeSpec, ...]:
    cells = [ShapeSpec(*TRAIN_4K), ShapeSpec(*PREFILL_32K),
             ShapeSpec(*DECODE_32K)]
    cells.append(ShapeSpec(*LONG_500K) if long_context
                 else ShapeSpec(*LONG_500K[:4], skip=skip_reason))
    return tuple(cells)


# ---------------------------------------------------------------------------
# dry-run input specs (meta-device tensors only — never allocates)
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_spec(b: int, s: int) -> torch.Tensor:
    return _spec((b, s), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-device stand-ins for every input of this (arch x shape)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.input_mode == "embeddings":
            batch = {"inputs": _spec((b, s, cfg.d_model), cfg.cdtype),
                     "labels": _token_spec(b, s)}
        else:
            batch = {"inputs": _token_spec(b, s), "labels": _token_spec(b, s)}
        if cfg.rope_kind == "mrope":
            batch["position_ids"] = _spec((3, b, s), torch.int32)
        return {"batch": batch}
    if shape.kind == "prefill":
        if cfg.input_mode == "embeddings":
            inputs = _spec((b, s, cfg.d_model), cfg.cdtype)
        else:
            inputs = _token_spec(b, s)
        out = {"inputs": inputs}
        if cfg.rope_kind == "mrope":
            out["position_ids"] = _spec((3, b, s), torch.int32)
        return out
    # decode: one new token against a cache of seq_len positions
    cache = init_cache(cfg, b, s, device=META)
    if cfg.input_mode == "embeddings":
        inputs = _spec((b, 1, cfg.d_model), cfg.cdtype)
    else:
        inputs = _spec((b, 1), torch.int32)
    out = {"inputs": inputs, "cache": cache, "index": _spec((), torch.int32)}
    if cfg.rope_kind == "mrope":
        out["position_ids"] = _spec((3, b, 1), torch.int32)
    return out


def smoke_batch(cfg: ModelConfig, *, batch: int = 2, seq: int = 16,
                seed: int = 0, device=None) -> dict[str, torch.Tensor]:
    """A real (allocated) tiny batch for smoke tests, drawn from a numpy
    seed."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        inputs = torch.as_tensor(
            rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32),
            device=device).to(cfg.cdtype)
    else:
        inputs = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
            device=device)
    labels = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
        device=device)
    out = {"inputs": inputs, "labels": labels}
    if cfg.rope_kind == "mrope":
        pos = torch.arange(seq, dtype=torch.int32, device=device)[None]
        out["position_ids"] = pos.expand(3, batch, seq)
    return out
