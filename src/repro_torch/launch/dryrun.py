"""The dry run's model-size arithmetic, in part.

The port of ``opt_config_for``, ``active_param_count`` and
``model_flops`` from the JAX package's ``repro.launch.dryrun``; the
parameter shapes come from an init on the meta device.  The rest of the
dry run (lowering and compiling every cell on a device mesh, HLO
analysis) is mesh / XLA machinery and is not part of the port.
"""

from __future__ import annotations

import re

import torch

from repro_torch.models.transformer import ModelConfig, init_params
from repro_torch.train.optimizer import OptConfig, tree_paths


def opt_config_for(cfg: ModelConfig) -> OptConfig:
    # 8-bit moments for the configs sharded by unit (llama4's 400 B)
    return OptConfig(moment_dtype="int8" if cfg.fsdp_units else "f32")


def active_param_count(cfg: ModelConfig) -> tuple[int, int]:
    """(total_params, active_non_embedding_params) from meta shapes."""
    shapes = init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    total = active = 0
    moe_frac = (cfg.moe.top_k / cfg.moe.n_experts) if cfg.moe else 1.0
    for key_path, leaf in tree_paths(shapes):
        path = "/".join(key_path)
        n = leaf.numel()
        total += n
        if path.startswith("embed/"):
            continue
        if "/ffn/" in path and re.search(r"/ffn/(wi|wg|wo)$", path) \
                and cfg.moe and leaf.dim() == 4:  # stacked [U, E, ...] experts
            active += int(n * moe_frac)
            continue
        active += n
    return int(total), int(active)


def model_flops(cfg: ModelConfig, kind: str, seq: int, batch: int) -> float:
    _, n_active = active_param_count(cfg)
    if kind == "train":
        return 6.0 * n_active * seq * batch
    if kind == "prefill":
        return 2.0 * n_active * seq * batch
    return 2.0 * n_active * batch  # decode: one token per sequence
