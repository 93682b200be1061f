"""Architecture registry: ``--arch <id>`` resolution for all ten ids of the
JAX package."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import Arch

_MODULES = {
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(name: str) -> Arch:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{', '.join(ARCH_IDS)}")
    return importlib.import_module(_MODULES[name]).ARCH


def all_arches() -> dict[str, Arch]:
    return {name: get_arch(name) for name in ARCH_IDS}
