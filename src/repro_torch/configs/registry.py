"""Architecture registry: ``--arch <id>`` resolution.

All ten ids of the JAX package are listed; only ``recurrentgemma-9b`` is
ported so far, and the others raise naming the slice that brings them.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import Arch

_MODULES = {
    "qwen2-0.5b": None,
    "minicpm-2b": None,
    "granite-3-2b": None,
    "starcoder2-3b": None,
    "llama4-maverick-400b-a17b": None,
    "granite-moe-3b-a800m": None,
    "musicgen-medium": None,
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "qwen2-vl-2b": None,
    "xlstm-350m": None,
}

ARCH_IDS = tuple(_MODULES)


def get_arch(name: str) -> Arch:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{', '.join(ARCH_IDS)}")
    module = _MODULES[name]
    if module is None:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: the other nine configs land "
            "with slice H item 21, with models/moe.py and models/xlstm.py")
    return importlib.import_module(module).ARCH
