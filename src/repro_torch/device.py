"""Device resolution shared by every entry point of the port.

The port's entry points run on the card unless the caller asks for the
CPU: ``device=None`` means ``"cuda"``, and with no CUDA device that
raises instead of carrying on silently on the CPU.  Tests pass
``device="cpu"`` explicitly.  ``"meta"`` builds shapes without data
(``launch.steps.abstract_train_state``, ``configs.base.input_specs``).
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise when the requested card is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run it on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev} (cuda, cpu or meta)")
    return dev
