"""Carry the JAX package's parameters and caches into the port.

The JAX trees arrive as nested dicts of numpy arrays (``np.asarray`` of
each leaf).  A bf16 JAX array becomes an ``ml_dtypes`` bfloat16 numpy
array, which ``torch.from_numpy`` rejects, so such leaves (recognised by
``arr.dtype.name``, without importing ``ml_dtypes``) travel as their
uint16 bit patterns and are viewed back as ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf(arr, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def _tree(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def params_from_jax(tree_of_numpy, device=None):
    """The port's parameter dict from the JAX package's (as numpy)."""
    return _tree(tree_of_numpy, resolve_device(device))


def cache_from_jax(tree_of_numpy, device=None):
    """The port's serving cache from the JAX package's (as numpy)."""
    return _tree(tree_of_numpy, resolve_device(device))
