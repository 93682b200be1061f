"""Carry the JAX package's parameters, caches and train states into the
port.

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
    arr = np.array(arr, order="C")      # a C-ordered copy; keeps 0-d leaves
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _tree(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def params_from_jax(tree_of_numpy, device=None):
    """The port's tree from the JAX package's (as numpy), leaf for leaf:
    parameters, serving caches, or train states ``{'params', 'opt'}``
    with f32 / bf16 moments or int8 ``{q, scale}`` ones, masters and the
    int32 ``count``."""
    return _tree(tree_of_numpy, resolve_device(device))


#: Caches and train states travel leaf for leaf, as parameters do.
cache_from_jax = train_state_from_jax = params_from_jax
