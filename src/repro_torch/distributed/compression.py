"""Error feedback for compressed gradients.

The port of ``ErrorFeedback`` from the JAX package's
``repro.distributed.compression``: EF21-style residual accumulation, so
the int8 quantisation error of one step is re-injected the next — with it,
compressed SGD keeps the uncompressed fixed points.  The int8-wire
all-reduce the JAX package builds around it is a multi-device collective
and is not part of the one-card port.  Trees are nested dicts of tensors.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.train.optimizer import tree_map


class ErrorFeedback:
    """EF21 residual state: e' = g + e - C(g + e); apply C(g+e) instead of g."""

    @staticmethod
    def init(grads: Any) -> Any:
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)

    @staticmethod
    def compress(grads: Any, residual: Any) -> tuple[Any, Any]:
        def one(g, e):
            x = g.to(torch.float32) + e
            scale = torch.clamp_min(x.abs().max(), 1e-20) / 127.0
            cx = torch.round(x / scale).to(torch.int8).to(torch.float32) * scale
            return cx, x - cx

        pairs = tree_map(one, grads, residual)
        compressed = tree_map(lambda p: p[0], pairs)
        new_res = tree_map(lambda p: p[1], pairs)
        return compressed, new_res
