"""Gradient compression for data-parallel reduction.

The port of the JAX package's ``repro.distributed.compression``, over
``torch.distributed`` (NCCL on the cards, gloo on the CPU):

* ``compressed_psum`` is an exact-sum int8 all-reduce: a shared scale is
  agreed by an all-reduce MAX of the ranks' absmaxes, each rank quantises
  to int8, the int8 values are summed in int32 by an all-reduce SUM, and
  the sum is descaled — deterministic, with no per-rank scale mixing;
* ``make_dp_grad_sync`` averages a gradient tree over the group, through
  ``compressed_psum`` or a plain all-reduce SUM;
* ``ErrorFeedback`` is EF21-style residual accumulation, so the int8
  quantisation error of one step is re-injected the next — with it,
  compressed SGD keeps the uncompressed fixed points.

The process group is the caller's to create
(``torch.distributed.init_process_group``); nothing here initialises one.
Trees are nested dicts of tensors.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.train.optimizer import tree_map


def _q8_psum(g: torch.Tensor, group) -> torch.Tensor:
    absmax = g.abs().amax().reshape(1)
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(absmax[0], 1e-20) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * scale


def compressed_psum(grads: Any, group=None) -> Any:
    """int8-wire sum of a gradient tree over the ranks of ``group`` (the
    default group for ``None``), in float32."""
    return tree_map(lambda g: _q8_psum(g.to(torch.float32), group), grads)


def _psum(g: torch.Tensor, group) -> torch.Tensor:
    total = g.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total


def make_dp_grad_sync(group=None, compress: bool = True):
    """A synchroniser of per-rank *partial* gradients (each rank a tree of
    the same shapes, unsummed): returns their mean over ``group``, summed
    through ``compressed_psum`` or a plain all-reduce.  As in the JAX
    package the mean is at least float32 (a bf16 sum is divided in
    float32)."""

    def sync(grads):
        n = float(dist.get_world_size(group))
        summed = (compressed_psum(grads, group) if compress
                  else tree_map(lambda g: _psum(g, group), grads))
        return tree_map(lambda g: g.to(torch.promote_types(
            g.dtype, torch.float32)) / n, summed)

    return sync


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
