"""Train / prefill / decode steps.

The port of the JAX package's ``repro.launch.steps`` for one device: the
exact computations the trainer and the serving engine execute.
``train_step`` is forward + backward (+ microbatch accumulation) + AdamW
update; ``serve_decode`` one token against the cache, ``serve_prefill``
the batched prompt pass.  The mesh machinery (``train_state_pspecs``,
``lower_cell``) stays with the JAX package.

Gradients come from ``torch.autograd``; on the card they run through the
hand-written attention and RG-LRU kernels forwards and backwards.  The
step returns a new state; the state it was given is left as it was.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            init_params, loss_fn, prefill)
from repro_torch.train.optimizer import (OptConfig, adamw_init, adamw_update,
                                         tree_from_paths, tree_map,
                                         tree_paths)
from repro_torch.train.schedules import constant

Params = Any


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------


def init_train_state(cfg: ModelConfig, ocfg: OptConfig,
                     gen: torch.Generator | int, device=None) -> Params:
    """{'params', 'opt'}: random parameters from ``gen`` (a generator on
    ``device`` or an int seed) and a fresh AdamW state."""
    params = init_params(cfg, gen, device=device)
    return {"params": params, "opt": adamw_init(ocfg, params)}


def abstract_train_state(cfg: ModelConfig, ocfg: OptConfig) -> Params:
    """The train state's structure, shapes and dtypes as meta-device
    tensors (no data)."""
    return init_train_state(cfg, ocfg, torch.Generator().manual_seed(0),
                            device="meta")


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def value_and_grad(cfg: ModelConfig, params: Params, batch
                   ) -> tuple[torch.Tensor, dict, Params]:
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; the gradients
    in each parameter's dtype, as ``jax.value_and_grad`` gives them."""
    paths, leaves = zip(*tree_paths(params))
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = loss_fn(cfg, tree_from_paths(zip(paths, live)), batch)
    grads = tree_from_paths(zip(paths, torch.autograd.grad(loss, live)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def loss_and_grads(cfg: ModelConfig, params: Params, batch,
                   grad_accum: int = 1) -> tuple[torch.Tensor, dict, Params]:
    """The train step's (loss, metrics, grads) before the update.  With
    ``grad_accum > 1`` the batch is split along its first axis into
    microbatches run in turn; gradients accumulate in f32 in order, as
    JAX's ``lax.scan`` does, and loss, ce and gradients are their means."""
    if grad_accum == 1:
        return value_and_grad(cfg, params, batch)
    micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                          + tuple(v.shape[1:])) for k, v in batch.items()}
    gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    lacc = ceacc = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
    for i in range(grad_accum):
        loss, m, g = value_and_grad(cfg, params,
                                    {k: v[i] for k, v in micro.items()})
        gacc = tree_map(lambda a, b: a + b.to(torch.float32), gacc, g)
        del g
        lacc, ceacc = lacc + loss, ceacc + m["ce"]
    grads = tree_map(lambda g: g / grad_accum, gacc)
    metrics = {"ce": ceacc / grad_accum,
               "moe_aux": torch.zeros((), dtype=torch.float32,
                                      device=lacc.device),
               "tokens": torch.tensor(batch["labels"].numel(),
                                      dtype=torch.int32, device=lacc.device)}
    return lacc / grad_accum, metrics, grads


def make_train_step(cfg: ModelConfig, ocfg: OptConfig,
                    schedule: Callable[[torch.Tensor], torch.Tensor]
                    | None = None, grad_accum: int = 1):
    """forward+backward (+ microbatch accumulation) + AdamW update:
    ``train_step(state, batch) -> (new_state, metrics)``."""
    schedule = schedule or constant(3e-4)

    def train_step(state: Params, batch: dict[str, torch.Tensor]):
        loss, metrics, grads = loss_and_grads(cfg, state["params"], batch,
                                              grad_accum)
        new_params, new_opt, info = adamw_update(
            ocfg, schedule, state["params"], grads, state["opt"])
        metrics = dict(metrics)
        metrics.update(info)
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_serve_decode(cfg: ModelConfig):
    def serve_decode(params, cache, inputs, index, position_ids=None):
        return decode_step(cfg, params, cache, inputs, index, position_ids)
    return serve_decode


def make_serve_prefill(cfg: ModelConfig, max_seq: int):
    def serve_prefill(params, inputs, position_ids=None):
        return prefill(cfg, params, inputs, max_seq=max_seq,
                       position_ids=position_ids)
    return serve_prefill


def to_device(tree, device=None):
    """A batch or state tree moved to ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev), tree)
