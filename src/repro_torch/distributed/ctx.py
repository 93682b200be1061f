"""Activation-sharding context for model-internal constraints.

The port of the JAX package's ``repro.distributed.ctx``.  Model code is
mesh-agnostic; a planner installs an ``activation_sharding`` context
before it runs a step, and blocks like attention and the MoE dispatch
call ``constrain`` with *logical* dims ('batch', 'seq', None, ...).

On one device a sharding constraint changes nothing, so ``constrain``
returns ``x`` itself, always.  Inside a context it also records the spec
the rules give ``x`` (``(dims, spec)`` in the context's ``records``), which
the dry run reports; outside one it does nothing else.

The data-parallel train step installs a ``data_parallel`` context: each
rank holds its rows of the global batch, and the model's two sums over
the batch (``loss_fn``'s token denominator and ``nll`` sum, the MoE aux
loss's routing means) go through ``dp_sum``, so every rank computes the
JAX package's function of the global batch.  The context is the
process's, not a thread's: under remat, autograd recomputes the forward
on its own threads, and the recomputation must sum as the forward did.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.distributed.partitioning import PartitionSpec


@dataclasses.dataclass
class ActivationSharding:
    mesh: object                      # a launch.mesh.MeshSpec
    rules: dict                       # logical dim -> axis / axes / None
    records: list = dataclasses.field(default_factory=list)


_RULES: contextvars.ContextVar[ActivationSharding | None] = \
    contextvars.ContextVar("activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict):
    """rules: logical dim name -> mesh axis (or axes tuple) or None.
    Yields the context, whose ``records`` collect the constrained specs."""
    state = ActivationSharding(mesh, rules)
    token = _RULES.set(state)
    try:
        yield state
    finally:
        _RULES.reset(token)


def constrain(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """``x`` itself; inside a context, the spec that maps logical dim i of
    ``x`` per the installed rules is recorded."""
    state = _RULES.get()
    if state is None:
        return x
    sizes = state.mesh.shape

    def axes_for(dim_name, dim_size):
        axes = state.rules.get(dim_name) if dim_name is not None else None
        if axes is None:
            return None
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        return axes if dim_size % math.prod(sizes[a] for a in axes_t) == 0 \
            else None

    spec = PartitionSpec(*(axes_for(d, s) for d, s in zip(dims, x.shape)))
    state.records.append((tuple(dims), spec))
    return x


# ---------------------------------------------------------------------------
# data parallelism: sums over the data group's ranks
# ---------------------------------------------------------------------------

_DATA_GROUP = None


@contextlib.contextmanager
def data_parallel(group):
    """Inside the block (on this process, every thread), ``dp_sum`` sums
    over ``group`` (a ``torch.distributed`` process group; ``None``: no
    sum, the one-device model)."""
    global _DATA_GROUP
    prev, _DATA_GROUP = _DATA_GROUP, group
    try:
        yield group
    finally:
        _DATA_GROUP = prev


def data_group():
    """The installed data group, or None."""
    return _DATA_GROUP


class _SumOverData(torch.autograd.Function):
    """All-reduce SUM whose gradient is the identity: every rank's loss
    is the one global loss, so the gradient that reaches this rank's own
    summand is the loss's gradient of the sum itself, and the ranks'
    parameter gradients, summed, are the global batch's."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the installed data group's ranks (``x`` itself
    without one), the gradient carried to this rank's summand."""
    group = _DATA_GROUP
    if group is None:
        return x
    return _SumOverData.apply(x, group)


def dp_size() -> int:
    """Ranks of the installed data group (1 without one)."""
    return 1 if _DATA_GROUP is None else dist.get_world_size(_DATA_GROUP)
