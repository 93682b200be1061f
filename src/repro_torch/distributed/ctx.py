"""Activation-sharding context for model-internal constraints.

The port of the JAX package's ``repro.distributed.ctx``.  Model code is
mesh-agnostic; a planner installs an ``activation_sharding`` context
before it runs a step, and blocks like attention and the MoE dispatch
call ``constrain`` with *logical* dims ('batch', 'seq', None, ...).

On one device a sharding constraint changes nothing, so ``constrain``
returns ``x`` itself, always.  Inside a context it also records the spec
the rules give ``x`` (``(dims, spec)`` in the context's ``records``), which
the dry run reports; outside one it does nothing else.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch

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
