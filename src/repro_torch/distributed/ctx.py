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

The tensor-parallel train step also installs a ``model_parallel``
context (process-wide too): each rank of the model group holds its slice
of the parameters along ``model`` (``partitioning.param_pspecs``) and the
whole batch of its data row.  The model's layers then go in and out of
their sharded regions through the Megatron pair: ``to_model`` (the
identity forward, an all-reduce SUM of the gradient: a replicated input,
or a replicated weight used in a rank's part of a sum, gathers every
rank's share of its gradient) and ``from_model`` (an all-reduce SUM
forward, the identity backward: the ranks' partial outputs summed).
``gather_model`` joins the ranks' equal contiguous chunks along a dim (a
sequence in the sequence-sharded attention, heads in serving), and
``model_max`` takes a MAX over the group (the vocabulary-parallel cross
entropy's row max).  Each sum runs in float32 and comes back in the
input's dtype.  Every rank must issue the group's collectives in one
order: the layers call them in program order, and remat replays them in
the backward in the same order on every rank.

Serving under ``model`` (the prefill and decode steps of
``launch.steps`` on a ``(data, model)`` mesh) adds the decode's
log-sum-exp join of the ranks' partial softmaxes over their slots of the
KV cache (``combine_partials``: one all-gather, then the sums in f32 in
rank order, the same on every rank, so the joined output is bit-equal
across them) and ``gather_data``, the data group's rows joined (a decode
MoE layer groups the whole global batch).

Parameters sharded over ``data`` (``ModelConfig.fsdp_units``, ZeRO-3, and
the experts of ``moe_shard_mode="e_data_f_model"``) run inside a
``param_shards`` context (process-wide too), which installs this rank's
``ParamShards``: the shard group (the data ranks of its pod that split a
leaf) and the leaves split along which dim.  ``gather_params`` joins a
unit's (or a layer's) split leaves before it runs, through one flat
buffer and one all-gather; its gradient is one reduce-scatter of the
whole leaves' f32 gradients into this rank's shards (``_GatherShards``).
Called inside a unit's remat boundary, the backward gathers again, so
only one unit is whole at a time.  ``exchange`` (``_Exchange``) is the
experts' token movement: one all-to-all over the shard group, whose
gradient is the same all-to-all of the gradient.

Every collective goes through ``all_reduce`` / ``all_gather`` /
``reduce_scatter`` / ``all_to_all`` here, which call
``torch.distributed``'s functions, looked up at each call, on a real
process group (gloo takes all four on CPU and CUDA tensors:
``reduce_scatter`` of a list, ``all_to_all_single``), and only log the
call on a ``PlanGroup``: the stand-in the dry run gives one rank of a
production mesh (``launch.mesh.plan_mesh``), which moves no data (its
tensors are meta tensors) and counts every collective by kind, calls
and bytes (an all-reduce's tensor, an all-gather's input, a
reduce-scatter's and an all-to-all's whole input).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.distributed.partitioning import PartitionSpec
from repro_torch.train.optimizer import tree_from_paths, tree_paths


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
        all_reduce(y, op=dist.ReduceOp.SUM, group=group)
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
    return 1 if _DATA_GROUP is None else group_size(_DATA_GROUP)


def dp_rank() -> int:
    """This rank's place in the installed data group (0 without one)."""
    return 0 if _DATA_GROUP is None else group_rank(_DATA_GROUP)


def gather_data(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The data group's equal parts of ``x`` joined along ``dim`` in rank
    order (``x`` itself without a group); forward only (serving)."""
    group = _DATA_GROUP
    return x if group is None else _gather(x, dim, group)


# ---------------------------------------------------------------------------
# tensor parallelism: the model group's collectives
# ---------------------------------------------------------------------------

_MODEL_GROUP = None


@contextlib.contextmanager
def model_parallel(group):
    """Inside the block (on this process, every thread) the model's layers
    run their parts of the tensor-parallel program over ``group`` (a
    ``torch.distributed`` process group of the ranks of one data row;
    ``None``: the one-device model, unchanged bit for bit)."""
    global _MODEL_GROUP
    prev, _MODEL_GROUP = _MODEL_GROUP, group
    try:
        yield group
    finally:
        _MODEL_GROUP = prev


def mp_size() -> int:
    """Ranks of the installed model group (1 without one)."""
    return 1 if _MODEL_GROUP is None else group_size(_MODEL_GROUP)


def mp_rank() -> int:
    """This rank's coordinate along ``model`` (0 without a group)."""
    return 0 if _MODEL_GROUP is None else group_rank(_MODEL_GROUP)


def _all_reduce_f32(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """``x`` reduced over ``group`` in float32, back in its dtype."""
    y = x.to(torch.float32, copy=True).contiguous()
    all_reduce(y, op=op, group=group)
    return y.to(x.dtype)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced (SUM) over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _FromModel(torch.autograd.Function):
    """All-reduce SUM forward; the gradient handed on as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    """The ranks' equal contiguous chunks along ``dim`` joined in rank
    order; the gradient is this rank's chunk of it."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.rank, ctx.n = dim, group_rank(group), x.shape[dim]
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering a sharded region: itself, its gradient summed over
    the installed model group (``x`` itself without one)."""
    group = _MODEL_GROUP
    return x if group is None else _ToModel.apply(x, group)


def from_model(x: torch.Tensor) -> torch.Tensor:
    """The ranks' partial ``x`` summed over the installed model group, the
    gradient handed to each rank's part (``x`` itself without one)."""
    group = _MODEL_GROUP
    return x if group is None else _FromModel.apply(x, group)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model group's chunks of ``x`` (of a sequence, or of the heads)
    joined along ``dim``, rank r's the r-th (``x`` itself without a
    group)."""
    group = _MODEL_GROUP
    return x if group is None else _GatherModel.apply(x, dim, group)


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise MAX of ``x`` over the installed model group, no
    gradient (``x`` detached without one)."""
    group = _MODEL_GROUP
    x = x.detach()
    return x if group is None else _all_reduce_f32(x, group,
                                                   dist.ReduceOp.MAX)


def combine_partials(m: torch.Tensor, l: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """The softmax-weighted sum [..., D] from the model group's partial
    ones, each over its own keys: its row max ``m`` [...], its sum of
    ``exp(s - m)`` ``l`` [...] and of ``exp(s - m) v`` ``acc`` [..., D],
    all float32.  One all-gather of the three; then, on every rank in
    rank order, the global max M, each part weighted by ``exp(m - M)``
    and summed.  A rank with no kept key gives ``l = acc = 0`` and
    ``m = -1e30``: its weight is 0, so it adds nothing.  Without a group,
    ``acc / l``."""
    group = _MODEL_GROUP
    if group is None:
        return acc / l.clamp_min(1e-37)[..., None]
    packed = torch.cat([m[..., None], l[..., None], acc], dim=-1)
    parts = [torch.empty_like(packed) for _ in range(group_size(group))]
    all_gather(parts, packed.contiguous(), group=group)
    big = parts[0][..., 0]
    for part in parts[1:]:
        big = torch.maximum(big, part[..., 0])
    lsum = asum = None
    for part in parts:
        w = torch.exp(part[..., 0] - big)
        lw, aw = w * part[..., 1], w[..., None] * part[..., 2:]
        lsum = lw if lsum is None else lsum + lw
        asum = aw if asum is None else asum + aw
    return asum / lsum.clamp_min(1e-37)[..., None]


# ---------------------------------------------------------------------------
# parameters sharded over data: the unit gathers and the experts' exchange
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamShards:
    """This rank's place in the split of the parameters over ``data``:
    ``group``, the shard group (the ranks of its pod and model
    coordinates, one a block of each split leaf), ``pod_group``, the ranks
    of the other pods holding the same blocks (None on one pod), and by
    path (tuples of the whole tree's keys) the dim ``data`` splits:
    ``gathered``, the leaves all-gathered before they are used
    (``fsdp_units``), and ``owned``, the experts this rank computes on
    (``e_data_f_model``).  Their gradients come whole for the rank's
    block from the shard group and are summed over the pods only."""
    group: object
    pod_group: object
    gathered: dict
    owned: dict

    @property
    def held(self) -> dict:
        """Every leaf ``data`` splits: path -> dim."""
        return {**self.gathered, **self.owned}


_SHARDS: ParamShards | None = None


@contextlib.contextmanager
def param_shards(shards: ParamShards | None):
    """Inside the block (on this process, every thread) the model gathers
    the leaves ``shards`` splits before it uses them (``None``: every
    leaf whole, the model unchanged)."""
    global _SHARDS
    prev, _SHARDS = _SHARDS, shards
    try:
        yield shards
    finally:
        _SHARDS = prev


def installed_shards() -> ParamShards | None:
    """The installed ``ParamShards``, or None."""
    return _SHARDS


#: bytes each leaf's segment of a flat gather buffer is padded to, so that
#: every segment can be viewed as any dtype
_ALIGN = 16


def _padded(n: int, unit: int) -> int:
    return -(-n // unit) * unit


class _GatherShards(torch.autograd.Function):
    """The whole leaves from every rank's blocks (``dims[i]`` the dim
    leaf i is split along), through one flat byte buffer and one
    all-gather; the gradient is one reduce-scatter (SUM) of the whole
    leaves' gradients, in float32, into this rank's blocks, returned in
    their dtypes."""

    @staticmethod
    def forward(ctx, group, dims, *shards):
        ctx.group, ctx.dims = group, dims
        ctx.meta = [(s.shape, s.dtype) for s in shards]
        n = group_size(group)
        sizes = [_padded(s.numel() * s.element_size(), _ALIGN)
                 for s in shards]
        flat = shards[0].new_zeros(sum(sizes), dtype=torch.uint8)
        at = 0
        for s, size in zip(shards, sizes):
            flat[at:at + s.numel() * s.element_size()].copy_(
                s.contiguous().view(-1).view(torch.uint8))
            at += size
        parts = flat.new_empty((n, flat.numel()))
        all_gather(list(parts.unbind(0)), flat, group=group)
        del flat
        out, at = [], 0
        for s, d, size in zip(shards, dims, sizes):
            nb = s.numel() * s.element_size()
            out.append(torch.cat([parts[r, at:at + nb].view(s.dtype).view(
                s.shape) for r in range(n)], dim=d))
            at += size
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        n = group_size(ctx.group)
        sizes = [_padded(math.prod(shape), _ALIGN // 4)
                 for shape, _ in ctx.meta]
        flat = torch.zeros((n, sum(sizes)), dtype=torch.float32,
                           device=next(g for g in grads
                                       if g is not None).device)
        at = 0
        for g, (shape, _), d, size in zip(grads, ctx.meta, ctx.dims, sizes):
            if g is not None:       # an unused leaf's gradient is zero
                k = shape[d]
                for i in range(n):
                    flat[i, at:at + math.prod(shape)].view(shape).copy_(
                        g.narrow(d, i * k, k))
            at += size
        out = flat.new_empty(flat.shape[1])
        reduce_scatter(out, list(flat.unbind(0)), group=ctx.group)
        del flat
        shards, at = [], 0
        for (shape, dtype), size in zip(ctx.meta, sizes):
            shards.append(out[at:at + math.prod(shape)].view(shape).to(dtype))
            at += size
        return (None, None, *shards)


def gather_params(tree, prefix: tuple = (), shift: int = 0):
    """``tree`` (a subtree at ``prefix`` of the parameters: a unit's
    slices, ``shift=1`` for the stacked unit axis indexed away; a tail
    layer; the final norm) with the leaves the installed ``ParamShards``
    gathers made whole: one all-gather for all of them, one
    reduce-scatter in the backward.  ``tree`` itself without a context or
    where it splits no leaf."""
    shards = _SHARDS
    if shards is None:
        return tree
    items = list(tree_paths(tree))
    picked = [i for i, (p, _) in enumerate(items)
              if prefix + p in shards.gathered]
    if not picked:
        return tree
    dims = tuple(shards.gathered[prefix + items[i][0]] - shift
                 for i in picked)
    whole = _GatherShards.apply(shards.group, dims,
                                *(items[i][1] for i in picked))
    leaves = [x for _, x in items]
    for i, w in zip(picked, whole):
        leaves[i] = w
    return tree_from_paths((p, x) for (p, _), x in zip(items, leaves))


class _Exchange(torch.autograd.Function):
    """``all_to_all`` over ``group`` of ``x`` [n, ...] (row i to rank i,
    row i of the result from rank i); its own inverse, so the gradient is
    the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchanged(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchanged(g, ctx.group), None


def _exchanged(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    all_to_all(out, x, group=group)
    return out


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Row i of ``x`` [n, ...] sent to rank i of ``group`` and rank i's
    row of its ``x`` received in its place, the gradient exchanged back
    (``x`` itself for a group of one)."""
    if group is None or group_size(group) == 1:
        return x
    return _Exchange.apply(x, group)


# ---------------------------------------------------------------------------
# collectives over a process group or a plan's stand-in
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class PlanGroup:
    """A stand-in for a process group in a plan of one rank's program on
    meta tensors: the rank's place in the group and its size.  It moves
    no data: every collective issued on it is only logged, by kind, into
    ``log`` (``{kind: {"calls", "bytes"}}``), which the groups of one
    plan share."""
    rank: int
    size: int
    log: dict = dataclasses.field(default_factory=dict)

    def record(self, kind: str, *ts: torch.Tensor) -> None:
        entry = self.log.setdefault(kind, {"calls": 0, "bytes": 0})
        entry["calls"] += 1
        entry["bytes"] += sum(t.numel() * t.element_size() for t in ts)


def group_size(group) -> int:
    return (group.size if isinstance(group, PlanGroup)
            else dist.get_world_size(group))


def group_rank(group) -> int:
    return (group.rank if isinstance(group, PlanGroup)
            else dist.get_rank(group))


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> None:
    """``x`` reduced in place over ``group``; logged on a ``PlanGroup``."""
    if isinstance(group, PlanGroup):
        group.record("all_reduce", x)
    else:
        dist.all_reduce(x, op=op, group=group)


def all_gather(parts: list, x: torch.Tensor, group=None) -> None:
    """Every rank's ``x`` into ``parts`` in rank order; logged on a
    ``PlanGroup``."""
    if isinstance(group, PlanGroup):
        group.record("all_gather", x)
    else:
        dist.all_gather(parts, x, group=group)


def reduce_scatter(out: torch.Tensor, parts: list, group=None) -> None:
    """``out`` = the SUM over ``group`` of every rank's ``parts[r]``, r
    this rank's place; logged on a ``PlanGroup`` (all the parts' bytes)."""
    if isinstance(group, PlanGroup):
        group.record("reduce_scatter", *parts)
    else:
        dist.reduce_scatter(out, parts, group=group)


def all_to_all(out: torch.Tensor, x: torch.Tensor, group=None) -> None:
    """Row ``i`` of ``out`` (its first dim, one row a rank) = rank i's row
    r of ``x``, r this rank's place; logged on a ``PlanGroup``."""
    if isinstance(group, PlanGroup):
        group.record("all_to_all", x)
    else:
        dist.all_to_all_single(out, x, group=group)
