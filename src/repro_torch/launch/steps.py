"""Train / prefill / decode steps, their state's partition specs, and the
plan of one (arch x shape) cell on a mesh.

The port of the JAX package's ``repro.launch.steps``: the exact
computations the trainer and the serving engine execute.
``train_step`` is forward + backward (+ microbatch accumulation) + AdamW
update; ``serve_decode`` one token against the cache, ``serve_prefill``
the batched prompt pass.  ``train_state_pspecs`` gives the train state's
specs on a mesh (``distributed.partitioning``), and ``plan_cell`` — the
counterpart of JAX's ``lower_cell`` — the cell's meta-device arguments,
their specs and the step that would run on them; it lowers nothing (the
dry run, ``launch.dryrun``, runs the step on meta).

Gradients come from ``torch.autograd``; on the card they run through the
hand-written attention and RG-LRU kernels forwards and backwards.  The
step returns a new state; the state it was given is left as it was.

On a data-parallel mesh (``group``: the ``torch.distributed`` data
group) the step computes what JAX's jit of the same step over a
``(data, model)`` mesh computes: each rank takes its rows of every
microbatch (``rank_rows``: the global batch split ``grad_accum`` ways,
each part split over the data ranks as ``batch_pspecs`` shards it), the
model sums over the global batch (``distributed.ctx.data_parallel``), the
ranks' gradients are all-reduced as an exact f32 SUM, and the global norm
and the clip are taken on the whole gradient.  With ZeRO-1
(``zero1_shard``) each rank updates its slice of the moments and the
parameters are all-gathered.

On a ``(data, model)`` mesh with ``model > 1`` (``model_group``: the
ranks of this rank's data row) each rank holds its slices of the train
state along ``model`` (``train_state_pspecs``) and runs the whole
batch of its data row through the tensor-parallel model
(``distributed.ctx.model_parallel``; ``partitioning.tp_layout``): the
gradients are this rank's slices, whole and equal on every model rank
for the replicated leaves, summed over the data group only;
``model_shards`` tells the optimizer which leaves ``model`` splits.

With ``fsdp_units`` (ZeRO-3) a rank holds only its block along ``data``
of every parameter ``param_pspecs`` splits there (``param_shards``: the
shard group, the pod group and the split leaves, from the specs): the
model gathers a unit's blocks where it runs it (``ctx.param_shards``),
their gradients arrive reduce-scattered over the shard group and stay
out of the data group's all-reduce (summed over the pods only), and the
optimizer updates each block where it lies (``ShardedUpdate.held``).
The experts of ``moe_shard_mode="e_data_f_model"`` are split over
``data`` the same way and are computed where they lie: their gradients
are whole on their owner, and a sum over ``data`` would count them once
a data rank.

Serving on such a mesh (``make_serve_prefill`` / ``make_serve_decode``
with the rank's groups) is this rank's part of the prefill and decode
cells JAX's ``lower_cell`` jits: the global batch in, the rank's rows
run on its slices of the parameters (``serve_params``) and of the cache
inside ``ctx.model_parallel``, its columns of the logits out.
``plan_cell(rank=)`` gives one rank's program of a cell on any mesh,
its groups stand-ins that log their collectives (``launch.mesh.
plan_mesh``), for the dry run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeSpec, input_specs
from repro_torch.device import resolve_device
from repro_torch.distributed import partitioning as part
from repro_torch.distributed.ctx import (ParamShards, all_reduce,
                                         data_parallel, group_rank,
                                         group_size, model_parallel,
                                         param_shards as install_shards)
from repro_torch.launch.mesh import plan_mesh
from repro_torch.models.transformer import (ModelConfig, decode_step,
                                            init_cache, init_params,
                                            loss_fn, prefill)
from repro_torch.storage.checkpoint import place_on_mesh
from repro_torch.train.optimizer import (ModelShards, OptConfig,
                                         ShardedUpdate, adamw_init,
                                         adamw_update, tree_from_paths,
                                         tree_map, tree_paths)
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


def train_state_pspecs(cfg: ModelConfig, ocfg: OptConfig, mesh,
                       state_shape: Params, *, zero1: bool = True) -> Params:
    """PartitionSpecs for the {'params', 'opt'} train state: the moments
    and master follow their parameter's spec (an int8 moment's ``q`` too,
    its ``scale`` replicated on the last dim), then, with ``zero1``, shard
    their first free divisible dim over ``data``; ``count`` replicates."""
    pspecs = part.param_pspecs(cfg, mesh, state_shape["params"])
    zdiv = part.axis_size(mesh, part.FSDP_AXIS)
    flat_specs = {"/".join(p): v for p, v in tree_paths(pspecs)}
    flat_shapes = {"/".join(p): tuple(v.shape)
                   for p, v in tree_paths(state_shape["params"])}

    def opt_spec(path, leaf):
        if path == "count":
            return part.P()
        _, rest = path.split("/", 1)
        suffix = None
        if rest not in flat_specs and rest.endswith(("/q", "/scale")):
            rest, suffix = rest.rsplit("/", 1)  # int8 moment {'q','scale'}
        base = flat_specs[rest]
        parts = list(base) + [None] * (len(flat_shapes[rest]) - len(base))
        if suffix == "scale":
            parts[-1] = None  # scale dim is size-1
        spec = part.P(*parts)
        return (part.zero1_spec(spec, tuple(leaf.shape), zdiv) if zero1
                else spec)

    opt_specs = tree_from_paths((p, opt_spec("/".join(p), leaf))
                                for p, leaf in tree_paths(state_shape["opt"]))
    return {"params": pspecs, "opt": opt_specs}


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


def rank_rows(batch: dict, grad_accum: int, rank: int, world: int) -> dict:
    """Rank ``rank``'s rows of a global batch, in microbatch order: the
    batch cut into ``grad_accum`` microbatches as ``loss_and_grads``
    cuts it, each cut into ``world`` contiguous blocks (``batch_pspecs``'
    split over the data axis), block ``rank`` of each kept."""
    out = {}
    for k, v in batch.items():
        d = part.batch_dim(k)
        b = v.shape[d]
        if b % (grad_accum * world):
            raise ValueError(
                f"batch {k!r} of {b} rows does not split into "
                f"{grad_accum} microbatches over {world} data ranks")
        mb, per = b // grad_accum, b // (grad_accum * world)
        out[k] = torch.cat([v.narrow(d, i * mb + rank * per, per)
                            for i in range(grad_accum)], dim=d)
    return out


#: Elements a gradient's segment of the all-reduce buffer is padded to:
#: each segment starts 512-byte aligned, as a tensor of its own would, so
#: the reductions that read it (the global norm) take the same path.
_SEGMENT = 128


def _sum_over(items: list, group) -> list:
    """The gradients ((path, leaf) pairs) summed over ``group`` in f32,
    one all-reduce over one buffer holding them all (each an aligned
    segment of it)."""
    paths, leaves = zip(*items)
    sizes = [-(-g.numel() // _SEGMENT) * _SEGMENT for g in leaves]
    flat = torch.zeros(sum(sizes), dtype=torch.float32,
                       device=leaves[0].device)
    out, at = [], 0
    for g, n in zip(leaves, sizes):
        seg = flat[at:at + g.numel()].view(g.shape)
        seg.copy_(g)
        out.append(seg)
        at += n
    all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return list(zip(paths, out))


def _sync(grads: Params, group, shards: ParamShards | None) -> Params:
    """The ranks' gradients summed: over the data ``group`` where a leaf
    is whole on every data rank; a leaf ``shards`` splits over ``data``
    came whole for this rank's block from the shard group (the unit
    gathers' reduce-scatter, an expert's owner) and is summed over the
    pods only."""
    held = shards.held if shards is not None else {}
    items = list(tree_paths(grads))
    rest = [(p, g) for p, g in items if p not in held]
    mine = [(p, g.to(torch.float32)) for p, g in items if p in held]
    if rest and group_size(group) > 1:  # a sum over one rank is itself
        rest = _sum_over(rest, group)
    pods = shards.pod_group if shards is not None else None
    if mine and pods is not None and group_size(pods) > 1:
        mine = _sum_over(mine, pods)
    return tree_from_paths(rest + mine)


def loss_and_grads(cfg: ModelConfig, params: Params, batch,
                   grad_accum: int = 1, group=None, model_group=None,
                   shards: ParamShards | None = None
                   ) -> tuple[torch.Tensor, dict, Params]:
    """The train step's (loss, metrics, grads) before the update.  With
    ``grad_accum > 1`` the batch is split along its first axis into
    microbatches run in turn; gradients accumulate in f32 in order, as
    JAX's ``lax.scan`` does, and loss, ce and gradients are their means.

    With a data ``group``, ``batch`` is the global batch: this rank runs
    its rows of each microbatch (``rank_rows``) with the model's sums
    taken over the group, and the gradients (f32) are the SUM of the
    ranks' parts before the mean over microbatches.  With a
    ``model_group`` (needs a data ``group``) ``params`` are this rank's
    slices along ``model`` and so are the gradients; with ``shards``
    (``param_shards``) the leaves it splits are this rank's blocks along
    ``data``, and so are their gradients (``_sync``)."""
    if group is None:
        if model_group is not None or shards is not None:
            raise ValueError("a model group or parameter shards need "
                             "their data group")
        return _loss_and_grads(cfg, params, batch, grad_accum)
    local = rank_rows(batch, grad_accum, group_rank(group),
                      group_size(group))
    with data_parallel(group), model_parallel(model_group), \
            install_shards(shards):
        loss, metrics, grads = _loss_and_grads(cfg, params, local,
                                               grad_accum, mean=False)
    grads = _sync(grads, group, shards)
    if grad_accum > 1:
        grads = tree_map(lambda g: g / grad_accum, grads)
        metrics["tokens"] = torch.tensor(batch["labels"].numel(),
                                         dtype=torch.int32,
                                         device=loss.device)
    return loss, metrics, grads


def _loss_and_grads(cfg: ModelConfig, params: Params, batch,
                    grad_accum: int, mean: bool = True):
    """``loss_and_grads`` on one rank's rows; without ``mean`` the
    accumulated gradients are left as sums over the microbatches."""
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
    grads = tree_map(lambda g: g / grad_accum, gacc) if mean else gacc
    metrics = {"ce": ceacc / grad_accum,
               "moe_aux": torch.zeros((), dtype=torch.float32,
                                      device=lacc.device),
               "tokens": torch.tensor(batch["labels"].numel(),
                                      dtype=torch.int32, device=lacc.device)}
    return lacc / grad_accum, metrics, grads


def make_train_step(cfg: ModelConfig, ocfg: OptConfig,
                    schedule: Callable[[torch.Tensor], torch.Tensor]
                    | None = None, grad_accum: int = 1, *, group=None,
                    shard: ShardedUpdate | None = None,
                    model: ModelShards | None = None,
                    data: ParamShards | None = None):
    """forward+backward (+ microbatch accumulation) + AdamW update:
    ``train_step(state, batch) -> (new_state, metrics)``.  With a data
    ``group`` the step takes the global batch on every rank and reduces
    over the group (``loss_and_grads``); ``shard`` (``zero1_shard``) is
    this rank's ZeRO-1 share of the update; ``model`` (``model_shards``)
    its place on a ``model`` axis of more than one rank; ``data``
    (``param_shards``) the parameters split over ``data``."""
    schedule = schedule or constant(3e-4)
    model_group = None if model is None else model.group

    def train_step(state: Params, batch: dict[str, torch.Tensor]):
        loss, metrics, grads = loss_and_grads(cfg, state["params"], batch,
                                              grad_accum, group, model_group,
                                              data)
        new_params, new_opt, info = adamw_update(
            ocfg, schedule, state["params"], grads, state["opt"], shard,
            model, data)
        metrics = dict(metrics)
        metrics.update(info)
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def zero1_shard(state_specs: Params, params: Params, mesh, position: int,
                group, held=()) -> ShardedUpdate:
    """Mesh position ``position``'s ZeRO-1 share of the update under the
    train state's specs (``train_state_pspecs(..., zero1=True)``): for
    each parameter of ``params`` (any tensors of its shapes), the slice
    its moment shard covers (an int8 moment's codes ``q``) and the dim
    the data axis cuts (None where no dim divides and the moment is
    whole); ``group`` is the data group.  On a ``model`` axis the slice is
    of the rank's own slice of the parameter along ``model``.  The
    parameters of ``held`` (paths) are themselves this rank's block along
    ``data``: the share is all of the block, and the dim the one ``data``
    splits."""
    index, dims = {}, {}
    for path, p in tree_paths(params):
        spec = state_specs["opt"]["m"]
        for k in path:
            spec = spec[k]
        if isinstance(spec, dict):          # int8 {'q', 'scale'}
            spec = spec["q"]
        if path in held:
            index[path] = (slice(None),) * p.dim()
            dims[path] = part.sharded_dim(spec, part.FSDP_AXIS)
            continue
        on = [part.axes_of(e) for e in spec]
        local = part.local_shape(p.shape, part.P(*(
            e if part.MODEL_AXIS in a else None for e, a in zip(spec, on))),
            mesh)
        data = part.P(*(None if part.MODEL_AXIS in a else e
                        for e, a in zip(spec, on)))
        index[path] = part.NamedSharding(mesh, data).index(local, position)
        dims[path] = part.sharded_dim(spec, part.FSDP_AXIS)
    return ShardedUpdate(group, index, dims, frozenset(held))


def model_shards(cfg: ModelConfig, mesh, group) -> ModelShards | None:
    """This rank's place on ``mesh``'s ``model`` axis for the optimizer
    (``group``: its model group), or None for ``model = 1``: the
    parameter paths ``param_pspecs`` splits over ``model``, and those it
    splits along their last dim."""
    if part.axis_size(mesh, part.MODEL_AXIS) == 1:
        return None
    shape = init_params(cfg, torch.Generator().manual_seed(0),
                        device="meta")
    dims = {p: x.dim() for p, x in tree_paths(shape)}
    specs = part.param_pspecs(cfg, mesh, shape)
    sharded = part.model_sharded_paths(specs)
    rows = frozenset(p for p, spec in tree_paths(specs)
                     if p in sharded and len(spec) == dims[p]
                     and part.MODEL_AXIS in part.axes_of(spec[-1]))
    return ModelShards(group, sharded, rows)


def param_shards(cfg: ModelConfig, mesh, params: Params | None = None
                 ) -> ParamShards | None:
    """This rank's ``ctx.ParamShards`` on ``mesh`` (its groups: the shard
    group is the ZeRO-1 group, the data group on one pod), or None where
    ``data`` splits no parameter (one data rank, no ``fsdp_units`` nor
    ``e_data_f_model``): the leaves ``param_pspecs`` splits over ``data``
    and along which dim (``partitioning.data_split``); ``params``: any
    tensors of the parameters' shapes (a meta init by default)."""
    if part.axis_size(mesh, part.FSDP_AXIS) == 1:
        return None
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="meta")
    gathered, owned = part.data_split(cfg, part.param_pspecs(cfg, mesh,
                                                             params))
    if not (gathered or owned):
        return None
    return ParamShards(mesh.zero1_group or mesh.data_group, mesh.pod_group,
                       gathered, owned)


def mesh_train_step(cfg: ModelConfig, ocfg: OptConfig, mesh, position: int,
                    schedule=None, *, grad_accum: int = 1,
                    zero1: bool = True):
    """(the train step, this rank's ZeRO-1 share or None) of mesh
    position ``position`` on a ``(data, model)`` mesh with its groups
    (``launch.mesh.make_data_mesh``, or ``plan_mesh``'s stand-ins), the
    ``Trainer``'s step: the data group's sums, the rank's ZeRO-1 share
    (``zero1_shard``), its blocks of the parameters split over ``data``
    (``param_shards``) and its place on ``model`` (``model_shards``).
    A split that does not divide raises ``ValueError`` naming the leaf;
    a rule the port does not take raises by name
    (``partitioning.tp_plan``)."""
    part.tp_plan(cfg, mesh)
    state_shape = abstract_train_state(cfg, ocfg)
    specs = train_state_pspecs(cfg, ocfg, mesh, state_shape, zero1=zero1)
    part.tree_local_shapes(state_shape, specs, mesh)
    shards = param_shards(cfg, mesh, state_shape["params"])
    shard = None
    if zero1 or shards is not None:
        shard = zero1_shard(specs, state_shape["params"], mesh, position,
                            mesh.zero1_group or mesh.data_group,
                            shards.held if shards is not None else ())
    return make_train_step(cfg, ocfg, schedule, grad_accum,
                           group=mesh.data_group, shard=shard,
                           model=model_shards(cfg, mesh, mesh.model_group),
                           data=shards), shard


def _rank_batch(group, rows: int) -> tuple[Any, slice]:
    """The data group a serving step sums over (None: no sum) and this
    rank's rows of a global batch of ``rows``: a contiguous block of them
    where the group divides them (``batch_pspecs``), every row where it
    does not (JAX's fallback: the batch replicates)."""
    if group is None:
        return None, slice(0, rows)
    n, r = group_size(group), group_rank(group)
    if n == 1 or rows % n:
        return None, slice(0, rows)
    return group, slice(r * (rows // n), (r + 1) * (rows // n))


def _on_mesh(fn, group, model_group, shards, inputs, position_ids):
    """``fn(inputs, position_ids)`` on this rank's rows, inside its data
    and model groups and its parameter shards (``fn`` itself without
    any)."""
    if group is None and model_group is None and shards is None:
        return fn(inputs, position_ids)
    data, rows = _rank_batch(group, inputs.shape[0])
    if position_ids is not None:        # [3, B, S]
        position_ids = position_ids[:, rows]
    with data_parallel(data), model_parallel(model_group), \
            install_shards(shards):
        return fn(inputs[rows], position_ids)


def make_serve_decode(cfg: ModelConfig, max_seq: int | None = None, *,
                      group=None, model_group=None,
                      shards: ParamShards | None = None):
    """``serve_decode(params, cache, inputs, index, position_ids=None)``:
    one token against the cache.  With ``group`` / ``model_group`` (a
    ``(data, model)`` mesh's groups of this rank) it is this rank's part
    of JAX's decode cell: it takes the global inputs and runs its rows
    (``_rank_batch``) on its slices of the parameters (``param_pspecs``)
    and its cache (``cache_pspecs`` of a cache of ``max_seq``
    positions), inside ``ctx.model_parallel``; the logits are its
    columns of the vocabulary.  ``shards`` (``param_shards``): the
    parameters split over ``data``, gathered a unit at a time."""
    def serve_decode(params, cache, inputs, index, position_ids=None):
        return _on_mesh(lambda x, ids: decode_step(
            cfg, params, cache, x, index, ids, max_seq=max_seq), group,
            model_group, shards, inputs, position_ids)
    return serve_decode


def make_serve_prefill(cfg: ModelConfig, max_seq: int, *, group=None,
                       model_group=None, shards: ParamShards | None = None):
    """``serve_prefill(params, inputs, position_ids=None)``: the batched
    prompt pass, (last logits, cache).  With ``group`` / ``model_group``
    / ``shards`` it is this rank's part of JAX's prefill cell, as
    ``make_serve_decode``'s: its rows, its slices of the parameters, its
    slices of the cache, its columns of the logits."""
    def serve_prefill(params, inputs, position_ids=None):
        return _on_mesh(lambda x, ids: prefill(
            cfg, params, x, max_seq=max_seq, position_ids=ids), group,
            model_group, shards, inputs, position_ids)
    return serve_prefill


def serve_params(cfg: ModelConfig, mesh, params: Params,
                 position: int | None = None) -> Params:
    """Mesh position ``position``'s slices (this rank's by default) of
    the whole ``params`` under ``param_pspecs``, on its device
    (``storage.checkpoint.place_on_mesh``)."""
    return place_on_mesh(params, part.shardings(
        mesh, part.param_pspecs(cfg, mesh, params)), position)


def serve_cache(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                device=None) -> Params:
    """This rank's empty cache on ``mesh`` for a global batch of
    ``batch`` rows: its rows (``_rank_batch``), its slices of the slots
    and states (``cache_pspecs``)."""
    rows = _rank_batch(mesh.data_group, batch)[1]
    with model_parallel(mesh.model_group):
        return init_cache(cfg, rows.stop - rows.start, max_seq, device)


def local_meta(tree: Params, specs: Params, mesh) -> Params:
    """Meta tensors of the shapes one position of ``mesh`` holds of each
    leaf of ``tree`` under ``specs`` (``partitioning.local_shape``)."""
    local = part.tree_local_shapes(tree, specs, mesh)
    return tree_from_paths(
        (p, torch.empty(local[p], dtype=x.dtype, device="meta"))
        for p, x in tree_paths(tree))


def to_device(tree, device=None):
    """A batch or state tree moved to ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev), tree)


# ---------------------------------------------------------------------------
# the plan of one (arch x shape) cell on a mesh — used by the dry run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellPlan:
    """One cell's step, its meta-device arguments and their specs.

    ``args`` are the step's positional arguments (``index``, decode's
    position, a Python int: the port's decode takes one); ``groups`` splits
    them into ``params`` / ``opt`` / ``batch`` / ``cache`` trees, each with
    its spec tree, for the per-device byte count.  A plan of one rank
    (``rank``) holds that rank's slices of the state and the cache, and
    ``collectives`` is the log its stand-in groups fill while the step
    runs (``{kind: {"calls", "bytes"}}``); None for the whole program."""
    kind: str
    step: Callable
    args: tuple
    groups: dict[str, tuple[Any, Any]]
    rules: dict
    rank: int | None = None
    collectives: dict | None = None

    def run(self):
        """The step on its arguments: with gradients for a train cell,
        under ``torch.inference_mode`` for serving, as the trainer and the
        serving engine run it."""
        if self.collectives is not None:
            self.collectives.clear()
        if self.kind == "train":
            return self.step(*self.args)
        with torch.inference_mode():
            return self.step(*self.args)


def plan_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
              ocfg: OptConfig | None = None, zero1: bool = True,
              grad_accum: int = 1, rank: int | None = None,
              max_seq: int | None = None,
              index: int | None = None) -> CellPlan:
    """The counterpart of the JAX package's ``lower_cell``: the arguments
    ``lower_cell`` would lower the cell's step on (from
    ``abstract_train_state`` or a meta ``init_params``, ``input_specs``, and
    for decode the cache), as meta tensors, their specs on ``mesh``, and
    the step (``make_train_step`` / ``make_serve_prefill`` /
    ``make_serve_decode``).  Nothing is lowered or run.

    With ``rank`` the plan is that mesh position's program (``plan_mesh``'s
    stand-in groups): its slices of the state, parameters and cache as
    its arguments, the global batch (the steps take their rows), and the
    step the ``Trainer`` / the serving steps run there
    (``mesh_train_step``, ``make_serve_*(group=, model_group=)``); the
    rules the port does not take raise by name.  ``max_seq`` (a serving
    cell's cache length, ``shape.seq_len`` by default) and ``index`` (the
    decode position, ``shape.seq_len - 1`` by default) plan a serving
    call other than the cell's own."""
    ocfg = ocfg or OptConfig()
    specs = input_specs(cfg, shape)
    rules = part.activation_rules(cfg, mesh, shape.global_batch)
    log = None
    if rank is not None:
        log = {}
        mesh = plan_mesh(mesh, rank, log)
        part.tp_plan(cfg, mesh)
        if part.batch_axes(mesh, shape.global_batch) not in (
                None, part.dp_axes(mesh)):
            raise NotImplementedError(
                f"a batch of {shape.global_batch} split over part of the "
                f"data axes {part.dp_axes(mesh)} is not planned")

    def local(tree, tree_specs):
        return tree if rank is None else local_meta(tree, tree_specs, mesh)

    if shape.kind == "train":
        state = abstract_train_state(cfg, ocfg)
        state_specs = train_state_pspecs(cfg, ocfg, mesh, state, zero1=zero1)
        batch = specs["batch"]
        step = (make_train_step(cfg, ocfg, grad_accum=grad_accum)
                if rank is None else
                mesh_train_step(cfg, ocfg, mesh, rank, grad_accum=grad_accum,
                                zero1=zero1)[0])
        return CellPlan(
            "train", step, (local(state, state_specs), batch),
            {"params": (state["params"], state_specs["params"]),
             "opt": (state["opt"], state_specs["opt"]),
             "batch": (batch, part.batch_pspecs(cfg, mesh, batch))}, rules,
            rank, log)

    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="meta")
    param_specs = part.param_pspecs(cfg, mesh, params)
    arg_groups = {"params": (params, param_specs)}
    groups = {}
    if rank is not None:
        groups = {"group": mesh.data_group, "model_group": mesh.model_group,
                  "shards": param_shards(cfg, mesh, params)}
    inputs = {k: specs[k] for k in ("inputs", "position_ids") if k in specs}
    binp = part.batch_axes(mesh, shape.global_batch)
    max_seq = shape.seq_len if max_seq is None else max_seq
    if shape.kind == "prefill":
        arg_groups["batch"] = (inputs, part.batch_pspecs(cfg, mesh, inputs))
        return CellPlan(
            "prefill", make_serve_prefill(cfg, max_seq, **groups),
            (local(params, param_specs), inputs["inputs"],
             inputs.get("position_ids")), arg_groups, rules, rank, log)
    if shape.kind != "decode":
        raise ValueError(f"unknown cell kind {shape.kind!r}")
    cache = specs["cache"]
    if max_seq != shape.seq_len:
        cache = init_cache(cfg, shape.global_batch, max_seq, device="meta")
    cache_specs = part.cache_pspecs(cfg, mesh, cache)
    arg_groups["cache"] = (cache, cache_specs)
    in_specs = {"inputs": part.P(binp, *([None] * (inputs["inputs"].dim()
                                                   - 1)))}
    if "position_ids" in inputs:
        in_specs["position_ids"] = part.P(None, binp, None)
    arg_groups["batch"] = (inputs, in_specs)
    return CellPlan(
        "decode", make_serve_decode(cfg, max_seq, **groups),
        (local(params, param_specs), local(cache, cache_specs),
         inputs["inputs"], shape.seq_len - 1 if index is None else index,
         inputs.get("position_ids")), arg_groups, rules, rank, log)
