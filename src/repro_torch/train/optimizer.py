"""AdamW with fp32 master weights and quantised moment storage.

The port of the JAX package's ``repro.train.optimizer``, with its state
layout, so a JAX train state carries across
(``repro_torch.models.convert.train_state_from_jax``):

* **fp32 master** — model params live in bf16 for compute; the optimizer
  keeps the fp32 copy.
* **Moment dtypes** — ``f32`` (default), ``bf16``, or ``int8`` with
  per-row (last-axis) fp32 scales ``{"q", "scale"}``.  Quantisation is
  stateless (re-quantised each step).
* Global-norm clipping, decoupled weight decay, bias correction; the step
  ``count`` is int32, as in JAX.
* **ZeRO-1** — on a data-parallel mesh a rank may hold only a slice of
  each moment and master (``ShardedUpdate``): it updates the slice of the
  parameter that its shard covers and the parameters are all-gathered;
  where the slice splits an int8 moment's rows, a row's absmax is an
  all-reduce MAX, so the shard quantises as the whole leaf would.
* **Tensor parallelism** — on a ``model`` axis a rank holds its slice of
  each model-sharded parameter, gradient and moment (``ModelShards``):
  the global norm sums the sharded leaves' squares over the model group
  and counts each replicated leaf once (JAX's norm of the whole tree),
  and where ``model`` splits an int8 moment's rows, their absmax is a
  MAX over the model group.
* **Parameters split over ``data``** (``fsdp_units``' ZeRO-3 and the
  ``e_data_f_model`` experts: ``ShardedUpdate.held``) — the rank holds
  its block of the parameter, its gradient and its moments; it updates
  the block where it lies and gathers nothing after the update; the
  global norm sums those leaves' squares over the shard group
  (``global_norm(data=)``), and where the block splits an int8 moment's
  rows their absmax is a MAX over it, as ZeRO-1's split rows.

Trees are nested dicts of tensors; leaves are visited in the JAX
package's order (dict keys sorted), which fixes the order of the
global-norm sum.  Each leaf's update is one plain elementwise torch
expression on the leaf's device, in JAX's order of operations (no
``torch.optim``, no foreach or fused kernels: they round differently).
The update returns new tensors; the state it was given is not changed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

Params = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    moment_dtype: str = "f32"      # 'f32' | 'bf16' | 'int8'
    master: bool = True


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def tree_paths(tree, prefix: tuple = (), *, is_leaf=None):
    """(path, leaf) pairs in JAX's leaf order: dict keys sorted."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,), is_leaf=is_leaf)
    else:
        yield prefix, tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the trees ``rest`` of the
    same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_from_paths(items) -> dict:
    """The nested dict of (path, leaf) pairs (``tree_paths``' inverse)."""
    tree: dict = {}
    for path, leaf in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --- int8 per-row quantisation ---------------------------------------------


def _quantize(x: torch.Tensor, row_group=None) -> dict[str, torch.Tensor]:
    """Per-row int8 codes and scales; ``row_group``: the ranks that hold
    the other parts of each row, whose absmax is their all-reduce MAX."""
    xf = x.to(torch.float32)
    if xf.dim() == 0:
        xf = xf[None]
        scale = torch.clamp_min(xf.abs(), 1e-20) / 127.0
    else:
        amax = xf.abs().amax(dim=-1, keepdim=True)
        if row_group is not None:
            from repro_torch.distributed.ctx import all_reduce
            all_reduce(amax, op=dist.ReduceOp.MAX, group=row_group)
        scale = torch.clamp_min(amax, 1e-20) / 127.0
    return {"q": torch.round(xf / scale).to(torch.int8), "scale": scale}


def _dequantize(d: dict[str, torch.Tensor]) -> torch.Tensor:
    return d["q"].to(torch.float32) * d["scale"]


def _store_moment(x: torch.Tensor, dtype: str, row_group=None):
    if dtype == "int8":
        return _quantize(x, row_group)
    return x.to(torch.bfloat16 if dtype == "bf16" else torch.float32)


def _load_moment(x, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequantize(x)
    return x.to(torch.float32)


# --- state ------------------------------------------------------------------


def adamw_init(cfg: OptConfig, params: Params) -> Params:
    def zeros(p):
        return _store_moment(torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), cfg.moment_dtype)
    device = next(leaf for _, leaf in tree_paths(params)).device
    state: dict[str, Any] = {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.master:
        state["master"] = tree_map(lambda p: p.to(torch.float32, copy=True),
                                   params)
    return state


@dataclasses.dataclass(frozen=True)
class ShardedUpdate:
    """One rank's share of a ZeRO-1 update: per parameter path, the slice
    of the parameter its moments and master cover (``index``) and the dim
    that slice cuts over the data group (``dim``; None: the whole leaf,
    which every rank updates alike).  ``group`` is the data group that
    all-gathers the updated slices.  The paths of ``held`` are parameters
    that are themselves this rank's block along ``data`` (``index`` all of
    it): updated where they lie, not gathered."""
    group: Any
    index: dict[tuple, tuple[slice, ...]]
    dim: dict[tuple, int | None]
    held: frozenset = frozenset()

    def gather(self, path: tuple, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf from this rank's slice ``x`` of it (``x`` itself
        for a leaf of ``held``)."""
        from repro_torch.distributed.ctx import all_gather, group_size
        d = self.dim[path]
        world = group_size(self.group)
        if d is None or world == 1 or path in self.held:
            return x
        parts = [torch.empty_like(x) for _ in range(world)]
        all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=d)


@dataclasses.dataclass(frozen=True)
class ModelShards:
    """A rank's place on a ``model`` axis: the model group, the parameter
    paths whose leaves it splits (``sharded``), and those it splits along
    the last dim (``rows``: an int8 moment's rows, quantised over the
    group)."""
    group: Any
    sharded: frozenset
    rows: frozenset


def global_norm(tree: Params, model: ModelShards | None = None,
                data=None) -> torch.Tensor:
    """The L2 norm of every leaf; with ``model`` the norm of the whole
    tree: the squares of the leaves ``model`` splits are summed over its
    group, the replicated leaves (whole on every rank) counted once.
    With ``data`` (a ``ctx.ParamShards``) the squares of the leaves it
    splits are summed over its shard group first."""
    paths, leaves = zip(*((p, torch.sum(torch.square(x.to(torch.float32))))
                          for p, x in tree_paths(tree)))
    if model is None and data is None:
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    from repro_torch.distributed.ctx import all_reduce
    on_model = model.sharded if model is not None else frozenset()
    on_data = data.held if data is not None else {}

    def total(pick):
        picked = [x for p, x in zip(paths, leaves) if pick(p)]
        return torch.sum(torch.stack(picked)) if picked else leaves[0] * 0
    whole = total(lambda p: p not in on_model and p not in on_data)
    split = total(lambda p: p in on_model and p not in on_data)
    if data is not None:      # [data alone, data and model]
        both = torch.stack([total(lambda p: p in on_data
                                  and p not in on_model),
                            total(lambda p: p in on_data and p in on_model)])
        all_reduce(both, op=dist.ReduceOp.SUM, group=data.group)
        whole = whole + both[0]
        split = split + both[1]
    if model is not None:
        all_reduce(split, op=dist.ReduceOp.SUM, group=model.group)
    return torch.sqrt(split + whole if model is not None else whole)


def adamw_update(
    cfg: OptConfig,
    schedule: Callable[[torch.Tensor], torch.Tensor],
    params: Params,
    grads: Params,
    state: Params,
    shard: ShardedUpdate | None = None,
    model: ModelShards | None = None,
    data=None,
) -> tuple[Params, Params, dict[str, torch.Tensor]]:
    """Returns (new_params, new_state, info).  With ``shard`` (ZeRO-1) the
    state's moments and master are this rank's slices, ``params`` and
    ``grads`` whole; the new parameters are whole again.  With ``model``
    (tensor parallelism) every leaf is this rank's slice along
    ``model``; with ``data`` (a ``ctx.ParamShards``) the leaves it splits
    are this rank's blocks along ``data`` (``shard.held``)."""
    count = state["count"] + 1
    lr = schedule(count)

    gnorm = global_norm(grads, model, data)
    if cfg.clip_norm is not None:
        scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                                1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)

    countf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=countf.device), countf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=countf.device), countf)
    md = cfg.moment_dtype

    def upd(path, p, g, m, v, master):
        rows = None
        if shard is not None:
            idx = shard.index[path]
            p, g = p[idx], g[idx]
            if shard.dim[path] is not None and shard.dim[path] == p.dim() - 1:
                rows = shard.group     # the slice splits each moment row
        if model is not None and path in model.rows:
            rows = model.group         # model splits each moment row
        g = g.to(torch.float32) * scale
        mf = cfg.b1 * _load_moment(m, md) + (1 - cfg.b1) * g
        vf = cfg.b2 * _load_moment(v, md) + (1 - cfg.b2) * torch.square(g)
        step = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        base = master if master is not None else p.to(torch.float32)
        new_master = base - lr * (step + cfg.weight_decay * base)
        new_p = new_master.to(p.dtype)
        if shard is not None:
            new_p = shard.gather(path, new_p)
        return (new_p, _store_moment(mf, md, rows),
                _store_moment(vf, md, rows), new_master)

    paths = [path for path, _ in tree_paths(params)]
    out = [upd(path, _get(params, path), _get(grads, path),
               _get(state["m"], path), _get(state["v"], path),
               _get(state["master"], path) if cfg.master else None)
           for path in paths]
    new_params = tree_from_paths((path, o[0]) for path, o in zip(paths, out))
    new_state: dict[str, Any] = {
        "m": tree_from_paths((path, o[1]) for path, o in zip(paths, out)),
        "v": tree_from_paths((path, o[2]) for path, o in zip(paths, out)),
        "count": count,
    }
    if cfg.master:
        new_state["master"] = tree_from_paths(
            (path, o[3]) for path, o in zip(paths, out))
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
