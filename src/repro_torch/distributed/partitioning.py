"""Path- and config-aware parameter / activation / cache partitioning.

The port of the JAX package's ``repro.distributed.partitioning``: the same
rules, giving the same specs path by path, over a ``launch.mesh.MeshSpec``
(``(pod, data, model)`` multi-pod, ``(data, model)`` single-pod or one
card).  A spec is a ``PartitionSpec``: one entry per tensor dim, ``None``
(replicated), a mesh axis name, or a tuple of them.  ``to_placements``
turns a spec into ``torch.distributed.tensor`` placements, one per mesh
dim, and ``local_shape`` / ``local_nbytes`` give what one device holds.

**Divisibility-first**: a sharded dim must divide exactly (no padding),
and the assigned archs have awkward head / expert / vocab counts, so
every rule checks divisibility against the mesh and falls back along a
documented chain:

* attention — head-parallel when the kv-head or query-group axis divides
  the ``model`` axis; otherwise the weights replicate over ``model`` and
  the *sequence* axis of attention activations is model-sharded instead
  (``activation_rules``' ``"seq"``, read by ``ctx.constrain``).  Decode
  shards the KV cache's sequence dim over ``model``.
* MoE — expert-parallel over ``model`` when E divides; otherwise the
  weights replicate and the dispatch buffers' capacity-slot axis shards
  over ``model`` (``"moe_cap"``); ``moe_shard_mode`` selects the
  ``e_data_f_model`` and ``f_model`` variants.
* FFN / RG-LRU — column / row over ``model``.
* embeddings — vocab padded to a multiple of 256 in-model
  (``ModelConfig.padded_vocab``) then vocab-sharded over ``model``.
* ``fsdp_units`` (llama4) — parameters additionally shard their first
  free divisible dim over ``data`` (ZeRO-3 storage).
* ZeRO-1 — optimizer moments / master shard their first free divisible
  dim over ``data``.
* xLSTM mixers — replicated (pure data parallel); ZeRO-1 still applies.

The JAX package's ``shard_points`` (``shard_map`` of a sweep over several
devices) is not ported: it needs more than one card.
"""

from __future__ import annotations

import math
import re
from typing import TYPE_CHECKING, Any

import torch

from repro_torch.train.optimizer import tree_from_paths, tree_paths

if TYPE_CHECKING:   # the model imports ctx, which imports this module
    from repro_torch.models.transformer import LayerSpec, ModelConfig

MODEL_AXIS = "model"
FSDP_AXIS = "data"
POINTS_AXIS = "points"


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name or a tuple of
    axis names (the dim is split over them, the first the major one); a
    tuple of one name is that name, as in ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name]


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(n for n in mesh.axis_names if n != MODEL_AXIS)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _layer_spec_for(cfg: ModelConfig, path: str) -> LayerSpec | None:
    m = re.search(r"unit/layer(\d+)", path)
    if m:
        return cfg.pattern[int(m.group(1))]
    m = re.search(r"tail/tail(\d+)", path)
    if m:
        return cfg.tail[int(m.group(1))]
    return None


def _attn_param_spec(cfg: ModelConfig, name: str, tp: int) -> P:
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    if kvh % tp == 0:
        kv, gq = MODEL_AXIS, None
    elif g % tp == 0:
        kv, gq = None, MODEL_AXIS
    else:  # replicated weights; sequence-sharded activations instead
        kv = gq = None
    return {
        "wq": P(None, kv, gq, None),
        "wk": P(None, kv, None),
        "wv": P(None, kv, None),
        "wo": P(kv, gq, None, None),
        "bq": P(kv, gq, None),
        "bk": P(kv, None),
        "bv": P(kv, None),
        "bo": P(None),
    }[name]


def _rglru_spec(cfg: ModelConfig, name: str, tp: int) -> P:
    r = cfg.rglru.d_rnn if cfg.rglru else 0
    h = cfg.rglru.n_heads if cfg.rglru else 0
    rm = MODEL_AXIS if r % tp == 0 else None
    hm = MODEL_AXIS if h % tp == 0 else None
    return {
        "wx": P(None, rm), "wy": P(None, rm), "wo": P(rm, None),
        "conv_w": P(None, rm), "conv_b": P(rm),
        "a_gate": P(hm, None, None), "x_gate": P(hm, None, None),
        "a_bias": P(rm), "x_bias": P(rm), "lambda": P(rm),
    }[name]


def _ffn_spec(cfg: ModelConfig, name: str, tp: int) -> P:
    fm = MODEL_AXIS if cfg.d_ff % tp == 0 else None
    return {
        "wi": P(None, fm), "wg": P(None, fm), "wo": P(fm, None),
        "bi": P(fm), "bo": P(None),
    }[name]


def _moe_spec(cfg: ModelConfig, name: str, tp: int) -> P:
    """Expert-parallel when E divides the TP axis; otherwise capacity-slot
    parallel: the weights replicate and ``apply_moe``'s dispatch buffers
    shard their slot axis over ``model`` (``ctx.constrain``).  The
    ``e_data_f_model`` mode shards experts over ``data`` and their width
    over ``model``; ``f_model`` shards each expert's width only."""
    e = cfg.moe.n_experts
    sf = cfg.moe.shared_d_ff
    sm = MODEL_AXIS if sf % tp == 0 and sf else None
    shared = {"shared_wi": P(None, sm), "shared_wg": P(None, sm),
              "shared_wo": P(sm, None)}
    if cfg.moe_shard_mode == "e_data_f_model":
        return {
            "router": P(None, None),
            "wi": P(FSDP_AXIS, None, MODEL_AXIS),
            "wg": P(FSDP_AXIS, None, MODEL_AXIS),
            "wo": P(FSDP_AXIS, MODEL_AXIS, None), **shared,
        }[name]
    if cfg.moe_shard_mode == "f_model":
        fm = MODEL_AXIS if cfg.moe.d_ff % tp == 0 else None
        return {
            "router": P(None, None),
            "wi": P(None, None, fm), "wg": P(None, None, fm),
            "wo": P(None, fm, None), **shared,
        }[name]
    ew = MODEL_AXIS if e % tp == 0 else None
    return {
        "router": P(None, None),
        "wi": P(ew, None, None), "wg": P(ew, None, None),
        "wo": P(ew, None, None), **shared,
    }[name]


def _leaf_param_spec(cfg: ModelConfig, path: str, ndim: int, tp: int) -> P:
    """Spec for the *unstacked* view of the leaf (``ndim`` excludes any
    leading unit axis)."""
    name = path.rsplit("/", 1)[-1]
    if path.startswith("embed/"):
        return P(MODEL_AXIS, None)   # vocab padded to x256 => always divides
    if path.startswith("head/"):
        return P(None, MODEL_AXIS)
    if "norm" in path or path.startswith("final_norm"):
        return P(*([None] * ndim))
    spec = _layer_spec_for(cfg, path)
    if spec is None:
        return P(*([None] * ndim))
    if "/mixer/" in path:
        if spec.mixer == "attn":
            return _attn_param_spec(cfg, name, tp)
        if spec.mixer == "rglru":
            return _rglru_spec(cfg, name, tp)
        return P(*([None] * ndim))   # mlstm/slstm: replicated (pure DP)
    if "/ffn/" in path:
        if spec.ffn == "moe":
            return _moe_spec(cfg, name, tp)
        return _ffn_spec(cfg, name, tp)
    return P(*([None] * ndim))


def _insert_axis(spec: P, shape: tuple[int, ...], axis: str, divisor: int,
                 start_dim: int = 0) -> P:
    """Add ``axis`` on the first free exactly-divisible dim >= start_dim.
    No-op if the axis already shards some dim (a mesh axis may appear in
    at most one position of a spec)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if any(axis in _axes(e) for e in parts):
        return P(*parts)
    for i in range(start_dim, len(shape)):
        if parts[i] is None and shape[i] % divisor == 0 and shape[i] > 1:
            parts[i] = axis
            return P(*parts)
    return P(*parts)


def _map_paths(fn, tree) -> Any:
    """``fn("a/b/c", leaf)`` over a nested dict's leaves, keeping its
    structure (``jax.tree_util.tree_map_with_path`` with the path as the
    JAX package's ``_path_str`` writes it)."""
    return tree_from_paths((path, fn("/".join(path), leaf))
                           for path, leaf in tree_paths(tree))


def param_pspecs(cfg: ModelConfig, mesh, params_shape: Any) -> Any:
    """PartitionSpec tree matching ``params_shape`` (tensors, meta or not)."""
    tp = axis_size(mesh, MODEL_AXIS)
    fsdp = axis_size(mesh, FSDP_AXIS)

    def spec_of(path, leaf):
        stacked = path.startswith("unit/")
        shape = tuple(leaf.shape)
        base = _leaf_param_spec(cfg, path, len(shape) - (1 if stacked else 0),
                                tp)
        if stacked:
            base = P(None, *base)     # stacked unit axis in front
            if cfg.fsdp_units:
                base = _insert_axis(base, shape, FSDP_AXIS, fsdp, start_dim=1)
        elif cfg.fsdp_units and not path.startswith(("embed/", "head/")):
            base = _insert_axis(base, shape, FSDP_AXIS, fsdp)
        return base

    return _map_paths(spec_of, params_shape)


def zero1_spec(spec: P, shape: tuple[int, ...], divisor: int) -> P:
    """Extra 'data' sharding for optimizer state (first free divisible dim)."""
    return _insert_axis(spec, shape, FSDP_AXIS, divisor)


# ---------------------------------------------------------------------------
# activations / batches / caches
# ---------------------------------------------------------------------------


def batch_axes(mesh, batch_size: int) -> tuple[str, ...] | None:
    """DP axes to shard a batch dim over (largest prefix that divides)."""
    axes = dp_axes(mesh)
    sizes = mesh.shape
    for cand in (axes, axes[1:] if len(axes) > 1 else ()):
        if cand and batch_size % math.prod(sizes[a] for a in cand) == 0:
            return cand
    return None


def activation_rules(cfg: ModelConfig, mesh, batch_size: int) -> dict:
    """Logical-dim rules consumed by ``repro_torch.distributed.ctx``.

    'seq' maps to the model axis only when attention weights could NOT be
    head-sharded (context-parallel fallback); otherwise constraining the
    sequence would conflict with head parallelism.
    """
    tp = axis_size(mesh, MODEL_AXIS)
    g = cfg.n_heads // cfg.n_kv_heads
    head_tp = (cfg.n_kv_heads % tp == 0) or (g % tp == 0)
    moe_slot = cfg.moe is not None and cfg.moe.n_experts % tp != 0
    return {"batch": batch_axes(mesh, batch_size),
            "seq": None if head_tp else MODEL_AXIS,
            "moe_cap": MODEL_AXIS if moe_slot else None}


def batch_pspecs(cfg: ModelConfig, mesh, batch: Any) -> Any:
    """Specs for a train/prefill batch dict (leading batch dim sharded).
    ``position_ids`` has layout [3, B, S] — batch on axis 1."""

    def spec_of(path, leaf):
        bdim = 1 if path.endswith("position_ids") else 0
        parts: list = [None] * leaf.dim()
        parts[bdim] = batch_axes(mesh, leaf.shape[bdim])
        return P(*parts)

    return _map_paths(spec_of, batch)


def cache_pspecs(cfg: ModelConfig, mesh, cache_shape: Any) -> Any:
    """Decode-state specs: batch over DP; long (seq / width) dims over model.

    KV caches shard the *sequence* slot axis over ``model``; recurrent
    states shard their feature width when divisible.
    """
    tp = axis_size(mesh, MODEL_AXIS)

    def spec_of(path, leaf):
        stacked = path.startswith("unit/")
        name = path.rsplit("/", 1)[-1]
        shape = tuple(leaf.shape)
        dims: list = [None] * len(shape)
        bdim = 1 if stacked else 0
        dims[bdim] = batch_axes(mesh, shape[bdim])
        if name in ("k", "v"):                       # [.., B, kvH, S, Dh]
            if shape[bdim + 2] % tp == 0:
                dims[bdim + 2] = MODEL_AXIS
        elif name == "pos":                          # [.., B, S]
            if shape[bdim + 1] % tp == 0:
                dims[bdim + 1] = MODEL_AXIS
        elif name in ("h", "c", "n", "m", "C", "conv"):
            if shape[-1] % tp == 0 and shape[-1] > 1:
                dims[-1] = MODEL_AXIS
        return P(*dims)

    return _map_paths(spec_of, cache_shape)


def points_spec(ndim: int) -> P:
    """Leading axis over ``points``, everything else replicated."""
    return P(POINTS_AXIS, *([None] * (ndim - 1)))


# ---------------------------------------------------------------------------
# what one device holds
# ---------------------------------------------------------------------------


def _check_axes(spec: P, mesh) -> None:
    used = [a for e in spec for a in _axes(e)]
    unknown = [a for a in used if a not in mesh.shape]
    if unknown or len(used) != len(set(used)):
        raise ValueError(f"spec {spec} does not fit mesh axes "
                         f"{mesh.axis_names}")


def to_placements(spec: P, mesh) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``, one
    per mesh dim: ``Shard(d)`` where the axis splits tensor dim d, else
    ``Replicate()``.  A dim split over several axes gets ``Shard(d)`` on
    each, the major axis first (the order of the mesh's dims)."""
    from torch.distributed.tensor import Replicate, Shard
    _check_axes(spec, mesh)
    owner = {a: d for d, e in enumerate(spec) for a in _axes(e)}
    for d, e in enumerate(spec):
        order = [mesh.axis_names.index(a) for a in _axes(e)]
        if order != sorted(order):
            raise ValueError(f"dim {d} of {spec} splits over {e}, not in "
                             f"the mesh's axis order {mesh.axis_names}")
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.axis_names)


def local_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """The shard of a ``shape`` tensor one device holds under ``spec``;
    raises where a sharded dim does not divide."""
    shape = tuple(int(n) for n in shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    _check_axes(spec, mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        div = math.prod(mesh.shape[a] for a in _axes(e))
        if shape[d] % div:
            raise ValueError(f"dim {d} of {shape} ({shape[d]}) does not "
                             f"divide over {e} ({div} devices)")
        out[d] = shape[d] // div
    return tuple(out)


def local_nbytes(shape, dtype: torch.dtype, spec: P, mesh) -> int:
    """Bytes one device holds of a ``shape`` / ``dtype`` tensor under
    ``spec``."""
    return math.prod(local_shape(shape, spec, mesh)) * dtype.itemsize


def tree_local_nbytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of every tensor of ``tree`` under the
    matching tree of ``specs``."""
    leaves = dict(tree_paths(tree))
    spec_of = dict(tree_paths(specs))
    if set(leaves) != set(spec_of):
        raise ValueError("the specs do not match the tree's paths")
    return sum(local_nbytes(x.shape, x.dtype, spec_of[p], mesh)
               for p, x in leaves.items())
