"""Path- and config-aware parameter / activation / cache partitioning.

The port of the JAX package's ``repro.distributed.partitioning``: the same
rules, giving the same specs path by path, over a ``launch.mesh.MeshSpec``
(``(pod, data, model)`` multi-pod, ``(data, model)`` single-pod or one
card).  A spec is a ``PartitionSpec``: one entry per tensor dim, ``None``
(replicated), a mesh axis name, or a tuple of them.  ``to_placements``
turns a spec into ``torch.distributed.tensor`` placements, one per mesh
dim, ``local_shape`` / ``local_nbytes`` give what one device holds, and
``shardings`` pairs each spec with its mesh (``NamedSharding``), which
names the slice of a leaf that one rank holds.

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
  ``f_model`` variant (each expert's ``d_ff`` over ``model``) and
  ``e_data_f_model`` (the experts over ``data`` too, in storage and in
  compute: the tokens move to their experts' owners, ``data_split``'s
  ``owned`` leaves).
* FFN / RG-LRU — column / row over ``model``.
* embeddings — vocab padded to a multiple of 256 in-model
  (``ModelConfig.padded_vocab``) then vocab-sharded over ``model``.
* ``fsdp_units`` (llama4) — parameters additionally shard their first
  free divisible dim over ``data`` (ZeRO-3 storage; ``data_split``'s
  ``gathered`` leaves, all-gathered a unit at a time where they are
  used).
* ZeRO-1 — optimizer moments / master shard their first free divisible
  dim over ``data``.
* xLSTM mixers — replicated (pure data parallel); ZeRO-1 still applies.

``shard_points`` is the sweeps' counterpart of JAX's ``shard_map`` over
the 1-D ``("points",)`` mesh: the design points split into one block a
device, each block run from a host thread of its own.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Any

import numpy as np

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


def axes_of(entry) -> tuple[str, ...]:
    """The mesh axes one entry of a spec names (none for ``None``)."""
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


def attn_mode(n_heads: int, n_kv_heads: int, tp: int) -> str:
    """How attention splits over ``tp`` model ranks: ``"kv"`` (kv heads,
    with their query groups), ``"group"`` (each group's query heads, the
    kv heads replicated), or ``"seq"`` (neither divides: the weights
    replicate and the attention activations' sequence is sharded)."""
    if n_kv_heads % tp == 0:
        return "kv"
    if (n_heads // n_kv_heads) % tp == 0:
        return "group"
    return "seq"


def _attn_param_spec(cfg: ModelConfig, name: str, tp: int) -> P:
    mode = attn_mode(cfg.n_heads, cfg.n_kv_heads, tp)
    kv = MODEL_AXIS if mode == "kv" else None
    gq = MODEL_AXIS if mode == "group" else None
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
    if any(axis in axes_of(e) for e in parts):
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


def sharded_dim(spec: P, axis: str) -> int | None:
    """The dim of ``spec`` that ``axis`` splits, or None."""
    return next((d for d, e in enumerate(spec) if axis in axes_of(e)), None)


# ---------------------------------------------------------------------------
# the tensor-parallel program the rules give a config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """What each kind of layer of a config does on ``tp`` model ranks under
    ``param_pspecs`` / ``activation_rules`` (the model's layers read it
    inside a ``ctx.model_parallel`` context)."""
    tp: int
    attn: str            # attn_mode: "kv", "group" or "seq"
    ffn: bool            # the dense FFN column / row split
    rglru: bool          # the RG-LRU's channels and gate heads split
    moe: str | None      # "expert", "slot" (capacity slots), "f" (each
    #                      expert's d_ff) or None
    moe_shared: bool     # the shared expert column / row split


def tp_plan(cfg: ModelConfig, mesh) -> TPPlan:
    """The tensor-parallel program of ``cfg`` on ``mesh`` (``tp_layout``
    of its ``model`` axis); an RG-LRU whose width divides ``model`` while
    its head count does not raises ``NotImplementedError`` naming its
    ROADMAP item."""
    return tp_layout(cfg, axis_size(mesh, MODEL_AXIS))


@functools.lru_cache(maxsize=None)
def tp_layout(cfg: ModelConfig, tp: int) -> TPPlan:
    """What each kind of layer of ``cfg`` does on ``tp`` model ranks; an
    RG-LRU whose width divides ``tp`` while its head count does not (its
    gate heads would straddle ranks) raises ``NotImplementedError``."""
    rglru = False
    if cfg.rglru is not None and tp > 1:
        rm = _rglru_spec(cfg, "wx", tp)[1] == MODEL_AXIS
        hm = _rglru_spec(cfg, "a_gate", tp)[0] == MODEL_AXIS
        if rm and not hm:
            raise NotImplementedError(
                f"{cfg.name}: an RG-LRU of {cfg.rglru.d_rnn} channels over "
                f"model = {tp} with {cfg.rglru.n_heads} gate heads, which do "
                "not divide, is not ported (ROADMAP item 32)")
        rglru = rm
    moe = shared = None
    if cfg.moe is not None:
        wi = _moe_spec(cfg, "wi", tp)
        moe = ("expert" if wi[0] == MODEL_AXIS
               else "f" if wi[2] == MODEL_AXIS else "slot")
        shared = _moe_spec(cfg, "shared_wi", tp)[1] == MODEL_AXIS
    return TPPlan(tp, attn_mode(cfg.n_heads, cfg.n_kv_heads, tp),
                  _ffn_spec(cfg, "wi", tp)[1] == MODEL_AXIS, rglru, moe,
                  bool(shared))


def model_sharded_paths(specs: Any) -> frozenset:
    """The paths (tuples) of a spec tree whose leaves ``model`` splits."""
    return frozenset(p for p, spec in tree_paths(specs)
                     if any(MODEL_AXIS in axes_of(e) for e in spec))


def data_split(cfg: ModelConfig, specs: Any) -> tuple[dict, dict]:
    """(gathered, owned): the leaves of a parameter spec tree
    (``param_pspecs``) that ``data`` splits, path (tuple) -> the dim it
    splits.  ``owned`` are the experts of ``moe_shard_mode=
    "e_data_f_model"``, which a rank computes on where they lie (the
    tokens move to them); ``gathered`` every other such leaf
    (``fsdp_units``), made whole where it is used."""
    gathered, owned = {}, {}
    for p, spec in tree_paths(specs):
        d = sharded_dim(spec, FSDP_AXIS)
        if d is None:
            continue
        path = "/".join(p)
        layer = _layer_spec_for(cfg, path)
        expert = (cfg.moe_shard_mode == "e_data_f_model" and layer is not None
                  and layer.ffn == "moe"
                  and re.search(r"/ffn/(wi|wg|wo)$", path) is not None)
        (owned if expert else gathered)[p] = d
    return gathered, owned


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
    head_tp = attn_mode(cfg.n_heads, cfg.n_kv_heads, tp) != "seq"
    moe_slot = cfg.moe is not None and cfg.moe.n_experts % tp != 0
    return {"batch": batch_axes(mesh, batch_size),
            "seq": None if head_tp else MODEL_AXIS,
            "moe_cap": MODEL_AXIS if moe_slot else None}


def batch_dim(path: str) -> int:
    """The batch dim of a train / prefill batch leaf: ``position_ids`` is
    [3, B, S], every other leaf batch-first."""
    return 1 if path.endswith("position_ids") else 0


def batch_pspecs(cfg: ModelConfig, mesh, batch: Any) -> Any:
    """Specs for a train/prefill batch dict (leading batch dim sharded).
    ``position_ids`` has layout [3, B, S] — batch on axis 1."""

    def spec_of(path, leaf):
        bdim = batch_dim(path)
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
# design-point sweep sharding (simulator batches)
# ---------------------------------------------------------------------------


def _pad_rows(a, pad: int):
    """``a`` with ``pad`` copies of its row 0 appended."""
    if pad == 0:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])
    if isinstance(a, np.ndarray):
        return np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
    return list(a) + [a[0]] * pad


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def _gather(outs: list, device, n: int):
    """The blocks' results joined along their first axis on ``device``,
    the padding sliced off; tuples joined field by field."""
    first = outs[0]
    if isinstance(first, tuple):
        return tuple(_gather([o[i] for o in outs], device, n)
                     for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs])[:n]
    return np.concatenate([np.asarray(o) for o in outs])[:n]


def _tensors(out):
    if isinstance(out, tuple):
        return [t for o in out for t in _tensors(o)]
    return [out] if isinstance(out, torch.Tensor) else []


def _on_stream(fn, device, caller):
    """``fn()`` on a side stream of ``device`` that starts after the
    caller's stream ``caller`` and hands its results back to it (the
    caller's stream waits for the side stream; the results' memory is
    recorded on it)."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            out = fn()
        caller.wait_stream(side)
        for t in _tensors(out):
            if t.device.type == "cuda":
                t.record_stream(caller)
    return out


def shard_points(mesh, fn, *, n_sharded: int):
    """``fn`` (batched over its arguments' leading axis) run over the 1-D
    ``("points",)`` mesh (``launch.mesh.make_points_mesh``): the first
    ``n_sharded`` arguments split their leading axis into contiguous
    blocks, one a device; the rest are handed whole to each device; the
    blocks' results gather back on the first device.

    The batch pads to a multiple of the mesh size by repeating row 0; the
    padded rows simulate harmless copies that are sliced off, so callers
    see exactly their B results.  Arguments may be tensors (moved to the
    block's device), numpy arrays or sequences (split, left on the host);
    ``fn`` gets the block's device as ``device=`` and returns a tensor, a
    numpy array or a tuple of them.  Each block runs from a host thread of
    its own, on the card on a side stream of its own: the folds the sweeps
    run are bound by the host's launches, so one thread would run the
    blocks one after another.  The points are independent, so no
    collective is needed and each block's rows are the rows the whole
    batch gives."""
    devices = mesh.devices
    if devices is None:
        raise ValueError("shard_points needs a mesh with devices "
                         "(launch.mesh.make_points_mesh)")
    size = axis_size(mesh, POINTS_AXIS)

    def call(*args):
        n = len(args[0])
        pad = -n % size
        head = [_pad_rows(a, pad) for a in args[:n_sharded]]
        rest = args[n_sharded:]
        per = (n + pad) // size

        def block(i):
            dev = devices[i]
            return fn(*(_to(a[i * per:(i + 1) * per], dev) for a in head),
                      *(_to(a, dev) for a in rest), device=dev)

        if size == 1:
            outs = [block(0)]
        else:
            callers = {d: torch.cuda.current_stream(d)
                       for d in set(devices) if d.type == "cuda"}

            def run(i):
                dev = devices[i]
                if dev.type != "cuda":
                    return block(i)
                return _on_stream(lambda: block(i), dev, callers[dev])

            with ThreadPoolExecutor(size) as pool:
                outs = list(pool.map(run, range(size)))
        return _gather(outs, devices[0], n)

    return call


# ---------------------------------------------------------------------------
# what one rank holds
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the port's ``jax.sharding.NamedSharding``: which
    slice of a leaf each mesh position (a rank) holds, and on which
    device."""
    mesh: Any
    spec: PartitionSpec

    @property
    def blocks(self) -> tuple[int, ...]:
        """The number of blocks each dim of the spec is cut into."""
        return tuple(math.prod(self.mesh.shape[a] for a in axes_of(e))
                     for e in self.spec)

    def index(self, shape, position: int) -> tuple[slice, ...]:
        """The slice of a ``shape`` leaf held at mesh position
        ``position``: each sharded dim cut into equal blocks, the block
        numbered row-major over the dim's axes (the first the major)."""
        local = local_shape(shape, self.spec, self.mesh)
        coords = self.mesh.coords(position)
        out = []
        for d, n in enumerate(local):
            block = 0
            for a in axes_of(self.spec[d] if d < len(self.spec) else None):
                block = block * self.mesh.shape[a] + coords[a]
            out.append(slice(block * n, (block + 1) * n))
        return tuple(out)

    def shard(self, x: torch.Tensor, position: int) -> torch.Tensor:
        """Position ``position``'s slice of the whole leaf ``x``."""
        return x[self.index(x.shape, position)]

    def device(self, position: int) -> torch.device:
        if self.mesh.devices is None:
            raise ValueError("the mesh names no devices")
        return self.mesh.devices[position]


def shardings(mesh, pspecs: Any) -> Any:
    """The tree of ``NamedSharding`` of a tree of specs on ``mesh``."""
    return _map_specs(lambda s: NamedSharding(mesh, s), pspecs)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


# ---------------------------------------------------------------------------
# what one device holds
# ---------------------------------------------------------------------------


def _check_axes(spec: P, mesh) -> None:
    used = [a for e in spec for a in axes_of(e)]
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
    owner = {a: d for d, e in enumerate(spec) for a in axes_of(e)}
    for d, e in enumerate(spec):
        order = [mesh.axis_names.index(a) for a in axes_of(e)]
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
        div = math.prod(mesh.shape[a] for a in axes_of(e))
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
    return sum(math.prod(local) * leaves[p].dtype.itemsize
               for p, local in tree_local_shapes(tree, specs, mesh).items())


def tree_local_shapes(tree: Any, specs: Any, mesh) -> dict:
    """Path (a tuple) -> the shape one device holds of that tensor of
    ``tree`` under the matching tree of ``specs``; a split dim that does
    not divide raises ``ValueError`` naming the leaf."""
    leaves = dict(tree_paths(tree))
    spec_of = dict(tree_paths(specs))
    if set(leaves) != set(spec_of):
        raise ValueError("the specs do not match the tree's paths")
    out = {}
    for p, x in leaves.items():
        try:
            out[p] = local_shape(x.shape, spec_of[p], mesh)
        except ValueError as e:
            raise ValueError(f"{'/'.join(p)}: {e}") from None
    return out
