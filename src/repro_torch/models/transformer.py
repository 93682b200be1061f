"""Composable decoder-only LM: the port of the JAX package's model stack.

A model is a repeating **pattern** of layers (e.g. RecurrentGemma's
``(rglru, rglru, local-attn)``, Llama-4's ``(dense-ffn, moe-ffn)``,
xLSTM's ``(mlstm×7, slstm)``) applied ``num_units`` times, plus an
optional ``tail``.  Per-layer parameters are stacked on a leading unit
axis, with the JAX package's key paths (``unit/layer{i}/...``,
``tail/tail{i}/...``), so its parameters convert 1:1
(``repro_torch.models.convert``); JAX's ``lax.scan`` over units is a
Python loop over that axis here.

Three execution modes share the same layer code:

* ``forward``      — full-sequence train / scoring forward (logits);
  ``mode="train"`` (the default, as in JAX) adds the MoE load-balance
  term, and where gradients are on each unit is recomputed in the
  backward as ``cfg.remat`` asks (JAX's ``jax.checkpoint`` per unit).
* ``prefill``      — full sequence + per-layer cache extraction.
* ``decode_step``  — single token against the cache (serving); it updates
  the cache in place.

``loss_fn`` is next-token cross entropy plus the MoE term.

Inside a ``distributed.ctx.model_parallel`` context (the tensor-parallel
train step) the parameters are this rank's slices along ``model``
(``partitioning.param_pspecs``), the layers run the program
``partitioning.tp_layout`` gives them, ``forward`` returns this rank's
columns of the logits, and ``loss_fn``'s cross entropy is
vocabulary-parallel: the row max a MAX over the group, the sum of
exponentials and the target's logit sums over it.  Serving runs in
such a context too (``launch.steps.make_serve_prefill`` /
``make_serve_decode`` on a mesh): ``prefill``, ``decode_step`` and
``init_cache`` then hold the rank's slices of the cache
(``partitioning.cache_pspecs``), and the xLSTM mixers, whose weights
replicate, gather their split states for a step and keep their slices.
Inside a ``distributed.ctx.param_shards`` context (``fsdp_units`` on
more than one data rank, ZeRO-3) the parameters are this rank's blocks
along ``data`` too: ``forward``, ``prefill`` and ``decode_step`` gather a
unit's blocks (``ctx.gather_params``) right before the unit runs, inside
its remat boundary, so the backward gathers again and one unit is whole
at a time; the tail layers and the final norm are gathered the same way.
Mixers:
``attn``, ``rglru``, ``mlstm`` and ``slstm``; FFNs: ``dense``, ``moe``
and ``none``.  On the card, attention and the RG-LRU scan run the
hand-written kernels forwards and backwards (their ops' autograd
Functions).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import partitioning as part
from repro_torch.distributed.ctx import (dp_sum, from_model, gather_model,
                                         gather_params, model_max,
                                         model_parallel, mp_rank, mp_size,
                                         to_model)
from repro_torch.kernels.flash_attention.plan import PosPlan
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import AttnSpec
from repro_torch.models.layers import (Params, apply_norm, embed,
                                       init_embedding, init_head, init_mlp,
                                       init_norm, logits_head, mlp)
from repro_torch.models.moe import MoESpec
from repro_torch.models.rglru import RGLRUSpec
from repro_torch.models.rope import text_mrope_positions
from repro_torch.models.xlstm import MLSTMSpec, SLSTMSpec
from repro_torch.train.optimizer import tree_from_paths, tree_paths

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}

MIXERS = ("attn", "rglru", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # 'attn' | 'rglru' | 'mlstm' | 'slstm'
    ffn: str = "dense"         # 'dense' | 'moe' | 'none'
    window: int | None = None  # sliding window for 'attn'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    tail: tuple[LayerSpec, ...] = ()   # trailing layers when depth % pattern != 0
    # attention
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int | None = None
    qkv_bias: bool = False
    rope_kind: str = "rope"           # 'rope' | 'mrope' | 'none'
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    attn_softcap: float | None = None
    # dense ffn
    d_ff: int = 0
    act: str = "silu"
    ffn_gated: bool = True
    mlp_bias: bool = False
    # sub-block specs (None when unused)
    moe: MoESpec | None = None
    rglru: RGLRUSpec | None = None
    mlstm: MLSTMSpec | None = None
    slstm: SLSTMSpec | None = None
    # embeddings / head
    tie_embeddings: bool = False
    input_mode: str = "tokens"        # 'tokens' | 'embeddings' (modality stub)
    emb_scale: float | None = None
    logit_scale: float | None = None
    logit_softcap: float | None = None
    residual_scale: float | None = None   # MiniCPM-style depth scaling
    norm: str = "rms"
    # numerics
    param_dtype: str = "bf16"
    compute_dtype: str = "bf16"
    remat: str = "full"               # 'none' | 'full' | 'dots' (training only)
    vocab_pad_to: int = 256           # Megatron-style vocab padding (TP divisibility)
    # losses
    moe_aux_weight: float = 0.01
    # distribution hints (read by the JAX package's partitioning)
    fsdp_units: bool = False
    moe_shard_mode: str = "auto"
    # misc notes (e.g. applicability of paper technique)
    supports_kv_offload: bool = True

    def __post_init__(self):
        if (self.n_layers - len(self.tail)) % len(self.pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers minus a "
                             f"tail of {len(self.tail)} is not a multiple of "
                             f"the pattern ({len(self.pattern)})")

    @property
    def num_units(self) -> int:
        return (self.n_layers - len(self.tail)) // len(self.pattern)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p

    @property
    def hd(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.n_heads)

    @property
    def pdtype(self):
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return DTYPES[self.compute_dtype]

    def attn_spec(self, window: int | None) -> AttnSpec:
        return AttnSpec(
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            qkv_bias=self.qkv_bias, rope_kind=self.rope_kind,
            rope_theta=self.rope_theta, mrope_sections=self.mrope_sections,
            window=window, softcap=self.attn_softcap)


def _check_layer(spec: LayerSpec) -> None:
    if spec.mixer not in MIXERS:
        raise ValueError(f"unknown mixer {spec.mixer!r} (one of {MIXERS})")
    if spec.ffn not in FFNS:
        raise ValueError(f"unknown ffn {spec.ffn!r} (one of {FFNS})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layer(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator,
                device) -> Params:
    p: Params = {"norm1": init_norm(cfg.norm, cfg.d_model, torch.float32,
                                    device)}
    d, dt = cfg.d_model, cfg.pdtype
    if spec.mixer == "attn":
        p["mixer"] = attn_mod.init_attention(
            gen, d, cfg.attn_spec(spec.window), dt, device)
    elif spec.mixer == "rglru":
        p["mixer"] = rglru_mod.init_rglru_block(gen, d, cfg.rglru, dt, device)
    elif spec.mixer == "mlstm":
        p["mixer"] = xlstm_mod.init_mlstm_block(gen, d, cfg.mlstm, dt, device)
    else:
        p["mixer"] = xlstm_mod.init_slstm_block(gen, d, cfg.slstm, dt, device)
    if spec.ffn != "none":
        p["norm2"] = init_norm(cfg.norm, d, torch.float32, device)
        if spec.ffn == "dense":
            p["ffn"] = init_mlp(gen, d, cfg.d_ff, gated=cfg.ffn_gated,
                                bias=cfg.mlp_bias, dtype=dt, device=device)
        else:
            p["ffn"] = moe_mod.init_moe(gen, d, cfg.moe, dt, device)
    return p


def _copy_into(dst: Params, src: Params, u: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v, u)
        else:
            dst[k][u].copy_(v)


def _stacked_like(src: Params, n: int) -> Params:
    return {k: (_stacked_like(v, n) if isinstance(v, dict) else
                torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                            device=v.device))
            for k, v in src.items()}


def init_params(cfg: ModelConfig, gen: torch.Generator | int,
                device=None) -> Params:
    """Random parameters from ``gen`` (a generator on ``device``, or an
    int seed).  Units are drawn one at a time and written into the stacked
    tensors, so peak memory is the parameters plus one unit."""
    device = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=device).manual_seed(gen)
    for spec in cfg.pattern + cfg.tail:
        _check_layer(spec)
    params: Params = {}
    if cfg.input_mode == "tokens":
        params["embed"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                         cfg.pdtype, device)
    if not cfg.tie_embeddings:
        params["head"] = init_head(gen, cfg.d_model, cfg.padded_vocab,
                                   cfg.pdtype, device)
    unit = None
    for u in range(cfg.num_units):
        one = {f"layer{i}": _init_layer(cfg, spec, gen, device)
               for i, spec in enumerate(cfg.pattern)}
        if unit is None:
            unit = _stacked_like(one, cfg.num_units)
        _copy_into(unit, one, u)
        del one
    params["unit"] = unit
    if cfg.tail:
        params["tail"] = {f"tail{i}": _init_layer(cfg, spec, gen, device)
                          for i, spec in enumerate(cfg.tail)}
    params["final_norm"] = init_norm(cfg.norm, cfg.d_model, torch.float32,
                                     device)
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in _leaves(params))


def _unit_slice(tree, u: int):
    return {k: _unit_slice(v, u) if isinstance(v, dict) else v[u]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# layer application (shared by score / prefill / decode)
# ---------------------------------------------------------------------------


def _apply_mixer(cfg: ModelConfig, spec: LayerSpec, p: Params,
                 h: torch.Tensor, positions, position_ids, mode: str, cache,
                 index, max_seq, plan=None):
    cd = cfg.cdtype
    _check_layer(spec)
    if mode == "prefill":
        return _prefill_mixer(cfg, spec, p, h, positions, position_ids,
                              max_seq)
    if spec.mixer == "attn":
        aspec = cfg.attn_spec(spec.window)
        if mode == "decode":
            return attn_mod.attn_decode(p, aspec, h, cache, index,
                                        position_ids=position_ids,
                                        compute_dtype=cd, max_seq=max_seq)
        out = attn_mod.attn_full(p, aspec, h, positions,
                                 position_ids=position_ids, compute_dtype=cd,
                                 plan=plan)
        return out, None
    block, step, sp = {
        "rglru": (rglru_mod.rglru_block, rglru_mod.rglru_block_step,
                  cfg.rglru),
        "mlstm": (xlstm_mod.mlstm_block, xlstm_mod.mlstm_block_step,
                  cfg.mlstm),
        "slstm": (xlstm_mod.slstm_block, xlstm_mod.slstm_block_step,
                  cfg.slstm)}[spec.mixer]
    if mode == "decode":
        if mp_size() == 1:
            return step(p, sp, h, cache, compute_dtype=cd)
        if spec.mixer == "rglru":
            return step(p, sp, h, cache, compute_dtype=cd,
                        model_sharded=part.tp_layout(cfg, mp_size()).rglru)
        return _replicated_step(cfg, spec, p, h, cache)
    if spec.mixer == "rglru" and mp_size() > 1:
        return block(p, sp, h, compute_dtype=cd,
                     model_sharded=part.tp_layout(cfg, mp_size()).rglru), None
    return block(p, sp, h, compute_dtype=cd), None


def _apply_layer(cfg: ModelConfig, spec: LayerSpec, p: Params,
                 x: torch.Tensor, positions, position_ids, mode: str, cache,
                 index, max_seq=None, plan=None):
    """One residual layer.  Returns (x, the layer's cache, aux): the
    updated cache in ``decode`` mode, the filled one in ``prefill`` mode,
    None otherwise; aux the MoE load-balance loss of a MoE layer in
    ``train`` mode, None otherwise (JAX's zero, which adds nothing).
    ``plan``: the positions' ``PosPlan`` for the attention kernels."""
    rs = cfg.residual_scale if cfg.residual_scale is not None else 1.0
    h = apply_norm(cfg.norm, p["norm1"], x)
    h, new_cache = _apply_mixer(cfg, spec, p["mixer"], h, positions,
                                position_ids, mode, cache, index, max_seq,
                                plan)
    x = x + rs * h
    aux = None
    if spec.ffn != "none":
        h = apply_norm(cfg.norm, p["norm2"], x)
        if spec.ffn == "dense":
            h = mlp(p["ffn"], h, act=cfg.act, compute_dtype=cfg.cdtype,
                    model_sharded=mp_size() > 1
                    and part.tp_layout(cfg, mp_size()).ffn)
        else:
            if mode == "train":
                aux = moe_mod.aux_load_balance_loss(p["ffn"]["router"], h,
                                                    cfg.moe)
            h = moe_mod.apply_moe(p["ffn"], cfg.moe, h,
                                  compute_dtype=cfg.cdtype,
                                  tp=part.tp_layout(cfg, mp_size())
                                  if mp_size() > 1 else None)
        x = x + rs * h
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# full-sequence forward (score)
# ---------------------------------------------------------------------------


def _embed_inputs(cfg: ModelConfig, params: Params,
                  inputs: torch.Tensor) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        x = embed(params["embed"], inputs, compute_dtype=cfg.cdtype)
    else:
        x = inputs.to(cfg.cdtype)
    if cfg.emb_scale is not None:
        x = x * torch.tensor(cfg.emb_scale, dtype=cfg.cdtype, device=x.device)
    return x


def _head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits [B, S, V] in float32; inside a model group this rank's
    columns of them."""
    w = params["embed"]["table"] if cfg.tie_embeddings else params["head"]["w"]
    start = 0
    if mp_size() > 1:
        x = to_model(x)
        if cfg.tie_embeddings:        # [d, V / tp]: the layout is explicit
            w = w.T
        start = mp_rank() * w.shape[1]
    logits = logits_head(w, x, softcap=cfg.logit_softcap,
                         compute_dtype=cfg.cdtype, valid_vocab=cfg.vocab_size,
                         vocab_start=start)
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    return logits


#: the products whose outputs ``remat="dots"`` keeps (JAX's
#: ``checkpoint_dots`` keeps the outputs of its dot products)
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` recomputed in the backward as ``cfg.remat`` asks: nothing
    kept (``"full"``), the matmul outputs kept (``"dots"``), or run as it
    is (``"none"``, or no gradient being taken)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r} (none, full or dots)")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)
    return functools.partial(torch_checkpoint.checkpoint, fn,
                             use_reentrant=False, **kw)


def forward(cfg: ModelConfig, params: Params, inputs: torch.Tensor,
            positions: torch.Tensor | None = None,
            position_ids: torch.Tensor | None = None,
            mode: str = "train") -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B,S,V] fp32, moe_aux scalar).

    ``mode="train"`` (JAX's default) sums the MoE load-balance loss into
    moe_aux; ``"eval"`` scores without it.  ``positions`` None stands for
    ``arange(S)`` in every row, as in the JAX package; it stays None down
    to the attention layers, which build it only for RoPE, so that the
    card's attention takes its index path without reading positions.
    Caller positions are sorted once here (``PosPlan``) for every
    attention layer's kernels, forward and backward (remat replays
    too)."""
    b, s = inputs.shape[:2]
    plan = None if positions is None else PosPlan.build(positions)
    if cfg.rope_kind == "mrope" and position_ids is None:
        position_ids = text_mrope_positions(
            attn_mod.default_positions(b, s, inputs.device)
            if positions is None else positions)
    x = _embed_inputs(cfg, params, inputs)

    def unit_fn(x, aux, unit_p):
        unit_p = gather_params(unit_p, ("unit",), shift=1)
        for i, spec in enumerate(cfg.pattern):
            x, _, a = _apply_layer(cfg, spec, unit_p[f"layer{i}"], x,
                                   positions, position_ids, mode, None, None,
                                   plan=plan)
            if a is not None:
                aux = aux + a
        return x, aux

    unit_fn = _remat(cfg, unit_fn)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(cfg.num_units):
        x, aux = unit_fn(x, aux, _unit_slice(params["unit"], u))
    for i, spec in enumerate(cfg.tail):
        x, _, a = _apply_layer(cfg, spec, _tail_params(params, i), x,
                               positions, position_ids, mode, None, None,
                               plan=plan)
        if a is not None:
            aux = aux + a
    x = apply_norm(cfg.norm, _final_norm(params), x)
    return _head(cfg, params, x), aux


def _tail_params(params: Params, i: int) -> Params:
    """Tail layer ``i``'s parameters, whole (gathered over ``data`` inside
    a ``ctx.param_shards`` context)."""
    name = f"tail{i}"
    return gather_params(params["tail"][name], ("tail", name))


def _final_norm(params: Params) -> Params:
    return gather_params(params["final_norm"], ("final_norm",))


def loss_fn(cfg: ModelConfig, params: Params, batch
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ MoE aux). batch: inputs, labels[, mask].
    Inside a ``ctx.data_parallel`` context ``batch`` is this rank's rows,
    and the loss is the global batch's: the masked ``nll`` sum and the
    token count are summed over the data group (the gradient carried to
    this rank's rows), not averaged from rank-local means."""
    logits, aux = forward(cfg, params, batch["inputs"],
                          batch.get("positions"), batch.get("position_ids"),
                          mode="train")
    labels = batch["labels"]
    if mp_size() == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        logz, gold = _vocab_parallel_terms(logits, labels)
    nll = logz - gold
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.to(torch.float32)
    tokens = dp_sum(torch.sum(mask))
    denom = torch.clamp_min(tokens, 1.0)
    ce = dp_sum(torch.sum(nll * mask)) / denom
    total = ce + cfg.moe_aux_weight * aux
    return total, {"ce": ce, "moe_aux": aux,
                   "tokens": tokens.to(torch.int32)}


def _vocab_parallel_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(log Z, the target's logit) of each row from this rank's columns of
    the logits [B, S, V / tp]: the row max a MAX over the model group
    (no gradient, as in ``logsumexp``), the sum of exponentials and the
    target's logit (zero on the ranks that do not hold it) sums over it."""
    n = logits.shape[-1]
    m = model_max(logits.amax(dim=-1))
    sumexp = from_model(torch.exp(logits - m[..., None]).sum(dim=-1))
    local = labels.long() - mp_rank() * n
    inside = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = from_model(torch.where(inside, picked, picked.new_zeros(())))
    return m + torch.log(sumexp), gold


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                      max_seq: int, device):
    _check_layer(spec)
    cd = cfg.cdtype
    if spec.mixer == "attn":
        return attn_mod.init_attn_cache(batch, cfg.attn_spec(spec.window),
                                        max_seq, cd, device)
    if spec.mixer == "rglru":
        return rglru_mod.init_rglru_cache(batch, cfg.rglru, cd, device)
    if spec.mixer == "mlstm":
        return xlstm_mod.init_mlstm_cache(batch, cfg.mlstm, cd, device)
    return xlstm_mod.init_slstm_cache(batch, cfg.slstm, cd, device)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Params:
    """{'unit': stacked per-unit cache, 'tail': per-tail-layer cache}.
    Inside a model group, this rank's slices of the cache of its
    ``batch`` rows (``partitioning.cache_pspecs``: the slots, or the
    recurrent states' widths, that divide the group)."""
    device = resolve_device(device)
    if mp_size() > 1:
        return _rank_cache(cfg, batch, max_seq, device)
    one = {f"layer{i}": _init_layer_cache(cfg, spec, batch, max_seq, device)
           for i, spec in enumerate(cfg.pattern)}
    unit = _stacked_like(one, cfg.num_units)
    for u in range(cfg.num_units):
        _copy_into(unit, one, u)
    cache: Params = {"unit": unit}
    if cfg.tail:
        cache["tail"] = {f"tail{i}": _init_layer_cache(cfg, spec, batch,
                                                       max_seq, device)
                         for i, spec in enumerate(cfg.tail)}
    return cache


def _rank_cache(cfg: ModelConfig, batch: int, max_seq: int,
                device) -> Params:
    """``init_cache``'s leaves cut to this rank's slices under
    ``cache_pspecs`` on a ``(1, model)`` mesh: empty slots (pos -1),
    zero states, the xLSTM stabilisers ``m`` at -1e30."""
    with model_parallel(None):
        whole = init_cache(cfg, batch, max_seq, device="meta")
    mesh = _model_mesh()
    specs = dict(tree_paths(part.cache_pspecs(cfg, mesh, whole)))
    fill = {"pos": -1, "m": xlstm_mod.NEG}
    return tree_from_paths(
        (path, torch.full(part.local_shape(x.shape, specs[path], mesh),
                          fill.get(path[-1], 0), dtype=x.dtype,
                          device=device))
        for path, x in tree_paths(whole))


def _model_mesh():
    """The ``(1, model)`` mesh of this rank's model group."""
    from repro_torch.launch.mesh import MeshSpec
    return MeshSpec(("data", "model"), (1, mp_size()))


def _state_splits(cfg: ModelConfig, spec: LayerSpec) -> dict[str, bool]:
    """Which leaves of an xLSTM layer's cache ``cache_pspecs`` splits
    over the model group (their last dim)."""
    init = {"mlstm": (xlstm_mod.init_mlstm_cache, cfg.mlstm),
            "slstm": (xlstm_mod.init_slstm_cache, cfg.slstm)}[spec.mixer]
    layer = {"layer": init[0](1, init[1], device="meta")}
    specs = part.cache_pspecs(cfg, _model_mesh(), layer)["layer"]
    return {k: part.MODEL_AXIS in part.axes_of(s[-1])
            for k, s in specs.items()}


def _rank_states(cfg: ModelConfig, spec: LayerSpec, cache: Params
                 ) -> Params:
    """An xLSTM layer's whole cache cut to this rank's slices (copies)."""
    n, r = mp_size(), mp_rank()
    split = _state_splits(cfg, spec)
    return {k: (v.narrow(-1, r * (v.shape[-1] // n),
                         v.shape[-1] // n).clone() if split[k] else v)
            for k, v in cache.items()}


def _replicated_step(cfg: ModelConfig, spec: LayerSpec, p: Params,
                     h: torch.Tensor, cache: Params):
    """An xLSTM decode step inside a model group: the mixer's weights
    replicate, while ``cache_pspecs`` splits its states' widths, so the
    split states are gathered (one all-gather each), the whole step runs
    on every rank, and the rank keeps its slices."""
    step, sp = {"mlstm": (xlstm_mod.mlstm_block_step, cfg.mlstm),
                "slstm": (xlstm_mod.slstm_block_step, cfg.slstm)}[spec.mixer]
    split = _state_splits(cfg, spec)
    whole = {k: gather_model(v, v.dim() - 1) if split[k] else v
             for k, v in cache.items()}
    y, whole = step(p, sp, h, whole, compute_dtype=cfg.cdtype)
    for k, v in _rank_states(cfg, spec, whole).items():
        if split[k]:
            cache[k].copy_(v)
    return y, cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                inputs: torch.Tensor, index: int,
                position_ids: torch.Tensor | None = None,
                max_seq: int | None = None
                ) -> tuple[torch.Tensor, Params]:
    """One decode step. inputs: [B, 1] tokens (or [B, 1, d] embeddings);
    index: absolute position. Returns (logits [B,1,V], cache), the cache
    updated in place.  Inside a model group ``params`` and ``cache`` are
    this rank's slices, ``max_seq`` is the whole cache's length (which
    says which layers' slots the group splits), and the logits are the
    rank's columns of the vocabulary."""
    index = int(index)
    if cfg.rope_kind == "mrope" and position_ids is None:
        b = inputs.shape[0]
        pos = torch.full((b, 1), index, dtype=torch.int32,
                         device=inputs.device)
        position_ids = text_mrope_positions(pos)
    x = _embed_inputs(cfg, params, inputs)
    for u in range(cfg.num_units):
        unit_p = gather_params(_unit_slice(params["unit"], u), ("unit",), 1)
        unit_c = _unit_slice(cache["unit"], u)
        for i, spec in enumerate(cfg.pattern):
            x, _, _ = _apply_layer(cfg, spec, unit_p[f"layer{i}"], x, None,
                                   position_ids, "decode",
                                   unit_c[f"layer{i}"], index, max_seq)
        del unit_p              # gathered: one unit whole at a time
    for i, spec in enumerate(cfg.tail):
        x, _, _ = _apply_layer(cfg, spec, _tail_params(params, i), x,
                               None, position_ids, "decode",
                               cache["tail"][f"tail{i}"], index, max_seq)
    x = apply_norm(cfg.norm, _final_norm(params), x)
    return _head(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: Params, inputs: torch.Tensor,
            max_seq: int | None = None,
            position_ids: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, Params]:
    """Full-sequence prefill: logits for the last position + a filled cache.

    Implemented as forward + cache reconstruction per layer; attention
    layers lay their K/V out as the cache (ring-aligned for windowed
    layers), recurrent layers keep their final state.  Inside a model
    group ``params`` are this rank's slices, the cache is its slices
    (``init_cache``'s shapes) and the logits its columns of the
    vocabulary."""
    b, s = inputs.shape[:2]
    max_seq = max_seq or s
    positions = attn_mod.default_positions(b, s, inputs.device)
    if cfg.rope_kind == "mrope" and position_ids is None:
        position_ids = text_mrope_positions(positions)
    x = _embed_inputs(cfg, params, inputs)
    unit_cache = None
    for u in range(cfg.num_units):
        unit_p = gather_params(_unit_slice(params["unit"], u), ("unit",), 1)
        caches = {}
        for i, spec in enumerate(cfg.pattern):
            name = f"layer{i}"
            x, caches[name], _ = _apply_layer(cfg, spec, unit_p[name], x,
                                              positions, position_ids,
                                              "prefill", None, None, max_seq)
        del unit_p              # gathered: one unit whole at a time
        if unit_cache is None:
            unit_cache = _stacked_like(caches, cfg.num_units)
        _copy_into(unit_cache, caches, u)
    cache: Params = {"unit": unit_cache}
    if cfg.tail:
        cache["tail"] = {}
        for i, spec in enumerate(cfg.tail):
            name = f"tail{i}"
            x, cache["tail"][name], _ = _apply_layer(
                cfg, spec, _tail_params(params, i), x, positions,
                position_ids, "prefill", None, None, max_seq)
    x = apply_norm(cfg.norm, _final_norm(params), x[:, -1:])
    return _head(cfg, params, x), cache


def _prefill_mixer(cfg: ModelConfig, spec: LayerSpec, p: Params,
                   h: torch.Tensor, positions, position_ids, max_seq: int):
    cd = cfg.cdtype
    if spec.mixer == "attn":
        return attn_mod.attn_prefill(p, cfg.attn_spec(spec.window), h,
                                     positions, position_ids, max_seq,
                                     compute_dtype=cd)
    if spec.mixer == "mlstm":
        y, (C, n, m), u = xlstm_mod.mlstm_prefill(p, cfg.mlstm, h,
                                                  compute_dtype=cd)
        # decode consumes the PRE-conv inputs u
        cache = {"C": C, "n": n, "m": m,
                 "conv": _conv_tail(u, cfg.mlstm.conv_width).clone()}
        return y, (_rank_states(cfg, spec, cache) if mp_size() > 1
                   else cache)
    if spec.mixer == "slstm":
        y, (c, n, hst, m) = xlstm_mod.slstm_prefill(p, cfg.slstm, h,
                                                    compute_dtype=cd)
        cache = {"c": c, "n": n, "h": hst, "m": m,
                 "conv": _conv_tail(h.to(cd), cfg.slstm.conv_width).clone()}
        return y, (_rank_states(cfg, spec, cache) if mp_size() > 1
                   else cache)
    sp = cfg.rglru
    sharded = mp_size() > 1 and part.tp_layout(cfg, mp_size()).rglru
    x = h.to(cd)
    if sharded:                # this rank's channels
        x = to_model(x)
    xb_raw = x @ p["wx"].to(cd)
    gb = torch.nn.functional.gelu(x @ p["wy"].to(cd), approximate="tanh")
    xb = rglru_mod.causal_conv(xb_raw, p["conv_w"].to(cd), p["conv_b"].to(cd))
    hs = rglru_mod.rglru_scan(p, sp, xb)
    tail = _conv_tail(xb_raw, sp.conv_width)   # decode consumes PRE-conv inputs
    y = (hs * gb) @ p["wo"].to(cd)
    # the compute-dtype-rounded output, not the f32 state: decode goes on
    # from what the JAX package stores.  Copies, so the cache holds no view
    # of the sequence-long activations.
    return (from_model(y) if sharded else y), {
        "h": hs[:, -1].to(torch.float32, copy=True), "conv": tail.clone()}


def _conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    b, s, d = x.shape
    tail = width - 1
    if s >= tail:
        return x[:, s - tail:]
    return torch.cat([x.new_zeros((b, tail - s, d)), x], dim=1)
