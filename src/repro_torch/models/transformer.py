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

* ``forward``      — full-sequence scoring forward (logits).
* ``prefill``      — full sequence + per-layer cache extraction.
* ``decode_step``  — single token against the cache (serving); it updates
  the cache in place.

Mixers: ``attn``, ``rglru``, ``mlstm`` and ``slstm``; FFNs: ``dense``,
``moe`` and ``none``.  Training (``mode="train"``, ``loss_fn``) raises
naming the slice that ports it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
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
                 index, max_seq):
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
                                        compute_dtype=cd)
        out = attn_mod.attn_full(p, aspec, h, positions,
                                 position_ids=position_ids, compute_dtype=cd)
        return out, None
    block, step, sp = {
        "rglru": (rglru_mod.rglru_block, rglru_mod.rglru_block_step,
                  cfg.rglru),
        "mlstm": (xlstm_mod.mlstm_block, xlstm_mod.mlstm_block_step,
                  cfg.mlstm),
        "slstm": (xlstm_mod.slstm_block, xlstm_mod.slstm_block_step,
                  cfg.slstm)}[spec.mixer]
    if mode == "decode":
        return step(p, sp, h, cache, compute_dtype=cd)
    return block(p, sp, h, compute_dtype=cd), None


def _apply_layer(cfg: ModelConfig, spec: LayerSpec, p: Params,
                 x: torch.Tensor, positions, position_ids, mode: str, cache,
                 index, max_seq=None):
    """One residual layer.  Returns (x, the layer's cache): the updated
    cache in ``decode`` mode, the filled one in ``prefill`` mode, None
    otherwise."""
    rs = cfg.residual_scale if cfg.residual_scale is not None else 1.0
    h = apply_norm(cfg.norm, p["norm1"], x)
    h, new_cache = _apply_mixer(cfg, spec, p["mixer"], h, positions,
                                position_ids, mode, cache, index, max_seq)
    x = x + rs * h
    if spec.ffn != "none":
        h = apply_norm(cfg.norm, p["norm2"], x)
        if spec.ffn == "dense":
            h = mlp(p["ffn"], h, act=cfg.act, compute_dtype=cfg.cdtype)
        else:
            h = moe_mod.apply_moe(p["ffn"], cfg.moe, h,
                                  compute_dtype=cfg.cdtype)
        x = x + rs * h
    return x, new_cache


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
    w = params["embed"]["table"] if cfg.tie_embeddings else params["head"]["w"]
    logits = logits_head(w, x, softcap=cfg.logit_softcap,
                         compute_dtype=cfg.cdtype, valid_vocab=cfg.vocab_size)
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    return logits


def _default_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def forward(cfg: ModelConfig, params: Params, inputs: torch.Tensor,
            positions: torch.Tensor | None = None,
            position_ids: torch.Tensor | None = None,
            mode: str = "eval") -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits [B,S,V] fp32, moe_aux scalar)."""
    if mode == "train":
        raise NotImplementedError("training is not ported yet: train/ lands "
                                  "with slice H item 22")
    b, s = inputs.shape[:2]
    if positions is None:
        positions = _default_positions(b, s, inputs.device)
    if cfg.rope_kind == "mrope" and position_ids is None:
        position_ids = text_mrope_positions(positions)
    x = _embed_inputs(cfg, params, inputs)
    for u in range(cfg.num_units):
        unit_p = _unit_slice(params["unit"], u)
        for i, spec in enumerate(cfg.pattern):
            x, _ = _apply_layer(cfg, spec, unit_p[f"layer{i}"], x, positions,
                                position_ids, mode, None, None)
    for i, spec in enumerate(cfg.tail):
        x, _ = _apply_layer(cfg, spec, params["tail"][f"tail{i}"], x,
                            positions, position_ids, mode, None, None)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params: Params, batch):
    raise NotImplementedError("loss_fn is not ported yet: train/ lands with "
                              "slice H item 22")


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
    """{'unit': stacked per-unit cache, 'tail': per-tail-layer cache}."""
    device = resolve_device(device)
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


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                inputs: torch.Tensor, index: int,
                position_ids: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, Params]:
    """One decode step. inputs: [B, 1] tokens (or [B, 1, d] embeddings);
    index: absolute position. Returns (logits [B,1,V], cache), the cache
    updated in place."""
    index = int(index)
    if cfg.rope_kind == "mrope" and position_ids is None:
        b = inputs.shape[0]
        pos = torch.full((b, 1), index, dtype=torch.int32,
                         device=inputs.device)
        position_ids = text_mrope_positions(pos)
    x = _embed_inputs(cfg, params, inputs)
    for u in range(cfg.num_units):
        unit_p = _unit_slice(params["unit"], u)
        unit_c = _unit_slice(cache["unit"], u)
        for i, spec in enumerate(cfg.pattern):
            x, _ = _apply_layer(cfg, spec, unit_p[f"layer{i}"], x, None,
                                position_ids, "decode", unit_c[f"layer{i}"],
                                index)
    for i, spec in enumerate(cfg.tail):
        x, _ = _apply_layer(cfg, spec, params["tail"][f"tail{i}"], x, None,
                            position_ids, "decode",
                            cache["tail"][f"tail{i}"], index)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return _head(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: Params, inputs: torch.Tensor,
            max_seq: int | None = None,
            position_ids: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, Params]:
    """Full-sequence prefill: logits for the last position + a filled cache.

    Implemented as forward + cache reconstruction per layer; attention
    layers re-project K/V into the cache layout (ring-aligned for
    windowed layers), recurrent layers keep their final state."""
    b, s = inputs.shape[:2]
    max_seq = max_seq or s
    positions = _default_positions(b, s, inputs.device)
    if cfg.rope_kind == "mrope" and position_ids is None:
        position_ids = text_mrope_positions(positions)
    x = _embed_inputs(cfg, params, inputs)
    unit_cache = None
    for u in range(cfg.num_units):
        unit_p = _unit_slice(params["unit"], u)
        caches = {}
        for i, spec in enumerate(cfg.pattern):
            name = f"layer{i}"
            x, caches[name] = _apply_layer(cfg, spec, unit_p[name], x,
                                           positions, position_ids,
                                           "prefill", None, None, max_seq)
        if unit_cache is None:
            unit_cache = _stacked_like(caches, cfg.num_units)
        _copy_into(unit_cache, caches, u)
    cache: Params = {"unit": unit_cache}
    if cfg.tail:
        cache["tail"] = {}
        for i, spec in enumerate(cfg.tail):
            name = f"tail{i}"
            x, cache["tail"][name] = _apply_layer(
                cfg, spec, params["tail"][name], x, positions, position_ids,
                "prefill", None, None, max_seq)
    x = apply_norm(cfg.norm, params["final_norm"], x[:, -1:])
    return _head(cfg, params, x), cache


def _ring_align(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                slots: int):
    """Pack the last ≤slots (k, v) pairs into ring layout (pos % slots)."""
    b, s = positions.shape
    if s <= slots:
        padk = k.new_zeros((b, slots - s) + tuple(k.shape[2:]))
        kr = torch.cat([k, padk], dim=1)
        vr = torch.cat([v, padk], dim=1)
        pr = torch.cat([positions.to(torch.int32),
                        positions.new_full((b, slots - s), -1).to(
                            torch.int32)], dim=1)
        return kr, vr, pr
    ar = torch.arange(slots, device=k.device)
    idx = s - 1 - (s - 1 - ar) % slots              # source row per slot
    return k[:, idx], v[:, idx], positions[:, idx].to(torch.int32)


def _prefill_mixer(cfg: ModelConfig, spec: LayerSpec, p: Params,
                   h: torch.Tensor, positions, position_ids, max_seq: int):
    cd = cfg.cdtype
    if spec.mixer == "attn":
        aspec = cfg.attn_spec(spec.window)
        q, k, v = attn_mod._project_qkv(p, aspec, h.to(cd), cd)
        q, k = attn_mod._apply_positional(aspec, q, k, positions,
                                          position_ids)
        out = attn_mod.attend(aspec, q, k, v, positions)
        y = attn_mod._out_proj(p, out, cd)
        slots = min(max_seq, aspec.window) if aspec.window else max_seq
        kr, vr, pr = _ring_align(k, v, positions, slots)
        cache = {"k": kr.transpose(1, 2), "v": vr.transpose(1, 2), "pos": pr}
        return y, cache
    if spec.mixer == "mlstm":
        y, (C, n, m), u = xlstm_mod.mlstm_prefill(p, cfg.mlstm, h,
                                                  compute_dtype=cd)
        # decode consumes the PRE-conv inputs u
        return y, {"C": C, "n": n, "m": m,
                   "conv": _conv_tail(u, cfg.mlstm.conv_width).clone()}
    if spec.mixer == "slstm":
        y, (c, n, hst, m) = xlstm_mod.slstm_prefill(p, cfg.slstm, h,
                                                    compute_dtype=cd)
        return y, {"c": c, "n": n, "h": hst, "m": m,
                   "conv": _conv_tail(h.to(cd), cfg.slstm.conv_width).clone()}
    sp = cfg.rglru
    x = h.to(cd)
    xb_raw = x @ p["wx"].to(cd)
    gb = torch.nn.functional.gelu(x @ p["wy"].to(cd), approximate="tanh")
    xb = rglru_mod.causal_conv(xb_raw, p["conv_w"].to(cd), p["conv_b"].to(cd))
    hs = rglru_mod.rglru_scan(p, sp, xb)
    tail = _conv_tail(xb_raw, sp.conv_width)   # decode consumes PRE-conv inputs
    y = (hs * gb) @ p["wo"].to(cd)
    # the compute-dtype-rounded output, not the f32 state: decode goes on
    # from what the JAX package stores.  Copies, so the cache holds no view
    # of the sequence-long activations.
    return y, {"h": hs[:, -1].to(torch.float32, copy=True),
               "conv": tail.clone()}


def _conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    b, s, d = x.shape
    tail = width - 1
    if s >= tail:
        return x[:, s - tail:]
    return torch.cat([x.new_zeros((b, tail - s, d)), x], dim=1)
