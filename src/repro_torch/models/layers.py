"""Core neural-net layers shared by the port's architectures.

Parameters are plain nested dicts of tensors with the JAX package's key
paths; every layer is an ``init_*`` function returning a param dict plus a
plain function on tensors.  All matmul-bearing layers take an explicit
``compute_dtype`` so the stack runs mixed precision (bf16 compute,
configurable param dtype) as the JAX package does.

Under tensor parallelism (a ``distributed.ctx.model_parallel`` context)
a rank holds its slice of each parameter along ``model``: ``mlp`` with
``model_sharded`` is Megatron's column / row pair (its ``wi`` / ``wg``
columns and ``wo`` rows, ``to_model`` in and ``from_model`` out, the
replicated ``bo`` added once after the sum), ``embed`` looks up the
rank's rows of the vocabulary and sums the ranks' rows (the one nonzero
row of each token: exact), and ``logits_head`` gives the rank's columns.

Initialization follows the JAX package's distributions — fan-in scaled
truncated normal on [-2, 2] for projections, ones for norm scales, zeros
for biases — drawn from an explicit ``torch.Generator`` (the numbers differ
from JAX's; parity tests carry JAX's parameters across with
``repro_torch.models.convert``).  Truncated normals are drawn in float32
chunks of at most ``INIT_CHUNK`` elements and written into the parameter's
own dtype, so a full-width init holds no large float32 temporaries.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import from_model, mp_rank, mp_size, to_model

Params = dict[str, Any]

INIT_CHUNK = 1 << 26


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def trunc_normal_(out: torch.Tensor, gen: torch.Generator, *,
                  scale: float = 1.0) -> torch.Tensor:
    """Fill ``out`` in place with ``scale`` times a standard normal
    truncated to [-2, 2] (inverse-CDF sampling, as ``jax.random``).  A
    meta tensor has no values to draw and is returned as it is."""
    if out.device.type == "meta":
        return out
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    flat = out.view(-1)
    for start in range(0, flat.numel(), INIT_CHUNK):
        n = min(INIT_CHUNK, flat.numel() - start)
        x = torch.empty(n, dtype=torch.float32, device=out.device)
        x.uniform_(lo, hi, generator=gen).erfinv_().mul_(math.sqrt(2.0))
        x.clamp_(-2.0, 2.0).mul_(scale)
        flat[start:start + n].copy_(x)
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None, dtype=torch.float32,
               shape: tuple[int, ...] | None = None,
               device=None) -> torch.Tensor:
    """Fan-in scaled truncated normal; optional explicit shape."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    shape = shape if shape is not None else (d_in, d_out)
    return trunc_normal_(torch.empty(shape, dtype=dtype, device=device), gen,
                         scale=scale)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return trunc_normal_(torch.empty((vocab, d), dtype=dtype, device=device),
                         gen)


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    orig_dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(orig_dtype)


def init_layernorm(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    orig_dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(orig_dtype)


def init_norm(kind: str, d: int, dtype=torch.float32, device=None) -> Params:
    return (init_rmsnorm(d, dtype, device) if kind == "rms"
            else init_layernorm(d, dtype, device))


def apply_norm(kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rms" else layernorm(p, x)


# ---------------------------------------------------------------------------
# activations (JAX's "gelu" is the tanh approximation)
# ---------------------------------------------------------------------------

ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# feed-forward (gated SwiGLU/GeGLU or classic 2-layer MLP)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, d_ff: int, *, gated: bool,
             bias: bool = False, dtype=torch.float32, device=None) -> Params:
    p: Params = {"wi": dense_init(gen, d, d_ff, dtype=dtype, device=device),
                 "wo": dense_init(gen, d_ff, d, dtype=dtype, device=device)}
    if gated:
        p["wg"] = dense_init(gen, d, d_ff, dtype=dtype, device=device)
    if bias:
        p["bi"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["bo"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def mlp(p: Params, x: torch.Tensor, *, act: str,
        compute_dtype=torch.bfloat16,
        model_sharded: bool = False) -> torch.Tensor:
    """``model_sharded``: ``p`` holds this rank's columns of ``wi`` /
    ``wg`` / ``bi`` and rows of ``wo`` (the ranks' outputs are summed)."""
    x = x.to(compute_dtype)
    if model_sharded:
        x = to_model(x)
    h = x @ p["wi"].to(compute_dtype)
    if "bi" in p:
        h = h + p["bi"].to(compute_dtype)
    h = ACTIVATIONS[act](h)
    if "wg" in p:
        h = h * (x @ p["wg"].to(compute_dtype))
    out = h @ p["wo"].to(compute_dtype)
    if model_sharded:
        out = from_model(out)
    if "bo" in p:
        out = out + p["bo"].to(compute_dtype)
    return out


# ---------------------------------------------------------------------------
# logits head / embedding
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device=None) -> Params:
    return {"table": embed_init(gen, vocab, d, dtype=dtype, device=device)}


def embed(p: Params, ids: torch.Tensor, *,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Inside a model group the table is this rank's rows [r n, (r + 1) n)
    of the padded vocabulary: ids outside them give zero rows, and the
    ranks' rows are summed."""
    table = p["table"]
    if mp_size() == 1:
        return table[ids.long()].to(compute_dtype)
    n = table.shape[0]
    local = ids.long() - mp_rank() * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(compute_dtype)
    return from_model(torch.where(inside[..., None], rows,
                                  rows.new_zeros(())))


def init_head(gen: torch.Generator, d: int, vocab: int, dtype=torch.float32,
              device=None) -> Params:
    return {"w": dense_init(gen, d, vocab, dtype=dtype, device=device)}


def logits_head(w: torch.Tensor, x: torch.Tensor, *,
                softcap: float | None = None, compute_dtype=torch.bfloat16,
                valid_vocab: int | None = None,
                vocab_start: int = 0) -> torch.Tensor:
    """``w`` is ``[V, d]`` (tied-embedding layout) or ``[d, V]``.

    ``valid_vocab`` masks Megatron-style vocab-padding columns to -1e30 so
    padded entries never receive probability mass.  ``vocab_start``: the
    vocabulary index of ``w``'s first column (a rank's slice of it)."""
    w = w.to(compute_dtype)
    if w.shape[0] != x.shape[-1]:  # [V, d] tied layout
        logits = x.to(compute_dtype) @ w.T
    else:
        logits = x.to(compute_dtype) @ w
    logits = logits.float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if valid_vocab is not None:
        valid = max(valid_vocab - vocab_start, 0)
        if valid < logits.shape[-1]:
            logits[..., valid:] = -1e30
    return logits
