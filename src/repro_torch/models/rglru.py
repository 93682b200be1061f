"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Block structure (temporal-mixing half of a residual block):

    x ──→ Wx ──→ causal depthwise conv (w=4) ──→ RG-LRU ──┐
      └─→ Wy ──→ GeLU ───────────────────────────────────⊙─→ Wo → out

RG-LRU recurrence (fp32):

    r_t = sigmoid(blockdiag(x_t, A_gate))          # recurrence gate
    i_t = sigmoid(blockdiag(x_t, X_gate))          # input gate
    log a_t = -c · softplus(Λ) · r_t               # c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The full-sequence path computes the gates in float32 and hands ``a`` and
``b`` to the RG-LRU scan op (``repro_torch.kernels.rglru``): the
hand-written CUDA kernel on the card, its plain sequential version on the
CPU.  Decode is the O(1) single-step update with a (state, conv-tail)
cache, updated in place.

Under tensor parallelism (``rglru_block(model_sharded=True)`` inside a
``distributed.ctx.model_parallel`` context) a rank holds its R / tp
channels of ``wx``, ``wy``, the conv, the biases and ``lambda``, its
heads of the block-diagonal gates and ``wo``'s rows of them: the scan
runs on [B, S, R / tp], and the ranks' outputs are summed.  The decode
step (``rglru_block_step(model_sharded=True)``) does the same on one
token, its cache's state ``h`` and conv tail holding the rank's
channels, as ``cache_pspecs`` splits them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.ctx import from_model, to_model
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.layers import Params, dense_init, trunc_normal_

RGLRU_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_rnn: int
    n_heads: int
    conv_width: int = 4

    @property
    def head_dim(self) -> int:
        if self.d_rnn % self.n_heads:
            raise ValueError(f"d_rnn {self.d_rnn} is not a multiple of "
                             f"{self.n_heads} heads")
        return self.d_rnn // self.n_heads


def init_rglru_block(gen: torch.Generator, d: int, spec: RGLRUSpec,
                     dtype=torch.float32, device=None) -> Params:
    r, h, hd = spec.d_rnn, spec.n_heads, spec.head_dim
    kw = dict(dtype=dtype, device=device)
    # Λ init so that a ∈ (0.9, 0.999) at r=1 (Griffin appendix).
    u = torch.empty((r,), dtype=torch.float32, device=device).uniform_(
        0.9 ** 2, 0.999 ** 2, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / (2.0 * RGLRU_C)))
    return {
        "wx": dense_init(gen, d, r, **kw),
        "wy": dense_init(gen, d, r, **kw),
        "wo": dense_init(gen, r, d, **kw),
        "conv_w": trunc_normal_(torch.empty((spec.conv_width, r), **kw), gen,
                                scale=0.1),
        "conv_b": torch.zeros((r,), **kw),
        "a_gate": dense_init(gen, hd, hd, shape=(h, hd, hd), **kw),
        "a_bias": torch.zeros((r,), **kw),
        "x_gate": dense_init(gen, hd, hd, shape=(h, hd, hd), **kw),
        "x_bias": torch.zeros((r,), **kw),
        "lambda": lam,  # fp32 always
    }


def _blockdiag(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               n_heads: int) -> torch.Tensor:
    """x: [..., R] -> [..., R] via per-head dense (block-diagonal) map."""
    shape = x.shape
    xh = x.reshape(*shape[:-1], n_heads, shape[-1] // n_heads)
    yh = torch.einsum("...hd,hde->...he", xh, w)
    return yh.reshape(shape) + b


def _gates(p: Params, spec: RGLRUSpec, x: torch.Tensor):
    """fp32 (log_a, beta·i·x) for the recurrence; x: [..., R] (a rank's
    channels of the heads ``p`` holds, under tensor parallelism)."""
    xf = x.float()
    heads = p["a_gate"].shape[0]
    r_gate = torch.sigmoid(_blockdiag(xf, p["a_gate"].float(),
                                      p["a_bias"].float(), heads))
    i_gate = torch.sigmoid(_blockdiag(xf, p["x_gate"].float(),
                                      p["x_bias"].float(), heads))
    log_a = -RGLRU_C * F.softplus(p["lambda"]) * r_gate
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * i_gate * xf


def rglru_scan(p: Params, spec: RGLRUSpec, x: torch.Tensor) -> torch.Tensor:
    """Full sequence. x: [B, S, R] -> h: [B, S, R] (same dtype as x)."""
    log_a, b = _gates(p, spec, x)
    return rglru_ops.rglru_linear_scan(torch.exp(log_a), b).to(x.dtype)


def rglru_step(p: Params, spec: RGLRUSpec, x: torch.Tensor,
               h_prev: torch.Tensor):
    """One step. x: [B, 1, R]; h_prev: [B, R] fp32."""
    log_a, b = _gates(p, spec, x)
    h = torch.exp(log_a[:, 0]) * h_prev + b[:, 0]
    return h.to(x.dtype)[:, None], h


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, R]; w: [W, R]."""
    width = w.shape[0]
    out = x * w[-1]
    for i in range(1, width):
        shifted = F.pad(x[:, :-i], (0, 0, i, 0))
        out = out + shifted * w[-1 - i]
    return out + b


def causal_conv_step(x: torch.Tensor, tail: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor):
    """x: [B, 1, R]; tail: [B, W-1, R] (previous inputs). Returns (y, new_tail)."""
    window = torch.cat([tail, x], dim=1)                      # [B, W, R]
    y = torch.einsum("bwr,wr->br", window, w)[:, None] + b
    return y, window[:, 1:]


def init_rglru_cache(batch: int, spec: RGLRUSpec, dtype=torch.bfloat16,
                     device=None) -> Params:
    return {
        "h": torch.zeros((batch, spec.d_rnn), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, spec.conv_width - 1, spec.d_rnn),
                            dtype=dtype, device=device),
    }


def rglru_block(p: Params, spec: RGLRUSpec, x: torch.Tensor, *,
                compute_dtype=torch.bfloat16,
                model_sharded: bool = False) -> torch.Tensor:
    """Full-sequence temporal-mixing block. x: [B, S, d] -> [B, S, d].
    ``model_sharded``: ``p`` is this rank's channels (the ranks' outputs
    are summed)."""
    x = x.to(compute_dtype)
    if model_sharded:
        x = to_model(x)
    xb = x @ p["wx"].to(compute_dtype)
    gb = F.gelu(x @ p["wy"].to(compute_dtype), approximate="tanh")
    xb = causal_conv(xb, p["conv_w"].to(compute_dtype),
                     p["conv_b"].to(compute_dtype))
    h = rglru_scan(p, spec, xb)
    y = (h * gb) @ p["wo"].to(compute_dtype)
    return from_model(y) if model_sharded else y


def rglru_block_step(p: Params, spec: RGLRUSpec, x: torch.Tensor,
                     cache: Params, *, compute_dtype=torch.bfloat16,
                     model_sharded: bool = False
                     ) -> tuple[torch.Tensor, Params]:
    """One decode step. x: [B, 1, d].  Writes ``cache`` in place and
    returns it.  ``model_sharded``: ``p`` and the cache's ``h`` / ``conv``
    are this rank's channels (the ranks' outputs are summed)."""
    x = x.to(compute_dtype)
    if model_sharded:
        x = to_model(x)
    xb = x @ p["wx"].to(compute_dtype)
    gb = F.gelu(x @ p["wy"].to(compute_dtype), approximate="tanh")
    xb, new_tail = causal_conv_step(xb, cache["conv"],
                                    p["conv_w"].to(compute_dtype),
                                    p["conv_b"].to(compute_dtype))
    hseq, h_state = rglru_step(p, spec, xb, cache["h"])
    y = (hseq * gb) @ p["wo"].to(compute_dtype)
    cache["h"].copy_(h_state)
    cache["conv"].copy_(new_tail)
    return (from_model(y) if model_sharded else y), cache
