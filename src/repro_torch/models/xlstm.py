"""xLSTM blocks: chunkwise-parallel mLSTM and sequential sLSTM.

(arXiv:2405.04517.)  Both cells use the paper's exp-gate stabilisation
(running max ``m``).  The mLSTM (matrix memory C ∈ R^{Dk×Dv}) is computed
in a **chunkwise-parallel form**: intra-chunk attention-like scores with
cumulative log-decay, inter-chunk linear recurrence on the (C, n, m)
state, one Python step a chunk.  The sLSTM has a true hidden-state
feedback (block-diagonal per-head recurrent matrices) and is inherently
sequential: one Python step a token.  Both are plain torch: the JAX
package computes them in plain ``jnp`` too, with no Pallas kernel.

mLSTM block:   x ─→ up(×2) ─→ conv4 ─→ silu ─→ (q,k) ; u ─→ v ; gates(u)
               h = mLSTM(q,k,v,i,f) ─→ per-head RMSNorm ─⊙ silu(gate) ─→ down
sLSTM block:   conv4/silu feeds (i,f); z,o from x; post GN + GeGLU(4/3) FF.

The step functions write their (state, conv-tail) cache in place and
return it, as the port's other decode steps do.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, trunc_normal_
from repro_torch.models.rglru import causal_conv, causal_conv_step

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class MLSTMSpec:
    d_inner: int
    n_heads: int
    conv_width: int = 4
    chunk: int = 256

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


@dataclasses.dataclass(frozen=True)
class SLSTMSpec:
    d: int
    n_heads: int
    conv_width: int = 4
    d_ff: int = 0  # gated FF width after the cell (0 = none)

    @property
    def head_dim(self) -> int:
        return self.d // self.n_heads


def forget_bias(n: int, device=None) -> torch.Tensor:
    """The paper's positive forget-gate bias, ``linspace(3, 6, n)`` in
    float32 (long memory at init)."""
    return torch.linspace(3.0, 6.0, n, dtype=torch.float64,
                          device=device).float()


# ---------------------------------------------------------------------------
# mLSTM cell — chunkwise parallel
# ---------------------------------------------------------------------------


def mlstm_chunkwise(q, k, v, i_raw, f_raw, *, chunk: int, initial=None):
    """q,k,v: [B, S, H, D]; i_raw,f_raw: [B, S, H] (pre-activation gates).

    Returns (h [B, S, H, D], final_state (C, n, m)).  fp32 internally."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q = q.float() * scale
    k = k.float()
    v = v.float()
    logf = F.logsigmoid(f_raw.float())
    logi = i_raw.float()

    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logf = F.pad(logf, (0, 0, 0, pad))                 # f=1: keeps state
        logi = F.pad(logi, (0, 0, 0, pad), value=NEG)
    nc = q.shape[1] // chunk
    L = chunk

    if initial is None:
        C = torch.zeros((b, h, d, d), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h), NEG, dtype=torch.float32, device=q.device)
    else:
        C, n, m = initial

    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    hs = []
    for ci in range(nc):
        sl = slice(ci * L, (ci + 1) * L)
        qx, kx, vx, lf, li = q[:, sl], k[:, sl], v[:, sl], logf[:, sl], \
            logi[:, sl]                                  # [B, L, H(, D)]
        bcum = torch.cumsum(lf, dim=1)                    # [B, L, H]
        g = bcum[:, -1]                                   # [B, H]
        # log weights: intra (i attends j<=i) and inter (state)
        intra = bcum[:, :, None] - bcum[:, None, :] + li[:, None, :, :]
        intra = torch.where(causal, intra, NEG)           # [B, L, L, H]
        m_intra = intra.amax(dim=2)                       # [B, L, H]
        m_inter = m[:, None] + bcum                       # [B, L, H]
        m_i = torch.maximum(m_intra, m_inter)
        A = torch.exp(intra - m_i[:, :, None, :])         # [B, L, L, H]
        rho = torch.exp(m_inter - m_i)                    # [B, L, H]

        s_qk = torch.einsum("blhd,bjhd->bljh", qx, kx)    # [B, L, L, H]
        num = (torch.einsum("bljh,bjhd->blhd", A * s_qk, vx)
               + rho[..., None] * torch.einsum("blhd,bhde->blhe", qx, C))
        nv = (torch.einsum("bljh,bjhd->blhd", A, kx)
              + rho[..., None] * n[:, None])
        denom = torch.maximum(
            torch.einsum("blhd,blhd->blh", qx, nv).abs(), torch.exp(-m_i))
        hs.append(num / denom[..., None])

        # state update to end of chunk
        m_new = torch.maximum(m + g, (g[:, None] - bcum + li).amax(dim=1))
        decay_j = torch.exp(g[:, None] - bcum + li - m_new[:, None])  # [B,L,H]
        keep = torch.exp(m + g - m_new)
        C = (keep[:, :, None, None] * C
             + torch.einsum("blhd,blhe->bhde", decay_j[..., None] * kx, vx))
        n = keep[:, :, None] * n + torch.einsum("blh,blhd->bhd", decay_j, kx)
        m = m_new
    return torch.cat(hs, dim=1)[:, :s], (C, n, m)


def mlstm_step(q, k, v, i_raw, f_raw, state):
    """Single decode step. q,k,v: [B, H, D]; gates: [B, H]."""
    C, n, m = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    q = q.float() * scale
    k, v = k.float(), v.float()
    logf = F.logsigmoid(f_raw.float())
    logi = i_raw.float()
    m_new = torch.maximum(logf + m, logi)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(logi - m_new)
    C_new = (fp[..., None, None] * C
             + ip[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n_new = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new)
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", q, n_new).abs(),
                          torch.exp(-m_new))
    return num / denom[..., None], (C_new, n_new, m_new)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def init_mlstm_block(gen: torch.Generator, d: int, spec: MLSTMSpec,
                     dtype=torch.float32, device=None) -> Params:
    di, h, hd = spec.d_inner, spec.n_heads, spec.head_dim
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_up_v": dense_init(gen, d, di, **kw),
        "w_up_g": dense_init(gen, d, di, **kw),
        "conv_w": trunc_normal_(torch.empty((spec.conv_width, di), **kw), gen,
                                scale=0.1),
        "conv_b": torch.zeros((di,), **kw),
        # per-head block-diagonal q/k/v maps (keeps the 350M budget; the
        # matrix memory mixes within heads only, as in the paper's cell)
        "wq": dense_init(gen, hd, hd, shape=(h, hd, hd), **kw),
        "wk": dense_init(gen, hd, hd, shape=(h, hd, hd), **kw),
        "wv": dense_init(gen, hd, hd, shape=(h, hd, hd), **kw),
        "wi": dense_init(gen, di, h, **f32),
        "bi": torch.zeros((h,), **f32),
        "wf": dense_init(gen, di, h, **f32),
        "bf": forget_bias(h, device),
        "gn_scale": torch.ones((di,), **f32),
        "w_down": dense_init(gen, di, d, **kw),
    }


def _headwise_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                      n_heads: int) -> torch.Tensor:
    b, s, di = x.shape
    xh = x.float().reshape(b, s, n_heads, di // n_heads)
    var = xh.square().mean(dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + 1e-6)
    return (xh.reshape(b, s, di) * scale).to(x.dtype)


def _mlstm_qkv_gates(p: Params, spec: MLSTMSpec, u, c, dtype):
    h, hd = spec.n_heads, spec.head_dim
    ch = c.reshape(c.shape[0], c.shape[1], h, hd)
    uh = u.reshape(u.shape[0], u.shape[1], h, hd)
    q = torch.einsum("bshd,hde->bshe", ch, p["wq"].to(dtype))
    k = torch.einsum("bshd,hde->bshe", ch, p["wk"].to(dtype))
    v = torch.einsum("bshd,hde->bshe", uh, p["wv"].to(dtype))
    uf = u.float()
    i_raw = torch.einsum("bsd,dh->bsh", uf, p["wi"].float()) + p["bi"]
    f_raw = torch.einsum("bsd,dh->bsh", uf, p["wf"].float()) + p["bf"]
    return q, k, v, i_raw, f_raw


def _mlstm_in(p: Params, x: torch.Tensor, dtype):
    """x -> (u, z): the up projections of the value path and the gate."""
    x = x.to(dtype)
    return x @ p["w_up_v"].to(dtype), x @ p["w_up_g"].to(dtype)


def _mlstm_out(p: Params, spec: MLSTMSpec, h: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    h = h.reshape(z.shape[0], z.shape[1], spec.d_inner).to(dtype)
    h = _headwise_rmsnorm(h, p["gn_scale"], spec.n_heads)
    return (h * F.silu(z)) @ p["w_down"].to(dtype)


def mlstm_prefill(p: Params, spec: MLSTMSpec, x: torch.Tensor, *,
                  compute_dtype=torch.bfloat16):
    """Full sequence. x: [B, S, d] -> (y [B, S, d], (C, n, m), u): the
    final state, and ``u``, whose last ``conv_width - 1`` rows (the
    *pre*-conv inputs) are the decode cache's conv tail."""
    cd = compute_dtype
    u, z = _mlstm_in(p, x, cd)
    c = F.silu(causal_conv(u, p["conv_w"].to(cd), p["conv_b"].to(cd)))
    q, k, v, i_raw, f_raw = _mlstm_qkv_gates(p, spec, u, c, cd)
    h, state = mlstm_chunkwise(q, k, v, i_raw, f_raw, chunk=spec.chunk)
    return _mlstm_out(p, spec, h, z, cd), state, u


def mlstm_block(p: Params, spec: MLSTMSpec, x: torch.Tensor, *,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    return mlstm_prefill(p, spec, x, compute_dtype=compute_dtype)[0]


def init_mlstm_cache(batch: int, spec: MLSTMSpec, dtype=torch.bfloat16,
                     device=None) -> Params:
    h, hd = spec.n_heads, spec.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, h, hd, hd), **f32),
        "n": torch.zeros((batch, h, hd), **f32),
        "m": torch.full((batch, h), NEG, **f32),
        "conv": torch.zeros((batch, spec.conv_width - 1, spec.d_inner),
                            dtype=dtype, device=device),
    }


def mlstm_block_step(p: Params, spec: MLSTMSpec, x: torch.Tensor,
                     cache: Params, *, compute_dtype=torch.bfloat16
                     ) -> tuple[torch.Tensor, Params]:
    """One decode step. x: [B, 1, d].  Writes ``cache`` in place and
    returns it."""
    cd = compute_dtype
    u, z = _mlstm_in(p, x, cd)
    c, new_tail = causal_conv_step(u, cache["conv"], p["conv_w"].to(cd),
                                   p["conv_b"].to(cd))
    c = F.silu(c)
    q, k, v, i_raw, f_raw = _mlstm_qkv_gates(p, spec, u, c, cd)
    h, (C, n, m) = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                              f_raw[:, 0], (cache["C"], cache["n"],
                                            cache["m"]))
    y = _mlstm_out(p, spec, h, z, cd)
    for key, val in (("C", C), ("n", n), ("m", m), ("conv", new_tail)):
        cache[key].copy_(val)
    return y, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


def init_slstm_block(gen: torch.Generator, d: int, spec: SLSTMSpec,
                     dtype=torch.float32, device=None) -> Params:
    h, hd = spec.n_heads, spec.head_dim
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "conv_w": trunc_normal_(torch.empty((spec.conv_width, d), **kw), gen,
                                scale=0.1),
        "conv_b": torch.zeros((d,), **kw),
        "gn_scale": torch.ones((d,), dtype=torch.float32, device=device),
    }
    for g in GATES:
        p[f"w{g}"] = dense_init(gen, d, d, **kw)
        p[f"r{g}"] = dense_init(gen, hd, hd, shape=(h, hd, hd), **kw)
        p[f"b{g}"] = (forget_bias(d, device) if g == "f" else
                      torch.zeros((d,), dtype=torch.float32, device=device))
    if spec.d_ff:
        p["ff_w1"] = dense_init(gen, d, spec.d_ff, **kw)
        p["ff_w2"] = dense_init(gen, d, spec.d_ff, **kw)
        p["ff_w3"] = dense_init(gen, spec.d_ff, d, **kw)
    return p


def _slstm_weights(p: Params):
    """The cell's recurrent maps stacked in ``GATES`` order, [4, h, hd, hd]
    float32, and its biases [4, 1, d]: cast once a sequence, not a step."""
    r = torch.stack([p[f"r{g}"].float() for g in GATES])
    bias = torch.stack([p[f"b{g}"].float() for g in GATES])[:, None]
    return r, bias


def _slstm_cell(spec: SLSTMSpec, r, bias, xs, state):
    """One timestep.  xs: [4, B, d] float32, the input projections of z,
    i, f and o; r, bias from ``_slstm_weights``; state = (c, n, h, m)."""
    c, n, h_prev, m = state
    b, nh = h_prev.shape[0], spec.n_heads
    rec = torch.einsum("bhd,ghde->gbhe", h_prev.reshape(b, nh, -1), r)
    pre = xs + rec.reshape(xs.shape) + bias
    z = torch.tanh(pre[0])
    o = torch.sigmoid(pre[3])
    i_raw, f_raw = pre[1], pre[2]
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    ip = torch.exp(i_raw - m_new)
    fp = torch.exp(logf + m - m_new)
    c_new = fp * c + ip * z
    n_new = fp * n + ip
    h_new = o * c_new / torch.maximum(n_new, torch.exp(-m_new))
    return c_new, n_new, h_new, m_new


def _slstm_scan(p: Params, spec: SLSTMSpec, x: torch.Tensor,
                xc: torch.Tensor, state):
    """x (for z/o), xc (conv'd, for i/f): [B, S, d]. Returns h [B,S,d],
    state.  One ``_slstm_cell`` a token, from Python."""
    xf32, xcf = x.float(), xc.float()
    xs = torch.stack([xf32 @ p["wz"].float(), xcf @ p["wi"].float(),
                      xcf @ p["wf"].float(), xf32 @ p["wo"].float()])
    r, bias = _slstm_weights(p)
    hs = torch.empty_like(xs[0])
    for t in range(x.shape[1]):
        state = _slstm_cell(spec, r, bias, xs[:, :, t], state)
        hs[:, t] = state[2]
    return hs, state


def init_slstm_cache(batch: int, spec: SLSTMSpec, dtype=torch.bfloat16,
                     device=None) -> Params:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, spec.d), **f32),
        "n": torch.zeros((batch, spec.d), **f32),
        "h": torch.zeros((batch, spec.d), **f32),
        "m": torch.full((batch, spec.d), NEG, **f32),
        "conv": torch.zeros((batch, spec.conv_width - 1, spec.d),
                            dtype=dtype, device=device),
    }


def _slstm_out(p: Params, spec: SLSTMSpec, h: torch.Tensor,
               dtype) -> torch.Tensor:
    h = _headwise_rmsnorm(h.to(dtype), p["gn_scale"], spec.n_heads)
    if spec.d_ff:
        a = F.gelu(h @ p["ff_w1"].to(dtype), approximate="tanh")
        h = (a * (h @ p["ff_w2"].to(dtype))) @ p["ff_w3"].to(dtype)
    return h


def slstm_prefill(p: Params, spec: SLSTMSpec, x: torch.Tensor, *,
                  compute_dtype=torch.bfloat16):
    """Full sequence from a zero state. x: [B, S, d] -> (y, final state
    (c, n, h, m)); the conv tail of the cache is x's last rows."""
    cd = compute_dtype
    x = x.to(cd)
    xc = F.silu(causal_conv(x, p["conv_w"].to(cd), p["conv_b"].to(cd)))
    zeros = torch.zeros((x.shape[0], spec.d), dtype=torch.float32,
                        device=x.device)
    state = (zeros, zeros, zeros, torch.full_like(zeros, NEG))
    h, state = _slstm_scan(p, spec, x, xc, state)
    return _slstm_out(p, spec, h, cd), state


def slstm_block(p: Params, spec: SLSTMSpec, x: torch.Tensor, *,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    return slstm_prefill(p, spec, x, compute_dtype=compute_dtype)[0]


def slstm_block_step(p: Params, spec: SLSTMSpec, x: torch.Tensor,
                     cache: Params, *, compute_dtype=torch.bfloat16
                     ) -> tuple[torch.Tensor, Params]:
    """One decode step. x: [B, 1, d].  Writes ``cache`` in place and
    returns it."""
    cd = compute_dtype
    x = x.to(cd)
    xc, new_tail = causal_conv_step(x, cache["conv"], p["conv_w"].to(cd),
                                    p["conv_b"].to(cd))
    xc = F.silu(xc)
    state = (cache["c"], cache["n"], cache["h"], cache["m"])
    h, state = _slstm_scan(p, spec, x, xc, state)
    y = _slstm_out(p, spec, h, cd)
    for key, val in zip(("c", "n", "h", "m"), state):
        cache[key].copy_(val)
    cache["conv"].copy_(new_tail)
    return y, cache
