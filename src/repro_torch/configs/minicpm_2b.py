"""MiniCPM-2B [arXiv:2404.06395; hf]. Llama-like dense MHA + mup-style scaling.

The paper's WSD (warmup-stable-decay) LR schedule belongs to the training
recipe, which the port takes over with slice H's training item.
"""

import math

from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    d_model=2304, n_layers=40, vocab_size=122753,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=36, n_kv_heads=36, head_dim=64,
    rope_kind="rope", rope_theta=10000.0,
    d_ff=5760, act="silu", ffn_gated=True,
    tie_embeddings=True,
    emb_scale=12.0,                           # scale_emb
    residual_scale=1.4 / math.sqrt(40),       # scale_depth / sqrt(L)
    logit_scale=256.0 / 2304.0,               # 1 / (d / dim_model_base)
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke",
    d_model=64, n_layers=2, vocab_size=256,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=160, act="silu", ffn_gated=True,
    tie_embeddings=True, emb_scale=12.0,
    residual_scale=1.4 / math.sqrt(2), logit_scale=0.25,
    remat="none", param_dtype="f32",
)

ARCH = Arch(config=CONFIG, smoke=SMOKE, shapes=lm_shapes(long_context=False),
            source="arXiv:2404.06395 / hf:openbmb/MiniCPM-2B",
            notes="MHA (kv=36); mup-style emb/residual/logit scaling; WSD schedule.")
