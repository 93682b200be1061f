"""Granite-3.0 MoE 3B-A800M [hf:ibm-granite/granite-3.0-*-base; assignment].

The assignment sheet specifies **40 experts top-8** (the hf 1b card lists
32; we follow the assignment).  Tiny per-expert FFN (d_ff=512).
"""

from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.moe import MoESpec
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    d_model=1536, n_layers=32, vocab_size=49155,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    n_heads=24, n_kv_heads=8, head_dim=64,
    rope_kind="rope", rope_theta=10000.0,
    act="silu", ffn_gated=True,
    moe=MoESpec(n_experts=40, top_k=8, d_ff=512, capacity_factor=1.25),
    tie_embeddings=True,
    emb_scale=12.0, residual_scale=0.22, logit_scale=1.0 / 6.0,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    d_model=64, n_layers=2, vocab_size=256,
    pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    n_heads=4, n_kv_heads=2, head_dim=16,
    act="silu", ffn_gated=True,
    moe=MoESpec(n_experts=8, top_k=2, d_ff=32, capacity_factor=8.0),  # dropless at smoke scale
    tie_embeddings=True, emb_scale=12.0, residual_scale=0.22,
    logit_scale=1.0 / 6.0, remat="none", param_dtype="f32",
)

ARCH = Arch(config=CONFIG, smoke=SMOKE, shapes=lm_shapes(long_context=False),
            source="hf:ibm-granite/granite-3.0-1b-a400m-base (family); assignment sheet",
            notes="MoE 40e top-8, tiny experts (d_ff=512); GQA kv=8.")
