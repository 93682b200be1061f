"""Granite-3.0-2B-base [hf:ibm-granite/granite-3.0-2b-base]. Dense GQA kv=8."""

from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    d_model=2048, n_layers=40, vocab_size=49155,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=32, n_kv_heads=8, head_dim=64,
    rope_kind="rope", rope_theta=10000.0,
    d_ff=8192, act="silu", ffn_gated=True,
    tie_embeddings=True,
    emb_scale=12.0, residual_scale=0.22, logit_scale=1.0 / 8.0,
)

SMOKE = ModelConfig(
    name="granite-3-2b-smoke",
    d_model=64, n_layers=2, vocab_size=256,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=256, act="silu", ffn_gated=True,
    tie_embeddings=True, emb_scale=12.0, residual_scale=0.22,
    logit_scale=1.0 / 8.0, remat="none", param_dtype="f32",
)

ARCH = Arch(config=CONFIG, smoke=SMOKE, shapes=lm_shapes(long_context=False),
            source="hf:ibm-granite/granite-3.0-2b-base",
            notes="GQA kv=8; Granite power-scaling multipliers.")
