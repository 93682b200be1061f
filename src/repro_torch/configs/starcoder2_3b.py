"""StarCoder2-3B [arXiv:2402.19173; hf]. GQA kv=2, RoPE, LayerNorm+bias, GELU MLP."""

from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    d_model=3072, n_layers=30, vocab_size=49152,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=24, n_kv_heads=2, head_dim=128, qkv_bias=True,
    rope_kind="rope", rope_theta=999999.44,
    d_ff=12288, act="gelu", ffn_gated=False, mlp_bias=True,
    tie_embeddings=True, norm="ln",
)

SMOKE = ModelConfig(
    name="starcoder2-3b-smoke",
    d_model=64, n_layers=2, vocab_size=256,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True,
    d_ff=256, act="gelu", ffn_gated=False, mlp_bias=True,
    tie_embeddings=True, norm="ln", remat="none", param_dtype="f32",
)

ARCH = Arch(config=CONFIG, smoke=SMOKE, shapes=lm_shapes(long_context=False),
            source="arXiv:2402.19173 / hf:bigcode/starcoder2-3b",
            notes="GQA kv=2; classic GELU MLP (non-gated) + LayerNorm with bias.")
