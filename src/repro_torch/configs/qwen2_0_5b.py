"""Qwen2-0.5B [arXiv:2407.10671; hf]. Dense, GQA kv=2, QKV bias, tied embeddings."""

from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    d_model=896, n_layers=24, vocab_size=151936,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=14, n_kv_heads=2, head_dim=64, qkv_bias=True,
    rope_kind="rope", rope_theta=1e6,
    d_ff=4864, act="silu", ffn_gated=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke",
    d_model=64, n_layers=2, vocab_size=256,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True,
    rope_kind="rope", rope_theta=1e6,
    d_ff=128, act="silu", ffn_gated=True,
    tie_embeddings=True, remat="none", param_dtype="f32",
)

ARCH = Arch(config=CONFIG, smoke=SMOKE, shapes=lm_shapes(long_context=False),
            source="arXiv:2407.10671 / hf:Qwen/Qwen2-0.5B",
            notes="GQA kv=2; QKV bias; RoPE theta 1e6; tied embeddings.")
