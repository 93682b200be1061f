"""Qwen2-VL-2B [arXiv:2409.12191; hf]. M-RoPE; vision frontend stubbed.

Backbone-only per the assignment: the dynamic-resolution ViT frontend is
a STUB — the caller provides token ids plus a precomputed
``position_ids [3, B, S]`` tensor (temporal/height/width M-RoPE ids, as
the frontend's patch-merger would emit).  head_dim=128 → M-RoPE sections
(16, 24, 24) frequency pairs.
"""

from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    d_model=1536, n_layers=28, vocab_size=151936,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=12, n_kv_heads=2, head_dim=128, qkv_bias=True,
    rope_kind="mrope", rope_theta=1e6, mrope_sections=(16, 24, 24),
    d_ff=8960, act="silu", ffn_gated=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-2b-smoke",
    d_model=64, n_layers=2, vocab_size=256,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True,
    rope_kind="mrope", rope_theta=1e6, mrope_sections=(2, 3, 3),
    d_ff=128, act="silu", ffn_gated=True,
    tie_embeddings=True, remat="none", param_dtype="f32",
)

ARCH = Arch(config=CONFIG, smoke=SMOKE, shapes=lm_shapes(long_context=False),
            source="arXiv:2409.12191 / hf:Qwen/Qwen2-VL-2B",
            notes="[vlm] backbone-only; ViT frontend stubbed (position_ids "
                  "provided); M-RoPE (16,24,24); GQA kv=2; QKV bias.")
