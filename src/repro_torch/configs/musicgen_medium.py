"""MusicGen-medium [arXiv:2306.05284; hf]. Decoder-only over EnCodec tokens.

Backbone only, per the assignment: the EnCodec frontend is a STUB — the
caller supplies precomputed frame embeddings
(``input_mode='embeddings'``, [B, S, d_model]); the four codebooks are
assumed already flattened by the delay-pattern into a single stream, so
the output head predicts one 2048-way codebook per step.  Positional
information is carried by the (precomputed) frame embeddings
(MusicGen uses sinusoidal embeddings added at input — frontend side).
"""

from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    d_model=1536, n_layers=48, vocab_size=2048,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=24, n_kv_heads=24, head_dim=64,
    rope_kind="none",
    d_ff=6144, act="gelu", ffn_gated=False, mlp_bias=True,
    norm="ln", input_mode="embeddings",
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    d_model=64, n_layers=2, vocab_size=64,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),),
    n_heads=4, n_kv_heads=4, head_dim=16,
    rope_kind="none", d_ff=128, act="gelu", ffn_gated=False, mlp_bias=True,
    norm="ln", input_mode="embeddings", remat="none", param_dtype="f32",
)

ARCH = Arch(config=CONFIG, smoke=SMOKE, shapes=lm_shapes(long_context=False),
            source="arXiv:2306.05284 / hf:facebook/musicgen-medium",
            notes="[audio] backbone-only; EnCodec frontend stubbed as "
                  "precomputed frame embeddings; MHA; vocab=2048 codes.")
