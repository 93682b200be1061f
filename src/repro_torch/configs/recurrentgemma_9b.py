"""RecurrentGemma-9B [arXiv:2402.19427; unverified]. Griffin: RG-LRU + local attn.

38 layers in the Griffin 1:2 pattern (recurrent, recurrent, local-MQA):
12 full (R, R, L) units + a trailing (R, R) — expressed with the model's
``tail`` mechanism so the 36 patterned layers still run as one loop.
Local attention window 2048, MQA (kv=1), GeGLU MLP, Gemma-style
sqrt(d) embedding scaling, tied embeddings.

``long_500k`` RUNS for this arch: decode is O(1) per step for RG-LRU
layers and O(window) for local attention.
"""

import math

from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.rglru import RGLRUSpec
from repro_torch.models.transformer import LayerSpec, ModelConfig

WINDOW = 2048

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    d_model=4096, n_layers=38, vocab_size=256000,
    pattern=(LayerSpec(mixer="rglru", ffn="dense"),
             LayerSpec(mixer="rglru", ffn="dense"),
             LayerSpec(mixer="attn", ffn="dense", window=WINDOW)),
    tail=(LayerSpec(mixer="rglru", ffn="dense"),
          LayerSpec(mixer="rglru", ffn="dense")),
    n_heads=16, n_kv_heads=1, head_dim=256,
    rope_kind="rope", rope_theta=10000.0,
    d_ff=12288, act="gelu", ffn_gated=True,
    rglru=RGLRUSpec(d_rnn=4096, n_heads=16, conv_width=4),
    tie_embeddings=True, emb_scale=math.sqrt(4096.0),
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    d_model=64, n_layers=5, vocab_size=256,
    pattern=(LayerSpec(mixer="rglru", ffn="dense"),
             LayerSpec(mixer="rglru", ffn="dense"),
             LayerSpec(mixer="attn", ffn="dense", window=8)),
    tail=(LayerSpec(mixer="rglru", ffn="dense"),
          LayerSpec(mixer="rglru", ffn="dense")),
    n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, act="gelu", ffn_gated=True,
    rglru=RGLRUSpec(d_rnn=64, n_heads=4, conv_width=4),
    tie_embeddings=True, emb_scale=8.0, remat="none", param_dtype="f32",
)

ARCH = Arch(config=CONFIG, smoke=SMOKE, shapes=lm_shapes(long_context=True),
            source="arXiv:2402.19427 / hf:google/recurrentgemma-9b",
            notes="[hybrid] RG-LRU + local MQA (window 2048) 2:1; tail=(R,R); "
                  "sub-quadratic => long_500k runs.")
