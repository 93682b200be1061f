"""Llama-4-Maverick-400B-A17B [hf:meta-llama (Scout/Maverick family); unverified].

MoE every other layer (interleave step 2): 24 MoE layers × 128 routed
experts (top-1, sigmoid router) + 1 shared expert, dense layers with the
larger ``intermediate_size_mlp``.  ≈400B total / ≈17B active parameters.
The modality "early fusion" frontend is out of scope for the LM backbone
cell (text path only), per the assignment.
"""

from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.moe import MoESpec
from repro_torch.models.transformer import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    d_model=5120, n_layers=48, vocab_size=202048,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),
             LayerSpec(mixer="attn", ffn="moe")),
    n_heads=40, n_kv_heads=8, head_dim=128,
    rope_kind="rope", rope_theta=500000.0,
    d_ff=16384,  # dense-layer MLP width (intermediate_size_mlp)
    act="silu", ffn_gated=True,
    moe=MoESpec(n_experts=128, top_k=1, d_ff=8192, shared_d_ff=8192,
                capacity_factor=1.25, router_scale="sigmoid"),
    fsdp_units=True,   # ~400B params: stacked-unit axis sharded over 'data' (ZeRO-3)
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    d_model=64, n_layers=2, vocab_size=256,
    pattern=(LayerSpec(mixer="attn", ffn="dense"),
             LayerSpec(mixer="attn", ffn="moe")),
    n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, act="silu", ffn_gated=True,
    moe=MoESpec(n_experts=8, top_k=1, d_ff=96, shared_d_ff=96,
                capacity_factor=8.0, router_scale="sigmoid"),  # dropless at smoke scale
    remat="none", param_dtype="f32",
)

ARCH = Arch(config=CONFIG, smoke=SMOKE, shapes=lm_shapes(long_context=False),
            source="hf:meta-llama/Llama-4-Scout-17B-16E (family); assignment sheet",
            notes="MoE 128e top-1 sigmoid router + shared expert; interleaved "
                  "dense/MoE (period 2); GQA kv=8. ~400B total / ~17B active.")
