"""xLSTM-350M [arXiv:2405.04517; unverified]. mLSTM:sLSTM 7:1 blocks.

24 blocks, d=1024, 4 heads.  ``d_ff=0`` per the assignment: there is no
separate FFN — the mLSTM block carries its own ×2 up/down projection and
the sLSTM block a 4/3-factor gated FF (width rounded to 1408 for mesh
divisibility).  Pattern: 7 mLSTM + 1 sLSTM per unit, 3 units.

Attention-free ⇒ ``long_500k`` runs (O(1)-state decode); the KV-offload
tier of the storage substrate is inapplicable by construction
(``supports_kv_offload=False``) — see DESIGN.md §Arch-applicability.
"""

from repro_torch.configs.base import Arch, lm_shapes
from repro_torch.models.transformer import LayerSpec, ModelConfig
from repro_torch.models.xlstm import MLSTMSpec, SLSTMSpec

_M = LayerSpec(mixer="mlstm", ffn="none")
_S = LayerSpec(mixer="slstm", ffn="none")

CONFIG = ModelConfig(
    name="xlstm-350m",
    d_model=1024, n_layers=24, vocab_size=50304,
    pattern=(_M, _M, _M, _M, _M, _M, _M, _S),
    n_heads=4, n_kv_heads=4,
    mlstm=MLSTMSpec(d_inner=2048, n_heads=4, conv_width=4, chunk=256),
    slstm=SLSTMSpec(d=1024, n_heads=4, conv_width=4, d_ff=1408),
    tie_embeddings=False,
    supports_kv_offload=False,
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke",
    d_model=64, n_layers=4, vocab_size=256,
    pattern=(_M, _M, _M, _S),
    n_heads=2, n_kv_heads=2,
    mlstm=MLSTMSpec(d_inner=128, n_heads=2, conv_width=4, chunk=8),
    slstm=SLSTMSpec(d=64, n_heads=2, conv_width=4, d_ff=96),
    tie_embeddings=False, supports_kv_offload=False,
    remat="none", param_dtype="f32",
)

ARCH = Arch(config=CONFIG, smoke=SMOKE, shapes=lm_shapes(long_context=True),
            source="arXiv:2405.04517 (xLSTM[7:1] 350M class)",
            notes="[ssm] attention-free; matrix-memory mLSTM (chunkwise "
                  "parallel) + sequential sLSTM; long_500k runs.")
