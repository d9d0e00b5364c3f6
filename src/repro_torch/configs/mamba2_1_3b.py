"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060].  48L, d_model=2048, ssm_state=128, headdim=64,
expand=2, vocab=50280.  No FFN — the Mamba2 block is the whole layer
(as in `repro.configs.mamba2_1_3b`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, vocab_size=512, ssm_state=16, ssm_headdim=32,
    ssm_chunk=32,
)
