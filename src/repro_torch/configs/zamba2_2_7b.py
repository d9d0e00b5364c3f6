"""zamba2-2.7b [hybrid] — Mamba2 trunk + shared-weight attention blocks.

[arXiv:2411.15242].  54L, d_model=2560, ssm_state=64; one shared
attention+FFN block (32H, GQA kv=32, head_dim=80, d_ff=10240) is
invoked after every 6th layer, reusing the same weights each time
(Zamba design; as in `repro.configs.zamba2_2_7b`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,                     # shared block FFN
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    shared_attn_every=6,
)

SMOKE = CONFIG.with_(
    num_layers=4, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512, ssm_state=16, ssm_headdim=32, ssm_chunk=32,
    shared_attn_every=2,
)
