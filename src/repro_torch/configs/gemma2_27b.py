"""gemma2-27b [dense] — local/global alternating attention + logit softcap.

[arXiv:2408.00118].  46L, d_model=4608, 32H (GQA kv=16, head_dim=128),
d_ff=36864, vocab=256000; sliding window 4096 on alternating layers,
attention softcap 50, final-logit softcap 30; gated GeLU MLP; tied
embeddings.  Queries are scaled by 1/sqrt(head_dim), as the JAX package
scales them (`repro.configs.gemma2_27b`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    sliding_window=4096,
    local_global_period=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512, sliding_window=16,
)
