"""gemma2-9b [dense] — local/global alternating attention + logit softcap.

[arXiv:2408.00118].  42L, d_model=3584, 16H (GQA kv=8, head_dim=256),
d_ff=14336, vocab=256000; local layers (even i) see a window of 4096
keys, global layers the whole cache; attention logits are capped at 50
and final logits at 30; gated GeLU MLP; tied embeddings (as in
`repro.configs.gemma2_9b`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
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
