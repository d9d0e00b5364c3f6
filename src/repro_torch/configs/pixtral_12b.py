"""pixtral-12b [vlm] — the Mistral-Nemo decoder of Pixtral-12B.

[hf:mistralai/Pixtral-12B-2409].  40L, d_model=5120, 32H (GQA kv=8,
head_dim=128), d_ff=14336, vocab=131072, RoPE theta 1e9, untied head.
The vision frontend is a stub, as in `repro.configs.pixtral_12b`:
precomputed patch embeddings fill the leading ``num_patches`` positions
of the sequence, ahead of the text.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000_000.0,
    num_patches=1024,               # stubbed ViT patch embeddings
    tie_embeddings=False,
    act="silu",
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512, num_patches=16,
)
