"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088].  56L, d_model=6144, 48H (GQA kv=8), expert d_ff=16384,
vocab=32768.
As in `repro.configs.mixtral_8x22b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    top_k=2,
    moe_d_ff=16384,
    sliding_window=4096,            # SWA on all layers (assignment sheet)
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
)

SMOKE = CONFIG.with_(
    capacity_factor=8.0,   # no-drop in smoke tests (determinism)
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512, n_experts=4, top_k=2, moe_d_ff=512,
    sliding_window=16,
)
