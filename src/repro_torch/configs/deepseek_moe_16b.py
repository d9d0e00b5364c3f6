"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6.

[arXiv:2401.06066].  28L, d_model=2048, 16H (GQA kv=16), expert d_ff=1408,
vocab=102400; the first layer keeps a dense FFN (paper's design).
As in `repro.configs.deepseek_moe_16b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,                     # dense FFN width of the first layer
    vocab_size=102400,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10_000.0,
    act="silu",
)

SMOKE = CONFIG.with_(
    capacity_factor=8.0,   # no-drop in smoke tests (determinism)
    num_layers=3, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512, n_experts=4, top_k=2, n_shared_experts=1,
    moe_d_ff=128, first_dense_layers=1,
)
