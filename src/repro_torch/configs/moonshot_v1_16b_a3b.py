"""moonshot-v1-16b-a3b — Moonlight-16B-A3B, fine-grained MoE (64e top-6).

[hf:moonshotai/Moonlight-16B-A3B].  48L, d_model=2048, 16H (GQA kv=16),
expert d_ff=1408, vocab=163840.  Labelled [dense] on the sheet but its
config fields are DeepSeek-style MoE; built as such (DESIGN.md §5).
As in `repro.configs.moonshot_v1_16b_a3b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=11264,                     # dense FFN width of the first layer
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=50_000.0,
    act="silu",
)

SMOKE = CONFIG.with_(
    capacity_factor=8.0,   # no-drop in smoke tests (determinism)
    num_layers=3, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512, n_experts=4, top_k=2, n_shared_experts=1,
    moe_d_ff=128, first_dense_layers=1,
)
