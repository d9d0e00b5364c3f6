"""stablelm-12b [dense] — plain GQA dense decoder with an untied head.

[hf:stabilityai/stablelm-2-1_6b (family)].  40L, d_model=5120, 32H
(GQA kv=8, head_dim=160), d_ff=13824, vocab=100352; gated SiLU MLP, no
sliding window or softcaps; the output head is a (d_model, vocab)
matrix of its own, not the embedding (as in `repro.configs.stablelm_12b`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    rope_theta=10_000.0,
    act="silu",
    tie_embeddings=False,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512,
)
