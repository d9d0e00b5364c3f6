"""gpt2-xl-paper — the paper's own 1.5B GPT-2 XL fine-tuning target.

[hf:gpt2-xl], used in the paper's language-modeling experiments
(WikiText2 / arXiv abstracts).  48L, d_model=1600, 25H, d_ff=6400,
vocab=50257, with RoPE in place of learned absolute positions (as in
`repro.configs.gpt2_xl_paper`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-xl-paper",
    family="dense",
    source="hf:gpt2-xl (paper §4.1)",
    num_layers=48,
    d_model=1600,
    num_heads=25,
    num_kv_heads=25,
    head_dim=64,
    d_ff=6400,
    vocab_size=50257,
    act="gelu",
    mlp_gated=False,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512,
)
