"""whisper-small [audio] — encoder-decoder transformer backbone.

[arXiv:2212.04356].  12 encoder + 12 decoder layers, d_model=768, 12H,
head_dim=64, d_ff=3072 (plain GeLU MLP), vocab=51865, tied embeddings.
The mel-spectrogram and conv frontend is a stub, as in
`repro.configs.whisper_small`: the encoder takes 1500 precomputed frame
embeddings (30 s of audio at 50 Hz), and every decoder layer attends to
its output through cross attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=12,                  # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    encoder_layers=12,
    encoder_seq=1500,               # 30 s of audio at 50 Hz (conv stub)
    cross_attention=True,
    act="gelu",
    mlp_gated=False,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512, encoder_layers=2, encoder_seq=32,
)
