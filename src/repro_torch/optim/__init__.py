"""Optimizers: AdamW with the paper's warmup-then-decay schedule."""
