"""Transformer building blocks and the dense-family model."""
