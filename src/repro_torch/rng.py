"""Seeded random streams of the port.

Random weights come from a CPU ``torch.Generator().manual_seed(seed)``
and are moved to their device leaf by leaf (`Transformer`), so one seed
gives the same weights on the card and on the CPU: a CUDA generator
draws other numbers than a CPU one from the same seed.  The noise of
stochastic rounding and sampling comes from a generator on the device
that uses it, seeded from the run's seed and a name through a stable
hash, so it never shares a stream with the weights.
"""
from __future__ import annotations

import hashlib

import torch


def seeded_generator(device, *parts) -> torch.Generator:
    """A generator on ``device`` seeded from ``parts`` (a stable hash)."""
    h = hashlib.sha256("/".join(map(str, parts)).encode()).digest()
    seed = int.from_bytes(h[:8], "little") & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(seed)
