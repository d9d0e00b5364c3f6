"""Writes of fresh rows into a cache store at a write head.

A store is ``(B, S, ...)``; a write puts ``s`` fresh rows ``(B, s,
...)`` at rows ``[head, head + s)``.  The head is an int (a uniform
batch) or a (B,) tensor, one head a batch entry (the continuous
batcher's pool).  A tensor head is clamped to ``[0, S - s]``, the rule
of ``jax.lax.dynamic_update_slice`` that the JAX package's per-row
writes follow under ``vmap``: an idle slot whose head has run past the
store writes its own last rows, never another row's.  Nothing here
reads a tensor head on the host.
"""
from __future__ import annotations

import torch


def clamp_heads(pos: torch.Tensor, cache_len: int, s: int = 1
                ) -> torch.Tensor:
    """(B,) write heads as int64, clamped to ``[0, cache_len - s]``."""
    return pos.long().clamp_(0, cache_len - s)


def write_rows_(store: torch.Tensor, rows: torch.Tensor, start) -> None:
    """Write ``rows`` (B, s, ...) into ``store`` (B, S, ...) in place at
    rows ``[start, start + s)``: ``start`` an int, or (B,) int64 heads
    already clamped (`clamp_heads`).  A tensor head is one scatter
    launch (plus an index add for s > 1)."""
    s = rows.shape[1]
    if not isinstance(start, torch.Tensor):
        store[:, start:start + s] = rows
        return
    idx = start[:, None]
    if s > 1:
        idx = idx + torch.arange(s, device=store.device)
    idx = idx.reshape(*idx.shape, *[1] * (rows.dim() - 2)).expand(rows.shape)
    store.scatter_(1, idx, rows.to(store.dtype))
