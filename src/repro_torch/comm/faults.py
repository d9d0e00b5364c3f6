"""Payload guards (port of `repro.comm.faults.guard_dp_pair`; fault
injection, host-side state checks and recovery are not ported yet).
"""
from __future__ import annotations

import torch

GUARD_MAX = 1e30   # |value| above this is declared corrupt


def _pieces(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for leaf in tree for t in _pieces(leaf)]


@torch.no_grad()
def guard_dp_pair(grads, new_err, *, expect_nonzero: bool = True):
    """Guard on the decoded DP mean: if any element of ``grads`` is
    non-finite or ``> GUARD_MAX`` in magnitude, or (with
    ``expect_nonzero``) the whole tree is zero (a dropped payload: a
    real full gradient mean is never identically zero), fill both
    ``grads`` and the error-feedback carry ``new_err`` with NaN, so the
    fault shows in the loss and the carry.  Clean payloads pass through
    bit-exactly.  Works in place and on the device: the verdict is a
    device scalar, never read by the host.  Returns (grads, new_err)."""
    pieces = [t for t in _pieces(grads) if t.numel()]
    if not pieces:
        return grads, new_err
    bad = torch.zeros((), dtype=torch.bool, device=pieces[0].device)
    zero = torch.ones_like(bad)
    for t in pieces:
        m = t.abs().amax()            # NaN propagates through amax
        bad |= ~(m <= GUARD_MAX)
        zero &= m == 0
    if expect_nonzero:
        bad |= zero
    for t in pieces + _pieces(new_err):
        t.masked_fill_(bad, float("nan"))
    return grads, new_err
