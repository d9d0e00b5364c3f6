"""Fault injection and payload guards (port of `repro.comm.faults`: the
fault plan, the corruption patterns, the DP pair's guard and the
serving batcher's slot guard; the trainer's host-side state checks and
recovery are not ported yet).

**Injection.** A :class:`FaultPlan` of ``(step, plane, kind)``
coordinates, parsed from ``step:plane:kind`` text.  Three kinds, each
the post-decode effect of a real wire failure: ``corrupt-codes``
(garbage codes: the decoded payload turns into +-1e32), ``nan-scale``
(a NaN row scale: the decode is NaN) and ``drop-hop`` (a zeroed hop:
the payload is silently all-zero).  kv faults poison one serving slot
(`repro_torch.serving.batcher`).

**Guards.** `guard_dp_pair` poisons the decoded DP mean and its carry
on the device; `_arr_detail` (the batcher's admission check) and
`slot_flags` (its per-tick scan of the pool) name corrupt payloads:
non-finite, or above ``GUARD_MAX`` in magnitude.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

FAULT_KINDS = ("corrupt-codes", "nan-scale", "drop-hop")
# drop-hop's zero sentinel only works where an all-zero payload is
# implausible: the DP gradient mean and the seen rows of the message
# buffers.  bw gradients and kv cache rows can be legitimately zero.
ALLOWED_KINDS = {
    "dp": FAULT_KINDS, "fw": FAULT_KINDS, "zbuf": FAULT_KINDS,
    "bw": ("corrupt-codes", "nan-scale"),
    "kv": ("corrupt-codes", "nan-scale"),
}
GUARD_MAX = 1e30   # |value| above this is declared corrupt: far above
                   # any trained tensor, far below corrupt-codes' 1e32


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault: at training step ``step`` (0-based; for the
    kv plane, the batcher tick), on ``plane`` (fw/bw/zbuf/dp/kv), of
    ``kind`` (`FAULT_KINDS`)."""
    step: int
    plane: str
    kind: str

    def __post_init__(self):
        if self.plane not in ALLOWED_KINDS:
            raise ValueError(f"unknown fault plane {self.plane!r}; "
                             f"one of {sorted(ALLOWED_KINDS)}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.kind not in ALLOWED_KINDS[self.plane]:
            raise ValueError(
                f"kind {self.kind!r} is not injectable on plane "
                f"{self.plane!r} (an all-zero payload is legitimate "
                f"there); allowed: {ALLOWED_KINDS[self.plane]}")
        if self.step < 0:
            raise ValueError(f"fault step {self.step} < 0")

    def text(self) -> str:
        """The ``step:plane:kind`` token for this fault."""
        return f"{self.step}:{self.plane}:{self.kind}"


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of injected faults (possibly empty).
    Built from text by `parse`; queried per step by `at`."""
    faults: tuple = ()

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse ``step:plane:kind[,step:plane:kind...]``.  Empty text
        is no faults.  Bad tokens raise with the expected grammar."""
        faults = []
        for tok in filter(None, (t.strip() for t in text.split(","))):
            parts = tok.split(":")
            if len(parts) != 3 or not parts[0].lstrip("-").isdigit():
                raise ValueError(
                    f"bad fault token {tok!r}: expected "
                    f"step:plane:kind, e.g. 3:dp:nan-scale")
            faults.append(FaultSpec(step=int(parts[0]), plane=parts[1],
                                    kind=parts[2]))
        return cls(faults=tuple(faults))

    def at(self, step: int, plane: Optional[str] = None) -> list:
        """The faults scheduled for ``step`` (optionally one plane)."""
        return [f for f in self.faults if f.step == step
                and (plane is None or f.plane == plane)]

    def text(self) -> str:
        """The text form (inverse of `parse`)."""
        return ",".join(f.text() for f in self.faults)

    def __bool__(self):
        return bool(self.faults)


# ---------------------------------------------------------------------------
# corruption patterns (the post-decode effect of each fault kind)
# ---------------------------------------------------------------------------

def _is_float(x) -> bool:
    """True for a floating-point or complex tensor."""
    return isinstance(x, torch.Tensor) and (x.is_floating_point()
                                            or x.is_complex())


def corrupt_array(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The ``kind``-corrupted version of a float tensor (a new tensor of
    its shape, dtype and device; int and bool tensors come back
    unchanged: codes corruption is modelled post-decode on the float
    payload)."""
    if not _is_float(x):
        return x
    if kind == "corrupt-codes":
        sign = 1 - 2 * (torch.arange(x.numel(), device=x.device) % 2)
        return (sign.reshape(x.shape) * 1e32).to(x.dtype)
    if kind == "nan-scale":
        return torch.full_like(x, float("nan"))
    if kind == "drop-hop":
        return torch.zeros_like(x)
    raise ValueError(f"unknown fault kind {kind!r}")


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

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


def _bad(a: torch.Tensor) -> torch.Tensor:
    """Elementwise: non-finite or above ``GUARD_MAX`` in magnitude."""
    a = a.float() if a.is_floating_point() else a.abs()
    return ~torch.isfinite(a) | (a.abs() > GUARD_MAX)


@torch.no_grad()
def _arr_detail(a) -> Optional[str]:
    """What is corrupt in one payload (None when clean or not a float
    tensor): the batcher's admission check, one host read."""
    if not _is_float(a) or not a.numel():
        return None
    flags = torch.stack([~torch.isfinite(a).all(),
                         (_bad(a)).any()]).tolist()
    if flags[0]:
        return "non-finite values"
    if flags[1]:
        return f"magnitude above guard bound {GUARD_MAX:g}"
    return None


@torch.no_grad()
def slot_flags(pool: dict) -> np.ndarray:
    """Per-slot corruption flags for the serving batcher's pool (the
    slot is dim 1 of every stacked leaf; the ``pos`` vector is dim 0).
    A slot is flagged when ANY of its float payload is non-finite or
    above ``GUARD_MAX``.  The reduction runs on the pool's device and
    one (num_slots,) bool comes to the host.  The caller masks with its
    active set: inactive slots hold stale bytes by design."""
    num_slots = pool["pos"].shape[0]
    flags = torch.zeros(num_slots, dtype=torch.bool,
                        device=pool["pos"].device)
    for leaf in pool.values():
        if not _is_float(leaf) or leaf.dim() < 2 \
                or leaf.shape[1] != num_slots or not leaf.numel():
            continue
        flags |= _bad(leaf).movedim(1, 0).reshape(num_slots, -1).any(dim=1)
    return flags.cpu().numpy()
