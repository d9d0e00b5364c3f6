"""Named registry of the data-parallel gradient wires (port of the DP
part of `repro.comm.wires`).

A *wire* is a named way of moving the DP gradient payload between
workers.  Each entry is a :class:`WireSpec` with a one-line summary,
``wire_bytes(shape, bits, n)`` (the bytes the wire puts on the network
for one ``(rows, d)`` bucket at ``bits`` over an ``n``-rank group, per
device per crossing, the JAX package's models number for number) and
``sim_allreduce``, its single-process simulator.

Registered here: ``ring`` and ``psum`` (both simulate with
`grad_compress.compress_allreduce`, bit-identical to each other).  Not
yet: their multi-process collectives, the ``ring-sharded`` and ``fp16``
wires, and the activation, buffer and KV planes' wires (ROADMAP queue
A).
"""
from __future__ import annotations

import difflib
from dataclasses import dataclass
from typing import Callable

from repro_torch.core import grad_compress as GC
from repro_torch.core import quantization as Q


@dataclass(frozen=True)
class WireSpec:
    """One registered DP wire: identity, help text, byte model and the
    simulator that carries it."""
    name: str
    summary: str
    wire_bytes: Callable[[tuple, int, int], int]
    sim_allreduce: Callable


_REGISTRY: dict = {}


def register_wire(name: str, *, summary: str, wire_bytes,
                  sim_allreduce) -> WireSpec:
    """Register a DP wire under ``name`` (unique).  Returns the spec."""
    if name in _REGISTRY:
        raise ValueError(f"wire {name!r} already registered")
    spec = WireSpec(name=name, summary=summary, wire_bytes=wire_bytes,
                    sim_allreduce=sim_allreduce)
    _REGISTRY[name] = spec
    return spec


def list_wires() -> list:
    """All registered specs, in registration order."""
    return list(_REGISTRY.values())


def wire_names() -> list:
    """Registered wire names, in registration order."""
    return list(_REGISTRY)


def get_wire(name: str) -> WireSpec:
    """Look a wire up by name; unknown names raise with a
    did-you-mean."""
    spec = _REGISTRY.get(name)
    if spec is None:
        known = wire_names()
        msg = f"unknown DP wire {name!r}; registered: {', '.join(known)}"
        close = difflib.get_close_matches(name, known, n=1, cutoff=0.5)
        if close:
            msg += f" — did you mean {close[0]!r}?"
        raise ValueError(msg)
    return spec


# ---------------------------------------------------------------------------
# byte models (shape, bits, n) -> int, per device per crossing
# ---------------------------------------------------------------------------

def ring_wire_bytes(shape, bits: int, n: int = 2) -> int:
    """The compressed ring over one (rows, d) bucket on n devices:
    n-1 hops of one packed b-bit segment (reduce-scatter), n-1 hops of
    one packed code-sum segment at `Q.sum_wire_bits` (all-gather), and
    the f32 scale max (one f32 per row)."""
    rows, d = shape
    seg = GC.ring_segment_rows(rows, n)
    hops = max(n - 1, 0)
    return hops * seg * (Q.packed_width(d, bits)
                         + Q.sum_packed_width(d, bits, n)) + rows * 4


def _psum_bytes(shape, bits: int, n: int = 1) -> int:
    """i32 code lanes in one all-reduce + the f32 scale max."""
    del bits, n
    rows, d = shape
    return rows * d * 4 + rows * 4


# ---------------------------------------------------------------------------
# built-in registrations
# ---------------------------------------------------------------------------

register_wire(
    "ring",
    summary="packed b-bit code segments on ring hops + packed code sums "
            "(bandwidth-optimal; bit-identical to psum)",
    wire_bytes=ring_wire_bytes,
    sim_allreduce=GC.compress_allreduce)
register_wire(
    "psum",
    summary="int32 code lanes in one all-reduce (conservative baseline; "
            "bit-identical to ring)",
    wire_bytes=_psum_bytes,
    sim_allreduce=GC.compress_allreduce)
