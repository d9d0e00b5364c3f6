"""Named registry of the data-parallel gradient wires (port of the DP
part of `repro.comm.wires`).

A *wire* is a named way of moving the DP gradient payload between
workers.  Each entry is a :class:`WireSpec` with a one-line summary,
``wire_bytes(shape, bits, n)`` (the bytes the wire puts on the network
for one ``(rows, d)`` bucket at ``bits`` over an ``n``-rank group, per
device per crossing, the JAX package's models number for number),
``sim_allreduce`` (its single-process simulator), ``collective`` (its
multi-process form, `repro_torch.core.collectives`) and
``expected_collectives(shape, bits, n)``, its manifest: the
``(kind, dtype, bytes, count)`` rows of every call one rank's
transport may make for it (`repro_torch.launch.mesh.Transport`), whose
bytes add up to ``wire_bytes``.

Registered here: ``ring`` and ``psum`` (bit-identical to each other
and to their simulator, `grad_compress.compress_allreduce`).  Not yet:
the ``ring-sharded`` and ``fp16`` wires, and the activation, buffer and
KV planes' wires (ROADMAP queue A).
"""
from __future__ import annotations

import difflib
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core import collectives as C
from repro_torch.core import grad_compress as GC
from repro_torch.core import quantization as Q


@dataclass(frozen=True)
class WireSpec:
    """One registered DP wire: identity, help text, byte model, the
    simulator and the collective that carry it, and the collective's
    manifest.  ``chunkable``: the collective takes ``chunks=`` (the
    double-buffered schedule, bit- and byte-identical to one chunk)."""
    name: str
    summary: str
    wire_bytes: Callable[[tuple, int, int], int]
    sim_allreduce: Callable
    collective: Optional[Callable] = None
    expected_collectives: Optional[Callable] = None
    chunkable: bool = False


_REGISTRY: dict = {}


def register_wire(name: str, *, summary: str, wire_bytes,
                  sim_allreduce, collective=None, expected_collectives=None,
                  chunkable: bool = False) -> WireSpec:
    """Register a DP wire under ``name`` (unique).  Returns the spec."""
    if name in _REGISTRY:
        raise ValueError(f"wire {name!r} already registered")
    if collective is not None and expected_collectives is None:
        raise ValueError(f"wire {name!r}: a collective needs its "
                         f"expected_collectives manifest")
    spec = WireSpec(name=name, summary=summary, wire_bytes=wire_bytes,
                    sim_allreduce=sim_allreduce, collective=collective,
                    expected_collectives=expected_collectives,
                    chunkable=chunkable)
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

def _psum_bytes(shape, bits: int, n: int = 1) -> int:
    """i32 code lanes in one all-reduce + the f32 scale max."""
    del bits, n
    rows, d = shape
    return rows * d * 4 + rows * 4


# ---------------------------------------------------------------------------
# manifests (shape, bits, n) -> [(kind, dtype, bytes_per_call, count)]:
# the calls one rank's transport makes for a wire, per step, on an
# n-rank ring (n > 1), sorted as `Transport.manifest` sorts them
# ---------------------------------------------------------------------------

def _scale_max(shape) -> tuple:
    """The call every codec wire shares: the f32 per-row scale max."""
    rows, _ = shape
    return ("all-reduce", "f32", rows * 4, 1)


def _ring_manifest(shape, bits: int, n: int) -> list:
    """n-1 packed b-bit code-segment hops (reduce-scatter), n-1 packed
    code-sum segment hops (all-gather) and the scale max."""
    rows, d = shape
    seg = C.ring_segment_rows(rows, n)
    return sorted([
        _scale_max(shape),
        ("collective-permute", "u8", seg * Q.packed_width(d, bits), n - 1),
        ("collective-permute", "u8", seg * Q.sum_packed_width(d, bits, n),
         n - 1)])


def _psum_manifest(shape, bits: int, n: int) -> list:
    """One s32 code all-reduce and the scale max."""
    del bits, n
    rows, d = shape
    return sorted([_scale_max(shape), ("all-reduce", "s32", rows * d * 4, 1)])


# ---------------------------------------------------------------------------
# built-in registrations
# ---------------------------------------------------------------------------

register_wire(
    "ring",
    summary="packed b-bit code segments on ring hops + packed code sums "
            "(bandwidth-optimal; bit-identical to psum)",
    wire_bytes=C.ring_wire_bytes,
    sim_allreduce=GC.compress_allreduce,
    collective=C.ring_ef_reduce_mean_bucket,
    expected_collectives=_ring_manifest,
    chunkable=True)
register_wire(
    "psum",
    summary="int32 code lanes in one all-reduce (conservative baseline; "
            "bit-identical to ring)",
    wire_bytes=_psum_bytes,
    sim_allreduce=GC.compress_allreduce,
    collective=C.ef_psum_mean_bucket,
    expected_collectives=_psum_manifest)
