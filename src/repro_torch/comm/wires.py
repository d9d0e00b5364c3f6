"""Named wire registry: every inter-machine byte class, one table (port
of `repro.comm.wires`).

A *wire* is a named way of moving one plane's payload between workers
(or, for the z-buffer and KV planes, into device memory).  Each entry
is a :class:`WireSpec` registered under ``(plane, name)`` with

* ``plane`` — ``fw-activation`` / ``bw-gradient`` / ``z-buffer`` /
  ``dp-grad`` / ``kv-cache``;
* ``summary`` — the one-line ``--dp-wire`` help and ``--list-wires``
  text;
* ``wire_bytes(shape, bits, n)`` — the bytes the wire puts on the
  network (``network=False``: into device memory) for one ``shape``
  payload at ``bits`` over an ``n``-rank group, per device per
  crossing, the JAX package's models number for number;
* for DP wires, the multi-process ``collective``
  (`repro_torch.core.collectives`), its single-process simulator
  ``sim_allreduce`` and ``expected_collectives(shape, bits, n)``, its
  manifest: the ``(kind, dtype, bytes, count)`` rows of every call one
  rank's transport may make for it (`repro_torch.launch.mesh.Transport`),
  whose bytes add up to ``wire_bytes``.  ``sharded`` marks the ZeRO
  wire, whose result is one owned segment a rank (its parameter
  all-gather goes on a plane of its own, ``dp-gather``, outside the
  manifest, as in the JAX package's); ``psum_lowered`` a wire that is
  one all-reduce, whose byte model counts logical lanes.

The codec wires (``ring``, ``psum``, ``ring-sharded``) are bit-identical
to each other and to their simulators: int32 code sums are exact in any
order.  ``fp16`` is a cast and one f16 all-reduce; f16 sums depend on
their order, so it matches its simulator bit for bit at n = 2 only.
"""
from __future__ import annotations

import difflib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.core import grad_compress as GC
from repro_torch.core import quantization as Q

PLANES = ("fw-activation", "bw-gradient", "z-buffer", "dp-grad",
          "kv-cache")


@dataclass(frozen=True)
class WireSpec:
    """One registered wire: identity, help text, byte model, and for DP
    wires the collective, its simulator and its manifest.
    ``chunkable``: the collective takes ``chunks=`` (the double-buffered
    schedule, bit- and byte-identical to one chunk).  ``internal``: a
    harness-owned wrapper (the fault wires of `repro_torch.comm.faults`),
    resolvable by `get_wire` and hidden from `list_wires` and
    `wire_names`, so from the ``--dp-wire`` choices and
    ``--list-wires``."""
    name: str
    plane: str
    summary: str
    wire_bytes: Callable[[tuple, int, int], int]
    collective: Optional[Callable] = None
    sim_allreduce: Optional[Callable] = None
    expected_collectives: Optional[Callable] = None
    sharded: bool = False
    network: bool = True
    chunkable: bool = False
    psum_lowered: bool = False
    internal: bool = False


_REGISTRY: dict = {}


def register_wire(name: str, *, summary: str, wire_bytes,
                  plane: str = "dp-grad", collective=None,
                  sim_allreduce=None, expected_collectives=None,
                  sharded: bool = False, network: bool = True,
                  chunkable: bool = False,
                  psum_lowered: bool = False,
                  internal: bool = False) -> WireSpec:
    """Register a wire under ``(plane, name)`` (names are unique per
    plane).  Returns the spec.  ``internal=True`` registers a
    harness-owned wrapper: hidden from enumeration, and its collective
    needs no manifest of its own."""
    if plane not in PLANES:
        raise ValueError(f"unknown plane {plane!r}; one of {PLANES}")
    if (plane, name) in _REGISTRY:
        raise ValueError(f"wire {name!r} already registered on plane "
                         f"{plane!r}")
    if collective is not None and (
            sim_allreduce is None
            or (expected_collectives is None and not internal)):
        raise ValueError(f"wire {name!r}: a collective needs its "
                         f"sim_allreduce and expected_collectives")
    spec = WireSpec(name=name, plane=plane, summary=summary,
                    wire_bytes=wire_bytes, collective=collective,
                    sim_allreduce=sim_allreduce,
                    expected_collectives=expected_collectives,
                    sharded=sharded, network=network, chunkable=chunkable,
                    psum_lowered=psum_lowered, internal=internal)
    _REGISTRY[(plane, name)] = spec
    return spec


def unknown_wire_message(name: str, plane: str) -> str:
    """Error text for an unknown wire, with a did-you-mean hint."""
    known = wire_names(plane)
    msg = (f"unknown wire {name!r} on plane {plane!r}; "
           f"registered wires: {', '.join(known)}")
    close = difflib.get_close_matches(name, known, n=1, cutoff=0.5)
    if close:
        msg += f" — did you mean {close[0]!r}?"
    return msg


def get_wire(name: str, plane: str = "dp-grad") -> WireSpec:
    """Look a wire up by name on ``plane`` (the DP gradient plane by
    default); unknown names raise with a did-you-mean."""
    spec = _REGISTRY.get((plane, name))
    if spec is None:
        raise ValueError(unknown_wire_message(name, plane))
    return spec


def list_wires(plane: Optional[str] = None, *,
               include_internal: bool = False) -> list:
    """All registered specs (of one plane, or every plane), in
    registration order; internal wrappers only with
    ``include_internal``."""
    return [s for (p, _), s in _REGISTRY.items()
            if (plane is None or p == plane)
            and (include_internal or not s.internal)]


def wire_names(plane: Optional[str] = None, *,
               include_internal: bool = False) -> list:
    """Registered wire names (of one plane, or every plane), in
    registration order; internal wrappers only with
    ``include_internal``."""
    return [s.name for s in list_wires(plane,
                                       include_internal=include_internal)]


# ---------------------------------------------------------------------------
# byte models (shape, bits, n) -> int, per device per crossing
# ---------------------------------------------------------------------------

def _codec_bytes(shape, bits: int, n: int = 1) -> int:
    """Packed b-bit codes + one f32 scale per row: the boundary payload
    (forward deltas, backward gradients, z-buffers)."""
    del n
    return Q.wire_bytes(shape, bits)


def _psum_bytes(shape, bits: int, n: int = 1) -> int:
    """i32 code lanes in one all-reduce + the f32 scale max."""
    del bits, n
    rows, d = shape
    return rows * d * 4 + rows * 4


def _ring_bytes(shape, bits: int, n: int = 2) -> int:
    return C.ring_wire_bytes(shape, bits, n=n)


def _ring_sharded_bytes(shape, bits: int, n: int = 2) -> int:
    return C.ring_wire_bytes(shape, bits, n=n, sharded=True)


def _fp16_bytes(shape, bits: int, n: int = 1) -> int:
    """f16 lanes in one all-reduce; no codes, no scales, no bits."""
    del bits, n
    rows, d = shape
    return rows * d * 2


def _kv_bytes(shape, bits: int, n: int = 1) -> int:
    """Stored bytes of one KV append: packed b-bit codes plus one f32
    scale a group row of the grouped value shape ``(..., group)``, or
    raw f32 when ``bits`` is 0."""
    del n
    if not bits:
        size = 1
        for s in shape:
            size *= int(s)
        return size * 4
    return Q.wire_bytes(shape, bits)


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


def _ring_sharded_manifest(shape, bits: int, n: int) -> list:
    """The ring stopped at its reduce-scatter midpoint: the n-1 packed
    code-segment hops and the scale max."""
    rows, d = shape
    seg = C.ring_segment_rows(rows, n)
    return sorted([
        _scale_max(shape),
        ("collective-permute", "u8", seg * Q.packed_width(d, bits), n - 1)])


def _psum_manifest(shape, bits: int, n: int) -> list:
    """One s32 code all-reduce and the scale max."""
    del bits, n
    rows, d = shape
    return sorted([_scale_max(shape), ("all-reduce", "s32", rows * d * 4, 1)])


def _fp16_manifest(shape, bits: int, n: int) -> list:
    """Exactly one f16 all-reduce: no codes, no scales."""
    del bits, n
    rows, d = shape
    return [("all-reduce", "f16", rows * d * 2, 1)]


# ---------------------------------------------------------------------------
# the fp16 DP wire: a cast, no codec
# ---------------------------------------------------------------------------

def _fp16_mean(total: torch.Tensor, n: int) -> torch.Tensor:
    """An f16 sum over n workers to its f32 mean, as jitted JAX divides:
    times ``f32(1/n)``."""
    return total.float() * float(np.float32(1.0) / np.float32(n))


def fp16_mean_bucket(v_grad, err, group, bits: int, *,
                     stochastic: bool = True, u=None, generator=None,
                     backend: str = "auto"):
    """The fp16 wire: the compensated bucket cast to f16 and summed in
    one f16 all-reduce over ``group``; half the f32 bytes, no codes,
    no scales, no noise.  The signature of the codec wires; ``bits``,
    the noise and ``backend`` are ignored (the cast is deterministic).
    The carry is the local cast error ``v - f32(f16(v))``.  Returns
    (mean bucket, new carry)."""
    del bits, stochastic, u, generator, backend
    v = v_grad.float() + err
    h = v.half()
    new_err = v - h.float()
    total = group.all_reduce(h) if group.size > 1 else h
    return _fp16_mean(total, group.size), new_err


def fp16_sim_allreduce(grads_list, error_state, bits: int, *,
                       stochastic: bool = True, generator=None,
                       backend: str = "auto", layout=None):
    """Single-process simulation of `fp16_mean_bucket` over n workers
    (the signature of `grad_compress.compress_allreduce`).  The f16 sum
    runs in worker order, each add rounded to f16, as XLA on the CPU
    computes the JAX package's simulator; a gloo all-reduce over n >= 3
    ranks may add in another order."""
    del bits, stochastic, generator, backend
    n = len(grads_list)
    lay = layout or GC.bucket_layout(grads_list[0])
    v = torch.stack([GC.flatten_bucket(g, lay) for g in grads_list])
    v += error_state
    h = v.half()
    new_err = v - h.float()
    total = h[0].clone()
    for i in range(1, n):
        total += h[i]
    return GC.unflatten_bucket(_fp16_mean(total, n), lay,
                               grads_list[0]), new_err


# ---------------------------------------------------------------------------
# built-in registrations, in the JAX package's order
# ---------------------------------------------------------------------------

register_wire(
    "ppermute", plane="fw-activation",
    summary="packed AQ-SGD delta / DirectQ codes + f32 row scales on "
            "the pipeline hop",
    wire_bytes=_codec_bytes)
register_wire(
    "ppermute", plane="bw-gradient",
    summary="packed DirectQ gradient codes + scales on the reverse "
            "pipeline hop",
    wire_bytes=_codec_bytes)
register_wire(
    "hbm", plane="z-buffer", network=False,
    summary="z-bit stored message buffers (paper §H.5): device memory, "
            "not network bytes",
    wire_bytes=_codec_bytes)
register_wire(
    "paged", plane="kv-cache", network=False,
    summary="b-bit packed KV codes + f32 group scales in per-request "
            "cache slots (quantize-on-append, dequantize-on-attend)",
    wire_bytes=_kv_bytes)
register_wire(
    "ring", chunkable=True,
    summary="packed b-bit code segments on ring hops + packed code sums "
            "(bandwidth-optimal; bit-identical to psum)",
    wire_bytes=_ring_bytes,
    collective=C.ring_ef_reduce_mean_bucket,
    sim_allreduce=GC.compress_allreduce,
    expected_collectives=_ring_manifest)
register_wire(
    "psum", psum_lowered=True,
    summary="int32 code lanes in one all-reduce (conservative baseline; "
            "bit-identical to ring)",
    wire_bytes=_psum_bytes,
    collective=C.ef_psum_mean_bucket,
    sim_allreduce=GC.compress_allreduce,
    expected_collectives=_psum_manifest)
register_wire(
    "ring-sharded", sharded=True, chunkable=True,
    summary="ZeRO wire: the ring's reduce-scatter half only, "
            "segment-owner optimizer, f32 updated-parameter all-gather",
    wire_bytes=_ring_sharded_bytes,
    collective=C.ring_ef_reduce_scatter_bucket,
    sim_allreduce=GC.compress_reduce_scatter,
    expected_collectives=_ring_sharded_manifest)
register_wire(
    "fp16", psum_lowered=True,
    summary="raw float16 gradient lanes in one all-reduce (passthrough "
            "baseline: no codes or scales; bits ignored)",
    wire_bytes=_fp16_bytes,
    collective=fp16_mean_bucket,
    sim_allreduce=fp16_sim_allreduce,
    expected_collectives=_fp16_manifest)
