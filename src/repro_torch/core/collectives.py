"""Quantized collectives for data-parallel gradient averaging over a
process group (port of `repro.core.collectives`).

Each rank calls these with its own compensated gradient bucket, its
error-feedback carry and its stochastic-rounding noise, inside a
distributed run (`repro_torch.launch.mesh`); ``group`` is the rank's
data group (`mesh.RingGroup`).  Three wire forms carry the same math:

* `ef_psum_mean_bucket` — the conservative form: the row scale is a
  max all-reduce, then the int32 codes are all-reduced and decoded.
* `ring_ef_reduce_mean_bucket` — the bandwidth-optimal ring.  The same
  encode also emits the packed b-bit payload.  Reduce-scatter half:
  the bucket is cut into n row segments; at step t rank i sends its
  packed codes of segment (i+t) mod n to that segment's owner (a
  rotation by t) and folds what arrives into its int32 accumulator
  (`boundary.accumulate_codes`).  All-gather half: each owner packs
  its segment's sums at ``sum_wire_bits(bits, n)`` bits
  (`boundary.pack_sums`) and rotates them to every rank the same way,
  storing the segment received at step t in slot (i-t) mod n; every
  rank unpacks the whole sum bucket and decodes the mean.
* `ring_ef_reduce_scatter_bucket` — the ZeRO wire: the ring stopped
  after its reduce-scatter half; each rank decodes only the mean of the
  segment it owns (its optimizer updates that segment, and the updated
  parameters are all-gathered by the trainer).

int32 code sums are exact in any order and the shared scale is an f32
max, so both forms are BIT-IDENTICAL to each other and to the
single-process `grad_compress.compress_allreduce` given the same
per-rank inputs and noise; the ZeRO wire's segment means are bit-equal
rows of that mean.  A ragged last segment is padded with zero
payload rows after encoding (zero codes, zero sums, sliced off).

``chunks > 1`` cuts each segment into `ring_chunk_bounds` chunks: the
hops of chunk c are posted, chunk c+1 is encoded, then chunk c's
arrivals are accumulated (the double-buffered schedule).  It ships the
same bytes and gives the same bits; the chunk encoder row-slices the
one full-bucket noise draw and zeroes pad rows in code space, because
quantize(0) under a shared scale is not 0.

Noise.  Given a ``generator`` and no ``u``, the monolithic forms (the
psum wire, and the ring and the ZeRO wire at ``chunks=1``) hand the
generator to the one encode of the bucket (`grad_compress.ef_encode`),
as the JAX package hands it the folded key: a draw of the bucket's
shape, or, with the on-core noise knob on the cuda backend
(`repro_torch.env.oncore_prng`), a (2,) seed for B5's own Philox
stream.  The chunked ring draws its one full-bucket tensor either way
(JAX's ``make_chunk_encoder`` passes ``noise=``, bypassing the on-core
opt-in).

This module holds every torch.distributed call of the data-parallel
plane; the transport records each one (`Transport.calls`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import boundary as B
from repro_torch.core import grad_compress as GC
from repro_torch.core import quantization as Q

# the one segment-geometry source, defined beside the bucket layout
ring_segment_rows = GC.ring_segment_rows
# the DP collectives of this module, by wire name
WIRES = ("psum", "ring", "ring-sharded")


def ring_chunk_bounds(seg: int, chunks: int) -> tuple:
    """Row bounds ``(lo, hi)`` cutting one ``seg``-row ring segment into
    chunks of ``ring_segment_rows(seg, chunks)`` rows: disjoint,
    covering, in order, only the last possibly shorter.  May return
    fewer chunks than asked for (ceil-division); callers iterate the
    bounds.  ``chunks`` must be a positive int no larger than ``seg``."""
    if not isinstance(chunks, int) or isinstance(chunks, bool) \
            or chunks < 1:
        raise ValueError(
            f"chunks={chunks!r} is invalid: the ring chunk count must "
            f"be a positive int — did you mean chunks=1 (the "
            f"monolithic schedule)?")
    if chunks > seg:
        raise ValueError(
            f"chunks={chunks} exceeds the segment's {seg} rows (each "
            f"chunk ships at least one row per hop); valid range is "
            f"1..{seg} — did you mean chunks={seg}?")
    cw = ring_segment_rows(seg, chunks)
    return tuple((lo, min(lo + cw, seg)) for lo in range(0, seg, cw))


def _noise(v: torch.Tensor, stochastic: bool, u, generator):
    """The full-bucket uniform noise: ``u``, or one draw from
    ``generator`` (None when deterministic)."""
    if not stochastic:
        return None
    if u is not None:
        return u
    if generator is None:
        raise ValueError("a stochastic wire needs noise u or a generator")
    return torch.rand(v.shape, generator=generator, dtype=torch.float32,
                      device=v.device)


def _shared_scale(v: torch.Tensor, group) -> torch.Tensor:
    """The group's rowwise max of |v|, floored at eps."""
    s = group.all_reduce(GC.local_scale(v), op=dist.ReduceOp.MAX)
    return torch.clamp(s, min=Q._EPS)


def _rows_padded(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of x, with zero rows past its end."""
    got = x[lo:min(hi, x.shape[0])]
    if got.shape[0] == hi - lo:
        return got
    pad = torch.zeros((hi - lo - got.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([got, pad])


def quantized_psum_mean(x, group, bits: int, *, stochastic: bool = True,
                        u: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        backend: str = "auto"):
    """Mean of x (..., d) over ``group`` with a b-bit payload: the row
    scale is a max all-reduce, then the int32 codes are all-reduced and
    decoded.  No error feedback.  Returns f32 of x's shape."""
    n = group.size
    xf = x.float().reshape(-1, x.shape[-1])
    s = _shared_scale(xf, group)
    codes = B.encode_codes_with_scale(
        xf, s, bits=bits, stochastic=stochastic,
        u=None if u is None else u.reshape(xf.shape), generator=generator,
        backend=backend)
    total = group.all_reduce(codes) if n > 1 else codes
    mean = B.decode_sum_mean(total, s, bits=bits, n=n, backend=backend)
    return mean.reshape(x.shape)


def ef_psum_mean_bucket(v_grad, err, group, bits: int, *,
                        stochastic: bool = True,
                        u: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        backend: str = "auto"):
    """Error-feedback compressed all-reduce of one (rows, group_d)
    bucket, psum form: int32 code lanes in one all-reduce.  Returns
    (mean bucket, new carry)."""
    n = group.size
    v = v_grad.float() + err
    s = _shared_scale(v, group)
    _, codes, new_err = GC.ef_encode(
        v, s, bits, stochastic=stochastic, u=u, generator=generator,
        backend=backend)
    total = group.all_reduce(codes) if n > 1 else codes
    return B.decode_sum_mean(total, s, bits=bits, n=n, backend=backend), \
        new_err


def _reduce_scatter_codes(packed, codes, group, bits, backend):
    """The ring's reduce-scatter half: rotate packed code segments to
    their owners and accumulate.  Returns (acc, seg): the exact (seg, d)
    code sum of this rank's own segment (zero rows past the bucket)."""
    n, i = group.size, group.index
    rows = codes.shape[0]
    seg = ring_segment_rows(rows, n)
    acc = _rows_padded(codes, i * seg, (i + 1) * seg).clone()
    for t in range(1, n):
        j = (i + t) % n
        send = _rows_padded(packed, j * seg, (j + 1) * seg)
        recv = group.permute(send.contiguous(), t)
        acc = B.accumulate_codes(recv, acc, bits=bits, backend=backend)
    return acc, seg


def make_chunk_encoder(v, s, u, bits: int, n: int, bounds, *,
                       stochastic: bool = True, backend: str = "auto"):
    """Per-chunk encoder of the double-buffered ring, bit-identical to
    `grad_compress.ef_encode` per row.  ``v``, ``s``: the compensated
    bucket and its shared scale; ``u``: the full-bucket noise (None when
    deterministic), row-sliced here.  Returns ``enc(ci) -> (packed,
    codes)`` of shapes ``(n, cw, ·)``: chunk ci's rows in every one of
    the n segments, pad rows zeroed in code space."""
    rows, d = v.shape
    seg = ring_segment_rows(rows, n)

    def take(x, lo, hi):
        return torch.cat([_rows_padded(x, a * seg + lo, a * seg + hi)
                          for a in range(n)])

    def enc(ci):
        lo, hi = bounds[ci]
        cw = hi - lo
        packed, codes = B.encode_codes_with_scale(
            take(v, lo, hi), take(s, lo, hi), bits=bits,
            stochastic=stochastic, u=take(u, lo, hi) if stochastic else None,
            pack=True, backend=backend)
        packed = packed.reshape(n, cw, -1)
        codes = codes.reshape(n, cw, d)
        if (n - 1) * seg + hi > rows:         # pad rows in this chunk
            gidx = torch.arange(n, device=v.device)[:, None] * seg \
                + torch.arange(lo, hi, device=v.device)[None, :]
            dead = (gidx >= rows)[..., None]
            packed = packed.masked_fill(dead, 0)
            codes = codes.masked_fill(dead, 0)
        return packed, codes

    return enc


def _chunked_reduce_scatter(v, s, u, group, bits, *, stochastic, backend,
                            chunks):
    """The reduce-scatter half, chunked and double-buffered.  Returns
    (acc, seg, new carry)."""
    n, i = group.size, group.index
    rows, d = v.shape
    seg = ring_segment_rows(rows, n)
    bounds = ring_chunk_bounds(seg, chunks)
    enc = make_chunk_encoder(v, s, u, bits, n, bounds,
                             stochastic=stochastic, backend=backend)
    accs, code_chunks = [], []
    packed_c, codes_c = enc(0)
    for ci in range(len(bounds)):
        code_chunks.append(codes_c)
        acc = codes_c[i].clone()
        pending = [group.permute_start(packed_c[(i + t) % n].contiguous(), t)
                   for t in range(1, n)]
        if ci + 1 < len(bounds):
            # encode the next chunk while this chunk's hops are posted
            packed_c, codes_c = enc(ci + 1)
        for p in pending:
            acc = B.accumulate_codes(p.wait(), acc, bits=bits,
                                     backend=backend)
        accs.append(acc)
    acc = torch.cat(accs)
    codes = torch.cat(code_chunks, dim=1).reshape(n * seg, d)[:rows]
    q = B.decode_sum_mean(codes, s, bits=bits, n=1, backend=backend)
    return acc, seg, v - q


def ring_ef_reduce_scatter_bucket(v_grad, err, group, bits: int, *,
                                  stochastic: bool = True,
                                  u: Optional[torch.Tensor] = None,
                                  generator: Optional[torch.Generator] = None,
                                  backend: str = "auto", chunks: int = 1):
    """The ZeRO wire: error-feedback compressed reduce-scatter, the
    ring stopped after its reduce-scatter half (see the module
    docstring).  Same inputs as `ring_ef_reduce_mean_bucket`.  Returns
    (the mean of this rank's own segment, (seg, group_d) with seg =
    `ring_segment_rows(rows, n)`; the new full-bucket carry).

    The segment's int32 code sum is the one the full ring holds at its
    midpoint, so its live rows equal those rows of the full ring's
    mean bit for bit.  Rows past the bucket decode against a zero
    scale, to signed zeros, which callers drop.  The carry stays
    full-bucket: every rank encodes its whole bucket, to ship each
    segment to its owner."""
    n, i = group.size, group.index
    v = v_grad.float() + err
    rows, d = v.shape
    s = _shared_scale(v, group)
    if chunks != 1:
        # validate even where nothing overlaps (n == 1)
        ring_chunk_bounds(ring_segment_rows(rows, n), chunks)
    if chunks == 1 or n == 1:
        packed, codes, new_err = GC.ef_encode(
            v, s, bits, stochastic=stochastic, u=u, generator=generator,
            backend=backend, pack=True)
        if n == 1:
            return B.decode_sum_mean(codes, s, bits=bits, n=1,
                                     backend=backend), new_err
        del v
        acc, seg = _reduce_scatter_codes(packed, codes, group, bits,
                                         backend)
        del packed, codes
    else:
        acc, seg, new_err = _chunked_reduce_scatter(
            v, s, _noise(v, stochastic, u, generator), group, bits,
            stochastic=stochastic, backend=backend, chunks=chunks)
    s_own = _rows_padded(s, i * seg, (i + 1) * seg)
    return B.decode_sum_mean(acc, s_own, bits=bits, n=n,
                             backend=backend), new_err


def ring_ef_reduce_mean_bucket(v_grad, err, group, bits: int, *,
                               stochastic: bool = True,
                               u: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None,
                               backend: str = "auto", chunks: int = 1):
    """Error-feedback compressed all-reduce as the bandwidth-optimal ring
    (see the module docstring).  Same signature and bit-identical result
    as `ef_psum_mean_bucket`.  Returns (mean bucket, new carry)."""
    n, i = group.size, group.index
    v = v_grad.float() + err
    rows, d = v.shape
    s = _shared_scale(v, group)
    if chunks != 1:
        # validate even where nothing overlaps (n == 1)
        ring_chunk_bounds(ring_segment_rows(rows, n), chunks)
    if chunks == 1 or n == 1:
        packed, codes, new_err = GC.ef_encode(
            v, s, bits, stochastic=stochastic, u=u, generator=generator,
            backend=backend, pack=True)
        if n == 1:
            return B.decode_sum_mean(codes, s, bits=bits, n=1,
                                     backend=backend), new_err
        del v
        acc, seg = _reduce_scatter_codes(packed, codes, group, bits,
                                         backend)
        del packed, codes
    else:
        acc, seg, new_err = _chunked_reduce_scatter(
            v, s, _noise(v, stochastic, u, generator), group, bits,
            stochastic=stochastic, backend=backend, chunks=chunks)

    # all-gather: rotate the packed segment sums to every rank
    own = B.pack_sums(acc, bits=bits, n=n, backend=backend)
    del acc
    gathered = torch.empty((n, *own.shape), dtype=torch.uint8,
                           device=own.device)
    gathered[i] = own
    pending = [(t, group.permute_start(own, t)) for t in range(1, n)]
    for t, p in pending:
        gathered[(i - t) % n] = p.wait()
    total_p = gathered.reshape(n * seg, -1)[:rows]
    total = B.unpack_sums(total_p, bits=bits, n=n, d=d, backend=backend)
    mean = B.decode_sum_mean(total, s, bits=bits, n=n, backend=backend)
    return mean, new_err


def ring_wire_bytes(shape, bits: int, n: int = 2, *,
                    sharded: bool = False, chunks: int = 1) -> int:
    """Bytes each rank sends in the compressed ring for one (rows, d)
    bucket on n ranks: n-1 hops of one packed b-bit segment
    (reduce-scatter), n-1 hops of one packed code-sum segment at
    `Q.sum_wire_bits` (all-gather; none with ``sharded``, the ZeRO
    wire), and the f32 scale max (one f32 per row).  ``chunks`` is
    validated only: chunking ships the same bytes."""
    rows, d = shape
    seg = ring_segment_rows(rows, n)
    if chunks != 1:
        ring_chunk_bounds(seg, chunks)
    hops = max(n - 1, 0)
    gather = 0 if sharded else hops * seg * Q.sum_packed_width(d, bits, n)
    return hops * seg * Q.packed_width(d, bits) + gather + rows * 4


def param_gather_bytes(shape, n: int = 2) -> int:
    """Bytes each rank sends in the ZeRO wire's parameter all-gather
    for a (rows, d) bucket on n ranks: its updated f32 segment to each
    of the n-1 others."""
    rows, d = shape
    return max(n - 1, 0) * ring_segment_rows(rows, n) * d * 4
