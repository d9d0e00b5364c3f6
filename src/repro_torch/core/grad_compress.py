"""Bucketed error-feedback gradient compression for the data-parallel
axis (port of `repro.core.grad_compress`).

The paper's §4.3 pairs AQ-SGD with an error-compensated low-bit
compressor on model gradients ("end-to-end communication compression",
Fig. 5).  Per worker i:

    v_i  = g_i + e_i               (compensate with the carried error)
    s    = max_i rowmax|v_i|       (shared scale)
    c_i  = quantize(v_i, s)        (b-bit codes, stochastic)
    e_i' = v_i - dequant(c_i, s)   (new carried error)
    ḡ   = dequant(Σ_i c_i, s) / n (int32 code sum, exact in any order)

The whole gradient tree is one zero-padded ``(rows, group_d)`` bucket
(`BucketLayout`), so scale groups are ``group_d`` wide whatever the
leaf shapes, and every pass runs through the boundary codec
(`encode_codes_with_scale` / `decode_sum_mean`).

A gradient *tree* here is a sequence of leaves in the JAX package's
``jax.tree.leaves`` order (`repro_torch.weights.jax_leaves`).  A leaf
is a tensor, or a list of tensors that stand for one leaf stacked along
a new dim 0 (the port keeps one tensor per layer where the JAX package
stacks ``layers.*`` as ``(L, ...)``).  Scale groups cross leaf edges,
so only that order gives the JAX package's scales.

The carry ``v - q`` is computed with ``q`` already rounded, as the JAX
package's Pallas backend computes it; its reference backend contracts
``v - p * C`` into one FMA under jit and differs by up to one ulp of
``q`` (ROADMAP, queue C).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.core import boundary as B
from repro_torch.core import quantization as Q

DEFAULT_GROUP_D = 512          # scale-group width (bucket columns)


def ring_segment_rows(rows: int, n: int) -> int:
    """Rows per ring segment for an n-device ring over a rows-row
    bucket: ceil(rows / n)."""
    return -(-rows // max(n, 1))


# ---------------------------------------------------------------------------
# bucket layout: gradient tree <-> one padded (rows, group_d) tensor
# ---------------------------------------------------------------------------

def _pieces(leaf) -> list:
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def _leaf_shape(leaf) -> tuple:
    if isinstance(leaf, (list, tuple)):
        return (len(leaf), *leaf[0].shape)
    return tuple(leaf.shape)


@dataclass(frozen=True)
class BucketLayout:
    """Static description of the flatten-and-concat gradient bucket."""
    sizes: tuple          # element count per leaf, tree order
    shapes: tuple         # leaf shapes
    rows: int             # bucket rows (ceil(total / group_d))
    group_d: int          # scale-group width
    pad: int              # trailing zeros filling the last row

    @property
    def total(self) -> int:
        return self.rows * self.group_d - self.pad


def bucket_layout(tree: Sequence, group_d: int = DEFAULT_GROUP_D
                  ) -> BucketLayout:
    """Layout of a gradient tree (see the module docstring)."""
    shapes = tuple(_leaf_shape(leaf) for leaf in tree)
    sizes = tuple(_numel(s) for s in shapes)
    total = sum(sizes)
    rows = max(-(-total // group_d), 1)
    return BucketLayout(sizes=sizes, shapes=shapes, rows=rows,
                        group_d=group_d, pad=rows * group_d - total)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def flatten_bucket(tree: Sequence, layout: BucketLayout,
                   rows: Optional[int] = None) -> torch.Tensor:
    """Gradient tree -> f32 (rows, group_d) bucket (zero-padded tail);
    ``rows`` (at least the layout's) pads it with zero rows."""
    rows = layout.rows if rows is None else rows
    pieces = [t for leaf in tree for t in _pieces(leaf)]
    flat = torch.zeros(rows * layout.group_d, dtype=torch.float32,
                       device=pieces[0].device)
    torch.cat([t.detach().float().reshape(-1) for t in pieces],
              out=flat[:layout.total])
    return flat.reshape(rows, layout.group_d)


def unflatten_bucket(bucket: torch.Tensor, layout: BucketLayout,
                     like: Sequence) -> list:
    """Inverse of `flatten_bucket`: the shapes and dtypes of ``like``,
    as views into ``bucket`` where the dtype allows."""
    flat = bucket.reshape(-1)
    out, off = [], 0
    for leaf in like:
        pieces = []
        for t in _pieces(leaf):
            n = t.numel()
            pieces.append(flat[off:off + n].reshape(t.shape).to(t.dtype))
            off += n
        out.append(pieces if isinstance(leaf, (list, tuple)) else pieces[0])
    return out


def init_error_state(tree: Sequence, group_d: int = DEFAULT_GROUP_D,
                     device=None) -> torch.Tensor:
    """Per-worker carried-error bucket, zeros (rows, group_d) f32."""
    lay = bucket_layout(tree, group_d)
    return torch.zeros((lay.rows, lay.group_d), dtype=torch.float32,
                       device=device)


# ---------------------------------------------------------------------------
# the shared codec math
# ---------------------------------------------------------------------------

def local_scale(v: torch.Tensor) -> torch.Tensor:
    """Rowwise absmax of a compensated bucket — what the wire reduces
    with a max to form the shared scale."""
    return v.abs().amax(dim=-1, keepdim=True)


def ef_encode(v: torch.Tensor, scale: torch.Tensor, bits: int, *,
              stochastic: bool = True, u: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              backend: str = "auto", pack: bool = False):
    """One worker's sender: (compensated bucket, shared scale) ->
    (packed payload | None, int32 codes, new carried error).  The
    dequantized value is `decode_sum_mean` with n=1."""
    out = B.encode_codes_with_scale(v, scale, bits=bits,
                                    stochastic=stochastic, u=u,
                                    generator=generator, pack=pack,
                                    backend=backend)
    packed, codes = out if pack else (None, out)
    q = B.decode_sum_mean(codes, scale, bits=bits, n=1, backend=backend)
    return packed, codes, v - q


def compress_gradients(grads: Sequence, error_state: torch.Tensor,
                       bits: int, *, stochastic: bool = True,
                       generator: Optional[torch.Generator] = None,
                       backend: str = "auto",
                       layout: Optional[BucketLayout] = None):
    """Error-feedback compress one gradient tree (the n=1 wire).
    Returns (compressed tree, new error state)."""
    lay = layout or bucket_layout(grads)
    v = flatten_bucket(grads, lay) + error_state
    scale = torch.clamp(local_scale(v), min=Q._EPS)
    _, _, new_err = ef_encode(v, scale, bits, stochastic=stochastic,
                              generator=generator, backend=backend)
    return unflatten_bucket(v - new_err, lay, grads), new_err


def compress_allreduce(grads_list: Sequence, error_state: torch.Tensor,
                       bits: int, *, stochastic: bool = True,
                       generator: Optional[torch.Generator] = None,
                       backend: str = "auto",
                       layout: Optional[BucketLayout] = None):
    """Simulate the compressed DP allreduce over n workers.

    grads_list: one gradient tree per worker; error_state: (n, rows,
    group_d) f32.  Worker i's noise is drawn from ``generator`` after
    worker i-1's.  Returns (mean tree, new error stack)."""
    n = len(grads_list)
    lay = layout or bucket_layout(grads_list[0])
    v = torch.stack([flatten_bucket(g, lay) for g in grads_list])
    v += error_state
    scale = torch.clamp(local_scale(v).amax(dim=0), min=Q._EPS)
    new_err = torch.empty_like(v)
    total = None
    for i in range(n):
        _, codes, new_err[i] = ef_encode(v[i], scale, bits,
                                         stochastic=stochastic,
                                         generator=generator,
                                         backend=backend)
        total = codes if total is None else total.add_(codes)
    del v
    mean = B.decode_sum_mean(total, scale, bits=bits, n=n, backend=backend)
    return unflatten_bucket(mean, lay, grads_list[0]), new_err


def compress_reduce_scatter(grads_list: Sequence, error_state: torch.Tensor,
                            bits: int, *, stochastic: bool = True,
                            generator: Optional[torch.Generator] = None,
                            backend: str = "auto",
                            layout: Optional[BucketLayout] = None):
    """Simulate the ZeRO wire over n workers: `compress_allreduce`'s
    encode (the same codes, scale, carries and noise order), stopped at
    the reduce-scatter midpoint, so worker i keeps only the mean of its
    own segment of ``ring_segment_rows(rows, n)`` rows.

    Returns (segment means (n, seg, group_d), new error stack (n, rows,
    group_d)).  A live row's mean equals that row of
    `compress_allreduce`'s mean bucket bit for bit (the decode is
    elementwise).  Rows past the bucket decode against a zero scale,
    to signed zeros; the tail past ``layout.total`` on the last live row
    holds nonzero values (quantize(0) is not 0 under a shared scale).
    Callers drop both before they touch a parameter."""
    n = len(grads_list)
    lay = layout or bucket_layout(grads_list[0])
    v = torch.stack([flatten_bucket(g, lay) for g in grads_list])
    v += error_state
    scale = torch.clamp(local_scale(v).amax(dim=0), min=Q._EPS)
    new_err = torch.empty_like(v)
    seg = ring_segment_rows(lay.rows, n)
    total = torch.zeros((n * seg, lay.group_d), dtype=torch.int32,
                        device=v.device)
    for i in range(n):
        _, codes, new_err[i] = ef_encode(v[i], scale, bits,
                                         stochastic=stochastic,
                                         generator=generator,
                                         backend=backend)
        total[:lay.rows] += codes
    del v
    scale = torch.cat([scale, scale.new_zeros((n * seg - lay.rows, 1))])
    means = B.decode_sum_mean(total, scale, bits=bits, n=n, backend=backend)
    return means.reshape(n, seg, lay.group_d), new_err


# ---------------------------------------------------------------------------
# wire accounting
# ---------------------------------------------------------------------------

def grad_wire_bytes(tree: Sequence, bits: int,
                    group_d: int = DEFAULT_GROUP_D) -> int:
    """Bytes on the DP wire per worker per step at b bits: one packed
    bucket + one f32 scale per ``group_d`` group."""
    lay = bucket_layout(tree, group_d)
    return Q.wire_bytes((lay.rows, lay.group_d), bits)
