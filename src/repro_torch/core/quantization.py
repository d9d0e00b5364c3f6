"""Uniform activation quantization used by AQ-SGD and DirectQ (port of
`repro.core.quantization`).

The paper's Q (§4.1): normalize a row by its absolute maximum and cut
[-1, 1] into ``2**b - 1`` uniform steps; stochastic rounding makes Q
unbiased.  Codes are uint8 (2/4/8 bits packed densely, little-endian:
code j of a byte sits at bit ``j * bits``) plus one f32 scale per row.

Bit parity with the JAX package.  Its serving loop runs under
``jax.jit``, where XLA rewrites ``(ic * s) / lv`` as ``(ic * s) *
f32(1/lv)`` and contracts a following ``m + ...`` into one FMA.  The
jitted numerics are the reference, so `dequantize` multiplies by the
rounded reciprocal and `fma_f32` rounds ``p * r + m`` once.  Codes
and scales divide by a tensor, which stays a true division under every
compiler, so they need no such care.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

_EPS = 1e-12


def levels(bits: int) -> int:
    """Top code of a b-bit grid: ``2**bits - 1``."""
    return (1 << bits) - 1


def rcp_levels(bits: int) -> float:
    """``f32(1 / levels)``, rounded once in float32 as XLA folds it."""
    return float(np.float32(1.0) / np.float32(levels(bits)))


def absmax_scale(x: torch.Tensor) -> torch.Tensor:
    """Positive per-row scale such that x/scale ∈ [-1, 1]."""
    s = x.float().abs().amax(dim=-1, keepdim=True)
    return torch.clamp(s, min=_EPS)


def quantize(x: torch.Tensor, bits: int, *,
             noise: Optional[torch.Tensor] = None,
             scale: Optional[torch.Tensor] = None):
    """Quantize to uint8 codes in [0, 2**bits - 1] plus an f32 scale.

    ``noise``: uniform(0, 1) of x.shape for stochastic rounding (a code
    is bumped up when ``noise < frac``); None rounds to nearest, ties to
    even as ``jnp.round`` does."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in 1..8, got {bits}")
    if scale is None:
        scale = absmax_scale(x)
    lv = levels(bits)
    y = torch.clamp((x.float() / scale + 1.0) * (0.5 * lv), 0.0, lv)
    if noise is None:
        codes = torch.round(y)
    else:
        lo = torch.floor(y)
        codes = lo + (noise < (y - lo)).float()
    return codes.to(torch.uint8), scale


def _dequant_product(codes: torch.Tensor, scale: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """``(2c - lv) * s`` in f32; ``2c - lv`` is integer-exact."""
    return (codes.float() * 2.0 - float(levels(bits))) * scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, bits: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Codes back to values: ``((2c - lv) * s) * f32(1/lv)``, the form
    jitted JAX computes (see the module docstring)."""
    return (_dequant_product(codes, scale, bits)
            * rcp_levels(bits)).to(dtype)


def fma_f32(p: torch.Tensor, r: float, m: torch.Tensor) -> torch.Tensor:
    """``p * r + m`` for f32 tensors, rounded ONCE to f32 (a fused
    multiply-add), on any device.

    The product of two f32 values is exact in float64.  The float64 sum
    then rounds once; rounding that result to f32 could round twice,
    so the sum is first turned into its round-to-odd form (its error
    from Knuth's TwoSum picks the odd neighbour), after which the f32
    rounding equals the once-rounded exact result (53 >= 24 + 2)."""
    s = p.double() * r
    m64 = m.double()
    t = s + m64
    bb = t - s
    err = (s - (t - bb)) + (m64 - bb)
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(t)
    t = torch.where((err != 0) & even, torch.nextafter(t, toward), t)
    return t.float()


def dequantize_accumulate(codes: torch.Tensor, scale: torch.Tensor,
                          m: torch.Tensor, bits: int) -> torch.Tensor:
    """``m + dequantize(codes)`` as jitted JAX computes it: one FMA
    ``fma((2c - lv) * s, f32(1/lv), m)``."""
    return fma_f32(_dequant_product(codes, scale, bits), rcp_levels(bits),
                   m.float())


def qdq(x: torch.Tensor, bits: int, *,
        noise: Optional[torch.Tensor] = None,
        per_row: bool = True) -> torch.Tensor:
    """Fake-quantization round trip in x's dtype: one scale a row, or
    with ``per_row=False`` one for the whole tensor.  ``noise`` as in
    `quantize` (None rounds to nearest)."""
    scale = None if per_row else torch.clamp(
        x.float().abs().amax(), min=_EPS)
    codes, scale = quantize(x, bits, noise=noise, scale=scale)
    return dequantize(codes, scale, bits, dtype=x.dtype)


# ---------------------------------------------------------------------------
# Dense bit-packing — the wire format.
# ---------------------------------------------------------------------------

def codes_per_byte(bits: int) -> int:
    """How many b-bit codes pack into one wire byte."""
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"packing supports 1/2/4/8 bits, got {bits}")
    return 8 // bits


def packed_width(n: int, bits: int) -> int:
    """Packed bytes per row: k codes/byte for 1/2/4/8 bits, else
    ceil(n * bits / 8)."""
    if bits in (1, 2, 4, 8):
        k = codes_per_byte(bits)
        return (n + k - 1) // k
    return (n * bits + 7) // 8


def _shifts(k: int, bits: int, device) -> torch.Tensor:
    return torch.arange(k, dtype=torch.int32, device=device) * bits


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint8 codes (< 2**bits) densely along the last axis."""
    k = codes_per_byte(bits)
    if k == 1:
        return codes
    n = codes.shape[-1]
    pad = (-n) % k
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    grouped = codes.reshape(*codes.shape[:-1], -1, k).to(torch.int32)
    packed = (grouped << _shifts(k, bits, codes.device)).sum(dim=-1)
    return packed.to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of `pack_codes`; n = original last-axis length."""
    k = codes_per_byte(bits)
    if k == 1:
        return packed[..., :n]
    vals = (packed.to(torch.int32)[..., None]
            >> _shifts(k, bits, packed.device)) & levels(bits)
    flat = vals.reshape(*packed.shape[:-1], -1)
    return flat[..., :n].to(torch.uint8)


def wire_bytes(shape: tuple, bits: int, scale_bytes: int = 4) -> int:
    """Bytes on the wire for a quantized tensor with per-row scales."""
    *rows, n = shape
    nrows = int(functools.reduce(lambda a, b: a * b, rows, 1))
    return nrows * packed_width(n, bits) + nrows * scale_bytes


# ---------------------------------------------------------------------------
# Code sums over n workers — the data-parallel gradient wire.
# ---------------------------------------------------------------------------

SUM_WIRE_WIDTHS = (1, 2, 4, 8, 16, 32)


def sum_wire_bits(bits: int, n: int) -> int:
    """Narrowest packing width (in bits) holding any sum of n b-bit
    codes: b + ceil(log2 n), rounded up to a packable width."""
    if n < 1 or not 1 <= bits <= 8:
        raise ValueError(f"need n >= 1 and bits in 1..8, got {bits}, {n}")
    maxv = n * levels(bits)
    for sw in SUM_WIRE_WIDTHS:
        if maxv <= (1 << sw) - 1:
            return sw
    raise ValueError(f"code sums for bits={bits}, n={n} exceed 32 bits")


def sum_packed_width(d: int, bits: int, n: int) -> int:
    """Packed wire bytes per row of d code sums over n workers."""
    sw = sum_wire_bits(bits, n)
    if sw <= 8:
        k = 8 // sw
        return (d + k - 1) // k
    return d * (sw // 8)


def sum_mean_factor(bits: int, n: int) -> float:
    """``f32(f32(1/lv) * f32(1/n))``: the one constant jitted JAX
    multiplies by for ``((ic * s) / lv) / n`` (XLA folds both constant
    divisions into it; neither ``1/(lv*n)`` nor two multiplies match)."""
    one = np.float32(1.0)
    return float((one / np.float32(levels(bits)))
                 * (one / np.float32(n)))


def dequant_sum_mean(total: torch.Tensor, scale: torch.Tensor, bits: int,
                     n: int) -> torch.Tensor:
    """Int32 code sum over n workers + shared row scale -> the mean of
    their dequantized values, ``((2T - n*lv) * s) * sum_mean_factor``.
    ``2T - n*lv`` is integer-exact in f32."""
    p = (total.float() * 2.0 - float(n * levels(bits))) * scale
    return p * sum_mean_factor(bits, n)


def pack_sums(total: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """int32 code sums over n workers -> dense u8 payload at
    `sum_wire_bits(bits, n)` bits per sum along the last axis: the
    ring's all-gather hop.  Widths up to 8 bits reuse the code packer
    (a sum is below ``2**sw`` by construction); 16 and 32 bits split
    each sum into little-endian bytes.  The arithmetic is int64, since
    torch's ``uint32`` supports few operations."""
    sw = sum_wire_bits(bits, n)
    if sw <= 8:
        return pack_codes(total.to(torch.uint8), sw)
    shifts = torch.arange(sw // 8, dtype=torch.int64,
                          device=total.device) * 8
    t = total.to(torch.int64) & 0xFFFFFFFF
    b = (t[..., None] >> shifts) & 0xFF
    return b.reshape(*t.shape[:-1], -1).to(torch.uint8)


def unpack_sums(packed: torch.Tensor, bits: int, n: int,
                d: int) -> torch.Tensor:
    """Inverse of `pack_sums`; d = original last-axis length.  int32."""
    sw = sum_wire_bits(bits, n)
    if sw <= 8:
        return unpack_codes(packed, sw, d).to(torch.int32)
    nb = sw // 8
    shifts = torch.arange(nb, dtype=torch.int64, device=packed.device) * 8
    b = packed.to(torch.int64).reshape(*packed.shape[:-1], -1, nb)
    return (b << shifts).sum(dim=-1)[..., :d].to(torch.int32)
