"""Plain PyTorch versions of the CUDA codec kernels.

Each function computes exactly what its kernel in ``csrc/quant_pack.cu``
computes, bit for bit, and equals the jitted `repro.kernels.ref` oracle
and the Pallas kernel of the same name.  The wrappers in
`repro_torch.kernels.quant_pack` run these for CPU tensors; the CPU
tests hold them against JAX and ``chip_smoke.py`` holds the kernels
against them on the card.  Shapes: rows ``(R, d)``, packed ``(R, d *
bits / 8)`` u8, scale ``(R, 1)`` f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantization as Q


def delta_quantize_pack_ref(a: torch.Tensor, m: torch.Tensor, bits: int,
                            u: Optional[torch.Tensor] = None):
    """AQ-SGD sender: delta = a - m -> rowwise absmax scale -> b-bit
    codes -> dense packing, plus the advanced buffer
    ``m_new = fma((2c - lv) * s, f32(1/lv), m)``.
    Returns (packed, scale, m_new)."""
    m32 = m.float()
    codes, scale = Q.quantize(a.float() - m32, bits, noise=u)
    return (Q.pack_codes(codes, bits), scale,
            Q.dequantize_accumulate(codes, scale, m32, bits))


def dequant_unpack_accumulate_ref(packed: torch.Tensor, scale: torch.Tensor,
                                  m: torch.Tensor, bits: int) -> torch.Tensor:
    """AQ-SGD receiver: unpack -> dequantize -> m += delta, one FMA."""
    codes = Q.unpack_codes(packed, bits, m.shape[-1])
    return Q.dequantize_accumulate(codes, scale, m, bits)


def quantize_pack_ref(x: torch.Tensor, bits: int,
                      u: Optional[torch.Tensor] = None):
    """DirectQ / KV-append sender: absmax -> codes -> packing.
    Returns (packed, scale)."""
    codes, scale = Q.quantize(x.float(), bits, noise=u)
    return Q.pack_codes(codes, bits), scale


def unpack_dequant_ref(packed: torch.Tensor, scale: torch.Tensor, bits: int,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of `quantize_pack_ref` over the full packed width."""
    d = packed.shape[-1] * Q.codes_per_byte(bits)
    return Q.dequantize(Q.unpack_codes(packed, bits, d), scale, bits,
                        out_dtype)


def quantize_codes_scaled_ref(x: torch.Tensor, scale: torch.Tensor,
                              bits: int, u: Optional[torch.Tensor] = None,
                              pack: bool = False):
    """Gradient-wire sender: codes against the given row scale (clamped
    at eps), as int32; with ``pack`` also the packed payload.
    Returns codes, or (packed, codes)."""
    s = torch.clamp(scale.float(), min=Q._EPS)
    codes, _ = Q.quantize(x.float(), bits, noise=u, scale=s)
    if pack:
        return Q.pack_codes(codes, bits), codes.to(torch.int32)
    return codes.to(torch.int32)


def dequant_sum_mean_ref(total: torch.Tensor, scale: torch.Tensor, bits: int,
                         n: int) -> torch.Tensor:
    """Gradient-wire receiver: the mean over n workers from their int32
    code sum, ``((2T - n*lv) * s) * f32(f32(1/lv) * f32(1/n))``."""
    return Q.dequant_sum_mean(total, scale, bits, n)
