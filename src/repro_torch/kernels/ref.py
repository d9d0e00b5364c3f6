"""Plain PyTorch versions of the CUDA kernels.

Each function computes exactly what its kernel in ``csrc/quant_pack.cu``
computes, bit for bit (the ring's sum packers on their domain: sums in
``[0, 2**sum_wire_bits)``), and equals the jitted `repro.kernels.ref` oracle
and the Pallas kernel of the same name.  The wrappers in
`repro_torch.kernels.quant_pack` run these for CPU tensors; the CPU
tests hold them against JAX and ``chip_smoke.py`` holds the kernels
against them on the card.  Shapes: rows ``(R, d)``, packed ``(R, d *
bits / 8)`` u8, scale ``(R, 1)`` f32.

`flash_attention_ref` is the plain version of the attention kernel
(``csrc/flash_attention.cu``): dense masked-softmax attention, the
counterpart of the JAX oracle ``repro.kernels.ref.flash_attention_ref``,
held to it and to the kernel within a tolerance, not bit for bit.
"""
from __future__ import annotations

import math
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


def unpack_accumulate_ref(packed: torch.Tensor, acc: torch.Tensor,
                          bits: int) -> torch.Tensor:
    """Ring accumulate: ``acc + unpack(packed)`` in int32, over the full
    packed width."""
    d = packed.shape[-1] * Q.codes_per_byte(bits)
    return acc.to(torch.int32) + Q.unpack_codes(packed, bits, d).to(
        torch.int32)


def pack_sums_ref(total: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Ring all-gather payload: int32 code sums over n workers packed at
    ``sum_wire_bits(bits, n)`` bits (sums in ``[0, 2**sw)``)."""
    return Q.pack_sums(total, bits, n)


def unpack_sums_ref(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of `pack_sums_ref` over the full packed width."""
    sw = Q.sum_wire_bits(bits, n)
    pw = packed.shape[-1]
    d = pw * (8 // sw) if sw <= 8 else pw // (sw // 8)
    return Q.unpack_sums(packed, bits, n, d)


NEG_INF = -1.0e9


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 10 ** 9,
                        softcap: float = 0.0,
                        q_offset: int = 0) -> torch.Tensor:
    """Dense attention, head-major: q (B, H, Sq, hd), k and v (B, Hk, Sk,
    hd) with H % Hk == 0; query head h reads kv head h // (H // Hk).
    Query row i sits at position ``q_offset + i``, key j at j; key j is
    visible iff j > pos - window and (causal) j <= pos; hidden scores
    are ``NEG_INF``.  f32 throughout; returns q's dtype."""
    b, h, sq, hd = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    qg = q.float().reshape(b, hk, g, sq, hd)
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) \
        * (1.0 / math.sqrt(hd))                       # (B, Hk, G, Sq, Sk)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    key = torch.arange(sk, device=q.device)[None, :]
    vis = key > pos - window
    if causal:
        vis &= key <= pos
    p = torch.softmax(torch.where(vis, s, NEG_INF), dim=-1)
    out = torch.matmul(p, v.float()[:, :, None])      # (B, Hk, G, Sq, hd)
    return out.reshape(b, h, sq, hd).to(q.dtype)
