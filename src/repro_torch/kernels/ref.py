"""Plain PyTorch versions of the CUDA kernels.

Each function computes exactly what its kernel in ``csrc/quant_pack.cu``
computes, bit for bit (the ring's sum packers on their domain: sums in
``[0, 2**sum_wire_bits)``), and equals the jitted `repro.kernels.ref` oracle
and the Pallas kernel of the same name.  The wrappers in
`repro_torch.kernels.quant_pack` run these for CPU tensors; the CPU
tests hold them against JAX and ``chip_smoke.py`` holds the kernels
against them on the card.  Shapes: rows ``(R, d)``, packed ``(R, d *
bits / 8)`` u8, scale ``(R, 1)`` f32.

`oncore_uniform_ref` is the plain version of the noise the encode
kernels draw themselves when given a seed (`philox4x32_10`, counter-based,
so it depends on the element's index and the seed only); the seeded
kernels equal ``*_ref(..., u=oncore_uniform_ref(seed, rows, d))``.

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


_M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)      # round multipliers
PHILOX_W = (0x9E3779B9, 0xBB67AE85)      # key schedule (Weyl) increments


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of the 64-bit product of u32 values ``a``
    (int64) and the constant ``m``, in 16-bit pieces so that no int64
    intermediate passes 2**49."""
    t_lo = a * (m & 0xFFFF)
    t_hi = a * (m >> 16)
    lo_full = t_lo + ((t_hi & 0xFFFF) << 16)
    return (t_hi >> 16) + (lo_full >> 32), lo_full & _M32


def philox4x32_10(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32 with 10 rounds (Salmon et al., SC'11; Random123's
    ``philox4x32``): ``ctr`` (..., 4) and ``key`` (..., 2), int64 tensors
    holding u32 values (broadcast against each other).  Returns (..., 4)
    int64 holding u32 words."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key.unbind(-1)
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _M32
            k1 = (k1 + PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def oncore_uniform_ref(seed: torch.Tensor, rows: int, d: int, *,
                       row0: int = 0) -> torch.Tensor:
    """The seeded encode kernels' uniform noise for rows ``row0 ..
    row0 + rows`` of an op's (R, d) row view, (rows, d) f32 on
    ``seed``'s device.  Element (r, c) has flat index i = r * d + c; its
    counter is (lo32(i >> 2), hi32(i >> 2), 0, 0), its key the (2,)
    int32 ``seed`` read as u32, and its value ``(word[i & 3] >> 8) *
    2**-24``: exact in f32, in [0, 1 - 2**-24]."""
    if seed.shape != (2,) or seed.dtype != torch.int32:
        raise ValueError(f"seed must be a (2,) int32 tensor, got "
                         f"{tuple(seed.shape)} {seed.dtype}")
    start, n = row0 * d, rows * d
    g0, g1 = start >> 2, (start + n + 3) >> 2
    g = torch.arange(g0, g1, dtype=torch.int64, device=seed.device)
    zero = torch.zeros_like(g)
    words = philox4x32_10(torch.stack([g & _M32, g >> 32, zero, zero], -1),
                          seed.to(torch.int64) & _M32)
    w = words.reshape(-1)[start - 4 * g0:start - 4 * g0 + n]
    return ((w >> 8).to(torch.float32) * 2.0 ** -24).reshape(rows, d)


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


def unpack_dequant_pair_ref(packed, scale, bits: int,
                            out_dtype: torch.dtype = torch.float32) -> tuple:
    """The KV store read of k and v (`quant_pack.unpack_dequant_pair`):
    `unpack_dequant_ref` of each (packed, scale)."""
    return tuple(unpack_dequant_ref(p, s, bits, out_dtype)
                 for p, s in zip(packed, scale))


def quantize_pack_into_ref(x, packed, scale, pos, bits: int,
                           u=(None, None)) -> None:
    """The KV append of k and v (`quant_pack.quantize_pack_into`): each
    fresh x (B, s, N, g) through `quantize_pack_ref` as rows of one
    scale group (noise u of x's shape, or None), its codes and scales
    written in place into rows [pos, pos + s) of its store, packed (B,
    S, N, pw) u8 and scale (B, S, N) f32.  ``pos`` is an int, or a (B,)
    int tensor of per-row heads, each clamped to [0, S - s] as
    ``jax.lax.dynamic_update_slice`` clamps it."""
    for xi, pi, si, ui in zip(x, packed, scale, u):
        b, s, n, g = xi.shape
        codes, sc = quantize_pack_ref(
            xi.reshape(-1, g), bits, None if ui is None else ui.reshape(-1, g))
        codes, sc = codes.reshape(b, s, n, -1), sc.reshape(b, s, n)
        if not isinstance(pos, torch.Tensor):
            pi[:, pos:pos + s] = codes
            si[:, pos:pos + s] = sc
            continue
        start = torch.clamp(pos.long(), 0, pi.shape[1] - s)
        rows = start[:, None] + torch.arange(s, device=pi.device)
        batch = torch.arange(b, device=pi.device)[:, None]
        pi[batch, rows] = codes
        si[batch, rows] = sc


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


def quantize_pack_scaled_ref(x: torch.Tensor, scale: torch.Tensor,
                             bits: int,
                             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Legacy gradient-wire sender: codes against the given row scale
    (clamped at eps), packed.  Returns packed only: every worker
    already holds the scale."""
    s = torch.clamp(scale.float(), min=Q._EPS)
    codes, _ = Q.quantize(x.float(), bits, noise=u, scale=s)
    return Q.pack_codes(codes, bits)


def unpack_codes_ref(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Legacy gradient-wire receiver: packed codes -> int32 codes over
    the full packed width."""
    d = packed.shape[-1] * Q.codes_per_byte(bits)
    return Q.unpack_codes(packed, bits, d).to(torch.int32)


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


def check_rows_see_keys(sq: int, sk: int, *, causal: bool, window: int,
                        q_offset: int) -> None:
    """Raise where a query row could see no key.  A call where every row
    sees every key (no causal mask, and a window past the last row's
    position: the whisper encoder's self-attention, cross attention)
    takes any ``q_offset + Sq``; any other call keeps its rows'
    positions among the keys (``q_offset + Sq <= Sk``), and its window
    at 1 or more."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if sk < 1:
        raise ValueError(f"no keys: Sk={sk}")
    every_key = not causal and window > q_offset + sq - 1
    if q_offset < 0 or (q_offset + sq > sk and not every_key):
        raise ValueError(f"query positions {q_offset}..{q_offset + sq - 1} "
                         f"run past the {sk} keys")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 10 ** 9,
                        softcap: float = 0.0, q_offset: int = 0,
                        return_lse: bool = False):
    """Dense attention, head-major: q (B, H, Sq, hd), k and v (B, Hk, Sk,
    hd) with H % Hk == 0; query head h reads kv head h // (H // Hk).
    Query row i sits at position ``q_offset + i``, key j at j; key j is
    visible iff j > pos - window and (causal) j <= pos; hidden scores
    are ``NEG_INF``.  f32 throughout; returns q's dtype, and with
    ``return_lse`` also each row's log-sum-exp ``m + log(max(l,
    1e-30))`` (m the row max, l the sum of exp(s - m)), (B, H, Sq) f32,
    as the JAX-level forward (`repro.models.layers`, ``_fwd``).  Raises
    where a row could see no key (`check_rows_see_keys`)."""
    b, h, sq, hd = q.shape
    hk, sk = k.shape[1], k.shape[2]
    check_rows_see_keys(sq, sk, causal=causal, window=window,
                        q_offset=q_offset)
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
    s = torch.where(vis, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v.float()[:, :, None])      # (B, Hk, G, Sq, hd)
    out = out.reshape(b, h, sq, hd).to(q.dtype)
    if not return_lse:
        return out
    m = s.amax(dim=-1, keepdim=True)
    l = torch.exp(s - m).sum(dim=-1)
    lse = m[..., 0] + torch.log(torch.clamp(l, min=1e-30))
    return out, lse.reshape(b, h, sq)
