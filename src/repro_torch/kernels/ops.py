"""Wrappers around the kernels (port of `repro.kernels.ops`).

The codec wrappers take any ``(..., d)`` batch shape, flatten it to the
kernels' ``(rows, d)`` layout and restore it on the outputs; an
encoder's ``seed`` (in place of noise ``u``) draws over that row view.
`flash_attention` takes the Pallas wrapper's head-major layout.  The
CUDA kernels mask the ragged last block themselves, so unlike the
Pallas wrappers nothing is padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quant_pack as _qp


def _rows(x: Optional[torch.Tensor], d: int) -> Optional[torch.Tensor]:
    return None if x is None else x.reshape(-1, d).contiguous()


def boundary_compress(a, m, u=None, *, bits: int, seed=None):
    """Sender side of an AQ-SGD boundary: (a, m) -> (packed, scale,
    m_new) for any (..., d)."""
    shape = a.shape
    d = shape[-1]
    packed, scale, m_new = _qp.delta_quantize_pack(
        _rows(a, d), _rows(m, d), _rows(u, d), bits=bits, seed=seed)
    return (packed.reshape(*shape[:-1], -1), scale.reshape(*shape[:-1], 1),
            m_new.reshape(shape))


def boundary_decompress(packed, scale, m, *, bits: int):
    """Receiver side: m_new = m + dequant(unpack(packed))."""
    shape = m.shape
    out = _qp.dequant_unpack_accumulate(
        _rows(packed, packed.shape[-1]), _rows(scale, 1),
        _rows(m, shape[-1]), bits=bits)
    return out.reshape(shape)


def quantize_pack(x, u=None, *, bits: int, seed=None):
    """Fused absmax -> quantize -> pack for any (..., d) tensor."""
    shape = x.shape
    d = shape[-1]
    packed, scale = _qp.quantize_pack(_rows(x, d), _rows(u, d), bits=bits,
                                      seed=seed)
    return (packed.reshape(*shape[:-1], -1), scale.reshape(*shape[:-1], 1))


def unpack_dequant(packed, scale, *, bits: int,
                   out_dtype: torch.dtype = torch.float32):
    """Fused unpack -> dequantize; inverse of `quantize_pack`."""
    shape = packed.shape
    out = _qp.unpack_dequant(_rows(packed, shape[-1]), _rows(scale, 1),
                             bits=bits, out_dtype=out_dtype)
    return out.reshape(*shape[:-1], out.shape[-1])


def unpack_dequant_pair(packed, scale, *, bits: int,
                        out_dtype: torch.dtype = torch.float32):
    """`unpack_dequant` of a pair of one shape (k's and v's stores) in
    one launch; returns the pair of values."""
    shape = packed[0].shape
    outs = _qp.unpack_dequant_pair(
        tuple(_rows(p, shape[-1]) for p in packed),
        tuple(_rows(s, 1) for s in scale), bits=bits, out_dtype=out_dtype)
    return tuple(o.reshape(*shape[:-1], o.shape[-1]) for o in outs)


def quantize_pack_into(x, packed, scale, pos, u=(None, None),
                       seed=(None, None), *, bits: int) -> None:
    """Fused absmax -> quantize -> pack of a pair of fresh (B, s, N, d)
    tensors, written in place into rows [pos, pos + s) of their stores
    (B, S, N, pw) u8 and (B, S, N) f32 in one launch: the KV append of
    k and v (``pos`` an int, or a (B,) int32 tensor of clamped per-row
    heads)."""
    _qp.quantize_pack_into(
        tuple(t.contiguous() for t in x), packed, scale, pos,
        tuple(None if t is None else t.contiguous() for t in u), seed,
        bits=bits)


def quantize_pack_scaled(x, scale, u=None, *, bits: int):
    """Packed codes against a given row scale for any (..., d) tensor."""
    shape = x.shape
    d = shape[-1]
    packed = _qp.quantize_pack_scaled(_rows(x, d), _rows(scale, 1),
                                      _rows(u, d), bits=bits)
    return packed.reshape(*shape[:-1], -1)


def unpack_codes(packed, *, bits: int):
    """Packed codes (..., pw) -> int32 codes (..., pw * 8/bits)."""
    shape = packed.shape
    out = _qp.unpack_codes(_rows(packed, shape[-1]), bits=bits)
    return out.reshape(*shape[:-1], out.shape[-1])


def quantize_codes_scaled(x, scale, u=None, *, bits: int, pack: bool = False,
                          seed=None):
    """Codes against a given row scale for any (..., d) tensor: int32
    codes, or (packed, codes) with ``pack``."""
    shape = x.shape
    d = shape[-1]
    out = _qp.quantize_codes_scaled(_rows(x, d), _rows(scale, 1),
                                    _rows(u, d), bits=bits, pack=pack,
                                    seed=seed)
    if pack:
        packed, codes = out
        return packed.reshape(*shape[:-1], -1), codes.reshape(shape)
    return out.reshape(shape)


def dequant_sum_mean(total, scale, *, bits: int, n: int):
    """Mean over n workers from an int32 code sum, any (..., d)."""
    shape = total.shape
    out = _qp.dequant_sum_mean(_rows(total, shape[-1]), _rows(scale, 1),
                               bits=bits, n=n)
    return out.reshape(shape)


def accumulate_codes(packed, acc, *, bits: int):
    """Ring accumulate for any (..., d): acc + unpack(packed), int32."""
    shape = acc.shape
    out = _qp.unpack_accumulate(_rows(packed, packed.shape[-1]),
                                _rows(acc, shape[-1]), bits=bits)
    return out.reshape(shape)


def pack_sums(total, *, bits: int, n: int):
    """int32 code sums (..., d) -> u8 payload (..., sum_packed_width)."""
    shape = total.shape
    out = _qp.pack_sums(_rows(total, shape[-1]), bits=bits, n=n)
    return out.reshape(*shape[:-1], out.shape[-1])


def unpack_sums(packed, *, bits: int, n: int):
    """Inverse of `pack_sums` over the full packed width."""
    shape = packed.shape
    out = _qp.unpack_sums(_rows(packed, shape[-1]), bits=bits, n=n)
    return out.reshape(*shape[:-1], out.shape[-1])


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int = _fa.BIG_WINDOW, softcap: float = 0.0,
                    q_offset: int = 0, return_lse: bool = False):
    """(B, H, Sq, hd) x (B, Hk, Sk, hd) -> (B, H, Sq, hd), query row i at
    position ``q_offset + i``.  Views are read in place (the last dim
    contiguous); the output has q's memory layout.  With ``return_lse``
    also the rows' log-sum-exp, (B, H, Sq) f32."""
    return _fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   return_lse=return_lse)
