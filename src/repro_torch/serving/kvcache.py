"""Quantized KV cache: quantize-on-append, dequantize-on-attend (port of
`repro.serving.kvcache`).

A raw layer cache row is ``(B, S, Hk, head_dim)``.  The codec reshapes
``head_dim`` into ``(G, group)`` scale groups (``group = kv.group_d or
head_dim``: by default one scale per head row) and stores

* ``codes``  u8  ``(L, B, S, Hk, G, packed_width(group, bits))``
* ``scale``  f32 ``(L, B, S, Hk, G)``

Each forward step dequantizes a layer's whole store, lets attention
scatter the step's fresh raw rows in, attends, then encodes ONLY those
rows back, so every token is encoded exactly once.  All quantization
goes through `repro_torch.core.boundary`, so on a CUDA tensor the
append runs the ``quantize_pack`` kernel and the read ``unpack_dequant``.
The model calls the pair forms, `KVCodec.decode_pair` and
`KVCodec.append_pair`: k's and v's stores are read in one launch, and
k's and v's fresh rows encoded in one launch that writes the codes and
scales straight into the stores at the write head (no temporary, no
copy kernel).  The per-tensor `decode` and `append`, the JAX package's
methods, stay, and the pairs equal them bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core import boundary as B
from repro_torch.core import quantization as Q


@dataclass(frozen=True)
class KVCodec:
    """The kv plane's codec: bits/group/stochastic/backend bound once.

    ``bits=0`` disables quantization (raw cache).  ``group_d=0`` means
    one scale group per head row.  Rounding is deterministic by default:
    decode must be reproducible across replays of the same request;
    a stochastic codec takes its noise from ``generator``."""
    bits: int = 0
    group_d: int = 0
    stochastic: bool = False
    backend: str = "auto"

    @classmethod
    def from_comm(cls, comm) -> "KVCodec":
        """Bind the ``kv`` plane of a `repro_torch.comm.CommConfig`."""
        pc = comm.kv
        return cls(bits=pc.bits, group_d=pc.group_d,
                   stochastic=pc.stochastic, backend=pc.backend)

    def group(self, head_dim: int) -> int:
        """Scale-group width along head_dim."""
        g = self.group_d or head_dim
        if head_dim % g:
            raise ValueError(f"group {g} does not divide head_dim "
                             f"{head_dim}")
        if self.bits in B.PACKABLE_BITS and g % Q.codes_per_byte(self.bits):
            # packing must round-trip without padding so the decode
            # side can recover g from the packed width
            raise ValueError(f"group {g} is not whole bytes at "
                             f"{self.bits} bits")
        return g

    def grouped_shape(self, shape) -> tuple:
        """(..., head_dim) value shape -> (..., G, group)."""
        *lead, hd = shape
        g = self.group(hd)
        return (*lead, hd // g, g)

    def stored_bytes(self, shape) -> int:
        """Modeled device bytes for one append of value shape
        ``(..., head_dim)``: packed codes plus one f32 scale per group
        (raw f32 when bits=0)."""
        if not self.bits:
            return math.prod(shape) * 4
        return Q.wire_bytes(self.grouped_shape(shape), self.bits)

    # -- cache structure ---------------------------------------------------

    def empty(self, shape, dtype=torch.bfloat16, device=None):
        """Zero store for a raw value shape ``(..., head_dim)``:
        ``{"codes", "scale"}`` when quantized, raw zeros when bits=0.
        Zero codes with zero scales decode to exact zeros."""
        if not self.bits:
            return torch.zeros(shape, dtype=dtype, device=device)
        *lead, hd = shape
        g = self.group(hd)
        pw = Q.packed_width(g, self.bits)
        return {"codes": torch.zeros((*lead, hd // g, pw), dtype=torch.uint8,
                                     device=device),
                "scale": torch.zeros((*lead, hd // g), dtype=torch.float32,
                                     device=device)}

    def encode(self, values, *, generator=None):
        """Quantize fresh rows ``(..., head_dim)`` -> (codes, scale) in
        the grouped store layout."""
        g = self.group(values.shape[-1])
        grouped = values.reshape(*values.shape[:-1], -1, g)
        packed, scale = B.encode(grouped, bits=self.bits,
                                 stochastic=self.stochastic,
                                 generator=generator, backend=self.backend)
        return packed, scale[..., 0]

    def decode(self, codes, scale, dtype=torch.bfloat16):
        """Whole-store dequantize: (codes (..., G, pw), scale (..., G))
        -> values (..., head_dim) in the attend dtype."""
        g = self._group_of(codes.shape[-1])
        vals = B.decode(codes, scale[..., None], bits=self.bits, d=g,
                        dtype=dtype, backend=self.backend)
        return vals.reshape(*codes.shape[:-2], -1)

    def _group_of(self, pw: int) -> int:
        """The group width behind a store's packed width."""
        if self.group_d:
            return self.group_d
        if self.bits in B.PACKABLE_BITS:
            return pw * Q.codes_per_byte(self.bits)
        return pw                  # non-byte-aligned widths store raw u8

    def append(self, codes, scale, values, pos: int, *, generator=None):
        """Encode ``values (B, s, Hk, head_dim)`` and write them IN PLACE
        at sequence position ``pos`` of one layer's store ``codes (B, S,
        Hk, G, pw)``, ``scale (B, S, Hk, G)``."""
        c, s = self.encode(values, generator=generator)
        n = values.shape[1]
        codes[:, pos:pos + n] = c
        scale[:, pos:pos + n] = s

    def decode_pair(self, codes, scales, dtype=torch.bfloat16):
        """`decode` of k's and v's stores together: a pair of codes (...,
        G, pw) and a pair of scales (..., G) of one shape -> a pair of
        values (..., head_dim); one kernel launch on the cuda backend."""
        g = self._group_of(codes[0].shape[-1])
        vals = B.decode_pair(codes, tuple(s[..., None] for s in scales),
                             bits=self.bits, d=g, dtype=dtype,
                             backend=self.backend)
        return tuple(v.reshape(*c.shape[:-2], -1)
                     for v, c in zip(vals, codes))

    def append_pair(self, codes, scales, values, pos, *,
                    generator=None):
        """`append` of k's and v's fresh ``values`` (a pair of (B, s, Hk,
        head_dim)) into their layer stores, a pair of ``codes`` (B, S,
        Hk, G, pw) and ``scales`` (B, S, Hk, G), IN PLACE at ``pos``:
        one kernel launch on the cuda backend, which writes the codes and
        scales straight into the stores.  ``pos`` is an int, or a (B,)
        int32 tensor of per-row heads (the continuous batcher's pool),
        each clamped to [0, S - s] as the JAX package's
        ``dynamic_update_slice`` clamps it under ``vmap``.  The same bits
        as ``append`` of k, then of v (a stochastic codec draws k's noise
        first)."""
        g = self.group(values[0].shape[-1])
        b, cache = codes[0].shape[:2]
        B.encode_pair_into(
            tuple(v.reshape(*v.shape[:2], -1, g) for v in values),
            tuple(c.view(b, cache, -1, c.shape[-1]) for c in codes),
            tuple(s.view(b, cache, -1) for s in scales), pos,
            bits=self.bits, stochastic=self.stochastic,
            generator=generator, backend=self.backend)



# JAX `quantize_caches`' refusal for the hybrid family
HYBRID_KV_REFUSAL = ("kv.bits > 0 is not wired for the hybrid family's "
                     "shared attention block yet — set kv.bits=0 for zamba2")


def store_codec(cfg, codec):
    """The KV codec a model's caches are built with, by the family
    rules of JAX `quantize_caches`: the ssm family keeps no KV cache, so
    a codec has nothing to quantize and passes through (None); the
    hybrid family's shared attention block keeps raw k and v, and a
    quantizing codec raises `NotImplementedError`; a dense, MoE, vlm or
    audio model takes ``codec`` as given for its stacked layers' ``k``
    and ``v`` (a MoE model's dense prefix keeps raw ``pk``/``pv`` and an
    audio model its cross caches raw ``xk``/``xv``, which hold no
    position-dependent growth, `Transformer.init_caches`)."""
    if cfg.family == "ssm":
        return None
    if cfg.family == "hybrid" and codec is not None and codec.bits:
        raise NotImplementedError(HYBRID_KV_REFUSAL)
    return codec
