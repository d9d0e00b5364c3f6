"""`Codec`: one plane's quantize-and-pack codec, bound to its knobs
(port of `repro.comm.codec`).

A :class:`Codec` is the (bits, stochastic, backend) triple of one
communication plane bound to the boundary ops of
`repro_torch.core.boundary`: encode and decode, the AQ-SGD delta pair,
the fake-quant round trip, and the error-feedback carry of
`repro_torch.core.grad_compress`.  It adds nothing to the math; it
spares callers threading ``bits=... stochastic=... backend=...``
through every call.  `comm.config.PlaneConfig.codec` builds one.
Stochastic rounding takes noise ``u`` or a ``generator``, as the
boundary ops do.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import boundary as B
from repro_torch.core import grad_compress as GC
from repro_torch.core import quantization as Q


@dataclass(frozen=True)
class Codec:
    """One plane's codec: knobs bound once, ops delegated to
    `core.boundary` (both backends bit-identical per op)."""
    bits: int
    stochastic: bool = True
    backend: str = "auto"

    def encode(self, x, *, u=None, generator=None):
        """Quantize-and-pack: (packed u8 codes, f32 row scales)."""
        return B.encode(x, bits=self.bits, stochastic=self.stochastic, u=u,
                        generator=generator, backend=self.backend)

    def decode(self, packed, scale, *, d: int, dtype=torch.float32):
        """Inverse of `encode`: payload + scales -> (..., d) values."""
        return B.decode(packed, scale, bits=self.bits, d=d, dtype=dtype,
                        backend=self.backend)

    def encode_delta(self, a, m, *, u=None, generator=None):
        """AQ-SGD sender: (payload, scale, updated message buffer)."""
        return B.encode_delta(a, m, bits=self.bits,
                              stochastic=self.stochastic, u=u,
                              generator=generator, backend=self.backend)

    def decode_accumulate(self, packed, scale, m):
        """AQ-SGD receiver: buffer + dequant(unpack(payload))."""
        return B.decode_accumulate(packed, scale, m, bits=self.bits,
                                   backend=self.backend)

    def roundtrip(self, x, *, u=None, generator=None):
        """encode -> decode in x.dtype (wire-faithful fake quant)."""
        return B.roundtrip(x, bits=self.bits, stochastic=self.stochastic,
                           u=u, generator=generator, backend=self.backend)

    def init_state(self, params, group_d: int = GC.DEFAULT_GROUP_D,
                   device=None):
        """Error-feedback carry for one rank: the zeros (rows, group_d)
        bucket of `grad_compress.init_error_state`."""
        return GC.init_error_state(params, group_d, device=device)

    def wire_bytes(self, shape) -> int:
        """Payload bytes for one ``shape`` crossing: packed codes + f32
        row scales, or raw f32 when ``bits`` is 0."""
        if not self.bits:
            size = 1
            for s in shape:
                size *= int(s)
            return size * 4
        return Q.wire_bytes(shape, self.bits)
