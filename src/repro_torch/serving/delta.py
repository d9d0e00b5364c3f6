"""Delta-encoded pipeline hops for autoregressive decode (port of
`repro.serving.delta`).

The paper's trick — quantize the CHANGE in an activation against a
reference buffer instead of the value — applied to decode: the
inter-stage hop ships ``Q(h_t - m)`` against a per-boundary reference
``m`` and both sides advance ``m += dequant(codes)`` in lockstep.

Modes mirror the activation plane (`CommConfig.mode`):

* ``aqsgd``   — `core.boundary.encode_delta` on the send side,
  `decode_accumulate` on the receive side (on a CUDA tensor: the
  ``delta_quantize_pack`` and ``dequant_unpack_accumulate`` kernels);
* ``directq`` — quantize the value itself every hop (`encode`, `decode`);
* ``fp32``    — pass-through (the uncompressed baseline).

The prefill crossing is uncompressed and sets ``m`` to the last prompt
position's hidden state, so the first decode delta is one token-step.

`SENT` counts the decode hops taken and the bytes of the payload each
one produced (packed codes and scales, or the raw f32 hidden state),
counted where the sender makes it; `reset_sent` zeroes it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import boundary as B
from repro_torch.core import quantization as Q

SENT = {"hops": 0, "bytes": 0}


def reset_sent() -> None:
    SENT.update(hops=0, bytes=0)


def _sent(*payload: torch.Tensor) -> None:
    SENT["hops"] += 1
    SENT["bytes"] += sum(t.numel() * t.element_size() for t in payload)


@dataclass(frozen=True)
class DeltaHopCodec:
    """Decode-hop codec for one pipeline: mode + fw-plane knobs.

    ``num_boundaries = num_stages - 1`` reference buffers of shape
    ``(B, 1, d)``, advanced once per decoded token.  Rounding is
    deterministic: both ends of a real wire must reconstruct identical
    references without sharing noise."""
    mode: str = "aqsgd"                 # aqsgd | directq | fp32
    bits: int = 4
    backend: str = "auto"

    def __post_init__(self):
        if self.mode not in ("aqsgd", "directq", "fp32"):
            raise ValueError(f"unknown hop mode {self.mode!r}")

    @classmethod
    def from_comm(cls, comm) -> "DeltaHopCodec":
        """Bind `CommConfig`'s mode + fw plane (rounding is forced
        deterministic whatever ``fw.stochastic`` says)."""
        return cls(mode=comm.mode, bits=comm.fw.bits or 4,
                   backend=comm.fw.backend)

    def init_state(self, num_boundaries: int, batch: int, d: int,
                   device=None) -> dict:
        """Zero reference buffers (filled by the prefill crossing)."""
        return {"m": torch.zeros((max(num_boundaries, 1), batch, 1, d),
                                 dtype=torch.float32, device=device)}

    def prefill_boundary(self, state, h, idx):
        """Prefill crossing: pass-through; the reference becomes the
        LAST prompt position's hidden state."""
        if self.mode != "fp32":
            state["m"][idx] = h[:, -1:, :].float()
        return state, h

    def decode_boundary(self, state, h, idx):
        """One decode-token crossing of boundary ``idx``; h (B, 1, d).
        aqsgd: the receiver's output IS the new reference (equal to the
        sender's ``m_new`` bit for bit), so one update serves both ends."""
        if self.mode == "fp32":
            _sent(h.float())
            return state, h
        if self.mode == "directq":
            packed, scale = B.encode(h, bits=self.bits, backend=self.backend)
            _sent(packed, scale)
            return state, B.decode(packed, scale, bits=self.bits,
                                   d=h.shape[-1], dtype=h.dtype,
                                   backend=self.backend)
        m = state["m"][idx]
        packed, scale, m_new = B.encode_delta(h, m, bits=self.bits,
                                              backend=self.backend)
        _sent(packed, scale)
        h2 = B.decode_accumulate(packed, scale, m, bits=self.bits,
                                 backend=self.backend)
        state["m"][idx] = m_new
        return state, h2.to(h.dtype)

    def boundary_fn(self, *, prefill: bool):
        """The ``boundary_fn(state, h, idx) -> (state, h)`` hook
        `Transformer.forward_with_caches` runs between stage groups."""
        return self.prefill_boundary if prefill else self.decode_boundary

    def hop_bytes(self, batch: int, d: int) -> int:
        """Modeled network bytes for ONE decode-token hop across one
        boundary: packed codes + one f32 scale per row over the
        ``(B, 1, d)`` hop (raw f32 for the fp32 pass-through)."""
        if self.mode == "fp32":
            return batch * d * 4
        return Q.wire_bytes((batch, 1, d), self.bits)
