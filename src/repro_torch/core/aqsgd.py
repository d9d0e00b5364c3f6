"""AQ-SGD: activation-delta compression at pipeline boundaries (port of
`repro.core.aqsgd`).

Algorithm 1/2 of the paper, as the simulated trainer runs it:

* per-(boundary, sample) message buffers ``m(ξ)``; both sides of a real
  boundary would keep bit-identical copies, so one logical buffer is
  carried;
* a first visit sends full precision (the ``seen`` mask);
* later visits send ``Q(a(ξ, x_t) − m(ξ))`` and update
  ``m(ξ) ← m(ξ) + Q(·)``;
* the next stage computes on ``m(ξ)``: the boundary is a
  straight-through estimator whose forward value is the message and
  whose backward gradient is ``Q_bw(∇)`` (`_StraightThrough`);
* buffers may be stored in z bits (paper §H.5).

``directq`` (the paper's baseline) and ``fp32`` share the interface.
Every quantize/pack/unpack goes through `repro_torch.core.boundary`,
whose backends are bit-identical.  Unlike the JAX package,
`write_buffer` updates the buffers in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import boundary as B
from repro_torch.core import quantization as Q


@dataclass(frozen=True)
class CompressionConfig:
    """Activation-boundary knobs: the algorithm, code widths, the
    optional z-bit stored-message format and the codec backend."""
    mode: str = "aqsgd"            # fp32 | directq | aqsgd
    fw_bits: int = 4               # forward activation bits
    bw_bits: int = 8               # backward activation-gradient bits
    buffer_bits: int = 0           # 0 = raw buffer; else z-bit stored
    buffer_dtype: str = "float32"  # raw-buffer storage dtype
    stochastic: bool = True
    backend: str = "auto"          # reference | cuda | auto


# ---------------------------------------------------------------------------
# message buffers
# ---------------------------------------------------------------------------

def init_buffers(cc: CompressionConfig, num_boundaries: int,
                 num_samples: int, seq: int, d: int,
                 device=None) -> Optional[dict]:
    """Buffers for the whole dataset (AQ-SGD only)."""
    if cc.mode != "aqsgd":
        return None
    nb = num_boundaries
    bufs = {"seen": torch.zeros((nb, num_samples), dtype=torch.bool,
                                device=device)}
    if cc.buffer_bits:
        pw = Q.packed_width(d, cc.buffer_bits)
        bufs["codes"] = torch.zeros((nb, num_samples, seq, pw),
                                    dtype=torch.uint8, device=device)
        bufs["scale"] = torch.ones((nb, num_samples, seq, 1),
                                   dtype=torch.float32, device=device)
    else:
        bufs["m"] = torch.zeros((nb, num_samples, seq, d),
                                dtype=getattr(torch, cc.buffer_dtype),
                                device=device)
    return bufs


def buffer_nbytes(cc: CompressionConfig, num_boundaries: int,
                  num_samples: int, seq: int, d: int) -> int:
    """Storage cost of the message buffers (paper §3.3 / §G)."""
    if cc.mode != "aqsgd":
        return 0
    nb = num_boundaries
    if cc.buffer_bits:
        return nb * num_samples * seq * (Q.packed_width(d, cc.buffer_bits)
                                         + 4)
    itemsize = torch.empty((), dtype=getattr(torch, cc.buffer_dtype)
                           ).element_size()
    return nb * num_samples * seq * d * itemsize


def read_buffer(cc: CompressionConfig, bufs: dict, boundary: int,
                sample_ids: torch.Tensor, d: int) -> torch.Tensor:
    """-> m (B, S, d) float32 for the given samples."""
    if cc.buffer_bits:
        codes = bufs["codes"][boundary][sample_ids]
        scale = bufs["scale"][boundary][sample_ids]
        return B.decode(codes, scale, bits=cc.buffer_bits, d=d,
                        backend=cc.backend)
    return bufs["m"][boundary][sample_ids].float()


def write_buffer(cc: CompressionConfig, bufs: dict, boundary: int,
                 sample_ids: torch.Tensor, m_new: torch.Tensor) -> dict:
    """Store the updated messages of ``sample_ids`` at one boundary (raw
    dtype, or z-bit codes + scales) and mark them seen, in place."""
    if cc.buffer_bits:
        packed, scale = B.encode(m_new, bits=cc.buffer_bits,
                                 stochastic=False, backend=cc.backend)
        bufs["codes"][boundary, sample_ids] = packed
        bufs["scale"][boundary, sample_ids] = scale
    else:
        bufs["m"][boundary, sample_ids] = m_new.to(bufs["m"].dtype)
    bufs["seen"][boundary, sample_ids] = True
    return bufs


# ---------------------------------------------------------------------------
# the boundary op (forward substitution + quantized backward gradient)
# ---------------------------------------------------------------------------

class _StraightThrough(torch.autograd.Function):
    """Forward value = the message ``m_used``; backward gradient to
    ``h`` = ``Q_bw(∇)``, the bw-bit wire round trip (Algorithm 1 line
    11); none to the message."""

    @staticmethod
    def forward(ctx, h, m_used, bw_bits, stochastic, backend, generator):
        ctx.bw = (bw_bits, stochastic, backend, generator)
        return m_used.clone()

    @staticmethod
    def backward(ctx, g):
        bw_bits, stochastic, backend, generator = ctx.bw
        if bw_bits < 32:
            g = B.roundtrip(g.contiguous(), bits=bw_bits,
                            stochastic=stochastic, generator=generator,
                            backend=backend)
        return g, None, None, None, None, None


def apply_boundary(cc: CompressionConfig, h: torch.Tensor,
                   m: Optional[torch.Tensor] = None,
                   seen: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """One pipeline-boundary crossing.

    h: (B, S, d) activations leaving stage a (differentiable).
    m: (B, S, d) f32 previous messages of these samples (aqsgd only).
    seen: (B,) bool first-visit mask.
    generator: the noise of stochastic rounding, forward now and
    backward when autograd reaches this boundary.

    Returns (h_out, m_new): what stage b computes on, and the messages
    to store (None unless aqsgd)."""
    if cc.mode == "fp32":
        return h, None
    dtype = h.dtype
    h_sg = h.detach().float()
    with torch.no_grad():
        if cc.mode == "directq":
            m_used = B.roundtrip(h_sg, bits=cc.fw_bits,
                                 stochastic=cc.stochastic,
                                 generator=generator, backend=cc.backend)
            m_new = None
        elif cc.mode == "aqsgd":
            if m is None or seen is None:
                raise ValueError("aqsgd boundaries need m and seen")
            _, _, m_upd = B.encode_delta(h_sg, m, bits=cc.fw_bits,
                                         stochastic=cc.stochastic,
                                         generator=generator,
                                         backend=cc.backend)
            m_used = torch.where(seen[:, None, None], m_upd, h_sg)
            m_new = m_used
        else:
            raise ValueError(f"unknown mode {cc.mode!r}")
    h_out = _StraightThrough.apply(h, m_used.to(dtype), cc.bw_bits,
                                   cc.stochastic, cc.backend, generator)
    return h_out, m_new
