"""Backend-selectable AQ-SGD boundary ops (port of `repro.core.boundary`).

Every codec crossing goes through these ops: the activation boundary
(`encode_delta`/`decode_accumulate`/`encode`/`decode`/`roundtrip`) and
the data-parallel gradient wire (`encode_codes_with_scale`, the sender
against a shared row scale, `decode_sum_mean`, the receiver, and the
compressed ring's integer steps `accumulate_codes`, `pack_sums` and
`unpack_sums`).  The legacy `encode_with_scale`/`decode_codes` pair
(packed codes against a shared row scale, then int32 codes from them:
the sender the fused `encode_codes_with_scale` replaced) is on no
trainer's path, as in the JAX package.  The KV plane's pair ops
(`encode_pair_into`, `decode_pair`: k and v together, the append
written in place into the stores) have no JAX counterpart; they equal
two `encode` (plus the slice writes) or two `decode` calls.  Each runs
on two bit-identical backends:

* ``"cuda"``      — the hand-written kernels (`repro_torch.kernels.ops`):
  one device pass per side;
* ``"reference"`` — the plain PyTorch chain over
  `repro_torch.core.quantization`, the correctness oracle.

``"auto"`` resolves by the tensor's device: cuda for a CUDA tensor,
reference otherwise.  Widths outside {2, 4, 8} always take the
reference chain (the kernels implement only those).

Stochastic rounding takes ONE uniform tensor ``u`` that feeds either
backend, drawn here from a ``torch.Generator`` when the caller passes
none, so the wire payload never depends on the backend.  The one
exception is opt-in (the counterpart of the JAX package's
``REPRO_ONCORE_PRNG``): with the on-core noise knob on
(`repro_torch.env.oncore_prng`) a stochastic encode on the cuda backend
that was given no ``u`` draws a (2,) int32 seed from the generator
instead, and its kernel draws the noise itself
(`repro_torch.kernels.ref.oncore_uniform_ref` is that stream), so no
noise tensor is written or read.  The reference backend
ignores the knob, as JAX's does; an explicit ``u`` always wins.  The
seeded stream is not the one ``torch.rand`` draws, so with the knob on
the cuda backend agrees with the reference backend in distribution
(unbiased rounding), not bit for bit.  `encode_with_scale` has no
seeded kernel (nor has the JAX package's), so it always draws ``u``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import env
from repro_torch.core import quantization as Q
from repro_torch.core.cache_rows import clamp_heads, write_rows_
from repro_torch.kernels import ops as K
from repro_torch.kernels.quant_pack import KERNEL_BITS

BACKENDS = ("reference", "cuda")
PACKABLE_BITS = (1, 2, 4, 8)       # dense byte-aligned wire packing


def resolve_backend(backend: str, x: torch.Tensor,
                    bits: Optional[int] = None) -> str:
    """'auto' -> cuda iff ``x`` lies on a CUDA device; widths outside
    KERNEL_BITS always resolve to the reference chain."""
    if bits is not None and bits not in KERNEL_BITS:
        return "reference"
    if backend == "auto":
        backend = "cuda" if x.is_cuda else "reference"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of "
                         f"{BACKENDS + ('auto',)}")
    return backend


def _uniform(x: torch.Tensor, stochastic: bool, u, generator):
    """The uniform noise of an encode op: None when deterministic; else
    ``u``, or a fresh draw of x's shape from ``generator``."""
    if not stochastic:
        return None
    if u is not None:
        return u
    if generator is None:
        raise ValueError("stochastic boundary ops need a noise tensor u "
                         "or a torch.Generator")
    return torch.rand(x.shape, generator=generator, dtype=torch.float32,
                      device=x.device)


def _noise(x: torch.Tensor, stochastic: bool, u, generator, backend: str):
    """(noise, seed) of an encode op: on the cuda backend with
    `env.oncore_prng` on, a stochastic op given no ``u`` gets a (2,)
    int32 seed for the kernel's own draw; otherwise `_uniform`."""
    if stochastic and u is None and generator is not None \
            and backend == "cuda" and env.oncore_prng():
        seed = torch.randint(-2 ** 31, 2 ** 31, (2,), generator=generator,
                             dtype=torch.int32, device=generator.device)
        return None, seed.to(x.device)
    return _uniform(x, stochastic, u, generator), None


def encode_delta(a, m, *, bits: int, stochastic: bool = False, u=None,
                 generator=None, backend: str = "auto"):
    """AQ-SGD sender: (a, m) -> (packed u8 (..., pw), scale f32 (..., 1),
    m_new f32 (..., d)), m_new = m + dequant(codes).  Widths that do
    not pack to whole bytes ship raw u8 codes."""
    backend = resolve_backend(backend, a, bits)
    u, seed = _noise(a, stochastic, u, generator, backend)
    if backend == "cuda":
        return K.boundary_compress(a, m, u, bits=bits, seed=seed)
    m32 = m.float()
    codes, scale = Q.quantize(a.float() - m32, bits, noise=u)
    packed = Q.pack_codes(codes, bits) if bits in PACKABLE_BITS else codes
    return packed, scale, Q.dequantize_accumulate(codes, scale, m32, bits)


def decode_accumulate(packed, scale, m, *, bits: int,
                      backend: str = "auto"):
    """AQ-SGD receiver: m_new f32 = m + dequant(unpack(packed)) — the
    sender's m_new bit for bit, so both buffer replicas agree."""
    backend = resolve_backend(backend, m, bits)
    if backend == "cuda":
        return K.boundary_decompress(packed, scale, m, bits=bits)
    codes = Q.unpack_codes(packed, bits, m.shape[-1]) \
        if bits in PACKABLE_BITS else packed
    return Q.dequantize_accumulate(codes, scale, m, bits)


def encode(x, *, bits: int, stochastic: bool = False, u=None,
           generator=None, backend: str = "auto"):
    """Direct quantize-and-pack: (packed u8 (..., pw), scale f32
    (..., 1)) — the DirectQ sender and the KV-cache append."""
    backend = resolve_backend(backend, x, bits)
    u, seed = _noise(x, stochastic, u, generator, backend)
    if backend == "cuda":
        return K.quantize_pack(x, u, bits=bits, seed=seed)
    codes, scale = Q.quantize(x.float(), bits, noise=u)
    packed = Q.pack_codes(codes, bits) if bits in PACKABLE_BITS else codes
    return packed, scale


def decode(packed, scale, *, bits: int, d: int,
           dtype: torch.dtype = torch.float32, backend: str = "auto"):
    """Inverse of `encode`: (..., pw) u8 + scales -> (..., d) values."""
    backend = resolve_backend(backend, packed, bits)
    if backend == "cuda":
        return K.unpack_dequant(packed, scale, bits=bits,
                                out_dtype=dtype)[..., :d]
    codes = Q.unpack_codes(packed, bits, d) if bits in PACKABLE_BITS \
        else packed
    return Q.dequantize(codes, scale, bits, dtype)


def encode_pair_into(xs, packed, scales, pos, *, bits: int,
                     stochastic: bool = False, generator=None,
                     backend: str = "auto") -> None:
    """`encode` of a pair of fresh tensors of one shape ``xs`` (B, s, N,
    d) (k's and v's rows), written in place into rows [pos, pos + s) of
    their stores ``packed`` (B, S, N, pw) u8 and ``scales`` (B, S, N)
    f32: the KV append.  ``pos`` is one head (an int) or a (B,) int32
    tensor, a head a batch entry, clamped to [0, S - s] as
    ``jax.lax.dynamic_update_slice`` clamps it.  The cuda backend runs
    both in one kernel launch.  Noise is drawn for ``xs[0]``, then
    ``xs[1]``, as two `encode` calls draw it, so the bits equal
    theirs."""
    backend = resolve_backend(backend, xs[0], bits)
    noise = [_noise(x, stochastic, None, generator, backend) for x in xs]
    if backend == "cuda":
        K.quantize_pack_into(xs, packed, scales, pos,
                             tuple(u for u, _ in noise),
                             tuple(seed for _, seed in noise), bits=bits)
        return
    if isinstance(pos, torch.Tensor):
        pos = clamp_heads(pos, packed[0].shape[1], xs[0].shape[1])
    for x, p, s, (u, _) in zip(xs, packed, scales, noise):
        codes, scale = encode(x, bits=bits, stochastic=stochastic, u=u,
                              backend=backend)
        write_rows_(p, codes, pos)
        write_rows_(s, scale[..., 0], pos)


def decode_pair(packed, scales, *, bits: int, d: int,
                dtype: torch.dtype = torch.float32, backend: str = "auto"):
    """`decode` of a pair of one shape (k's and v's stores); the cuda
    backend runs both in one kernel launch.  Returns the pair."""
    backend = resolve_backend(backend, packed[0], bits)
    if backend == "cuda":
        return tuple(v[..., :d] for v in K.unpack_dequant_pair(
            packed, scales, bits=bits, out_dtype=dtype))
    return tuple(decode(p, s, bits=bits, d=d, dtype=dtype, backend=backend)
                 for p, s in zip(packed, scales))


def roundtrip(x, *, bits: int, stochastic: bool = False, u=None,
              generator=None, backend: str = "auto"):
    """encode -> decode in x.dtype: the wire-faithful fake quant of the
    DirectQ hop."""
    packed, scale = encode(x, bits=bits, stochastic=stochastic, u=u,
                           generator=generator, backend=backend)
    return decode(packed, scale, bits=bits, d=x.shape[-1], dtype=x.dtype,
                  backend=backend)


def encode_with_scale(x, scale, *, bits: int, stochastic: bool = False,
                      u=None, generator=None, backend: str = "auto"):
    """Legacy DP gradient-wire sender: x quantized against the caller's
    row scale and packed, u8 (..., pw) (raw u8 codes for widths that do
    not pack to whole bytes).  The scale is clamped at eps here, once,
    for both backends.  Stochastic noise is ``u`` or a ``torch.rand``
    draw from ``generator``, whatever the on-core noise knob says."""
    backend = resolve_backend(backend, x, bits)
    scale = torch.clamp(scale.float(), min=Q._EPS)
    u = _uniform(x, stochastic, u, generator)
    if backend == "cuda":
        return K.quantize_pack_scaled(x, scale, u, bits=bits)
    codes, _ = Q.quantize(x.float(), bits, noise=u, scale=scale)
    return Q.pack_codes(codes, bits) if bits in PACKABLE_BITS else codes


def decode_codes(packed, *, bits: int, d: int, backend: str = "auto"):
    """Legacy DP gradient-wire receiver: the payload of
    `encode_with_scale` -> int32 codes (..., d), the form whose sums
    over workers `decode_sum_mean` turns into their mean."""
    backend = resolve_backend(backend, packed, bits)
    if backend == "cuda":
        return K.unpack_codes(packed, bits=bits)[..., :d]
    codes = Q.unpack_codes(packed, bits, d) if bits in PACKABLE_BITS \
        else packed
    return codes.to(torch.int32)


def encode_codes_with_scale(x, scale, *, bits: int, stochastic: bool = False,
                            u=None, generator=None, pack: bool = False,
                            backend: str = "auto"):
    """DP gradient-wire sender: int32 codes (..., d) of x against the
    caller's row scale (every worker quantizes against the same shared
    scale, so code sums dequantize to the exact mean).  ``pack`` also
    returns the packed payload: (packed, codes).  The scale is clamped
    at eps here, once, for both backends."""
    backend = resolve_backend(backend, x, bits)
    scale = torch.clamp(scale.float(), min=Q._EPS)
    u, seed = _noise(x, stochastic, u, generator, backend)
    if backend == "cuda":
        return K.quantize_codes_scaled(x, scale, u, bits=bits, pack=pack,
                                       seed=seed)
    codes, _ = Q.quantize(x.float(), bits, noise=u, scale=scale)
    icodes = codes.to(torch.int32)
    if pack:
        packed = Q.pack_codes(codes, bits) if bits in PACKABLE_BITS \
            else codes
        return packed, icodes
    return icodes


def decode_sum_mean(total, scale, *, bits: int, n: int,
                    backend: str = "auto"):
    """DP gradient-wire receiver: int32 code sum over n workers + the
    shared row scale -> their mean (f32)."""
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"n must be a positive int, got {n!r}")
    backend = resolve_backend(backend, total, bits)
    if backend == "cuda":
        return K.dequant_sum_mean(total, scale, bits=bits, n=n)
    return Q.dequant_sum_mean(total, scale, bits, n)


def accumulate_codes(packed, acc, *, bits: int, backend: str = "auto"):
    """Ring accumulate step: acc + unpack(packed) in int32, one pass.
    int32 adds are exact in any order, which keeps the ring
    bit-identical to an all-reduce of the codes."""
    backend = resolve_backend(backend, acc, bits)
    if backend == "cuda":
        return K.accumulate_codes(packed, acc, bits=bits)
    d = acc.shape[-1]
    codes = Q.unpack_codes(packed, bits, d) if bits in PACKABLE_BITS \
        else packed
    return acc + codes.to(torch.int32)


def pack_sums(total, *, bits: int, n: int, backend: str = "auto"):
    """Pack int32 code sums over n workers at `Q.sum_wire_bits(bits, n)`
    bits: the ring's all-gather payload (b + ceil(log2 n) bits is the
    price of exactness; re-quantizing the mean would not stay
    bit-identical to the all-reduce)."""
    backend = resolve_backend(backend, total, bits)
    if backend == "cuda":
        return K.pack_sums(total, bits=bits, n=n)
    return Q.pack_sums(total, bits, n)


def unpack_sums(packed, *, bits: int, n: int, d: int,
                backend: str = "auto"):
    """Inverse of `pack_sums`: u8 payload -> (..., d) int32 code sums."""
    backend = resolve_backend(backend, packed, bits)
    if backend == "cuda":
        return K.unpack_sums(packed, bits=bits, n=n)[..., :d]
    return Q.unpack_sums(packed, bits, n, d)
