"""Wrappers of the CUDA boundary-codec kernels (``csrc/quant_pack.cu``).

One wrapper per kernel, on row-major ``(R, d)`` tensors:

* `delta_quantize_pack`       — AQ-SGD sender (delta -> wire + m_new);
* `dequant_unpack_accumulate` — AQ-SGD receiver (wire + m -> m_new);
* `quantize_pack`             — DirectQ sender and backward-gradient
  quantize; `quantize_pack_into`, the same kernel, is the KV-cache
  append of k and v in one launch, written in place into the stores;
* `unpack_dequant`            — the matching receiver;
  `unpack_dequant_pair`, the same kernel, is the KV-cache read of k and
  v in one launch;
* `quantize_pack_scaled` / `unpack_codes` — the gradient wire's legacy
  pair (`core.boundary.encode_with_scale` / `decode_codes`, on no
  trainer's path): packed codes against a given (shared) row scale, and
  packed codes back to int32;
* `quantize_codes_scaled`     — data-parallel gradient sender: int32
  codes against a given (shared) row scale, optionally packed too;
* `dequant_sum_mean`          — its receiver: the mean over n workers
  from their int32 code sum;
* `unpack_accumulate`         — the compressed ring's reduce-scatter
  step: an arriving packed segment added into int32 code sums;
* `pack_sums` / `unpack_sums` — its all-gather payload: int32 code
  sums packed at ``sum_wire_bits(bits, n)`` bits, and back.

The three encoders round stochastically with uniform noise ``u``, or
draw that noise themselves from a ``seed``, a (2,) int32 tensor on the
data's device (Philox4x32-10 over each element's index; the plain
version is `ref.oncore_uniform_ref`).  At most one of the two is given.

A tensor on the CPU goes to the plain version in `repro_torch.kernels.ref`
(for the pair calls, the two per-tensor plain calls, plus the append's
slice writes).  A CUDA tensor goes to the kernel, launched on the
current stream, or the wrapper raises; nothing falls back.  `LAUNCHES`
counts kernel launches per wrapper (the CPU path does not count), so a
run can show that its path went through the kernels (a pair call is
one launch; ``flash_attention_fwd``, the attention kernel of
`repro_torch.kernels.flash_attention`, counts here too;
``oncore_uniform`` counts the encoders' launches with a seed).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import build
from repro_torch.kernels import ref

KERNEL_BITS = (2, 4, 8)

# kernel launches per wrapper since the last `reset_launches`
LAUNCHES = {"delta_quantize_pack": 0, "dequant_unpack_accumulate": 0,
            "quantize_pack": 0, "unpack_dequant": 0,
            "quantize_pack_scaled": 0, "unpack_codes": 0,
            "quantize_codes_scaled": 0, "dequant_sum_mean": 0,
            "unpack_accumulate": 0, "pack_sums": 0, "unpack_sums": 0,
            "flash_attention_fwd": 0, "oncore_uniform": 0}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*ts) -> bool:
    """True if the (non-None) tensors all lie on one CUDA device, False
    if all on the CPU; raises on a mix."""
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_bits(bits: int, d: int):
    if bits not in KERNEL_BITS:
        raise ValueError(f"the kernels implement bits {KERNEL_BITS}, "
                         f"got {bits}")
    if d % (8 // bits):
        raise ValueError(f"d={d} is not a multiple of {8 // bits} "
                         f"codes per byte at {bits} bits")


def _vec(d: int, *ts) -> int:
    """1 when the 4-element (float4 / int4) paths apply: d % 4 == 0 and
    16-byte aligned data."""
    return int(d % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in ts if t is not None))


# a row wider than 256 values: a block a row holding up to ROW_VALUES
# values in registers, ROW_NV[delta] float4s a thread (B1 holds m beside
# the delta, so half as many as B3); csrc/quant_pack.cu kRowValues, kRowNV
ROW_VALUES = 8192
ROW_NV = {False: 4, True: 2}


def _encode_tiling(d: int, delta: bool = False) -> tuple:
    """(threads a row, float4s a thread) of an encoder at rows of d
    values on the float4 path (``delta``: B1, else B3).  Rows of up to
    256 values, the KV plane's: a lane group of 8, 16 or 32 lanes
    holding 1, 1 or 2 float4s each.  Wider rows: a block of the fewest
    whole warps T with ``4 * T * nv >= d`` (nv = ``ROW_NV[delta]``), at
    most ``ROW_VALUES / (4 * nv)`` threads (512 for B3, 1024 for B1), so
    a row of up to 8192 values stays in registers from the absmax to the
    quantize and is read once; a wider row is walked twice by the widest
    block."""
    n4 = -(-d // 4)
    if n4 <= 8:
        return 8, 1
    if n4 <= 16:
        return 16, 1
    if n4 <= 64:
        return 32, 2
    nv = ROW_NV[delta]
    return min(ROW_VALUES // (4 * nv), 32 * -(-n4 // (32 * nv))), nv


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(name: str, fn: str, *args, seeded: bool = False) -> None:
    lib = build.load("quant_pack")
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {rc}")
    LAUNCHES[name] += 1
    if seeded:
        LAUNCHES["oncore_uniform"] += 1


def _noise_check(u: Optional[torch.Tensor], seed: Optional[torch.Tensor]):
    """At most one noise source (as the Pallas encoders assert)."""
    if u is not None and seed is not None:
        raise ValueError("pass uniform noise u or a seed, not both")


def _plain_noise(u, seed, rows: int, d: int):
    """The noise a plain version reads: ``u``, or the seeded kernels'
    draw from ``seed``."""
    return ref.oncore_uniform_ref(seed, rows, d) if seed is not None else u


def _check_noise(u, seed, r: int, d: int):
    if u is not None:
        _check(u, "u", torch.float32, (r, d))
    if seed is not None:
        _check(seed, "seed", torch.int32, (2,))


def delta_quantize_pack(a: torch.Tensor, m: torch.Tensor,
                        u: Optional[torch.Tensor] = None, *, bits: int,
                        seed: Optional[torch.Tensor] = None):
    """a, m (R, d) f32; u optional uniform noise (R, d) for stochastic
    rounding, or seed (2,) int32 to draw it in the kernel.  Returns
    (packed (R, d*bits/8) u8, scale (R, 1) f32, m_new (R, d) f32)."""
    _noise_check(u, seed)
    if not _on_cuda(a, m, u, seed):
        return ref.delta_quantize_pack_ref(
            a, m, bits, _plain_noise(u, seed, *a.shape))
    r, d = a.shape
    _check_bits(bits, d)
    _check(a, "a", torch.float32, (r, d))
    _check(m, "m", torch.float32, (r, d))
    _check_noise(u, seed, r, d)
    packed = torch.empty((r, d * bits // 8), dtype=torch.uint8,
                         device=a.device)
    scale = torch.empty((r, 1), dtype=torch.float32, device=a.device)
    m_new = torch.empty_like(a)
    if r:
        _launch("delta_quantize_pack", "rt_delta_quantize_pack",
                a.data_ptr(), m.data_ptr(), _ptr(u), _ptr(seed),
                packed.data_ptr(), scale.data_ptr(), m_new.data_ptr(), r, d,
                bits, _vec(d, a, m, u, packed, m_new),
                *_encode_tiling(d, delta=True), seeded=seed is not None)
    return packed, scale, m_new


def dequant_unpack_accumulate(packed: torch.Tensor, scale: torch.Tensor,
                              m: torch.Tensor, *, bits: int) -> torch.Tensor:
    """packed (R, d*bits/8) u8, scale (R, 1) f32, m (R, d) f32.
    Returns m_new (R, d) f32 = m + dequant(unpack(packed)), one FMA."""
    if not _on_cuda(packed, scale, m):
        return ref.dequant_unpack_accumulate_ref(packed, scale, m, bits)
    r, d = m.shape
    _check_bits(bits, d)
    _check(packed, "packed", torch.uint8, (r, d * bits // 8))
    _check(scale, "scale", torch.float32, (r, 1))
    _check(m, "m", torch.float32, (r, d))
    out = torch.empty_like(m)
    if r:
        _launch("dequant_unpack_accumulate", "rt_dequant_unpack_accumulate",
                packed.data_ptr(), scale.data_ptr(), m.data_ptr(),
                out.data_ptr(), r, d, bits, _vec(d, packed, m, out))
    return out


def quantize_pack(x: torch.Tensor, u: Optional[torch.Tensor] = None, *,
                  bits: int, seed: Optional[torch.Tensor] = None):
    """x (R, d) f32; u optional uniform noise (R, d), or seed (2,)
    int32.  Returns (packed (R, d*bits/8) u8, scale (R, 1) f32)."""
    _noise_check(u, seed)
    if not _on_cuda(x, u, seed):
        return ref.quantize_pack_ref(x, bits, _plain_noise(u, seed, *x.shape))
    r, d = x.shape
    _check_bits(bits, d)
    _check(x, "x", torch.float32, (r, d))
    _check_noise(u, seed, r, d)
    packed = torch.empty((r, d * bits // 8), dtype=torch.uint8,
                         device=x.device)
    scale = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    if r:
        # one tensor, its rows written to the same rows of the outputs
        # (no row map: rpb 0)
        _launch("quantize_pack", "rt_quantize_pack", x.data_ptr(), None,
                _ptr(u), None, _ptr(seed), None, packed.data_ptr(), None,
                scale.data_ptr(), None, r, d, 0, 0, 0, 0, None, 0, 0, bits,
                _vec(d, x, u, packed), *_encode_tiling(d),
                seeded=seed is not None)
    return packed, scale


def _pair(name: str, t) -> tuple:
    if not isinstance(t, (tuple, list)) or len(t) != 2:
        raise TypeError(f"{name}: expected a pair (k, v), got {t!r}")
    return tuple(t)


def _check_store(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple):
    """A layer store (B, S, ...): dtype and shape, each batch entry
    contiguous, entries apart by the batch stride (not overlapping)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    inner = [math.prod(shape[i + 1:]) for i in range(1, len(shape))]
    if list(t.stride()[1:]) != inner or \
            (shape[0] > 1 and t.stride(0) < math.prod(shape[1:])):
        raise ValueError(f"{name}: strides {t.stride()} are not a store's "
                         f"(batch entries contiguous, not overlapping)")


def quantize_pack_into(x, packed, scale, pos, u=(None, None),
                       seed=(None, None), *, bits: int) -> None:
    """The KV append of k and v in one launch, written in place.

    ``x``: a pair of fresh (B, s, N, g) f32 tensors, rows of one scale
    group each; ``packed`` and ``scale``: a pair of layer stores (B, S,
    N, g*bits/8) u8 and (B, S, N) f32 of one shape and strides, each
    batch entry contiguous.  Row (b, t, j) of x[i] is quantized and
    packed (`quantize_pack`) into row (b, pos + t, j) of packed[i] and
    scale[i]; nothing else in the stores is written.  ``pos``: one
    write head (an int, which must keep the rows inside the store), or
    a (B,) int32 tensor on the stores' device, a head a batch entry,
    which the kernel clamps to [0, S - s] (``dynamic_update_slice``'s
    rule) and the host never reads.  ``u``: a pair of uniform noise of
    x's shape, or ``seed``: a pair of (2,) int32 (the counter is each
    element's index in its own tensor's (B*s*N, g) row view), or
    neither."""
    x, packed, scale = _pair("x", x), _pair("packed", packed), \
        _pair("scale", scale)
    u, seed = _pair("u", u), _pair("seed", seed)
    if x[0].dim() != 4:
        raise ValueError(f"x: expected (B, s, N, g), got "
                         f"{tuple(x[0].shape)}")
    b, s, n, g = x[0].shape
    _check_bits(bits, g)
    if packed[0].dim() != 4:
        raise ValueError(f"packed: expected (B, S, N, pw), got "
                         f"{tuple(packed[0].shape)}")
    cache = packed[0].shape[1]
    for i in range(2):
        _noise_check(u[i], seed[i])
        _check(x[i], "x", torch.float32, (b, s, n, g))
        if u[i] is not None:
            _check(u[i], "u", torch.float32, (b, s, n, g))
        if seed[i] is not None:
            _check(seed[i], "seed", torch.int32, (2,))
        _check_store(packed[i], "packed", torch.uint8,
                     (b, cache, n, g * bits // 8))
        _check_store(scale[i], "scale", torch.float32, (b, cache, n))
    if packed[0].stride() != packed[1].stride() \
            or scale[0].stride() != scale[1].stride():
        raise ValueError("k's and v's stores must have the same strides")
    heads = isinstance(pos, torch.Tensor)
    if heads:
        if pos.dtype != torch.int32 or tuple(pos.shape) != (b,):
            raise ValueError(f"pos: expected a ({b},) int32 tensor, got "
                             f"{pos.dtype} {tuple(pos.shape)}")
        if pos.device != packed[0].device:
            raise ValueError(f"pos: on {pos.device}, the stores on "
                             f"{packed[0].device}")
        if s > cache:
            raise ValueError(f"{s} rows do not fit a store of {cache}")
    elif not 0 <= pos <= pos + s <= cache:
        raise ValueError(f"rows [{pos}, {pos + s}) do not fit a store of "
                         f"{cache}")
    rows = b * s * n
    if not _on_cuda(*x, *packed, *scale, *u, *seed):
        ref.quantize_pack_into_ref(
            x, packed, scale, pos, bits,
            tuple(None if ui is None and si is None else
                  _plain_noise(ui, si, rows, g).reshape(b, s, n, g)
                  for ui, si in zip(u, seed)))
        return
    if rows:
        # the packed words the kernel stores are at most 4 bytes
        vec = _vec(g, *x, *u) and packed[0].stride(0) % 4 == 0 and \
            all(p.data_ptr() % 4 == 0 for p in packed)
        _launch("quantize_pack", "rt_quantize_pack", *map(_ptr, x),
                *map(_ptr, u), *map(_ptr, seed), *map(_ptr, packed),
                *map(_ptr, scale), rows, g, s * n, 0 if heads else pos * n,
                packed[0].stride(0), scale[0].stride(0),
                _ptr(pos.contiguous()) if heads else None, n, cache - s,
                bits, int(vec), *_encode_tiling(g),
                seeded=any(t is not None for t in seed))


def _div_magic(d: int) -> tuple:
    """(mul, shift) such that ``((n * mul) >> 32) >> shift == n // d``
    for every 0 <= n < 2**31, for 2 <= d < 2**31: mul = ceil(2**(31 + l)
    / d) < 2**32 and shift = l - 1, l = ceil(log2 d) (the round-up
    method of Granlund and Montgomery, PLDI'94: the error n * (mul * d -
    2**(31 + l)) / (d * 2**(31 + l)) stays under 1 / d).  The store read
    finds a value's row with it in 32-bit integer work."""
    if not 2 <= d < 2 ** 31:
        raise ValueError(f"d={d} is outside [2, 2**31)")
    lg = (d - 1).bit_length()
    return -(-(1 << (31 + lg)) // d), lg - 1


def _unpack_dequant(packed: tuple, scale: tuple, bits: int,
                    out_dtype: torch.dtype) -> tuple:
    """One launch of the store read over one or two (packed, scale) of
    one shape, on the card."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unpack_dequant writes float32 or bfloat16, "
                        f"not {out_dtype}")
    r, pw = packed[0].shape
    _check_bits(bits, 8 // bits)
    d = pw * (8 // bits)
    for p, s in zip(packed, scale):
        _check(p, "packed", torch.uint8, (r, pw))
        _check(s, "scale", torch.float32, (r, 1))
    out = tuple(torch.empty((r, d), dtype=out_dtype, device=p.device)
                for p in packed)
    if r:
        vec = _vec(d, *packed, *out)
        mul, shift = _div_magic(d) if vec else (0, 0)
        pad = (None,) * (2 - len(packed))       # one tensor: nulls
        _launch("unpack_dequant", "rt_unpack_dequant",
                *map(_ptr, packed + pad), *map(_ptr, scale + pad),
                *map(_ptr, out + pad), r, d, bits,
                int(out_dtype == torch.bfloat16), mul, shift, vec)
    return out


def unpack_dequant(packed: torch.Tensor, scale: torch.Tensor, *, bits: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """packed (R, pw) u8, scale (R, 1) f32 -> values (R, pw * 8/bits) in
    out_dtype (float32 or bfloat16)."""
    if not _on_cuda(packed, scale):
        return ref.unpack_dequant_ref(packed, scale, bits, out_dtype)
    return _unpack_dequant((packed,), (scale,), bits, out_dtype)[0]


def unpack_dequant_pair(packed, scale, *, bits: int,
                        out_dtype: torch.dtype = torch.float32) -> tuple:
    """The store read of k and v in one launch: pairs of packed (R, pw)
    u8 and scale (R, 1) f32 of one shape -> a pair of values (R, pw *
    8/bits) in out_dtype, each what `unpack_dequant` returns."""
    packed, scale = _pair("packed", packed), _pair("scale", scale)
    if not _on_cuda(*packed, *scale):
        return ref.unpack_dequant_pair_ref(packed, scale, bits, out_dtype)
    return _unpack_dequant(packed, scale, bits, out_dtype)


def quantize_pack_scaled(x: torch.Tensor, scale: torch.Tensor,
                         u: Optional[torch.Tensor] = None, *,
                         bits: int) -> torch.Tensor:
    """x (R, d) f32 against the given row scale (R, 1) f32 (clamped at
    eps in the kernel too); u optional uniform noise (R, d).  Returns
    packed (R, d*bits/8) u8."""
    if not _on_cuda(x, scale, u):
        return ref.quantize_pack_scaled_ref(x, scale, bits, u)
    r, d = x.shape
    _check_bits(bits, d)
    _check(x, "x", torch.float32, (r, d))
    _check(scale, "scale", torch.float32, (r, 1))
    _check_noise(u, None, r, d)
    packed = torch.empty((r, d * bits // 8), dtype=torch.uint8,
                         device=x.device)
    if r:
        _launch("quantize_pack_scaled", "rt_quantize_pack_scaled",
                x.data_ptr(), scale.data_ptr(), _ptr(u), packed.data_ptr(),
                r, d, bits, _vec(d, x, u, packed))
    return packed


def unpack_codes(packed: torch.Tensor, *, bits: int) -> torch.Tensor:
    """packed (R, pw) u8 -> int32 codes (R, pw * 8/bits)."""
    if not _on_cuda(packed):
        return ref.unpack_codes_ref(packed, bits)
    r, pw = packed.shape
    _check_bits(bits, 8 // bits)
    d = pw * (8 // bits)
    _check(packed, "packed", torch.uint8, (r, pw))
    out = torch.empty((r, d), dtype=torch.int32, device=packed.device)
    if r * d:
        _launch("unpack_codes", "rt_unpack_codes", packed.data_ptr(),
                out.data_ptr(), r * d, bits, _vec(r * d, packed, out))
    return out


def quantize_codes_scaled(x: torch.Tensor, scale: torch.Tensor,
                          u: Optional[torch.Tensor] = None, *, bits: int,
                          pack: bool = False,
                          seed: Optional[torch.Tensor] = None):
    """x (R, d) f32 against the given row scale (R, 1) f32 (clamped at
    eps); u optional uniform noise (R, d), or seed (2,) int32.  Returns
    int32 codes (R, d), or (packed (R, d*bits/8) u8, codes) with
    ``pack``."""
    _noise_check(u, seed)
    if not _on_cuda(x, scale, u, seed):
        return ref.quantize_codes_scaled_ref(
            x, scale, bits, _plain_noise(u, seed, *x.shape), pack)
    r, d = x.shape
    _check_bits(bits, d)
    _check(x, "x", torch.float32, (r, d))
    _check(scale, "scale", torch.float32, (r, 1))
    _check_noise(u, seed, r, d)
    codes = torch.empty((r, d), dtype=torch.int32, device=x.device)
    packed = torch.empty((r, d * bits // 8), dtype=torch.uint8,
                         device=x.device) if pack else None
    if r:
        _launch("quantize_codes_scaled", "rt_quantize_codes_scaled",
                x.data_ptr(), scale.data_ptr(), _ptr(u), _ptr(seed),
                codes.data_ptr(), _ptr(packed), r, d, bits,
                _vec(d, x, u, codes, packed), seeded=seed is not None)
    return (packed, codes) if pack else codes


def dequant_sum_mean(total: torch.Tensor, scale: torch.Tensor, *,
                     bits: int, n: int) -> torch.Tensor:
    """total (R, d) int32 code sum over n workers, scale (R, 1) f32
    shared.  Returns the mean (R, d) f32."""
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"n must be a positive int, got {n!r}")
    if not _on_cuda(total, scale):
        return ref.dequant_sum_mean_ref(total, scale, bits, n)
    r, d = total.shape
    if bits not in KERNEL_BITS:
        raise ValueError(f"the kernels implement bits {KERNEL_BITS}, "
                         f"got {bits}")
    _check(total, "total", torch.int32, (r, d))
    _check(scale, "scale", torch.float32, (r, 1))
    out = torch.empty((r, d), dtype=torch.float32, device=total.device)
    if r:
        _launch("dequant_sum_mean", "rt_dequant_sum_mean", total.data_ptr(),
                scale.data_ptr(), out.data_ptr(), r, d,
                float(n * Q.levels(bits)), Q.sum_mean_factor(bits, n),
                _vec(d, total, out))
    return out


def _check_sum_width(bits: int, n: int, d: int) -> int:
    """The sums' wire width, checking bits and that no packed byte
    straddles two rows."""
    if bits not in KERNEL_BITS:
        raise ValueError(f"the kernels implement bits {KERNEL_BITS}, "
                         f"got {bits}")
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"n must be a positive int, got {n!r}")
    sw = Q.sum_wire_bits(bits, n)
    if sw <= 8 and d % (8 // sw):
        raise ValueError(f"d={d} is not a multiple of {8 // sw} sums per "
                         f"byte at {sw} bits")
    return sw


def unpack_accumulate(packed: torch.Tensor, acc: torch.Tensor, *,
                      bits: int) -> torch.Tensor:
    """packed (R, pw) u8 codes, acc (R, pw * 8/bits) int32.  Returns
    ``acc + unpack(packed)`` (R, d) int32, a new tensor."""
    if not _on_cuda(packed, acc):
        return ref.unpack_accumulate_ref(packed, acc, bits)
    r, pw = packed.shape
    _check_bits(bits, 8 // bits)
    d = pw * (8 // bits)
    _check(packed, "packed", torch.uint8, (r, pw))
    _check(acc, "acc", torch.int32, (r, d))
    out = torch.empty_like(acc)
    if r * d:
        _launch("unpack_accumulate", "rt_unpack_accumulate",
                packed.data_ptr(), acc.data_ptr(), out.data_ptr(), r * d,
                bits, _vec(r * d, packed, acc, out))
    return out


def pack_sums(total: torch.Tensor, *, bits: int, n: int) -> torch.Tensor:
    """total (R, d) int32 code sums over n workers, each in ``[0,
    2**sw)`` with sw = ``sum_wire_bits(bits, n)``.  Returns the u8
    payload (R, ``sum_packed_width(d, bits, n)``)."""
    if not _on_cuda(total):
        return ref.pack_sums_ref(total, bits, n)
    r, d = total.shape
    sw = _check_sum_width(bits, n, d)
    _check(total, "total", torch.int32, (r, d))
    out = torch.empty((r, Q.sum_packed_width(d, bits, n)), dtype=torch.uint8,
                      device=total.device)
    if r * d:
        _launch("pack_sums", "rt_pack_sums", total.data_ptr(),
                out.data_ptr(), r * d, sw, _vec(r * d, total, out))
    return out


def unpack_sums(packed: torch.Tensor, *, bits: int, n: int) -> torch.Tensor:
    """Inverse of `pack_sums`: packed (R, pw) u8 -> (R, d) int32 sums
    over the full packed width."""
    if not _on_cuda(packed):
        return ref.unpack_sums_ref(packed, bits, n)
    r, pw = packed.shape
    if bits not in KERNEL_BITS:
        raise ValueError(f"the kernels implement bits {KERNEL_BITS}, "
                         f"got {bits}")
    sw = Q.sum_wire_bits(bits, n)
    if sw > 8 and pw % (sw // 8):
        raise ValueError(f"packed width {pw} is not a multiple of "
                         f"{sw // 8} bytes a sum at {sw} bits")
    d = pw * (8 // sw) if sw <= 8 else pw // (sw // 8)
    _check(packed, "packed", torch.uint8, (r, pw))
    out = torch.empty((r, d), dtype=torch.int32, device=packed.device)
    if r * d:
        _launch("unpack_sums", "rt_unpack_sums", packed.data_ptr(),
                out.data_ptr(), r * d, sw, _vec(r * d, packed, out))
    return out
