// AQ-SGD boundary codec kernels for Hopper (sm_90a).
//
// Replaces eleven Pallas TPU kernels of src/repro/kernels/quant_pack.py:
//   delta_quantize_pack        (quant_pack.py:190, _dqp_kernel)  -> encode_rows<BITS, true>
//   dequant_unpack_accumulate  (quant_pack.py:239, _dua_kernel)  -> decode_flat<BITS, true, float>
//   quantize_pack              (quant_pack.py:278, _qp_kernel)   -> encode_rows<BITS, false>
//   unpack_dequant             (quant_pack.py:320, _ud_kernel)   -> decode_flat<BITS, false, OutT>
//   quantize_pack_scaled       (quant_pack.py:363, _qps_kernel)  -> codes_scaled_flat<BITS, false, true>
//   unpack_codes               (quant_pack.py:399, _uc_kernel)   -> unpack_sums_flat<BITS>
//   dequant_sum_mean           (quant_pack.py:434, _dsm_kernel)  -> sum_mean_flat
//   quantize_codes_scaled      (quant_pack.py:480, _qcs_kernel)  -> codes_scaled_flat<BITS, true, PACK>
//   unpack_accumulate          (quant_pack.py:528, _ua_kernel)   -> unpack_accumulate_flat<BITS>
//   pack_sums                  (quant_pack.py:579, _ps_kernel)   -> pack_sums_flat<SW>
//   unpack_sums                (quant_pack.py:620, _us_kernel)   -> unpack_sums_flat<SW>
// and the seed= path of the first, third and sixth (quant_pack.py:84
// _oncore_uniform, with _noise_arg :100 and _kernel_noise :111):
// encode_rows and codes_scaled_flat take a (2,) int32 seed in device
// memory in place of a noise tensor and draw the uniforms of
// stochastic rounding themselves (philox4x32_10 below).
// The first four are the activation boundary's codecs; the next two are
// the gradient wire's legacy pair (boundary.encode_with_scale and
// decode_codes: packed codes against a shared, given row scale, and
// packed codes back to int32), which no trainer runs; then the wire's
// sender (int32 codes against that scale, optionally packed in the same
// pass) and receiver (mean from an int32 code sum); the last three are
// the compressed ring's integer steps: the reduce-scatter's accumulate
// of an arriving packed segment into int32 code sums, the all-gather's
// packing of those sums at SW = sum_wire_bits(bits, n) bits (2, 4, 8,
// 16 or 32), and its inverse.  The legacy pair needs no kernel of its
// own: its sender is the wire's sender with the int32 codes store
// compiled out (CODES = false), and packed b-bit codes are the sums of
// one worker, so its receiver is the sums' unpacker at SW = BITS.
//
// What bounds them: bytes.  Each is a row codec doing ~10 float
// operations per element, far below the ~20 operations per byte the
// H100's float32 units need before arithmetic, not memory, is the
// limit.  The least time is therefore the bytes moved (each input read
// once, each output written once) over 3.35 TB/s: about 0.05 us for the
// decode hop (R=8, d=1600) -- a launch-latency-bound call -- about
// 3 us for a KV-store read at batch 8, cache 160 (R=32000, d=64, ~10 MB),
// and about 0.6-1.6 ms for the gradient wire over a 449M-parameter
// bucket (R=877132, d=512: 4.5-12 bytes an element).  The ring's three
// kernels do no float work at all (shifts, masks, one integer add), so
// bytes bound them too: 8.5, 5 and 5 bytes an element at 4 bits, n = 2.
//
// Design: the TPU kernels hold a 128-row tile in VMEM and walk a
// sequential grid.  Here there is no tile and no order between blocks:
//   * encoders: one warp per row, 8 rows per block, a grid over rows;
//     the ragged last block is masked by whole warps.  The row absmax is
//     a warp-shuffle max (exact in any order, so the scale is
//     bit-identical), then each lane quantizes and packs whole output
//     bytes, so no atomics are needed.
//   * decoders need no reduction, so they are flat: a grid-stride loop
//     over groups of 4 elements (or over packed bytes), each thread
//     writing whole bytes and whole float4s.  The gradient wire's two
//     kernels take the row scale as an input, so they need no
//     reduction either and share that flat design.
//   * loads and stores are vectorised (float4) where d % 4 == 0 and the
//     pointers are 16-byte aligned; the wrapper decides and passes `vec`.
//   * the ring's three kernels have no scale and no reduction, and no
//     packed byte straddles two rows (the wrappers check d % (8/SW)),
//     so they are flat over the whole (rows, d) array: a grid-stride
//     loop over groups of 4 elements, one int4 of codes or sums against
//     4*SW/8 packed bytes (1, 2, 4, 8 or 16) moved as one word.  At SW
//     16 and 32 the little-endian byte split of the JAX package is the
//     same shift-and-or, in a 64-bit word (SW 16) or the int4 itself
//     (SW 32).  Without `vec` an item is one element (one sum's bytes,
//     or one output byte when packing).
//   * the sums' unpacker (B8b, and B9b at SW = bits) is a pure stream:
//     it reads SW/8 bytes and writes 4 an element.  With one 2- or
//     4-byte load a thread per int4 stored (as the accumulate still
//     has it) too few read bytes were in flight, and the reads, 1/5 of
//     the traffic at SW 8 and 1/9 at SW 4, set the pace.  Now each lane
//     loads 16 packed bytes (one uint4; a warp, 512 contiguous bytes),
//     4 such loads in flight before the first store, into its warp's
//     stage in shared memory (2 KB a warp); the warp then writes the
//     values as int4s, 512 contiguous bytes a store, each lane reading
//     its 4 values' SW/2 bytes from the stage.  (Stores straight from
//     the loading lane, 64 bytes a lane at SW 8, were far slower on the
//     H100: a warp's store then touches 32 lines.)  The grid is the
//     blocks the card holds at once (occupancy count times SMs, asked
//     once per device).  What is left is the mix: 4 of every 5 bytes
//     are writes, and at the DP bucket the kernel runs level with the
//     widening cast (PERF.md).  The values past the last whole 512-byte
//     segment are unpacked one by one in the same launch, so a call
//     stays one launch; a misaligned view takes that element path for
//     all of n.
//
// Bit parity with the JAX package (jitted jnp and the Pallas kernels):
//   * codes use rintf (round half to even, as jnp.round), never roundf;
//   * the grid coordinate is (x / s + 1) * (lv / 2) with an IEEE
//     division, clipped to [0, lv];
//   * dequantize is ((2c - lv) * s) * f32(1/lv) -- XLA rewrites the
//     division by the constant lv as that multiply under jit;
//   * accumulate is fma((2c - lv) * s, f32(1/lv), m), rounded once, as
//     XLA contracts m + dequant into one FMA;
//   * every step is an explicit _rn intrinsic, so nvcc's contraction of
//     a*b+c cannot change the rounding;
//   * stochastic rounding reads u and bumps the code when
//     u < y - floor(y), the comparison jax.random.bernoulli makes;
//   * with a seed instead of u, u is drawn here (not the TPU's bits,
//     which depend on its grid blocks; this stream depends only on the
//     element's flat index i in the (rows, d) view and the seed, so the
//     plain version draws it bit for bit, ref.py oncore_uniform_ref):
//     Philox4x32-10 of counter (lo32(i >> 2), hi32(i >> 2), 0, 0) and
//     key (seed[0], seed[1]), word i & 3, u = (word >> 8) * 2^-24.  The
//     float4 paths make one Philox call per group of 4 elements and use
//     its four words; the scalar paths make one per element.  The
//     seed is read through a pointer, as the TPU kernel reads it from
//     SMEM: no host sync, and a launch whose arguments never change
//     (a CUDA graph can capture it).  Ten rounds are ~40 integer
//     operations per 4 elements; bytes still bound the encoders.
//   * the mean of n workers is ((2T - n*lv) * s) * C with
//     C = f32(f32(1/lv) * f32(1/n)), passed in by the caller: XLA folds
//     the source's ((ic * s) / lv) / n into that one constant under jit.
//
// Every launcher returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kWarp * kRowsPerBlock;
constexpr float kEps = 1e-12f;

template <int BITS>
struct Packed4;  // the bytes that hold 4 codes of BITS bits
template <> struct Packed4<2> { using T = uint8_t; };
template <> struct Packed4<4> { using T = uint16_t; };
template <> struct Packed4<8> { using T = uint32_t; };

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

// One code on the b-bit grid.  u < 0 selects round-to-nearest-even
// (callers pass -1 when there is no noise input; a uniform draw is >= 0).
template <int BITS>
__device__ __forceinline__ uint32_t quant_code(float x, float s, float u,
                                               bool stochastic) {
  constexpr float lv = float((1 << BITS) - 1);
  // (x / s + 1) * (0.5 * lv): IEEE division, then add, then multiply,
  // each rounded on its own as jnp computes them
  float y = __fmul_rn(__fadd_rn(__fdiv_rn(x, s), 1.0f), 0.5f * lv);
  y = fminf(fmaxf(y, 0.0f), lv);
  float c;
  if (stochastic) {
    const float lo = floorf(y);
    c = (u < __fsub_rn(y, lo)) ? __fadd_rn(lo, 1.0f) : lo;
  } else {
    c = rintf(y);  // ties to even, as jnp.round
  }
  return static_cast<uint32_t>(c);
}

// (2c - lv) * s, then * f32(1/lv) (or fused into m with one rounding)
template <int BITS, bool ACC>
__device__ __forceinline__ float dequant(uint32_t c, float s, float m) {
  constexpr int lv = (1 << BITS) - 1;
  const float rcp = __fdiv_rn(1.0f, float(lv));
  const float p = __fmul_rn(float(int(2 * c) - lv), s);
  return ACC ? __fmaf_rn(p, rcp, m) : __fmul_rn(p, rcp);
}

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32): 10
// rounds, the key bumped by the Weyl constants between rounds
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// 24 high bits of a word as a uniform on {0, ..., 2^24 - 1} / 2^24 (exact)
__device__ __forceinline__ float word_uniform(uint32_t w) {
  return __uint2float_rn(w >> 8) * (1.0f / 16777216.0f);
}

// the uniforms of elements 4g .. 4g+3 of the flat (rows, d) view
__device__ __forceinline__ float4 seeded_uniform4(int64_t g, uint32_t k0,
                                                  uint32_t k1) {
  const uint64_t c = static_cast<uint64_t>(g);
  const uint4 w = philox4x32_10(
      make_uint4(uint32_t(c), uint32_t(c >> 32), 0u, 0u), k0, k1);
  return make_float4(word_uniform(w.x), word_uniform(w.y), word_uniform(w.z),
                     word_uniform(w.w));
}

// the uniform of element i of the flat (rows, d) view
__device__ __forceinline__ float seeded_uniform(int64_t i, uint32_t k0,
                                                uint32_t k1) {
  const float4 v = seeded_uniform4(i >> 2, k0, k1);
  switch (i & 3) {
    case 0: return v.x;
    case 1: return v.y;
    case 2: return v.z;
    default: return v.w;
  }
}

template <typename OutT> __device__ __forceinline__ OutT from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch casts
}

// ---------------------------------------------------------------------------
// Encoders: x (or a - m) -> packed codes + row scale [+ m_new]
// ---------------------------------------------------------------------------

template <int BITS, bool DELTA>
__global__ void __launch_bounds__(kThreads)
encode_rows(const float* __restrict__ a, const float* __restrict__ m,
            const float* __restrict__ u, const int32_t* __restrict__ seed,
            uint8_t* __restrict__ packed,
            float* __restrict__ scale, float* __restrict__ m_new,
            int64_t rows, int64_t d, int vec) {
  constexpr int k = 8 / BITS;  // codes per byte
  const int lane = threadIdx.x % kWarp;
  const int64_t row = int64_t(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // whole warps leave together: shuffles stay full
  const float* ar = a + row * d;
  const float* mr = DELTA ? m + row * d : nullptr;
  const float* ur = u ? u + row * d : nullptr;
  uint8_t* pr = packed + row * (d / k);
  float* nr = DELTA ? m_new + row * d : nullptr;
  const bool stoch = u != nullptr || seed != nullptr;
  const uint32_t k0 = seed ? uint32_t(seed[0]) : 0u;
  const uint32_t k1 = seed ? uint32_t(seed[1]) : 0u;

  // pass 1: row absmax of the delta (or of x)
  float mx = 0.0f;
  if (vec) {
    const float4* a4 = reinterpret_cast<const float4*>(ar);
    const float4* m4 = reinterpret_cast<const float4*>(mr);
    for (int64_t g = lane; g < d / 4; g += kWarp) {
      float4 x = a4[g];
      if (DELTA) x = sub4(x, m4[g]);
      mx = fmaxf(mx, abs_max4(x));
    }
  } else {
    for (int64_t i = lane; i < d; i += kWarp) {
      const float x = DELTA ? __fsub_rn(ar[i], mr[i]) : ar[i];
      mx = fmaxf(mx, fabsf(x));
    }
  }
  const float s = fmaxf(warp_max(mx), kEps);
  if (lane == 0) scale[row] = s;

  // pass 2: quantize, pack whole bytes, advance the buffer
  if (vec) {
    using P = typename Packed4<BITS>::T;
    const float4* a4 = reinterpret_cast<const float4*>(ar);
    const float4* m4 = reinterpret_cast<const float4*>(mr);
    const float4* u4 = reinterpret_cast<const float4*>(ur);
    for (int64_t g = lane; g < d / 4; g += kWarp) {
      float4 mm = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 x = a4[g];
      if (DELTA) {
        mm = m4[g];
        x = sub4(x, mm);
      }
      const float4 uu = ur     ? u4[g]
                        : seed ? seeded_uniform4(row * (d / 4) + g, k0, k1)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t c0 = quant_code<BITS>(x.x, s, uu.x, stoch);
      const uint32_t c1 = quant_code<BITS>(x.y, s, uu.y, stoch);
      const uint32_t c2 = quant_code<BITS>(x.z, s, uu.z, stoch);
      const uint32_t c3 = quant_code<BITS>(x.w, s, uu.w, stoch);
      // 4 codes fill 4*BITS/8 bytes, little-endian: code j at bit j*BITS
      const uint32_t word = c0 | (c1 << BITS) | (c2 << (2 * BITS)) |
                            (c3 << (3 * BITS));
      reinterpret_cast<P*>(pr)[g] = static_cast<P>(word);
      if (DELTA) {
        reinterpret_cast<float4*>(nr)[g] = make_float4(
            dequant<BITS, true>(c0, s, mm.x), dequant<BITS, true>(c1, s, mm.y),
            dequant<BITS, true>(c2, s, mm.z), dequant<BITS, true>(c3, s, mm.w));
      }
    }
  } else {
    for (int64_t j = lane; j < d / k; j += kWarp) {  // one output byte
      uint32_t byte = 0;
#pragma unroll
      for (int t = 0; t < k; ++t) {
        const int64_t i = j * k + t;
        const float mm = DELTA ? mr[i] : 0.0f;
        const float x = DELTA ? __fsub_rn(ar[i], mm) : ar[i];
        const float uu = ur     ? ur[i]
                         : seed ? seeded_uniform(row * d + i, k0, k1)
                                : 0.0f;
        const uint32_t c = quant_code<BITS>(x, s, uu, stoch);
        byte |= c << (t * BITS);
        if (DELTA) nr[i] = dequant<BITS, true>(c, s, mm);
      }
      pr[j] = static_cast<uint8_t>(byte);
    }
  }
}

// ---------------------------------------------------------------------------
// Decoders: packed codes + row scale [+ m] -> values
// ---------------------------------------------------------------------------

template <int BITS, bool ACC, typename OutT>
__global__ void __launch_bounds__(256)
decode_flat(const uint8_t* __restrict__ packed, const float* __restrict__ scale,
            const float* __restrict__ m, OutT* __restrict__ out, int64_t rows,
            int64_t d, int vec) {
  constexpr int k = 8 / BITS;
  constexpr uint32_t mask = (1u << BITS) - 1u;
  const int64_t n = rows * d;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    // group g = elements 4g..4g+3 of the flat (rows, d) array; with
    // d % 4 == 0 a group never straddles two rows
    using P = typename Packed4<BITS>::T;
    for (int64_t g = first; g < n / 4; g += stride) {
      const float s = scale[(4 * g) / d];
      const uint32_t word = reinterpret_cast<const P*>(packed)[g];
      float mm[4] = {0.f, 0.f, 0.f, 0.f};
      if (ACC) {
        const float4 m4 = reinterpret_cast<const float4*>(m)[g];
        mm[0] = m4.x; mm[1] = m4.y; mm[2] = m4.z; mm[3] = m4.w;
      }
      float v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        v[t] = dequant<BITS, ACC>((word >> (t * BITS)) & mask, s, mm[t]);
      OutT* o = out + 4 * g;
      if constexpr (sizeof(OutT) == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) o[t] = from_float<OutT>(v[t]);
      }
    }
  } else {
    // one packed byte = k elements of one row (the wrapper checks d % k == 0)
    for (int64_t j = first; j < n / k; j += stride) {
      const int64_t i0 = j * k;
      const float s = scale[i0 / d];
      const uint32_t byte = packed[j];
#pragma unroll
      for (int t = 0; t < k; ++t) {
        const float mm = ACC ? m[i0 + t] : 0.0f;
        out[i0 + t] = from_float<OutT>(
            dequant<BITS, ACC>((byte >> (t * BITS)) & mask, s, mm));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Gradient wire: codes against a given row scale; mean from a code sum
// ---------------------------------------------------------------------------

// int32 codes of x against max(s, eps) with CODES, the packed u8
// payload with PACK (at least one of the two), one flat pass: groups of
// 4 elements with vec, else one packed byte's worth (8/BITS elements)
// per item.
template <int BITS, bool CODES, bool PACK>
__global__ void __launch_bounds__(256)
codes_scaled_flat(const float* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ u, const int32_t* __restrict__ seed,
                  int32_t* __restrict__ codes,
                  uint8_t* __restrict__ packed, int64_t rows, int64_t d,
                  int vec) {
  constexpr int k = 8 / BITS;
  const int64_t n = rows * d;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool stoch = u != nullptr || seed != nullptr;
  const uint32_t k0 = seed ? uint32_t(seed[0]) : 0u;
  const uint32_t k1 = seed ? uint32_t(seed[1]) : 0u;
  if (vec) {
    using P = typename Packed4<BITS>::T;
    for (int64_t g = first; g < n / 4; g += stride) {
      const float s = fmaxf(scale[(4 * g) / d], kEps);
      const float4 xx = reinterpret_cast<const float4*>(x)[g];
      const float4 uu = u    ? reinterpret_cast<const float4*>(u)[g]
                        : seed ? seeded_uniform4(g, k0, k1)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t c0 = quant_code<BITS>(xx.x, s, uu.x, stoch);
      const uint32_t c1 = quant_code<BITS>(xx.y, s, uu.y, stoch);
      const uint32_t c2 = quant_code<BITS>(xx.z, s, uu.z, stoch);
      const uint32_t c3 = quant_code<BITS>(xx.w, s, uu.w, stoch);
      if (CODES)
        reinterpret_cast<int4*>(codes)[g] =
            make_int4(int(c0), int(c1), int(c2), int(c3));
      if (PACK) {
        const uint32_t word = c0 | (c1 << BITS) | (c2 << (2 * BITS)) |
                              (c3 << (3 * BITS));
        reinterpret_cast<P*>(packed)[g] = static_cast<P>(word);
      }
    }
  } else {
    // one packed byte = k elements of one row (the wrapper checks d % k)
    for (int64_t j = first; j < n / k; j += stride) {
      const int64_t i0 = j * k;
      const float s = fmaxf(scale[i0 / d], kEps);
      uint32_t byte = 0;
#pragma unroll
      for (int t = 0; t < k; ++t) {
        const float uu = u    ? u[i0 + t]
                         : seed ? seeded_uniform(i0 + t, k0, k1)
                                : 0.0f;
        const uint32_t c = quant_code<BITS>(x[i0 + t], s, uu, stoch);
        if (CODES) codes[i0 + t] = int(c);
        byte |= c << (t * BITS);
      }
      if (PACK) packed[j] = static_cast<uint8_t>(byte);
    }
  }
}

__device__ __forceinline__ float sum_mean(int32_t t, float s, float nlv,
                                          float c) {
  // (T * 2 - n*lv) is integer-exact in f32, then * s, then * C
  const float ic = __fsub_rn(__fmul_rn(__int2float_rn(t), 2.0f), nlv);
  return __fmul_rn(__fmul_rn(ic, s), c);
}

// mean (rows, d) f32 from an int32 code sum over n workers
__global__ void __launch_bounds__(256)
sum_mean_flat(const int32_t* __restrict__ total,
              const float* __restrict__ scale, float* __restrict__ out,
              int64_t rows, int64_t d, float nlv, float c, int vec) {
  const int64_t n = rows * d;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    for (int64_t g = first; g < n / 4; g += stride) {
      const float s = scale[(4 * g) / d];
      const int4 t = reinterpret_cast<const int4*>(total)[g];
      reinterpret_cast<float4*>(out)[g] =
          make_float4(sum_mean(t.x, s, nlv, c), sum_mean(t.y, s, nlv, c),
                      sum_mean(t.z, s, nlv, c), sum_mean(t.w, s, nlv, c));
    }
  } else {
    for (int64_t i = first; i < n; i += stride)
      out[i] = sum_mean(total[i], scale[i / d], nlv, c);
  }
}

// ---------------------------------------------------------------------------
// The compressed ring: accumulate packed codes into int32 sums; pack and
// unpack the sums at SW bits
// ---------------------------------------------------------------------------

// the SW/2 bytes that hold 4 values of SW bits (SW <= 16)
template <int NB> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<8> { using T = unsigned long long; };

// values 4g..4g+3 of a packed SW-bit stream, as an int4
template <int SW>
__device__ __forceinline__ int4 unpack4(const uint8_t* __restrict__ p,
                                        int64_t g) {
  if constexpr (SW == 32) {
    return reinterpret_cast<const int4*>(p)[g];
  } else {
    constexpr unsigned long long mask = (1ull << SW) - 1ull;
    using W = typename Word<SW / 2>::T;
    const unsigned long long w = reinterpret_cast<const W*>(p)[g];
    return make_int4(int(w & mask), int((w >> SW) & mask),
                     int((w >> (2 * SW)) & mask), int((w >> (3 * SW)) & mask));
  }
}

// value i of a packed SW-bit stream
template <int SW>
__device__ __forceinline__ int unpack1(const uint8_t* __restrict__ p,
                                       int64_t i) {
  if constexpr (SW <= 8) {
    constexpr int k = 8 / SW;
    return int((uint32_t(p[i / k]) >> ((i % k) * SW)) & ((1u << SW) - 1u));
  } else {
    constexpr int nb = SW / 8;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < nb; ++b) v |= uint32_t(p[i * nb + b]) << (8 * b);
    return int(v);
  }
}

// out = acc + unpack(packed): n int32 elements, BITS-bit codes
template <int BITS>
__global__ void __launch_bounds__(256)
unpack_accumulate_flat(const uint8_t* __restrict__ packed,
                       const int32_t* __restrict__ acc,
                       int32_t* __restrict__ out, int64_t n, int vec) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    for (int64_t g = first; g < n / 4; g += stride) {
      const int4 c = unpack4<BITS>(packed, g);
      const int4 a = reinterpret_cast<const int4*>(acc)[g];
      reinterpret_cast<int4*>(out)[g] =
          make_int4(a.x + c.x, a.y + c.y, a.z + c.z, a.w + c.w);
    }
  } else {
    for (int64_t i = first; i < n; i += stride)
      out[i] = acc[i] + unpack1<BITS>(packed, i);
  }
}

// n int32 sums -> n*SW/8 packed bytes, little-endian within each word
template <int SW>
__global__ void __launch_bounds__(256)
pack_sums_flat(const int32_t* __restrict__ total, uint8_t* __restrict__ out,
               int64_t n, int vec) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    for (int64_t g = first; g < n / 4; g += stride) {
      const int4 t = reinterpret_cast<const int4*>(total)[g];
      if constexpr (SW == 32) {
        reinterpret_cast<int4*>(out)[g] = t;
      } else {
        constexpr unsigned long long mask = (1ull << SW) - 1ull;
        const unsigned long long w =
            (static_cast<unsigned long long>(uint32_t(t.x)) & mask) |
            ((static_cast<unsigned long long>(uint32_t(t.y)) & mask) << SW) |
            ((static_cast<unsigned long long>(uint32_t(t.z)) & mask)
             << (2 * SW)) |
            ((static_cast<unsigned long long>(uint32_t(t.w)) & mask)
             << (3 * SW));
        using W = typename Word<SW / 2>::T;
        reinterpret_cast<W*>(out)[g] = static_cast<W>(w);
      }
    }
  } else {
    const int64_t nbytes = n * SW / 8;
    for (int64_t j = first; j < nbytes; j += stride) {  // one output byte
      uint32_t byte = 0;
      if constexpr (SW <= 8) {
        constexpr int k = 8 / SW;
#pragma unroll
        for (int t = 0; t < k; ++t)
          byte |= (uint32_t(total[j * k + t]) & ((1u << SW) - 1u))
                  << (t * SW);
      } else {
        constexpr int nb = SW / 8;
        byte = (uint32_t(total[j / nb]) >> (8 * (j % nb))) & 0xFFu;
      }
      out[j] = static_cast<uint8_t>(byte);
    }
  }
}

// n*SW/8 packed bytes -> n int32 sums.  vec: a warp moves 512-byte
// segments of the packed stream, UNROLL at a time: each lane loads 16
// bytes of each (one uint4; the warp's loads are 512 contiguous bytes)
// into the warp's stage in shared memory, then the warp writes the
// segment's 128 * 32/SW values as int4s, 512 contiguous bytes a store,
// each lane reading its 4 values' SW/2 bytes from the stage (unpack4).
// The values past the last whole segment (fewer than 128 * 32/SW) are
// unpacked one by one in the same launch.
template <int SW>
__global__ void __launch_bounds__(256)
unpack_sums_flat(const uint8_t* __restrict__ packed,
                 int32_t* __restrict__ out, int64_t n, int vec) {
  constexpr int SEG = 128 * 32 / SW;      // values in 512 packed bytes
  constexpr int UNROLL = 4;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t first = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    __shared__ uint4 stage[256 / 32][UNROLL][32];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int64_t segs = n / SEG, nwarps = stride / 32;
    const uint4* src = reinterpret_cast<const uint4*>(packed);
    int4* dst = reinterpret_cast<int4*>(out);
    for (int64_t s = first / 32; s < segs; s += UNROLL * nwarps) {
      const int m = int((segs - s + nwarps - 1) / nwarps);  // this warp's
      const int u_end = m < UNROLL ? m : UNROLL;            // segments here
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (u < u_end)
          stage[warp][u][lane] = __ldcs(src + (s + u * nwarps) * 32 + lane);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (u < u_end) {
          const uint8_t* seg = reinterpret_cast<const uint8_t*>(stage[warp][u]);
          int4* o = dst + (s + u * nwarps) * (SEG / 4);
#pragma unroll
          for (int k = 0; k < SEG / 4 / 32; ++k)
            o[k * 32 + lane] = unpack4<SW>(seg, k * 32 + lane);
        }
      }
      __syncwarp();
    }
    done = segs * SEG;
  }
  for (int64_t i = done + first; i < n; i += stride)
    out[i] = unpack1<SW>(packed, i);
}

int encode_blocks(int64_t rows) {
  return int((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

int decode_blocks(int64_t items) {
  const int64_t b = (items + 255) / 256;
  return int(b < 132 * 32 ? b : 132 * 32);  // grid-stride beyond 32 blocks/SM
}

template <bool DELTA>
int launch_encode(const float* a, const float* m, const float* u,
                  const int32_t* seed, uint8_t* packed, float* scale,
                  float* m_new, int64_t rows, int64_t d, int bits, int vec,
                  cudaStream_t st) {
  const dim3 grid(encode_blocks(rows)), block(kThreads);
  switch (bits) {
    case 2: encode_rows<2, DELTA><<<grid, block, 0, st>>>(a, m, u, seed, packed, scale, m_new, rows, d, vec); break;
    case 4: encode_rows<4, DELTA><<<grid, block, 0, st>>>(a, m, u, seed, packed, scale, m_new, rows, d, vec); break;
    case 8: encode_rows<8, DELTA><<<grid, block, 0, st>>>(a, m, u, seed, packed, scale, m_new, rows, d, vec); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

template <bool ACC, typename OutT>
int launch_decode(const uint8_t* packed, const float* scale, const float* m,
                  OutT* out, int64_t rows, int64_t d, int bits, int vec,
                  cudaStream_t st) {
  const int64_t items = vec ? rows * d / 4 : rows * d / (8 / bits);
  const dim3 grid(decode_blocks(items)), block(256);
  switch (bits) {
    case 2: decode_flat<2, ACC, OutT><<<grid, block, 0, st>>>(packed, scale, m, out, rows, d, vec); break;
    case 4: decode_flat<4, ACC, OutT><<<grid, block, 0, st>>>(packed, scale, m, out, rows, d, vec); break;
    case 8: decode_flat<8, ACC, OutT><<<grid, block, 0, st>>>(packed, scale, m, out, rows, d, vec); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

template <bool CODES, bool PACK>
int launch_codes_scaled(const float* x, const float* s, const float* u,
                        const int32_t* seed, int32_t* codes,
                        uint8_t* packed, int64_t rows, int64_t d, int bits,
                        int vec, cudaStream_t st) {
  const int64_t items = vec ? rows * d / 4 : rows * d / (8 / bits);
  const dim3 grid(decode_blocks(items)), block(256);
  switch (bits) {
    case 2: codes_scaled_flat<2, CODES, PACK><<<grid, block, 0, st>>>(x, s, u, seed, codes, packed, rows, d, vec); break;
    case 4: codes_scaled_flat<4, CODES, PACK><<<grid, block, 0, st>>>(x, s, u, seed, codes, packed, rows, d, vec); break;
    case 8: codes_scaled_flat<8, CODES, PACK><<<grid, block, 0, st>>>(x, s, u, seed, codes, packed, rows, d, vec); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int launch_unpack_accumulate(const uint8_t* packed, const int32_t* acc,
                             int32_t* out, int64_t n, int bits, int vec,
                             cudaStream_t st) {
  const dim3 grid(decode_blocks(vec ? n / 4 : n)), block(256);
  switch (bits) {
    case 2: unpack_accumulate_flat<2><<<grid, block, 0, st>>>(packed, acc, out, n, vec); break;
    case 4: unpack_accumulate_flat<4><<<grid, block, 0, st>>>(packed, acc, out, n, vec); break;
    case 8: unpack_accumulate_flat<8><<<grid, block, 0, st>>>(packed, acc, out, n, vec); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

int launch_pack_sums(const int32_t* total, uint8_t* out, int64_t n, int sw,
                     int vec, cudaStream_t st) {
  const dim3 grid(decode_blocks(vec ? n / 4 : n * sw / 8)), block(256);
  switch (sw) {
    case 2: pack_sums_flat<2><<<grid, block, 0, st>>>(total, out, n, vec); break;
    case 4: pack_sums_flat<4><<<grid, block, 0, st>>>(total, out, n, vec); break;
    case 8: pack_sums_flat<8><<<grid, block, 0, st>>>(total, out, n, vec); break;
    case 16: pack_sums_flat<16><<<grid, block, 0, st>>>(total, out, n, vec); break;
    case 32: pack_sums_flat<32><<<grid, block, 0, st>>>(total, out, n, vec); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// the blocks of 256 threads of `kernel` the card holds at once, asked
// once per device
template <typename K>
cudaError_t resident_blocks(K kernel, int* cache, int& blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!cache[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          256, 0);
    if (err != cudaSuccess) return err;
    cache[dev] = sms * per_sm;
  }
  blocks = cache[dev];
  return cudaSuccess;
}

// a grid of at most the resident blocks; a warp walks the segments
// UNROLL at a time
template <int SW>
int launch_unpack_sums_sw(const uint8_t* packed, int32_t* out, int64_t n,
                          int vec, cudaStream_t st) {
  static int cache[64] = {};
  int resident = 0;
  const cudaError_t err = resident_blocks(unpack_sums_flat<SW>, cache,
                                          resident);
  if (err != cudaSuccess) return int(err);
  const int64_t items = vec ? n / (128 / SW) : n;   // 16-byte groups
  const int64_t want = (items + 255) / 256;
  const int blocks = int(want < 1 ? 1 : want < resident ? want : resident);
  unpack_sums_flat<SW><<<blocks, 256, 0, st>>>(packed, out, n, vec);
  return int(cudaGetLastError());
}

int launch_unpack_sums(const uint8_t* packed, int32_t* out, int64_t n,
                       int sw, int vec, cudaStream_t st) {
  switch (sw) {
    case 2: return launch_unpack_sums_sw<2>(packed, out, n, vec, st);
    case 4: return launch_unpack_sums_sw<4>(packed, out, n, vec, st);
    case 8: return launch_unpack_sums_sw<8>(packed, out, n, vec, st);
    case 16: return launch_unpack_sums_sw<16>(packed, out, n, vec, st);
    case 32: return launch_unpack_sums_sw<32>(packed, out, n, vec, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// a, m, u: (rows, d) f32; seed: (2,) i32 (u and seed null: round to
// nearest; u wins when both are given); packed: (rows, d*bits/8) u8;
// scale: (rows,) f32; m_new: (rows, d) f32
int rt_delta_quantize_pack(const void* a, const void* m, const void* u,
                           const void* seed, void* packed, void* scale,
                           void* m_new, long long rows, long long d,
                           int bits, int vec, void* stream) {
  return launch_encode<true>(
      static_cast<const float*>(a), static_cast<const float*>(m),
      static_cast<const float*>(u), static_cast<const int32_t*>(seed),
      static_cast<uint8_t*>(packed), static_cast<float*>(scale),
      static_cast<float*>(m_new), rows, d, bits, vec,
      static_cast<cudaStream_t>(stream));
}

// packed (rows, d*bits/8) u8, scale (rows,) f32, m (rows, d) f32 -> out f32
int rt_dequant_unpack_accumulate(const void* packed, const void* scale,
                                 const void* m, void* out, long long rows,
                                 long long d, int bits, int vec,
                                 void* stream) {
  return launch_decode<true, float>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
      static_cast<const float*>(m), static_cast<float*>(out), rows, d, bits,
      vec, static_cast<cudaStream_t>(stream));
}

// x, u: (rows, d) f32, seed (2,) i32 (either or both null) -> packed
// u8, scale (rows,) f32
int rt_quantize_pack(const void* x, const void* u, const void* seed,
                     void* packed, void* scale, long long rows, long long d,
                     int bits, int vec, void* stream) {
  return launch_encode<false>(
      static_cast<const float*>(x), nullptr, static_cast<const float*>(u),
      static_cast<const int32_t*>(seed), static_cast<uint8_t*>(packed),
      static_cast<float*>(scale), nullptr, rows, d, bits, vec,
      static_cast<cudaStream_t>(stream));
}

// packed (rows, d*bits/8) u8, scale (rows,) f32 -> out (rows, d), f32 or
// bf16 (out_bf16 != 0)
int rt_unpack_dequant(const void* packed, const void* scale, void* out,
                      long long rows, long long d, int bits, int out_bf16,
                      int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  if (out_bf16)
    return launch_decode<false, __nv_bfloat16>(
        p, s, nullptr, static_cast<__nv_bfloat16*>(out), rows, d, bits, vec,
        st);
  return launch_decode<false, float>(p, s, nullptr, static_cast<float*>(out),
                                     rows, d, bits, vec, st);
}

// x, u: (rows, d) f32, seed (2,) i32 (u and seed null: round to
// nearest); scale (rows,) f32, clamped at eps here -> codes (rows, d)
// i32 [+ packed (rows, d*bits/8) u8 when packed is not null]
int rt_quantize_codes_scaled(const void* x, const void* scale, const void* u,
                             const void* seed, void* codes, void* packed,
                             long long rows, long long d, int bits, int vec,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* up = static_cast<const float*>(u);
  const int32_t* kp = static_cast<const int32_t*>(seed);
  int32_t* cp = static_cast<int32_t*>(codes);
  if (packed)
    return launch_codes_scaled<true, true>(xp, sp, up, kp, cp,
                                           static_cast<uint8_t*>(packed),
                                           rows, d, bits, vec, st);
  return launch_codes_scaled<true, false>(xp, sp, up, kp, cp, nullptr, rows,
                                          d, bits, vec, st);
}

// x, u: (rows, d) f32 (u null: round to nearest); scale (rows,) f32,
// clamped at eps here -> packed (rows, d*bits/8) u8 only
int rt_quantize_pack_scaled(const void* x, const void* scale, const void* u,
                            void* packed, long long rows, long long d,
                            int bits, int vec, void* stream) {
  return launch_codes_scaled<false, true>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(u), nullptr, nullptr,
      static_cast<uint8_t*>(packed), rows, d, bits, vec,
      static_cast<cudaStream_t>(stream));
}

// packed (n*bits/8,) u8 -> out (n,) i32 codes, bits in {2, 4, 8}
int rt_unpack_codes(const void* packed, void* out, long long n, int bits,
                    int vec, void* stream) {
  if (bits != 2 && bits != 4 && bits != 8) return int(cudaErrorInvalidValue);
  return launch_unpack_sums(static_cast<const uint8_t*>(packed),
                            static_cast<int32_t*>(out), n, bits, vec,
                            static_cast<cudaStream_t>(stream));
}

// total (rows, d) i32 code sum over n workers, scale (rows,) f32 ->
// out (rows, d) f32 = ((2T - n_lv) * s) * c; the caller passes
// n_lv = n * (2**bits - 1) and c = f32(f32(1/lv) * f32(1/n))
int rt_dequant_sum_mean(const void* total, const void* scale, void* out,
                        long long rows, long long d, float n_lv, float c,
                        int vec, void* stream) {
  const int64_t items = vec ? rows * d / 4 : rows * d;
  sum_mean_flat<<<decode_blocks(items), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(total), static_cast<const float*>(scale),
      static_cast<float*>(out), rows, d, n_lv, c, vec);
  return int(cudaGetLastError());
}

// packed (n*bits/8,) u8 + acc (n,) i32 -> out (n,) i32 = acc + unpack
int rt_unpack_accumulate(const void* packed, const void* acc, void* out,
                         long long n, int bits, int vec, void* stream) {
  return launch_unpack_accumulate(
      static_cast<const uint8_t*>(packed), static_cast<const int32_t*>(acc),
      static_cast<int32_t*>(out), n, bits, vec,
      static_cast<cudaStream_t>(stream));
}

// total (n,) i32 sums -> out (n*sw/8,) u8, sw in {2, 4, 8, 16, 32}
int rt_pack_sums(const void* total, void* out, long long n, int sw, int vec,
                 void* stream) {
  return launch_pack_sums(static_cast<const int32_t*>(total),
                          static_cast<uint8_t*>(out), n, sw, vec,
                          static_cast<cudaStream_t>(stream));
}

// packed (n*sw/8,) u8 -> out (n,) i32 sums
int rt_unpack_sums(const void* packed, void* out, long long n, int sw,
                   int vec, void* stream) {
  return launch_unpack_sums(static_cast<const uint8_t*>(packed),
                            static_cast<int32_t*>(out), n, sw, vec,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
