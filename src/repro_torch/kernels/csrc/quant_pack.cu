// AQ-SGD boundary codec kernels for Hopper (sm_90a).
//
// Replaces eleven Pallas TPU kernels of src/repro/kernels/quant_pack.py:
//   delta_quantize_pack        (quant_pack.py:190, _dqp_kernel)  -> encode_rows<BITS, true, LPR, NV>,
//                                                                   encode_rows_block<BITS, true, NV> (wide rows)
//   dequant_unpack_accumulate  (quant_pack.py:239, _dua_kernel)  -> dequant_accumulate_flat<BITS>
//   quantize_pack              (quant_pack.py:278, _qp_kernel)   -> encode_rows<BITS, false, LPR, NV>,
//                                                                   encode_rows_into<BITS, LPR, NV> (KV),
//                                                                   encode_rows_block[_into] (wide rows)
//   unpack_dequant             (quant_pack.py:320, _ud_kernel)   -> unpack_dequant_flat<BITS, OutT>
//   quantize_pack_scaled       (quant_pack.py:363, _qps_kernel)  -> codes_scaled_flat<BITS, false, true>
//   unpack_codes               (quant_pack.py:399, _uc_kernel)   -> unpack_sums_flat<BITS>
//   dequant_sum_mean           (quant_pack.py:434, _dsm_kernel)  -> sum_mean_flat
//   quantize_codes_scaled      (quant_pack.py:480, _qcs_kernel)  -> codes_scaled_flat<BITS, true, PACK>
//   unpack_accumulate          (quant_pack.py:528, _ua_kernel)   -> unpack_accumulate_flat<BITS>
//   pack_sums                  (quant_pack.py:579, _ps_kernel)   -> pack_sums_flat<SW>
//   unpack_sums                (quant_pack.py:620, _us_kernel)   -> unpack_sums_flat<SW>
// and the seed= path of the first, third and sixth (quant_pack.py:84
// _oncore_uniform, with _noise_arg :100 and _kernel_noise :111):
// the encoders and codes_scaled_flat take a (2,) int32 seed in device
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
//   * encoders (B1, B3): the row absmax is a max over the row's threads
//     (exact in any order, so the scale is bit-identical), then each
//     thread quantizes and packs whole output words, so no atomics are
//     needed.  The wrapper picks the tiling from the row's width
//     (quant_pack.py _encode_tiling) and the launcher dispatches to a
//     fixed set of instances.  Rows of up to 256 values (the KV plane):
//     a lane group a row, a grid over rows, the ragged last block masked
//     by whole warps; the group is as wide as the row's float4s, up to a
//     warp (8 lanes at a group_d of 32, 16 at gpt2-xl's head_dim 64, 32
//     from 128 on, gemma2's 256 too), each lane holding its float4s in
//     registers, so the row is read once.  Wider rows (the hops' 1600
//     and 3584, the training boundary's 1600): a block a row, of the
//     fewest whole warps T with NV float4s a thread covering the row (B3:
//     NV 4, T 128 at 1600, 224 at 3584, at most 512; B1, which holds m
//     beside the delta for m_new: NV 2, T 224 and 448, at most 1024), a,
//     m and u (or the Philox draw) all issued before the first use, the
//     absmax a warp max then one __syncthreads across the warps, and the
//     row quantized and stored from registers: read once up to 8192
//     values, walked twice by the block past that.  (A warp walking the
//     row twice left the hop's eight rows on one SM, latency-bound at 10x
//     the launch floor, and read the training boundary's 52 MB twice,
//     past the L2.)  Rows without vec (d % 4 != 0, a misaligned view)
//     take the scalar path: a warp a row, walked twice, one packed
//     byte's values at a time.
//     One lane-group row body (encode_row) serves two kernels:
//     encode_rows, one tensor a launch (B1, B3 per call, their seeded
//     path) with every pointer a __restrict__ parameter, and
//     encode_rows_into, the KV pair below, whose pointers come from a
//     struct; the block row body (encode_row_block) serves
//     encode_rows_block and encode_rows_block_into the same way.  The
//     bodies' pointers are __restrict__, so the compiler may issue a
//     loop's next loads ahead of its stores.
//   * the KV plane runs k and v in one launch each (blockIdx.y picks
//     the tensor), and the append writes in place: an encoder row goes
//     through a RowMap to its row of the output, so the fresh rows (B,
//     s, N) land in rows [pos, pos + s) of each layer store (B, S, N)
//     through the store's batch stride, with no temporary and no copy.
//     The continuous batcher's pool gives each batch entry its own
//     head (a B int32 tensor on the device, never read by the host):
//     entry b starts at clamp(head[b], 0, S - s), the clamp of
//     jax.lax.dynamic_update_slice, so an idle slot's head past the
//     store writes its own last rows; one load a row, no extra launch.
//     Each layer of a serving step thus runs one store read and one
//     append (not two reads, two appends and four copies).  The
//     seeded counter stays each element's index in its own tensor's
//     row view, so the pair draws what two per-tensor calls draw.
//   * the store read (B4) is a pure stream, 1 byte read for 4 written
//     at 8 bits: each lane loads 16 code bytes (one streaming uint4)
//     into its warp's stage in shared memory and the warp stores
//     512-byte runs of float4s, as the sums' unpacker below does.  A
//     block walks its own run of segments; a value's row is the run's
//     first row plus a 32-bit multiply-high quotient (div_magic: no
//     64-bit division, a long software routine on this card, per
//     value).  The grid is one wave of the blocks the card holds, so a
//     10 MB read pays no second wave or tail.
//   * the other decoders need no reduction, so they are flat: a
//     grid-stride loop over groups of 4 elements (or over packed
//     bytes), each thread writing whole bytes and whole float4s.  The
//     gradient wire's two kernels take the row scale as an input, so
//     they need no reduction either and share that flat design.
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
// a row wider than 256 values: a block a row, kRowNV<DELTA> float4s a
// thread (B1 holds m beside the delta, so half as many as B3), and at
// most kRowValues / (4 * kRowNV) threads, so a block holds up to
// kRowValues values in registers (quant_pack.py _encode_tiling)
template <bool DELTA> constexpr int kRowNV = DELTA ? 2 : 4;
constexpr int kRowValues = 8192;
constexpr int kMaxRowThreads = 1024;
constexpr float kEps = 1e-12f;

template <int BITS>
struct Packed4;  // the bytes that hold 4 codes of BITS bits
template <> struct Packed4<2> { using T = uint8_t; };
template <> struct Packed4<4> { using T = uint16_t; };
template <> struct Packed4<8> { using T = uint32_t; };

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

// max over the LPR lanes of an aligned lane group (every lane of the warp
// takes part)
template <int LPR>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// values 4g..4g+3 of one row: codes packed into word g of its output row
// (and, delta, m_new's float4 g)
template <int BITS, bool DELTA>
__device__ __forceinline__ void encode4(float4 x, float4 mm, float4 uu,
                                        float s, bool stoch,
                                        uint8_t* __restrict__ pr,
                                        float* __restrict__ nr, int64_t g) {
  using P = typename Packed4<BITS>::T;
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

// One row, LPR lanes (lane: this lane's place in the group): ar, mr, ur
// the row's input, m and noise (mr, ur, nr null where absent), pr its
// packed codes, scale[srow] its scale, nr its m_new; has_u is ur !=
// nullptr.  (The per-call kernel passes the scale vector and the row, so
// the address is formed at the store and holds no registers over pass 1:
// B3 at (4096, 1600) ran ~2% slower with the pointer formed up front.)
// Rounding branches on has_u and seed, which come from the kernel's
// parameters, so the compiler sees them uniform (a test of ur, which
// depends on the row, costs each quantized value a reconvergence
// region); the noise load is selected on ur, which the compiler turns
// into a predicated load issued beside x's.  `row` is the row's index in
// its own tensor (the seeded counter); `live` false for a lane group past
// the last row, which takes part in the shuffles only.  NV > 0 (vec
// only, rows of up to 256 values): lane l holds the row's float4s l, l +
// LPR, ... (at most NV) in registers from the absmax to the quantize, so
// the row is read once.  NV == 0: the scalar path (no vec: d % 4 != 0 or
// a misaligned view), the row walked twice by a warp, one packed byte's
// values at a time.  Every pointer is __restrict__ (no input aliases an
// output), so the compiler may issue a pass's next loads before its last
// stores, and reads inputs through the read-only path.
template <int BITS, bool DELTA, int LPR, int NV>
__device__ __forceinline__ void encode_row(
    const float* __restrict__ ar, const float* __restrict__ mr,
    const float* __restrict__ ur, bool has_u,
    const int32_t* __restrict__ seed, uint8_t* __restrict__ pr,
    float* __restrict__ scale, int64_t srow, float* __restrict__ nr,
    int64_t row, int lane, bool live, int64_t d) {
  constexpr int k = 8 / BITS;  // codes per byte
  static_assert(NV == 0 ? LPR == kWarp : NV * LPR <= 2 * kWarp, "tiling");
  const bool stoch = has_u || seed != nullptr;
  const uint32_t k0 = seed ? uint32_t(seed[0]) : 0u;
  const uint32_t k1 = seed ? uint32_t(seed[1]) : 0u;
  const float4* a4 = reinterpret_cast<const float4*>(ar);
  const float4* m4 = reinterpret_cast<const float4*>(mr);
  const float4* u4 = reinterpret_cast<const float4*>(ur);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // the uniforms of float4 g: read, drawn from the seed (the counter is
  // the element's index in this tensor's row view), or none
  auto noise4 = [&](int64_t g) {
    return ur     ? u4[g]
           : seed ? seeded_uniform4(row * (d / 4) + g, k0, k1)
                  : zero;
  };

  if constexpr (NV > 0) {
    const int64_t n4 = d / 4;
    float4 x[NV], mm[NV];
    float mx = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int64_t g = lane + v * LPR;
      x[v] = mm[v] = zero;
      if (live && g < n4) {
        x[v] = a4[g];
        if (DELTA) {
          mm[v] = m4[g];
          x[v] = sub4(x[v], mm[v]);
        }
        mx = fmaxf(mx, abs_max4(x[v]));
      }
    }
    const float s = fmaxf(group_max<LPR>(mx), kEps);
    if (!live) return;
    if (lane == 0) scale[srow] = s;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int64_t g = lane + v * LPR;
      if (g < n4)
        encode4<BITS, DELTA>(x[v], mm[v], noise4(g), s, stoch, pr, nr, g);
    }
  } else {
    // pass 1: row absmax of the delta (or of x)
    float mx = 0.0f;
    for (int64_t i = lane; i < d; i += kWarp) {
      const float x = DELTA ? __fsub_rn(ar[i], mr[i]) : ar[i];
      mx = fmaxf(mx, fabsf(x));
    }
    const float s = fmaxf(group_max<kWarp>(mx), kEps);
    if (lane == 0) scale[srow] = s;

    // pass 2: quantize, pack whole bytes, advance the buffer
    for (int64_t j = lane; j < d / k; j += kWarp) {  // one output byte
      uint32_t byte = 0;
#pragma unroll
      for (int q = 0; q < k; ++q) {
        const int64_t i = j * k + q;
        const float mm = DELTA ? mr[i] : 0.0f;
        const float x = DELTA ? __fsub_rn(ar[i], mm) : ar[i];
        const float uu = ur     ? ur[i]
                         : seed ? seeded_uniform(row * d + i, k0, k1)
                                : 0.0f;
        const uint32_t c = quant_code<BITS>(x, s, uu, stoch);
        byte |= c << (q * BITS);
        if (DELTA) nr[i] = dequant<BITS, true>(c, s, mm);
      }
      pr[j] = static_cast<uint8_t>(byte);
    }
  }
}

// the max of v over the block's threads, to every thread (v >= 0; one
// __syncthreads, so a block calls it once)
__device__ __forceinline__ float block_max(float v) {
  __shared__ float part[kMaxRowThreads / kWarp];
  const int lane = threadIdx.x % kWarp;
  v = group_max<kWarp>(v);
  if (lane == 0) part[threadIdx.x / kWarp] = v;
  __syncthreads();
  return group_max<kWarp>(lane < int(blockDim.x / kWarp) ? part[lane]
                                                          : 0.0f);
}

// One row wider than 256 values (vec only), a block of T = blockDim.x
// threads (whole warps, T * NV * 4 <= kRowValues): the row goes in
// chunks of T * NV float4s, thread t holding float4s t, t + T, ... (NV
// of them) of a chunk.  A row of one chunk (up to kRowValues values at
// the widest block) is read once: a, m and u (or the Philox draw, whose
// ALU work overlaps the loads in flight) all issued before the first
// use, the absmax a block max, then quantize, pack and store from
// registers.  A wider row is walked twice by the block: its absmax over
// the chunks, then each chunk read again and encoded.  Pointers and
// arguments as encode_row's; the max is exact in any order, so the scale
// is bit-identical to a warp's or a lane group's.
template <int BITS, bool DELTA, int NV>
__device__ __forceinline__ void encode_row_block(
    const float* __restrict__ ar, const float* __restrict__ mr,
    const float* __restrict__ ur, bool has_u,
    const int32_t* __restrict__ seed, uint8_t* __restrict__ pr,
    float* __restrict__ scale, int64_t srow, float* __restrict__ nr,
    int64_t row, int64_t d) {
  const bool stoch = has_u || seed != nullptr;
  const uint32_t k0 = seed ? uint32_t(seed[0]) : 0u;
  const uint32_t k1 = seed ? uint32_t(seed[1]) : 0u;
  const float4* a4 = reinterpret_cast<const float4*>(ar);
  const float4* m4 = reinterpret_cast<const float4*>(mr);
  const float4* u4 = reinterpret_cast<const float4*>(ur);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t n4 = d / 4;
  const int t = threadIdx.x, T = blockDim.x;
  const int64_t span = int64_t(T) * NV;
  const bool once = n4 <= span;
  float4 x[NV], mm[NV], uu[NV];
  // the chunk from float4 c0 into registers: x the delta (or x), mm m,
  // uu the noise (read or drawn; the counter is the element's index in
  // this tensor's row view) where `noise`, zero past the row's end
  auto load = [&](int64_t c0, bool noise) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int64_t g = c0 + t + v * T;
      x[v] = mm[v] = uu[v] = zero;
      if (g < n4) {
        x[v] = a4[g];
        if (DELTA) mm[v] = m4[g];
        if (noise && has_u) uu[v] = u4[g];
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int64_t g = c0 + t + v * T;
      if (g < n4) {
        if (DELTA) x[v] = sub4(x[v], mm[v]);
        if (noise && !has_u && seed)
          uu[v] = seeded_uniform4(row * n4 + g, k0, k1);
      }
    }
  };
  auto encode = [&](int64_t c0, float s) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int64_t g = c0 + t + v * T;
      if (g < n4)
        encode4<BITS, DELTA>(x[v], mm[v], uu[v], s, stoch, pr, nr, g);
    }
  };
  float mx = 0.0f;
  for (int64_t c0 = 0; c0 < n4; c0 += span) {
    load(c0, once);
#pragma unroll
    for (int v = 0; v < NV; ++v) mx = fmaxf(mx, abs_max4(x[v]));
  }
  const float s = fmaxf(block_max(mx), kEps);
  if (t == 0) scale[srow] = s;
  if (once) {
    encode(0, s);
  } else {
    for (int64_t c0 = 0; c0 < n4; c0 += span) {
      load(c0, true);
      encode(c0, s);
    }
  }
}

// B1 (DELTA) and B3 per call, one tensor, row r to row r of the outputs:
// LPR lanes a row, kThreads / LPR rows a block
template <int BITS, bool DELTA, int LPR, int NV>
__global__ void __launch_bounds__(kThreads)
encode_rows(const float* __restrict__ a, const float* __restrict__ m,
            const float* __restrict__ u, const int32_t* __restrict__ seed,
            uint8_t* __restrict__ packed, float* __restrict__ scale,
            float* __restrict__ m_new, int64_t rows, int64_t d) {
  constexpr int RB = kThreads / LPR;
  const int64_t first = int64_t(blockIdx.x) * RB;
  // whole warps past the last row leave together; a warp with a live
  // row keeps all its lanes for the shuffles
  if (first + (threadIdx.x / kWarp) * (kWarp / LPR) >= rows) return;
  const int64_t row = first + threadIdx.x / LPR;
  encode_row<BITS, DELTA, LPR, NV>(
      a + row * d, DELTA ? m + row * d : nullptr, u ? u + row * d : nullptr,
      u != nullptr, seed, packed + row * (d / (8 / BITS)), scale, row,
      DELTA ? m_new + row * d : nullptr, row, threadIdx.x % LPR, row < rows,
      d);
}

// The KV append's tensors: blockIdx.y picks one of `pair` (1 or 2) inputs,
// noise sources and layer stores.
struct EncodeIO {
  const float* a[2];
  const float* u[2];
  const int32_t* seed[2];
  uint8_t* packed[2];
  float* scale[2];
};

// v[w] of a kernel's pair of pointers, by a select (no indexed load)
template <typename T>
__device__ __forceinline__ T pick(T const (&v)[2], int w) {
  return w ? v[1] : v[0];
}

// Where fresh row r writes its packed codes and its scale: the input is
// rpb rows a batch entry; row r = b * rpb + t goes to row base + t of
// entry b of the store, whose entries lie pstride packed bytes and
// sstride scales apart.  The KV append's fresh rows (B, s, N) land in
// rows [pos, pos + s) of each layer store (B, S, N): rpb = s * N, base =
// pos * N, the strides the store's batch strides.  With per-row write
// heads (`starts`, B int32 on the device, the continuous batcher's pool)
// entry b's base is clamp(starts[b], 0, hi) * n instead, hi = S - s:
// jax.lax.dynamic_update_slice's rule, so a head past the store (an idle
// slot's) writes the store's last s rows and never past them.
struct RowMap {
  int64_t rpb, base, pstride, sstride;
  const int32_t* starts;
  int64_t n, hi;
};

// the first store row of batch entry b
__device__ __forceinline__ int64_t map_base(const RowMap& map, uint32_t b) {
  if (!map.starts) return map.base;
  const int32_t h = __ldg(map.starts + b);
  return int64_t(min(max(h, 0), int32_t(map.hi))) * map.n;
}

// B3 for k and v (blockIdx.y) in one launch, written in place through
// the row map: the per-call kernel's rows and lanes
template <int BITS, int LPR, int NV>
__global__ void __launch_bounds__(kThreads)
encode_rows_into(EncodeIO io, RowMap map, int64_t rows, int64_t d) {
  constexpr int RB = kThreads / LPR;
  const int w = blockIdx.y;
  const int64_t first = int64_t(blockIdx.x) * RB;
  if (first + (threadIdx.x / kWarp) * (kWarp / LPR) >= rows) return;
  const int64_t row = first + threadIdx.x / LPR;
  // rows < 2^31 (the launcher checks), so the map's division is 32-bit
  const uint32_t b = uint32_t(row < rows ? row : rows - 1) /
                     uint32_t(map.rpb);
  const int64_t t = row - int64_t(b) * map.rpb;
  const int64_t base = map_base(map, b);
  const float* u = pick(io.u, w);
  encode_row<BITS, false, LPR, NV>(
      pick(io.a, w) + row * d, nullptr, u ? u + row * d : nullptr,
      u != nullptr, pick(io.seed, w),
      pick(io.packed, w) + b * map.pstride + (base + t) * (d / (8 / BITS)),
      pick(io.scale, w) + b * map.sstride + base + t, 0, nullptr, row,
      threadIdx.x % LPR, row < rows, d);
}

// B1 (DELTA) and B3 per call at rows wider than 256 values: a block a
// row (blockIdx.x), row r to row r of the outputs
template <int BITS, bool DELTA, int NV>
__global__ void __launch_bounds__(kRowValues / (4 * NV))
encode_rows_block(const float* __restrict__ a, const float* __restrict__ m,
                  const float* __restrict__ u,
                  const int32_t* __restrict__ seed,
                  uint8_t* __restrict__ packed, float* __restrict__ scale,
                  float* __restrict__ m_new, int64_t d) {
  const int64_t row = blockIdx.x;
  encode_row_block<BITS, DELTA, NV>(
      a + row * d, DELTA ? m + row * d : nullptr, u ? u + row * d : nullptr,
      u != nullptr, seed, packed + row * (d / (8 / BITS)), scale, row,
      DELTA ? m_new + row * d : nullptr, row, d);
}

// the KV append's rows wider than 256 values (no path has them): a block
// a row, k and v (blockIdx.y) in one launch through the row map
template <int BITS, int NV>
__global__ void __launch_bounds__(kRowValues / (4 * NV))
encode_rows_block_into(EncodeIO io, RowMap map, int64_t d) {
  const int w = blockIdx.y;
  const int64_t row = blockIdx.x;
  const uint32_t b = uint32_t(row) / uint32_t(map.rpb);
  const int64_t t = row - int64_t(b) * map.rpb;
  const int64_t base = map_base(map, b);
  const float* u = pick(io.u, w);
  encode_row_block<BITS, false, NV>(
      pick(io.a, w) + row * d, nullptr, u ? u + row * d : nullptr,
      u != nullptr, pick(io.seed, w),
      pick(io.packed, w) + b * map.pstride + (base + t) * (d / (8 / BITS)),
      pick(io.scale, w) + b * map.sstride, base + t, nullptr, row, d);
}

// ---------------------------------------------------------------------------
// Decoders: packed codes + row scale [+ m] -> values
// ---------------------------------------------------------------------------

// B2: m_new = fma((2c - lv) * s, f32(1/lv), m), a grid-stride loop over
// groups of 4 elements (vec) or over packed bytes
template <int BITS>
__global__ void __launch_bounds__(256)
dequant_accumulate_flat(const uint8_t* __restrict__ packed,
                        const float* __restrict__ scale,
                        const float* __restrict__ m, float* __restrict__ out,
                        int64_t rows, int64_t d, int vec) {
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
      const float4 m4 = reinterpret_cast<const float4*>(m)[g];
      reinterpret_cast<float4*>(out)[g] = make_float4(
          dequant<BITS, true>(word & mask, s, m4.x),
          dequant<BITS, true>((word >> BITS) & mask, s, m4.y),
          dequant<BITS, true>((word >> (2 * BITS)) & mask, s, m4.z),
          dequant<BITS, true>((word >> (3 * BITS)) & mask, s, m4.w));
    }
  } else {
    // one packed byte = k elements of one row (the wrapper checks d % k == 0)
    for (int64_t j = first; j < n / k; j += stride) {
      const int64_t i0 = j * k;
      const float s = scale[i0 / d];
      const uint32_t byte = packed[j];
#pragma unroll
      for (int t = 0; t < k; ++t)
        out[i0 + t] = dequant<BITS, true>((byte >> (t * BITS)) & mask, s,
                                          m[i0 + t]);
    }
  }
}

// One launch's tensors for the store read: blockIdx.y picks one of
// `pair` (1 or 2) triples of one shape.
template <typename OutT>
struct DecodeIO {
  const uint8_t* packed[2];
  const float* scale[2];
  OutT* out[2];
};

constexpr int kSegBytes = 512;   // a warp's 16-byte loads: one segment
constexpr int kSegUnroll = 4;    // segments a warp has in flight

// floor(n / d) for 0 <= n < 2^31 and d >= 2, in 32-bit integer work: the
// host gives mul = ceil(2^(31 + l) / d) and shift = l - 1, l = ceil(log2
// d) (quant_pack.py _div_magic; the round-up method of Granlund and
// Montgomery, PLDI'94)
__device__ __forceinline__ uint32_t div_magic(uint32_t n, uint32_t mul,
                                              uint32_t shift) {
  return __umulhi(n, mul) >> shift;
}

__device__ __forceinline__ void store4(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(from_float<__nv_bfloat16>(lo))) |
         (uint32_t(__bfloat16_as_ushort(from_float<__nv_bfloat16>(hi)))
          << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  *reinterpret_cast<uint2*>(o) =               // one 8-byte store
      make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
}

// B4: values = ((2c - lv) * s) * f32(1/lv), for one tensor or k and v.
// vec: block x of tensor y walks its own run of `per` 512-byte segments
// of the packed stream, a warp a segment at a time with kSegUnroll in
// flight: each lane loads 16 bytes (one streaming uint4) into the warp's
// stage in shared memory, then the warp stores the segment's values as
// float4s (bf16: 8-byte words), 512 (256) contiguous bytes a store, each
// lane reading its 4 codes from the stage.  A value's row is the run's
// first row plus a 32-bit quotient (div_magic) of its column offset
// within the run.  The values past the last whole segment, and all of
// them without vec, go one packed byte an item in the same launch.
template <int BITS, typename OutT>
__global__ void __launch_bounds__(256)
unpack_dequant_flat(DecodeIO<OutT> io, int64_t n, int64_t d, int64_t per,
                    uint32_t mul, uint32_t shift, int vec) {
  constexpr int k = 8 / BITS;
  constexpr int SEG = kSegBytes * k;          // values in a segment
  constexpr uint32_t mask = (1u << BITS) - 1u;
  using P = typename Packed4<BITS>::T;
  const uint8_t* __restrict__ packed = pick(io.packed, blockIdx.y);
  const float* __restrict__ scale = pick(io.scale, blockIdx.y);
  OutT* __restrict__ out = pick(io.out, blockIdx.y);
  int64_t done = 0;
  if (vec) {
    constexpr int W = 256 / kWarp;              // warps a block
    __shared__ uint4 stage[W][kSegUnroll][kWarp];
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    const int64_t segs = n / SEG;
    const int64_t s0 = int64_t(blockIdx.x) * per < segs
                           ? int64_t(blockIdx.x) * per : segs;
    const int cnt = int(s0 + per < segs ? per : segs - s0);
    const int64_t e0 = s0 * SEG;                 // the run's first value,
    const int64_t r0 = e0 / d;                   // its row and column:
    const uint32_t c0 = uint32_t(e0 - r0 * d);   // c0 + per * SEG < 2^31
    const uint4* src = reinterpret_cast<const uint4*>(packed) + s0 * kWarp;
    for (int t = warp; t < cnt; t += W * kSegUnroll) {
#pragma unroll
      for (int u = 0; u < kSegUnroll; ++u)
        if (t + W * u < cnt)
          stage[warp][u][lane] = __ldcs(src + (t + W * u) * kWarp + lane);
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kSegUnroll; ++u) {
        const int seg = t + W * u;
        if (seg < cnt) {
          const P* codes = reinterpret_cast<const P*>(stage[warp][u]);
#pragma unroll
          for (int j = 0; j < SEG / 4 / kWarp; ++j) {
            const int q = j * kWarp + lane;            // values 4q..4q+3
            const uint32_t v = uint32_t(seg) * SEG + 4u * uint32_t(q);
            const float s =
                __ldg(scale + r0 + div_magic(c0 + v, mul, shift));
            const uint32_t word = codes[q];
            store4(out + e0 + v, make_float4(
                dequant<BITS, false>(word & mask, s, 0.f),
                dequant<BITS, false>((word >> BITS) & mask, s, 0.f),
                dequant<BITS, false>((word >> (2 * BITS)) & mask, s, 0.f),
                dequant<BITS, false>((word >> (3 * BITS)) & mask, s, 0.f)));
          }
        }
      }
      __syncwarp();
    }
    done = segs * SEG;
  }
  // one packed byte = k values of one row (the wrapper checks d % k == 0)
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t j = done / k + int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n / k; j += stride) {
    const int64_t i0 = j * k;
    const float s = __ldg(scale + i0 / d);
    const uint32_t byte = __ldg(packed + j);
#pragma unroll
    for (int t = 0; t < k; ++t)
      out[i0 + t] = from_float<OutT>(
          dequant<BITS, false>((byte >> (t * BITS)) & mask, s, 0.f));
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

int decode_blocks(int64_t items) {
  const int64_t b = (items + 255) / 256;
  return int(b < 132 * 32 ? b : 132 * 32);  // grid-stride beyond 32 blocks/SM
}

// One tensor's rows (B1, B3 per call): the pointers of rt_delta_quantize_pack
struct EncodeArgs {
  const float* a;
  const float* m;
  const float* u;
  const int32_t* seed;
  uint8_t* packed;
  float* scale;
  float* m_new;
};

// a launch of B1 or B3 per call (pair == 0: `args`, identity rows) or of
// the KV append in place (pair 1 or 2: `io` through `map`): LPR lanes a
// row, kThreads / LPR rows a block
template <int BITS, bool DELTA, int LPR, int NV>
int launch_rows(const EncodeArgs& args, const EncodeIO& io, int pair,
                const RowMap& map, int64_t rows, int64_t d,
                cudaStream_t st) {
  constexpr int RB = kThreads / LPR;
  const unsigned blocks = static_cast<unsigned>((rows + RB - 1) / RB);
  if (pair == 0) {
    encode_rows<BITS, DELTA, LPR, NV><<<blocks, kThreads, 0, st>>>(
        args.a, args.m, args.u, args.seed, args.packed, args.scale,
        args.m_new, rows, d);
  } else if constexpr (!DELTA) {
    const dim3 grid(blocks, static_cast<unsigned>(pair));
    encode_rows_into<BITS, LPR, NV><<<grid, kThreads, 0, st>>>(io, map, rows,
                                                               d);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// the same at rows wider than 256 values: a block of `threads` a row
template <int BITS, bool DELTA>
int launch_rows_block(const EncodeArgs& args, const EncodeIO& io, int pair,
                      const RowMap& map, int64_t rows, int64_t d,
                      int threads, cudaStream_t st) {
  if (pair == 0) {
    encode_rows_block<BITS, DELTA, kRowNV<DELTA>>
        <<<static_cast<unsigned>(rows), threads, 0, st>>>(
            args.a, args.m, args.u, args.seed, args.packed, args.scale,
            args.m_new, d);
  } else if constexpr (!DELTA) {
    const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(pair));
    encode_rows_block_into<BITS, kRowNV<false>><<<grid, threads, 0, st>>>(
        io, map, d);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// The tiling the wrapper chose from the row's width (quant_pack.py
// _encode_tiling): `tpr` threads a row, `nv` float4s a thread.  Lane
// groups (8, 1), (16, 1), (32, 2) for the KV plane's rows of up to 256
// values; a block of tpr threads (whole warps, tpr * nv * 4 <=
// kRowValues) with nv = kRowNV<DELTA> for wider rows (the hops' 1600 and
// 3584, the training boundary).  Without vec, the scalar path: a warp a
// row, whatever the width.  Anything else is refused.
template <int BITS, bool DELTA>
int launch_encode_bits(const EncodeArgs& args, const EncodeIO& io, int pair,
                       const RowMap& map, int64_t rows, int64_t d, int vec,
                       int tpr, int nv, cudaStream_t st) {
  if (!vec)
    return launch_rows<BITS, DELTA, kWarp, 0>(args, io, pair, map, rows, d,
                                              st);
  const int64_t n4 = d / 4;
  if (tpr == 8 && nv == 1 && n4 <= 8)
    return launch_rows<BITS, DELTA, 8, 1>(args, io, pair, map, rows, d, st);
  if (tpr == 16 && nv == 1 && n4 <= 16)
    return launch_rows<BITS, DELTA, 16, 1>(args, io, pair, map, rows, d, st);
  if (tpr == kWarp && nv == 2 && n4 <= 2 * kWarp)
    return launch_rows<BITS, DELTA, kWarp, 2>(args, io, pair, map, rows, d,
                                              st);
  if (nv == kRowNV<DELTA> && tpr >= kWarp && tpr * nv * 4 <= kRowValues &&
      tpr % kWarp == 0)
    return launch_rows_block<BITS, DELTA>(args, io, pair, map, rows, d, tpr,
                                          st);
  return int(cudaErrorInvalidValue);
}

template <bool DELTA>
int launch_encode(const EncodeArgs& args, const EncodeIO& io, int pair,
                  const RowMap& map, int64_t rows, int64_t d, int bits,
                  int vec, int tpr, int nv, cudaStream_t st) {
  if (rows >= (int64_t(1) << 31) || (pair && map.rpb < 1) ||
      (map.starts && (map.n < 1 || map.hi < 0 || map.hi >= (int64_t(1) << 31))))
    return int(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch_encode_bits<2, DELTA>(args, io, pair, map, rows, d, vec, tpr, nv, st);
    case 4: return launch_encode_bits<4, DELTA>(args, io, pair, map, rows, d, vec, tpr, nv, st);
    case 8: return launch_encode_bits<8, DELTA>(args, io, pair, map, rows, d, vec, tpr, nv, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <int BITS>
int launch_dequant_accumulate(const uint8_t* packed, const float* scale,
                              const float* m, float* out, int64_t rows,
                              int64_t d, int vec, cudaStream_t st) {
  const int64_t items = vec ? rows * d / 4 : rows * d / (8 / BITS);
  dequant_accumulate_flat<BITS><<<decode_blocks(items), 256, 0, st>>>(
      packed, scale, m, out, rows, d, vec);
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

// One wave: the grid is at most the blocks the card holds at once
// (shared by the pair), and at least a segment a warp where there are
// that many.  A block's run of segments stays within 32-bit offsets of
// its first row (per * SEG + d < 2^31; more blocks where it would not).
template <int BITS, typename OutT>
int launch_unpack_dequant_bits(const DecodeIO<OutT>& io, int pair,
                               int64_t n, int64_t d, uint32_t mul,
                               uint32_t shift, int vec, cudaStream_t st) {
  constexpr int SEG = kSegBytes * (8 / BITS);
  static int cache[64] = {};
  int resident = 0;
  const cudaError_t err =
      resident_blocks(unpack_dequant_flat<BITS, OutT>, cache, resident);
  if (err != cudaSuccess) return int(err);
  const int64_t segs = vec ? n / SEG : 0;
  const int64_t want = vec ? (segs + 7) / 8 : (n / (8 / BITS) + 255) / 256;
  const int64_t cap = resident / pair > 1 ? resident / pair : 1;
  int64_t blocks = want < 1 ? 1 : want < cap ? want : cap;
  int64_t per = (segs + blocks - 1) / blocks;
  if (vec && d >= (int64_t(1) << 30)) return int(cudaErrorInvalidValue);
  while (vec && per * SEG + d >= (int64_t(1) << 31)) {
    blocks *= 2;
    per = (segs + blocks - 1) / blocks;
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(pair));
  unpack_dequant_flat<BITS, OutT><<<grid, 256, 0, st>>>(io, n, d, per, mul,
                                                        shift, vec);
  return int(cudaGetLastError());
}

template <typename OutT>
int launch_unpack_dequant(const DecodeIO<OutT>& io, int pair, int64_t n,
                          int64_t d, int bits, uint32_t mul, uint32_t shift,
                          int vec, cudaStream_t st) {
  switch (bits) {
    case 2: return launch_unpack_dequant_bits<2>(io, pair, n, d, mul, shift, vec, st);
    case 4: return launch_unpack_dequant_bits<4>(io, pair, n, d, mul, shift, vec, st);
    case 8: return launch_unpack_dequant_bits<8>(io, pair, n, d, mul, shift, vec, st);
    default: return int(cudaErrorInvalidValue);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// a, m, u: (rows, d) f32; seed: (2,) i32 (u and seed null: round to
// nearest; u wins when both are given); packed: (rows, d*bits/8) u8;
// scale: (rows,) f32; m_new: (rows, d) f32; tpr, nv: the tiling of d
// (quant_pack.py _encode_tiling), read with vec
int rt_delta_quantize_pack(const void* a, const void* m, const void* u,
                           const void* seed, void* packed, void* scale,
                           void* m_new, long long rows, long long d,
                           int bits, int vec, int tpr, int nv,
                           void* stream) {
  const EncodeArgs args = {
      static_cast<const float*>(a), static_cast<const float*>(m),
      static_cast<const float*>(u), static_cast<const int32_t*>(seed),
      static_cast<uint8_t*>(packed), static_cast<float*>(scale),
      static_cast<float*>(m_new)};
  return launch_encode<true>(args, EncodeIO{}, 0, RowMap{}, rows, d, bits,
                             vec, tpr, nv,
                             static_cast<cudaStream_t>(stream));
}

// packed (rows, d*bits/8) u8, scale (rows,) f32, m (rows, d) f32 -> out f32
int rt_dequant_unpack_accumulate(const void* packed, const void* scale,
                                 const void* m, void* out, long long rows,
                                 long long d, int bits, int vec,
                                 void* stream) {
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* s = static_cast<const float*>(scale);
  const float* mp = static_cast<const float*>(m);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch_dequant_accumulate<2>(p, s, mp, o, rows, d, vec, st);
    case 4: return launch_dequant_accumulate<4>(p, s, mp, o, rows, d, vec, st);
    case 8: return launch_dequant_accumulate<8>(p, s, mp, o, rows, d, vec, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// x0 [, x1]: (rows, d) f32, each with noise u (rows, d) f32 or seed (2,)
// i32 (both null: round to nearest).  rpb == 0: one tensor (x1 null),
// its rows written to the same rows of packed0 (rows, d*bits/8) u8 and
// scale0 (rows,) f32 (B3 per call).  rpb >= 1: the KV append of one or
// two tensors in place: row r of x_i writes its packed codes and its
// scale to row base + r % rpb of entry r / rpb of the stores packed_i and
// scale_i, whose entries lie pstride bytes and sstride scales apart.
// starts non-null (B int32, the per-row write heads): entry b's rows
// start at clamp(starts[b], 0, hi) * n instead of base (RowMap).
// tpr, nv: the tiling of d, as for rt_delta_quantize_pack.
int rt_quantize_pack(const void* x0, const void* x1, const void* u0,
                     const void* u1, const void* seed0, const void* seed1,
                     void* packed0, void* packed1, void* scale0,
                     void* scale1, long long rows, long long d,
                     long long rpb, long long base, long long pstride,
                     long long sstride, const void* starts, long long n,
                     long long hi, int bits, int vec, int tpr, int nv,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rpb == 0) {
    if (x1) return int(cudaErrorInvalidValue);
    const EncodeArgs args = {
        static_cast<const float*>(x0), nullptr,
        static_cast<const float*>(u0), static_cast<const int32_t*>(seed0),
        static_cast<uint8_t*>(packed0), static_cast<float*>(scale0), nullptr};
    return launch_encode<false>(args, EncodeIO{}, 0, RowMap{}, rows, d, bits,
                                vec, tpr, nv, st);
  }
  const EncodeIO io = {
      {static_cast<const float*>(x0), static_cast<const float*>(x1)},
      {static_cast<const float*>(u0), static_cast<const float*>(u1)},
      {static_cast<const int32_t*>(seed0), static_cast<const int32_t*>(seed1)},
      {static_cast<uint8_t*>(packed0), static_cast<uint8_t*>(packed1)},
      {static_cast<float*>(scale0), static_cast<float*>(scale1)}};
  return launch_encode<false>(EncodeArgs{}, io, x1 ? 2 : 1,
                              RowMap{rpb, base, pstride, sstride,
                                     static_cast<const int32_t*>(starts), n,
                                     hi},
                              rows, d,
                              bits, vec, tpr, nv, st);
}

// packed_i (rows, d*bits/8) u8, scale_i (rows,) f32 -> out_i (rows, d),
// f32 or bf16 (out_bf16 != 0), for one tensor (packed1 null) or two of
// one shape; mul and shift: _div_magic(d), read with vec
int rt_unpack_dequant(const void* packed0, const void* packed1,
                      const void* scale0, const void* scale1, void* out0,
                      void* out1, long long rows, long long d, int bits,
                      int out_bf16, unsigned int mul, unsigned int shift,
                      int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pair = packed1 ? 2 : 1;
  const uint8_t* p0 = static_cast<const uint8_t*>(packed0);
  const uint8_t* p1 = static_cast<const uint8_t*>(packed1);
  const float* s0 = static_cast<const float*>(scale0);
  const float* s1 = static_cast<const float*>(scale1);
  if (out_bf16) {
    const DecodeIO<__nv_bfloat16> io = {
        {p0, p1}, {s0, s1},
        {static_cast<__nv_bfloat16*>(out0), static_cast<__nv_bfloat16*>(out1)}};
    return launch_unpack_dequant(io, pair, rows * d, d, bits, mul, shift, vec,
                                 st);
  }
  const DecodeIO<float> io = {
      {p0, p1}, {s0, s1},
      {static_cast<float*>(out0), static_cast<float*>(out1)}};
  return launch_unpack_dequant(io, pair, rows * d, d, bits, mul, shift, vec,
                               st);
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

// an empty kernel: what one launch costs the caller's timing harness
int rt_launch_floor(void* stream) {
  empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

}  // extern "C"
