// Flash-attention forward for Hopper (sm_90a): float32 accuracy from the
// tensor cores, by a 3-pass TF32 split.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:81
// flash_attention_fwd (its body is _kernel at :36): online-softmax
// attention with a causal mask, a sliding window, a logit softcap and
// GQA read through the index map.  Shapes are head-major, as there:
//   q, o (B, H, Sq, hd);  k, v (B, Hk, Sk, hd);  H % Hk == 0,
// query head h reads kv head h / (H / Hk) in place (no repeated copy).
// Each tensor comes with its own batch, head and row strides (the last
// dim is contiguous), so a serving prefill passes transposed views of
// its (B, S, H, hd) queries and (B, Sc, Hk, hd) cache, and gets its
// output in (B, Sq, H, hd) memory, with no copies either way.
// Query row i sits at position q_offset + i, key j at position j: the
// Pallas kernel is q_offset = 0, Sq = Sk; a serving prefill attends
// over a cache of Sk >= q_offset + Sq rows.  Key j is visible to the
// query at position p iff j > p - window and (if causal) j <= p; a
// hidden score is set to -1e9, as in the reference.  The arithmetic is
// the Pallas kernel's: q * (1/sqrt(hd)) in f32, s = q k^T, s = cap *
// tanh(s / cap) when cap > 0, the running m, l, acc updated per kv tile
// (m_new = max(m, rowmax s), p = exp(s - m_new), corr = exp(m - m_new),
// l = l corr + sum p, acc = acc corr + p v), o = acc / max(l, 1e-30).
// expf, tanhf and IEEE division; no fast-math flags.  Inputs f32 or
// bf16, accumulation f32, output in the input's type (bf16 rounded to
// nearest even).  On request it also writes each row's log-sum-exp, f32
// (B, H, Sq) contiguous, in the units of the JAX-level forward that the
// training attention saves for its backward (src/repro/models/layers.py
// :213): lse = m + log(max(l, 1e-30)) over the softcapped, scaled
// scores, from the same m and l as o (natural units: p = expf(s - m)).
//
// What bounds it on this card.  At gemma2-9b's serving prefill (B 2, H
// 16, Hk 8, Sq 8160, Sk 8192, hd 256) the visible scores cost 4 * hd
// operations each, ~1.1e12 for a global layer, against ~0.8 GB of q, k,
// v and o (0.24 ms at 3.35 TB/s): operations.  On the f32 units (67
// TFLOP/s) that is 16 ms; the tensor cores take TF32 at 495 TFLOP/s, but
// one TF32 product keeps ~11 bits and the model holds attention to f32.
// So every product is split in three: x = hi + lo, hi = tf32(x), lo =
// tf32(x - hi) (round to nearest, ties away, as cvt.rna.tf32.f32 does;
// done as an integer add and mask, the same bits for finite x, because
// the conversion instruction made the whole kernel measurably slower on
// the H100; x - hi is exact in f32), and a b ~ lo_a hi_b + hi_a lo_b + hi_a
// hi_b, summed in f32.  The dropped lo_a lo_b and lo's rounding are
// ~2^-23 of |a b|.  Three passes bound the layer at 3 x 1.09e12 / 495e12
// = 6.6 ms.  Against a float64 evaluation of the plain version's formula
// this is closer than the f32 plain version itself (which rounds q k^T
// as one FMA chain along hd), so chip_smoke holds the f32 sweep to the
// float64 value.  The design:
//   * one block is two warpgroups (256 threads) on a 64-row query tile
//     of one (batch, head), walking 32-key tiles from the first key any
//     of its rows can see to the last; a tile the causal or window mask
//     hides entirely is never loaded.  The grid runs the heaviest
//     (latest) query tiles first, so the causal triangle leaves no tail;
//   * s = q k^T is wgmma tf32 with both operands in shared memory,
//     K-major (tf32 wgmma takes no other major), unswizzled: 8-row bands
//     of hd/4 core matrices of 8 rows x 16 bytes (LBO 128 B, SBO 32 hd
//     B).  q is split once into a hi and a lo tile.  Each warpgroup
//     takes 16 keys of the tile, whose hi and lo bands sit next to each
//     other, so one m64n32k8 gives hi_q hi_k and hi_q lo_k and one
//     m64n16k8 gives lo_q hi_k; with wgmma's A read from shared memory
//     for every instruction, this is what bounds q k^T (shared-memory
//     bandwidth, not the tensor cores);
//   * the k tile comes through registers: each thread loads its 16-byte
//     chunks of tile t+1 while tile t runs, and splits them on the way
//     into the hi and lo bands; fence.proxy.async hands them to wgmma;
//   * softmax: each warpgroup caps, masks (only in tiles the masks cut)
//     and exponentiates its 16 keys; a row's max and sum are two quad
//     shuffles and one exchange through shared memory between the
//     warpgroups; p, split, goes to shared memory as m16n8k8 A
//     fragments (a lane's 4 values in one 16-byte slot), in the k tile's
//     lo bands at hd >= 128 (free until the next split);
//   * p v is mma.sync m16n8k8 tf32, not wgmma: tf32 wgmma needs v
//     transposed (hd x keys, K-major) and split in shared memory, and at
//     hd 256 q's split and k's take 192 KB of the 227.  v stays raw and
//     row-major (rows padded to hd + 4 floats), brought by one
//     cp.async.bulk a row on an mbarrier, and each warp splits the B
//     fragments it reads (two 4-byte reads, conflict-free).  A warp owns
//     up to 4 x 4 m16n8 tiles of the output, all 64 rows where hd
//     allows, so each v element is split by one warp (at hd 160,
//     stablelm-12b's, 2 x 5 tiles: two rows of four warps, each v
//     element split by two; at hd 96, zamba2's 80 zero-padded by the
//     wrapper, 2 x 3 tiles in the same two rows of four).  Inside each 8-key
//     block the key order is permuted (logical k t is key 2t, t + 4 is
//     2t + 1) in p's fragments and in the v rows alike, which matches
//     the wgmma accumulator's layout;
//   * keys past Sk get -inf (exact zero weight) and zero v rows; query
//     rows past Sq load zeros and are not stored.  window and causal
//     are runtime arguments, so local and global layers share one
//     compiled kernel; hd (32, 64, 96, 128, 160, 256) and the input type are
//     template parameters.  bf16 inputs, and f32 views whose k or v rows
//     are not 16-byte aligned, are read element by element (bf16 widened
//     to f32; its lo parts are zero but all three passes run).
// Shared memory at hd 256: q 128 KB, k 64 KB, v 33 KB, row statistics,
// 226 KB of the 227 (at hd 160: 80, 40 and 20.5 KB, 142 KB).  Left for later: with one tile of k and v in
// flight and the two warpgroups in step, a tile's loads, split,
// softmax and products follow one another, and in exploratory builds
// on the H100 that left out the products, most of the time remained.
// Warp specialisation (a producer warp issuing TMA into a ring of
// tiles, consumer warpgroups ping-ponging softmax against wgmma) needs
// the shared memory that q's split holds: lo q in registers (hd split
// across the warpgroups) would free it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;          // query rows of a block: wgmma's M
constexpr int BK = 32;          // keys of a kv tile; 16 a warpgroup in q k^T
constexpr int THREADS = 256;    // two warpgroups
constexpr float NEG_INF = -1.0e9f;

template <int HD>
struct Tile {
  static constexpr int C4 = HD / 4;                // 16-byte chunks a row
  static constexpr int NK = BK * C4 / THREADS;     // k chunks a thread
  static constexpr int BAND = 8 * HD;              // floats of an 8-row band
  static constexpr int LDV = HD + 4;               // padded v row (floats)
  // p v: a warp owns MT x NT m16n8 tiles of the 64 x HD output, HD / 16
  // of them (the 8 warps share its 4 x HD / 8 tiles); MT is the most of
  // the 4 row tiles that divides that count (4, or 2 at hd 160: 2 x 5,
  // and at hd 96: 2 x 3)
  static constexpr int MT = HD / 16 % 4 == 0 ? 4 : HD / 16 % 2 == 0 ? 2 : 1;
  static constexpr int NT = HD / 16 / MT;
  static constexpr int NGN = HD / 8 / NT;          // warps along the columns
  static constexpr int NGM = BQ / 16 / MT;         // warps along the rows
  static constexpr int QF = BQ * HD;               // a q tile (hi or lo)
  static constexpr int KF = 2 * BK * HD;           // the k tile, hi and lo
  static constexpr int VF = BK * LDV;
  static constexpr int STATF = 6 * BQ;             // row max, sum (x2), corr, l
  static constexpr int PF = 2 * BQ * BK;           // p, hi and lo fragments
  // at hd >= 128 p lives in the k tile's lo bands (free from the end of
  // q k^T to the next split), else after the row statistics
  static constexpr bool P_IN_K = HD >= 128;
  static constexpr size_t SMEM =
      sizeof(float) * (size_t)(2 * QF + KF + VF + STATF + (P_IN_K ? 0 : PF)) +
      sizeof(uint64_t);                            // the v tile's mbarrier
  static constexpr uint32_t SBO = 8 * HD * 4;      // bytes between 8-row bands

  // the tilings cover their tiles exactly: a hole would leave output
  // columns or k chunks unwritten, and nothing would report it
  static_assert(HD % 32 == 0, "hd: whole 8-row bands of 4-float chunks, "
                              "and v rows whose padding keeps p v's reads "
                              "conflict-free");
  static_assert(NGM * NGN == THREADS / 32 && NGM * MT * 16 == BQ &&
                    NGN * NT * 8 == HD,
                "p v: the warps' MT x NT m16n8 tiles must cover the 64 x "
                "HD output exactly, one warp each");
  static_assert(BK * C4 % THREADS == 0 && QF / 4 % THREADS == 0,
                "k and q chunks: a whole number a thread");
  static_assert(HD / 8 % 4 == 0, "q k^T: whole commit groups of 4 k steps");
  static_assert(!P_IN_K || 2 * BAND >= BQ * BK,
                "p's hi and lo fragments fit the k tile's lo bands");
  static_assert(SBO >> 4 < (1u << 14), "wgmma descriptor: SBO field");
  static_assert(SMEM <= 227 * 1024, "shared memory of one block");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// element strides of q, k, v and o: batch, head, row
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo: hi = tf32(x), lo = tf32(x - hi), both rounded to nearest
// (ties away); the low 13 bits of hi are cleared so that x - hi is the
// exact residual
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void split4(float4 x, float* hi, float* lo) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p, float mul) {
  return make_float4(to_f32(p[0]) * mul, to_f32(p[1]) * mul,
                     to_f32(p[2]) * mul, to_f32(p[3]) * mul);
}

// the v tile's arrival is counted on an mbarrier in shared memory: one
// arrival (with the tile's byte count) a phase, one phase a tile
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// bytes from global to shared memory by the copy engine, counted on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma's unswizzled K-major layout: 8-row bands of HD/4 core matrices
// (8 rows x 16 bytes, 128 contiguous bytes each); consecutive float4
// slots walk the 8 rows of a core matrix, then the next 16 bytes of those
// rows, then the next band.  Slot idx of a tile: band idx / (8 C4), row
// idx % 8 of it, column 4 ((idx / 8) % C4)
template <int HD>
__device__ __forceinline__ int slot_col(int idx) {
  return ((idx >> 3) % Tile<HD>::C4) * 4;
}

// the q tile times mul, split into its hi and lo tiles; rows [valid,
// 64) are zeros
template <int HD, typename T>
__device__ __forceinline__ void load_q(float* hi, float* lo,
                                       const T* __restrict__ src,
                                       long long ld, int valid, float mul) {
  constexpr int N = Tile<HD>::QF / 4 / THREADS;
#pragma unroll 4
  for (int it = 0; it < N; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = (idx / (8 * Tile<HD>::C4)) * 8 + (idx & 7);
    const float4 x = r < valid ? load4(src + r * ld + slot_col<HD>(idx), mul)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    split4(x, hi + 4 * idx, lo + 4 * idx);
  }
}

// The k tile: 8 bands, keys 0-15 hi (bands 0, 1) and lo (2, 3), keys
// 16-31 hi (4, 5) and lo (6, 7), so that one descriptor covers a
// warpgroup's 16 keys hi and lo.  Hi slot of chunk idx (idx < BK * C4):
template <int HD>
__device__ __forceinline__ int k_slot(int idx, int& row) {
  constexpr int PER_BAND = 8 * Tile<HD>::C4;       // slots of a band
  const int hb = idx / PER_BAND;                   // hi band 0..3 in key order
  row = hb * 8 + (idx & 7);
  return (hb + (hb & 2)) * PER_BAND + idx % PER_BAND;
}

// k rows [0, valid) of a tile into registers, this thread's chunks
// (zeros past valid); vec: 16-byte loads (f32 rows 16-byte aligned)
template <int HD, typename T>
__device__ __forceinline__ void fetch_k(float4 (&kr)[Tile<HD>::NK],
                                        const T* __restrict__ src,
                                        long long ld, int valid, bool vec) {
#pragma unroll
  for (int it = 0; it < Tile<HD>::NK; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    int r;
    k_slot<HD>(idx, r);
    const T* p = src + r * ld + slot_col<HD>(idx);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      if constexpr (std::is_same<T, float>::value) {
        if (vec) x = *reinterpret_cast<const float4*>(p);
        else x = load4(p, 1.f);
      } else {
        x = load4(p, 1.f);
      }
    }
    kr[it] = x;
  }
}

// the fetched chunks, split, into the hi bands and the lo bands two
// further on
template <int HD>
__device__ __forceinline__ void store_k(float* sk,
                                        const float4 (&kr)[Tile<HD>::NK]) {
#pragma unroll
  for (int it = 0; it < Tile<HD>::NK; ++it) {
    int r;
    float* p = sk + 4 * k_slot<HD>(threadIdx.x + it * THREADS, r);
    split4(kr[it], p, p + 2 * Tile<HD>::BAND);
  }
}

// v rows [0, valid) of a tile, raw, row-major in padded rows; rows past
// valid are zeros.  bulk (f32 rows 16-byte aligned): the lanes of warp 0
// start one cp.async.bulk a row, counted on bar, and nothing waits here;
// else every thread copies its 16-byte chunks through registers
template <int HD, typename T>
__device__ __forceinline__ void load_v(float* dst, const T* __restrict__ src,
                                       long long ld, int valid, bool bulk,
                                       uint64_t* bar) {
  using C = Tile<HD>;
  constexpr int N = BK * C::C4 / THREADS;
  if constexpr (std::is_same<T, float>::value) {
    if (bulk) {
      if (threadIdx.x < 32) {
        if (threadIdx.x == 0) {
          // the last tile's reads (generic proxy) before the copy's writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_expect_tx(bar, (uint32_t)(valid * HD * 4));
        }
        __syncwarp();
        if ((int)threadIdx.x < valid)
          bulk_copy(dst + threadIdx.x * C::LDV, src + threadIdx.x * ld,
                    HD * 4, bar);
      }
      if (valid < BK) {
#pragma unroll
        for (int it = 0; it < N; ++it) {
          const int idx = threadIdx.x + it * THREADS;
          const int r = idx / C::C4, c = (idx % C::C4) * 4;
          if (r >= valid)
            *reinterpret_cast<float4*>(dst + r * C::LDV + c) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int it = 0; it < N; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    const int r = idx / C::C4, c = (idx % C::C4) * 4;
    *reinterpret_cast<float4*>(dst + r * C::LDV + c) =
        r < valid ? load4(src + r * ld + c, 1.f)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// wgmma shared-memory descriptor, K-major, no swizzle: start address,
// LBO (next core matrix along K: 128 B) and SBO (next 8-row band), all
// in 16-byte units; base offset 0, layout type 0
__device__ __forceinline__ uint64_t kmajor_desc(const float* p, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) |
         ((uint64_t)(128u >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

#define FA_D4(d, i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// d = a b (+ d if accumulate): a (64 x 8) and b (8 x 8 NB) tf32 from
// shared memory
template <int NB>
struct Wgmma;
template <>
struct Wgmma<2> {
  static __device__ __forceinline__ void run(float (&d)[2][4], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : FA_D4(d, 0), FA_D4(d, 1)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
template <>
struct Wgmma<4> {
  static __device__ __forceinline__ void run(float (&d)[4][4], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : FA_D4(d, 0), FA_D4(d, 1), FA_D4(d, 2), FA_D4(d, 3)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
#undef FA_D4

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// s = q k^T for the warpgroup's 16 keys (kh: their hi bands, then their
// lo bands), 3 TF32 passes a k step: one m64n32k8 of hi q against the hi
// and lo bands (hi hi in columns 0-15, hi lo in 16-31) and one m64n16k8
// of lo q against the hi band.  s[i][0..3] are (row g, key 8i+2t), (g,
// 8i+2t+1), (g+8, 8i+2t), (g+8, 8i+2t+1) of the warp's 16 rows (g =
// lane / 4, t = lane % 4).  The tensor cores drop the low bits of each
// wgmma's sum, so a long chain into one accumulator drifts: the m64n32
// pair restarts every CHUNK k steps in one of NPART accumulators, each
// added to s in f32 (round to nearest) while the next one runs; lo hi
// (~2^-11 of s) runs the whole chain in one accumulator
template <int HD>
__device__ __forceinline__ void qk(float (&s)[2][4], uint64_t qh,
                                   uint64_t ql, uint64_t kh) {
  constexpr int CHUNK = 4, NPART = 2;             // k steps, accumulators
  constexpr int G = HD / 8 / CHUNK;                // commit groups
  float small[2][4], part[NPART][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i][j] = small[i][j] = 0.f;
      reg_fence(small[i][j]);
    }
#pragma unroll
    for (int n = 0; n < NPART; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[n][i][j] = 0.f;
        reg_fence(part[n][i][j]);
      }
  }
  // s += hi hi (columns 0-15 of a part) + hi lo (columns 16-31)
  auto add = [&](float (&p)[4][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        reg_fence(p[i][j]);
        reg_fence(p[2 + i][j]);
        s[i][j] = __fadd_rn(__fadd_rn(s[i][j], p[i][j]), p[2 + i][j]);
      }
  };
#pragma unroll
  for (int c = 0; c < G; ++c) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < CHUNK; ++kk) {
      const uint64_t off = (uint64_t)((c * CHUNK + kk) * 256) >> 4;
      Wgmma<4>::run(part[c % NPART], qh + off, kh + off, kk > 0);
      Wgmma<2>::run(small, ql + off, kh + off, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (c >= NPART - 1) {
      wgmma_wait<NPART - 1>();
      add(part[(c - NPART + 1) % NPART]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = G - NPART + 1 > 0 ? G - NPART + 1 : 0; c < G; ++c)
    add(part[c % NPART]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(small[i][j]);
      s[i][j] = __fadd_rn(s[i][j], small[i][j]);
    }
}

// d += a b: m16n8k8, a row-major (16 x 8), b col-major (8 x 8), tf32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += p v for the warp's MT x NT tiles (rows 16 m0.., columns 8 n0..):
// p's A fragments as the softmax stored them, hi and lo (pf: m-tile,
// 8-key block, lane, 4); in each 8-key block logical k = t is key 2t
// and k = t + 4 is key 2t + 1, in p and in the v rows a thread reads
template <int HD>
__device__ __forceinline__ void pv(
    float (&acc)[Tile<HD>::MT][Tile<HD>::NT][4], const float* ph,
    const float* pl, const float* sV, int m0, int n0, int lane) {
  using C = Tile<HD>;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kb = 0; kb < BK / 8; ++kb) {
    uint32_t ah[C::MT][4], al[C::MT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const int f = (((m0 + mt) * (BK / 8) + kb) * 32 + lane) * 4;
      const uint4 h = *reinterpret_cast<const uint4*>(ph + f);
      const uint4 l = *reinterpret_cast<const uint4*>(pl + f);
      ah[mt][0] = h.x; ah[mt][1] = h.y; ah[mt][2] = h.z; ah[mt][3] = h.w;
      al[mt][0] = l.x; al[mt][1] = l.y; al[mt][2] = l.z; al[mt][3] = l.w;
    }
    const float* v0 = sV + (8 * kb + 2 * t) * C::LDV + 8 * n0 + g;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      uint32_t bh[2], bl[2];
      split(v0[8 * nt], bh[0], bl[0]);              // (k t,     col g)
      split(v0[C::LDV + 8 * nt], bh[1], bl[1]);     // (k t + 4, col g)
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        mma_tf32(acc[mt][nt], al[mt], bh);
        mma_tf32(acc[mt][nt], ah[mt], bl);
        mma_tf32(acc[mt][nt], ah[mt], bh);
      }
    }
  }
}

// max / sum over the 4 threads of a quad, which share a row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          Strides st, int H, int Hk, int Sq, int Sk, int q_offset, int causal,
          int window, float scale, float cap, int aligned_kv) {
  // aligned_kv: f32 k and v rows 16-byte aligned (v by cp.async.bulk, k by
  // 16-byte register loads); else both are read element by element.
  // lse: null, or the (B, H, Sq) row log-sum-exp
  using C = Tile<HD>;
  extern __shared__ __align__(128) float smem[];
  float* sQh = smem;
  float* sQl = sQh + C::QF;
  float* sK = sQl + C::QF;
  float* sV = sK + C::KF;
  float* sMax = sV + C::VF;          // [2][64]: each warpgroup's row max
  float* sSum = sMax + 2 * BQ;       // [2][64]: each warpgroup's row sum
  float* sCorr = sSum + 2 * BQ;      // [64]
  float* sL = sCorr + BQ;            // [64]
  float* sPh = C::P_IN_K ? sK + 2 * C::BAND : sL + BQ;
  float* sPl = C::P_IN_K ? sK + 6 * C::BAND : sPh + BQ * BK;
  uint64_t* vbar = reinterpret_cast<uint64_t*>(
      (C::P_IN_K ? sL + BQ : sPl + BQ * BK));

  const int qt = gridDim.x - 1 - blockIdx.x;   // latest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const int wg = threadIdx.x / 128;            // keys 16 wg.. of a tile
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool aligned = aligned_kv != 0;

  const T* qb = q + b * st.q[0] + h * st.q[1] + q0 * st.q[2];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];
  T* ob = o + b * st.o[0] + h * st.o[1] + q0 * st.o[2];

  // the keys any row of this tile can see: [k_lo, k_hi]
  const long long p_lo = (long long)q_offset + q0;
  const long long p_hi = p_lo + q_rows - 1;
  const long long k_lo = p_lo - window + 1 > 0 ? p_lo - window + 1 : 0;
  const long long k_hi = causal && p_hi < Sk - 1 ? p_hi : Sk - 1;
  const int kt_first = (int)(k_lo / BK), kt_last = (int)(k_hi / BK);

  float4 kr[C::NK];
  {
    const int k0 = kt_first * BK, rows = min(BK, Sk - k0);
    fetch_k<HD>(kr, kb + k0 * st.k[2], st.k[2], rows, aligned);
    if (threadIdx.x == 0) mbar_init(vbar);
    __syncthreads();
    load_v<HD>(sV, vb + k0 * st.v[2], st.v[2], rows, aligned, vbar);
  }
  load_q<HD>(sQh, sQl, qb, st.q[2], q_rows, scale);
  const uint64_t dqh = kmajor_desc(sQh, C::SBO), dql = kmajor_desc(sQl, C::SBO);
  const uint64_t dk = kmajor_desc(sK + 4 * wg * C::BAND, C::SBO);

  // softmax: this thread's rows r0 = 16 warp + g and r1 = r0 + 8 of its
  // warpgroup's S; p v: the warp's m16n8 tiles
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const long long pos0 = p_lo + r0, pos1 = pos0 + 8;
  const int gw = threadIdx.x / 32;
  const int m0 = gw / C::NGN * C::MT, n0 = gw % C::NGN * C::NT;
  float m_0 = NEG_INF, m_1 = NEG_INF, l_0 = 0.f, l_1 = 0.f;
  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * BK, k1 = k0 + BK;
    store_k<HD>(sK, kr);
    if (kt < kt_last)                       // lands during this whole tile
      fetch_k<HD>(kr, kb + k1 * st.k[2], st.k[2], min(BK, Sk - k1),
                  aligned);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    float s[2][4];
    qk<HD>(s, dqh, dql, dk);

    // softcap and masks; every key of the tile is visible to every row
    // in the causal interior, away from the window's edge and Sk
    const bool all_visible = (!causal || k0 + BK - 1 <= p_lo) &&
                             k0 > p_hi - window && k0 + BK <= Sk;
    float rmax0 = -INFINITY, rmax1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[i][e], x1 = s[i][2 + e];
        if (cap > 0.f) {
          x0 = cap * tanhf(x0 / cap);
          x1 = cap * tanhf(x1 / cap);
        }
        if (!all_visible) {
          const int key = k0 + 16 * wg + 8 * i + 2 * t + e;
          const bool vis0 = key > pos0 - window && (!causal || key <= pos0);
          const bool vis1 = key > pos1 - window && (!causal || key <= pos1);
          x0 = key >= Sk ? -INFINITY : (vis0 ? x0 : NEG_INF);
          x1 = key >= Sk ? -INFINITY : (vis1 ? x1 : NEG_INF);
        }
        s[i][e] = x0;
        s[i][2 + e] = x1;
        rmax0 = fmaxf(rmax0, x0);
        rmax1 = fmaxf(rmax1, x1);
      }
    rmax0 = quad_max(rmax0);
    rmax1 = quad_max(rmax1);
    if (t == 0) {
      sMax[wg * BQ + r0] = rmax0;
      sMax[wg * BQ + r1] = rmax1;
    }
    __syncthreads();                        // the maxima; q k^T is done, so
                                            // p may take k's lo bands
    const float mn0 = fmaxf(m_0, fmaxf(sMax[r0], sMax[BQ + r0]));
    const float mn1 = fmaxf(m_1, fmaxf(sMax[r1], sMax[BQ + r1]));
    const float corr0 = expf(m_0 - mn0), corr1 = expf(m_1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = expf(s[i][e] - mn0);
        p[2 + e] = expf(s[i][2 + e] - mn1);
        rs0 += p[e];
        rs1 += p[2 + e];
      }
      // the A fragment of m-tile `warp`, 8-key block 2 wg + i: (g, k t),
      // (g + 8, k t), (g, k t + 4), (g + 8, k t + 4)
      const int f = ((warp * (BK / 8) + 2 * wg + i) * 32 + lane) * 4;
      split4(make_float4(p[0], p[2], p[1], p[3]), sPh + f, sPl + f);
    }
    rs0 = quad_sum(rs0);
    rs1 = quad_sum(rs1);
    if (t == 0) {
      sSum[wg * BQ + r0] = rs0;
      sSum[wg * BQ + r1] = rs1;
      if (wg == 0) {
        sCorr[r0] = corr0;
        sCorr[r1] = corr1;
      }
    }
    m_0 = mn0;
    m_1 = mn1;
    if (aligned) mbar_wait(vbar, (kt - kt_first) & 1);   // v has landed
    __syncthreads();                        // p and the sums
    l_0 = l_0 * corr0 + (sSum[r0] + sSum[BQ + r0]);
    l_1 = l_1 * corr1 + (sSum[r1] + sSum[BQ + r1]);
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const float c0 = sCorr[16 * (m0 + mt) + g];
      const float c1 = sCorr[16 * (m0 + mt) + g + 8];
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        acc[mt][nt][0] *= c0;
        acc[mt][nt][1] *= c0;
        acc[mt][nt][2] *= c1;
        acc[mt][nt][3] *= c1;
      }
    }
    pv<HD>(acc, sPh, sPl, sV, m0, n0, lane);
    __syncthreads();                        // every warp is done with v, p
    if (kt < kt_last)
      load_v<HD>(sV, vb + k1 * st.v[2], st.v[2], min(BK, Sk - k1), aligned,
                 vbar);
  }

  if (wg == 0 && t == 0) {
    sL[r0] = fmaxf(l_0, 1e-30f);
    sL[r1] = fmaxf(l_1, 1e-30f);
    if (lse != nullptr) {          // every thread of a row holds its m, l
      float* lb = lse + ((long long)b * H + h) * Sq + q0;
      if (r0 < q_rows) lb[r0] = m_0 + logf(fmaxf(l_0, 1e-30f));
      if (r1 < q_rows) lb[r1] = m_1 + logf(fmaxf(l_1, 1e-30f));
    }
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
    const int row = 16 * (m0 + mt) + g;
    const float d0 = sL[row], d1 = sL[row + 8];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int col = 8 * (n0 + nt) + 2 * t;
      if (row < q_rows)
        store2(ob + row * st.o[2] + col, acc[mt][nt][0] / d0,
               acc[mt][nt][1] / d0);
      if (row + 8 < q_rows)
        store2(ob + (row + 8) * st.o[2] + col, acc[mt][nt][2] / d1,
               acc[mt][nt][3] / d1);
    }
  }
}

// 16-byte aligned base and strides that keep every row 16-byte aligned
bool rows_aligned16(const void* p, const long long* s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % 4 == 0 &&
         s[1] % 4 == 0 && s[2] % 4 == 0;
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Strides& st, int b, int h, int hk, int sq, int sk,
           int q_offset, int causal, int window, float scale, float cap,
           cudaStream_t stream) {
  auto kernel = flash_fwd<HD, T>;
  // raise the dynamic shared memory limit once per device (not again
  // inside a CUDA graph capture, which replays only the launches)
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tile<HD>::SMEM);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  // f32 rows 16-byte aligned: v by cp.async.bulk, k by 16-byte loads;
  // bf16 and misaligned f32 views are read element by element
  const int aligned_kv = std::is_same<T, float>::value &&
                         rows_aligned16(k, st.k) && rows_aligned16(v, st.v);
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, THREADS, Tile<HD>::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, st, h, hk, sq, sk,
      q_offset, causal, window, scale, cap, aligned_kv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, const Strides& st, int b, int h, int hk, int sq,
             int sk, int hd, int q_offset, int causal, int window,
             float scale, float cap, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32, T>(q, k, v, o, lse, st, b, h, hk, sq, sk,
                           q_offset, causal, window, scale, cap,
                           stream);
    case 64:
      return launch<64, T>(q, k, v, o, lse, st, b, h, hk, sq, sk,
                           q_offset, causal, window, scale, cap,
                           stream);
    case 96:
      return launch<96, T>(q, k, v, o, lse, st, b, h, hk, sq, sk,
                           q_offset, causal, window, scale, cap,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, o, lse, st, b, h, hk, sq, sk,
                            q_offset, causal, window, scale, cap,
                            stream);
    case 160:
      return launch<160, T>(q, k, v, o, lse, st, b, h, hk, sq, sk,
                            q_offset, causal, window, scale, cap,
                            stream);
    case 256:
      return launch<256, T>(q, k, v, o, lse, st, b, h, hk, sq, sk,
                            q_offset, causal, window, scale, cap,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (b, h, sq, hd); k, v: (b, hk, sk, hd), f32 or (bf16 != 0)
// bf16, the last dim contiguous; strides: 12 element strides, batch,
// head and row of q, k, v, o in turn; h % hk == 0, hd in {32, 64, 96,
// 128, 160, 256}, q_offset + sq <= sk, window >= 1 (the wrapper checks all of
// it); scale = f32(1 / sqrt(hd)); cap <= 0 disables the softcap; lse:
// null, or f32 (b, h, sq) contiguous for the rows' log-sum-exp
int rt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, void* lse, const long long* strides,
                           int b, int h, int hk, int sq, int sk, int hd,
                           int q_offset, int causal, int window, float scale,
                           float cap, int bf16, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, l, st, b, h, hk, sq, sk, hd,
                                   q_offset, causal, window, scale, cap, cs);
  return dispatch<float>(q, k, v, o, l, st, b, h, hk, sq, sk, hd, q_offset,
                         causal, window, scale, cap, cs);
}

}  // extern "C"
