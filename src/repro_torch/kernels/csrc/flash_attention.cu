// Flash-attention forward for Hopper (sm_90a), float32 on the CUDA cores.
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
// expf, tanhf and IEEE division; no fast-math flags; f32 products only
// (no TF32, no tensor cores).  Inputs f32 or bf16, accumulation f32,
// output in the input's type (bf16 rounded to nearest even).
//
// What bounds it on this card: operations.  At gemma2-9b's serving
// prefill (B 2, H 16, Hk 8, Sq 8160, Sk 8192, hd 256) the visible
// scores cost 4 * hd f32 operations each, ~1.1e12 for a global layer
// (16 ms at 67 TFLOP/s) against ~0.8 GB of q, k, v and o (0.24 ms at
// 3.35 TB/s): over a thousand operations a byte, far above the ~20
// the f32 units need before memory is the limit.  So the design spends its
// effort on keeping the f32 units fed from shared memory and on doing
// no work for hidden scores:
//   * one block of 256 threads owns a 64-row query tile of one (batch,
//     head) and walks the 64-key tiles from the first key any of its
//     rows can see to the last; a tile the causal or window mask hides
//     entirely is never loaded (its terms are exactly 0 once a row has
//     seen a visible key).  The grid runs the heaviest (latest) query
//     tiles first, so the causal triangle does not leave a tail;
//   * the q tile (scaled), then each k tile and v tile in turn, are
//     staged in shared memory as f32 (dynamic shared memory: 150 KB at
//     hd 256, past the 48 KB static limit, so the launcher raises the
//     limit with cudaFuncSetAttribute and checks cudaGetLastError);
//     rows are padded by 4 floats so the float4 reads of 16 different
//     key rows fall on different banks;
//   * each thread computes a 4 x 4 block of the 64 x 64 score tile
//     (rows ty + 16i, keys tx + 16j) from float4 reads, 16 FMAs for
//     every 8 reads; a row's max and sum are shuffles among the 16
//     threads that share it, and the same thread owns the same 4 rows of
//     the output accumulator (4 x hd/16 floats in registers), so the
//     correction factor never leaves the thread;
//   * the probabilities go through a padded shared tile to the p v
//     product; k and v share one buffer (loaded in turn), which keeps
//     hd 256 at 150 KB of shared memory.
// Ragged Sq and Sk: rows past Sq load zeros and are not stored; keys
// past Sk get -inf (exact zero weight) and zero v rows.  window and
// causal are runtime arguments, so local and global layers share one
// compiled kernel; hd (32, 64, 128, 256) and the input type are
// template parameters.  Not done here (a later PR's work): bf16 wgmma,
// TMA or cp.async double-buffering of the k/v tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows of a block
constexpr int BK = 64;         // keys of a kv tile
constexpr int THREADS = 256;   // 16 x 16: ty picks rows, tx picks keys
constexpr int TR = BQ / 16;    // rows of a thread
constexpr int TC = BK / 16;    // keys of a thread in the score tile
constexpr float NEG_INF = -1.0e9f;

template <int HD>
struct Tile {
  static constexpr int LD = HD + 4;             // padded q / kv row (floats)
  static constexpr int LDP = BK + 16;           // padded probability row
  static constexpr int CHUNKS = HD / 4;         // float4 columns of a row
  static constexpr int CPT = (CHUNKS + 15) / 16;  // of them, per thread
  static constexpr size_t SMEM =
      sizeof(float) * (size_t)((BQ + BK) * LD + BQ * LDP);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// element strides of q, k, v and o: batch, head, row
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

// rows [0, valid) of a (rows, HD) source, ld elements between rows,
// into a padded f32 tile, times mul; rows [valid, 64) become zeros.
// A thread keeps one column and walks rows THREADS / HD apart, so the
// row stride costs one pointer add a row.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long ld, int valid, float mul) {
  static_assert(THREADS % HD == 0, "a pass must cover whole rows");
  constexpr int STEP = THREADS / HD;
  const int c = threadIdx.x % HD;
  int r = threadIdx.x / HD;
  const T* p = src + r * ld + c;
#pragma unroll 8
  for (; r < 64; r += STEP, p += STEP * ld)
    dst[r * Tile<HD>::LD + c] = r < valid ? to_f32(*p) * mul : 0.f;
}

// max / sum over the 16 lanes that share a row (one half-warp)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides st, int H,
          int Hk, int Sq, int Sk, int q_offset, int causal, int window,
          float scale, float cap) {
  using C = Tile<HD>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sKV = sQ + BQ * C::LD;
  float* sP = sKV + BK * C::LD;

  const int qt = gridDim.x - 1 - blockIdx.x;   // latest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hk);
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, Sq - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

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

  load_tile<HD>(sQ, qb, st.q[2], q_rows, scale);

  float m[TR], l[TR], acc[TR][C::CPT * 4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CPT * 4; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * BK;
    const int k_rows = min(BK, Sk - k0);
    __syncthreads();                      // the last tile's v reads are done
    load_tile<HD>(sKV, kb + k0 * st.k[2], st.k[2], k_rows, 1.f);
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[TR], ka[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * i) * C::LD + d]);
#pragma unroll
      for (int j = 0; j < TC; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&sKV[(tx + 16 * j) * C::LD + d]);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // softcap, masks, and the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const long long pos = p_lo + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int key = k0 + tx + 16 * j;
        float x = s[i][j];
        if (cap > 0.f) x = cap * tanhf(x / cap);
        const bool vis = key > pos - window && (!causal || key <= pos);
        x = key >= Sk ? -INFINITY : (vis ? x : NEG_INF);
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(rmax));
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        sP[(ty + 16 * i) * C::LDP + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + half_warp_sum(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::CPT * 4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                      // k reads done, p written
    load_tile<HD>(sKV, vb + k0 * st.v[2], st.v[2], k_rows, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) p[i] = sP[(ty + 16 * i) * C::LDP + j];
#pragma unroll
      for (int cc = 0; cc < C::CPT; ++cc) {
        const int chunk = tx + 16 * cc;
        if (chunk < C::CHUNKS) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&sKV[j * C::LD + chunk * 4]);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            acc[i][cc * 4 + 0] = fmaf(p[i], vv.x, acc[i][cc * 4 + 0]);
            acc[i][cc * 4 + 1] = fmaf(p[i], vv.y, acc[i][cc * 4 + 1]);
            acc[i][cc * 4 + 2] = fmaf(p[i], vv.z, acc[i][cc * 4 + 2]);
            acc[i][cc * 4 + 3] = fmaf(p[i], vv.w, acc[i][cc * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = ty + 16 * i;
    if (row < q_rows) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int cc = 0; cc < C::CPT; ++cc) {
        const int chunk = tx + 16 * cc;
        if (chunk < C::CHUNKS) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            store(&ob[row * st.o[2] + chunk * 4 + e],
                  acc[i][cc * 4 + e] / denom);
        }
      }
    }
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
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
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, THREADS, Tile<HD>::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, h, hk, sq, sk,
      q_offset, causal, window, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const Strides& st, int b, int h, int hk, int sq, int sk, int hd,
             int q_offset, int causal, int window, float scale, float cap,
             cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32, T>(q, k, v, o, st, b, h, hk, sq, sk, q_offset,
                           causal, window, scale, cap, stream);
    case 64:
      return launch<64, T>(q, k, v, o, st, b, h, hk, sq, sk, q_offset,
                           causal, window, scale, cap, stream);
    case 128:
      return launch<128, T>(q, k, v, o, st, b, h, hk, sq, sk, q_offset,
                            causal, window, scale, cap, stream);
    case 256:
      return launch<256, T>(q, k, v, o, st, b, h, hk, sq, sk, q_offset,
                            causal, window, scale, cap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (b, h, sq, hd); k, v: (b, hk, sk, hd), f32 or (bf16 != 0)
// bf16, the last dim contiguous; strides: 12 element strides, batch,
// head and row of q, k, v, o in turn; h % hk == 0, hd in {32, 64, 128,
// 256}, q_offset + sq <= sk, window >= 1 (the wrapper checks all of
// it); scale = f32(1 / sqrt(hd)); cap <= 0 disables the softcap
int rt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, const long long* strides, int b, int h,
                           int hk, int sq, int sk, int hd, int q_offset,
                           int causal, int window, float scale, float cap,
                           int bf16, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, st, b, h, hk, sq, sk, hd,
                                   q_offset, causal, window, scale, cap, cs);
  return dispatch<float>(q, k, v, o, st, b, h, hk, sq, sk, hd, q_offset,
                         causal, window, scale, cap, cs);
}

}  // extern "C"
