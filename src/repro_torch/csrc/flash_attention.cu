// flash_attention: blockwise online-softmax attention for the LM prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel).  Same function:
//
//   o[b, h, i, :] = sum_j softmax_j(s_ij) * v[b, h / G, j, :],
//   s_ij = cap * tanh((q_ij . k_j) / cap)          (cap > 0; else q . k)
//
// with q pre-scaled by D^-0.5 in q's dtype, G = Hq / Hkv query heads per KV
// head (GQA), and (i, j) unmasked iff j < kv_len[b], j <= qpos (causal) and
// j > qpos - window (window > 0), where qpos = kv_len[b] - Sq + i: queries
// are right-aligned to the valid keys, as in a decode-style padded cache.
// The running max, running sum and accumulator are f32 whatever the input
// type; the output is rounded once to the input type.  The -1e30 sentinel
// and the m_safe guard are the reference's, so an all-masked row gives 0.
//
// What bounds it on the H100: operations.  At gemma2's prefill (Hq = 16,
// D = 256, S = 6144, causal) the two products are ~309 GFLOP against
// ~151 MB of q, k, v and o in bf16: far above the ~295 FLOP/byte ridge.
//
// What the design does (a first, simple kernel: plain f32 FMA, no tensor
// cores, no TMA -- those come in a later change):
//   * One CTA of 256 threads per (q tile of 64 rows, head, batch) loops
//     over KV tiles of 32 keys with an online softmax.  The TPU kernel's
//     sequential KV grid axis becomes this loop; the running max and sum
//     live in registers, replicated across the 16 threads of a row group.
//   * Thread (ty, tx) owns rows ty + 16 i (i < 4) in both products: score
//     columns tx + 16 j (j < 2) and output columns tx + 16 c (c < D / 16),
//     so row max and row sum are 16-lane shuffles and the rescale by
//     alpha touches registers only.
//   * q, k and v are staged in shared memory as f32 with a row stride of
//     D + 1 (conflict-free column reads).  At D = 256 that is ~105 KB, so
//     the kernel takes dynamic shared memory with the opt-in; two CTAs fit
//     on an SM.  K and V share one buffer.
//   * The KV loop runs only over tiles that hold an unmasked key for some
//     row of the q tile: tiles above the causal edge, before the window or
//     past kv_len[b] are never loaded, and the state is never touched.
//   * Ragged Sq and Sk are bounds-checked; nothing is padded in memory.
//   * Causal q tiles are launched heaviest first (the last tile of a
//     sequence has the most keys), so the tail of the grid is short.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileQ = 64;
constexpr int kTileK = 32;
constexpr int kThreads = 256;     // 16 x 16
constexpr int kLdP = kTileK + 1;  // row stride of the probabilities
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + rows) of a (n, D) matrix into shared memory as f32
// with row stride D + 1; rows at or past n are zero (never NaN, so a zero
// probability times them stays zero).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           int row0, int rows, int n,
                                           float scale, bool round_scaled) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (row0 + r < n) {
      x = to_f32(src[static_cast<int64_t>(row0 + r) * D + c]);
      // q * D^-0.5 rounded to q's type, as the reference forms it
      if (round_scaled) x = to_f32(from_f32<T>(x * scale));
    }
    dst[r * (D + 1) + c] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ kv_len, T* __restrict__ out,
                       int hq, int group, int sq, int sk, int causal,
                       int window, float cap, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;                  // (kTileQ, kLd)
  float* s_kv = s_q + kTileQ * kLd;   // (kTileK, kLd): K, then V
  float* s_p = s_kv + kTileK * kLd;   // (kTileQ, kLdP)

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / group;
  const int nq = min(kTileQ, sq - q0);
  const int len = kv_len[b];
  const int q_lo = len - sq + q0;  // absolute position of the tile's row 0

  const T* qb = q + (static_cast<int64_t>(b) * hq + h) * sq * D;
  const int64_t kv_off = (static_cast<int64_t>(b) * hkv + h / group) * sk * D;
  stage_rows<T, D>(s_q, qb, q0, kTileQ, sq, scale, true);

  // KV tiles holding an unmasked key for some row of this q tile
  int k_end = min(len, sk);
  if (causal) k_end = min(k_end, q_lo + nq);
  int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_beg -= k_beg % kTileK;

  float acc[4][kCols];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_beg; k0 < k_end; k0 += kTileK) {
    __syncthreads();  // q staged; the previous tile's V and P are consumed
    stage_rows<T, D>(s_kv, k + kv_off, k0, kTileK, sk, 0.f, false);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = s_kv[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    __syncthreads();  // every thread is done reading K
    stage_rows<T, D>(s_kv, v + kv_off, k0, kTileK, sk, 0.f, false);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + ty + 16 * i;
      bool ok[2];
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (cap > 0.f) x = cap * tanhf(x / cap);
        ok[j] = kpos < len && kpos < sk && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? x : kNegInf;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_new = fmaxf(m_run[i], m_cur);
      // guard all-masked rows (m_new is still the sentinel)
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        s_p[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        p_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      const float alpha =
          m_run[i] <= kNegInf / 2 ? 0.f : expf(m_run[i] - m_safe);
      l_run[i] = l_run[i] * alpha + p_sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // V and P staged

#pragma unroll 4
    for (int kk = 0; kk < kTileK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_p[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = s_kv[kk * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = out + (static_cast<int64_t>(b) * hq + h) * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row >= nq) continue;
    const float denom = l_run[i] == 0.f ? 1.f : l_run[i];
    T* o = ob + static_cast<int64_t>(q0 + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      o[tx + 16 * c] = from_f32<T>(acc[i][c] / denom);
  }
}

constexpr int smem_bytes_for(int d) {
  return ((kTileQ + kTileK) * (d + 1) + kTileQ * kLdP) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, int b, int hq, int hkv, int sq, int sk, int causal,
           int window, float cap, float scale, cudaStream_t stream) {
  const int smem = smem_bytes_for(D);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kTileQ - 1) / kTileQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), hq, hq / hkv,
      sq, sk, causal, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const int* kv_len, void* out, int b, int hq, int hkv, int sq,
               int sk, int causal, int window, float cap, float scale,
               cudaStream_t stream) {
  switch (d) {
#define REPRO_FLASH_D(DV)                                                  \
  case DV:                                                                 \
    return launch<T, DV>(q, k, v, kv_len, out, b, hq, hkv, sq, sk, causal, \
                         window, cap, scale, stream);
    REPRO_FLASH_D(16)
    REPRO_FLASH_D(32)
    REPRO_FLASH_D(64)
    REPRO_FLASH_D(128)
    REPRO_FLASH_D(256)
#undef REPRO_FLASH_D
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dynamic shared memory one launch takes at head dim d, in bytes (the
// wrapper checks it against the card's per-block limit).
extern "C" int flash_attention_smem_bytes(int d) { return smem_bytes_for(d); }

// q: (b, hq, sq, d); k, v: (b, hkv, sk, d); out: (b, hq, sq, d), all of one
// type (bf16 = 0: f32, bf16 = 1: bf16), contiguous; kv_len: (b,) int32.
// d is one of 16, 32, 64, 128, 256.  Returns the first CUDA error of the
// attribute call or the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* kv_len,
                                   void* out, int b, int hq, int hkv, int sq,
                                   int sk, int d, int causal, int window,
                                   float cap, float scale, int bf16,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, kv_len, out, b, hq, hkv,
                                     sq, sk, causal, window, cap, scale, st);
  return dispatch_d<float>(d, q, k, v, kv_len, out, b, hq, hkv, sq, sk,
                           causal, window, cap, scale, st);
}
