// seg_agg: blocked segmented row sum with the gather inside the kernel.
//
// Replaces the TPU kernel src/repro/kernels/seg_agg.py::seg_agg_blocked
// (body _seg_agg_kernel), which folds pre-gathered (nblocks, emax, F) edge
// rows into each destination block with a one-hot MXU matmul.  Its GPU
// sibling, src/repro/kernels/gpu_agg.py::seg_agg_gpu_blocked, has the same
// contract and is served by this kernel too.
//
//   out[b * tile_m + m, :] = sum over slots e of block b with dstl[b, e] == m
//                            and mask[b, e] != 0 of
//                            mask[b, e] * weight[b, e] * x[src[b, e], :]
//
// Layout (core/dataflow.py BlockedGraph, as block_graph builds it): in each
// block the valid slots (mask != 0) come first and are sorted by dstl; pad
// slots follow.  Pad slots are never read past, so never multiplied by 0.
// Every output row is written once; each term is rounded as coef * x and
// then added (__fmul_rn/__fadd_rn, no FMA contraction); each row is folded
// in slot order, so the result is deterministic.
//
// What bounds it on the H100: bytes.  One add per gathered element, far
// below the card's ~20 FLOP/byte f32 balance.  Each input read once is the
// floor (0.11 ms at Reddit's F = 128), but the gathered rows are E * F * 4
// bytes (5.9 GB at F = 128): a source row is gathered ~50 times, so what
// the kernel can reach is set by where those gathers hit -- HBM (3.35 TB/s)
// or the 50 MB L2.
//
// What the design does about it (two launches: row_starts, then fold):
//   * Column slices.  The fold's slow grid dimension is a slice of
//     slice_cols columns, so the CTAs in flight at any moment all gather
//     from one slice of x and a source row's slice is read from HBM about
//     once per slice, not once per edge.  Each slice is one more pass over
//     the indices and one more round of per-slot instructions, so the slice
//     is as wide as a fold unit holds: 64 columns, 59.6 MB of x at Reddit,
//     1.19 x the L2.  The power-law sources keep their hot rows resident
//     even so (measured on the H100 at Reddit: 64 columns beat 32 at
//     F = 128 and 602; chip_smoke.py's slice sweep).
//   * Warps split a block by destination rows.  row_starts finds, once per
//     block, where each destination row's slots start (no atomics); every
//     slice's fold CTA reads those tile_m + 1 integers instead of the
//     block's dstl.  A fold CTA of 256 threads is 32 fold units of 8
//     lanes; each unit gets a contiguous range of rows holding an equal
//     share of the block's slots and folds them one slot at a time in slot
//     order, so no two units touch one row and the serial chain is a few
//     hundred slots, not the block's thousands.  Four units share a warp,
//     so one warp instruction advances four slots.
//   * Memory-level parallelism and vector loads.  Lane i of a unit loads
//     slot i of the next batch (src, mask, weight) one batch ahead, and the
//     unit broadcasts them with shuffles; then each lane starts all of the
//     batch's gathers before the first add.  A lane's columns are VEC
//     floats wide -- 16-byte loads when F % 4 == 0, 8-byte when F % 2 == 0,
//     4-byte otherwise -- C of them per slot, at most 8 floats a lane.
//   * Few instructions per slot: each warp runs as many batches as its
//     busiest unit, so the shuffles are full-warp; a batch inside one row
//     adds without per-slot checks, and without the multiply when every
//     coefficient is 1 (1 * x == x, so the sum is bit for bit the same).
//   * No barrier inside the fold: after the row starts are read the units
//     run independently.  Outputs are streamed (st.cs) so they do not push
//     the slice of x out of L2.
//   * bf16 (the reference's bf16 rows, rounded once at its flush): x and
//     out are bf16, everything between is f32.  A load converts each
//     element exactly (bf16 is the top half of an f32), the fold is the
//     f32 fold above, and the store rounds once (__float2bfloat16_rn).
//     VEC counts elements, so a 16-byte load holds 8 bf16; a row of an
//     odd-width bf16 matrix may be only 2-byte aligned (F = 41: 82 bytes),
//     and F = 602 rows are 1,204 bytes, 4-byte aligned: 2-element loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // slots a row_starts thread loads at once
constexpr int kLanes = 8;   // lanes of a fold unit: 4 units share a warp

using bf16 = __nv_bfloat16;

// VEC elements at p into d as floats, one load of VEC * sizeof(T) bytes
template <int VEC>
__device__ __forceinline__ void load_vec(float* d, const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = t.x, d[1] = t.y, d[2] = t.z, d[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = t.x, d[1] = t.y;
  } else {
    d[0] = __ldg(p);
  }
}

// two bf16 of a 32-bit word, the lower address in the low half
__device__ __forceinline__ void unpack2(float* d, uint32_t w) {
  d[0] = __uint_as_float(w << 16);
  d[1] = __uint_as_float(w & 0xffff0000u);
}

template <int VEC>
__device__ __forceinline__ void load_vec(float* d, const bf16* p) {
  if constexpr (VEC == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    unpack2(d, t.x), unpack2(d + 2, t.y), unpack2(d + 4, t.z),
        unpack2(d + 6, t.w);
  } else if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    unpack2(d, t.x), unpack2(d + 2, t.y);
  } else if constexpr (VEC == 2) {
    unpack2(d, __ldg(reinterpret_cast<const unsigned int*>(p)));
  } else {
    d[0] = __uint_as_float(
        static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p)))
        << 16);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* s) {
  if constexpr (VEC == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(s[0], s[1], s[2], s[3]));
  else if constexpr (VEC == 2)
    __stcs(reinterpret_cast<float2*>(p), make_float2(s[0], s[1]));
  else
    __stcs(p, s[0]);
}

// the one rounding of the bf16 path: f32 sums to bf16, to nearest even
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const float* s) {
  if constexpr (VEC == 8)
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(pack2(s[0], s[1]), pack2(s[2], s[3]), pack2(s[4], s[5]),
                      pack2(s[6], s[7])));
  else if constexpr (VEC == 4)
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(pack2(s[0], s[1]), pack2(s[2], s[3])));
  else if constexpr (VEC == 2)
    __stcs(reinterpret_cast<unsigned int*>(p), pack2(s[0], s[1]));
  else
    __stcs(reinterpret_cast<unsigned short*>(p),
           __bfloat16_as_ushort(__float2bfloat16_rn(s[0])));
}

// starts[b, m] = first slot of block b holding a row >= m (n_valid, the
// first pad slot, if none), for m <= tile_m: rows [a, c) of the block own
// slots [starts[b, a], starts[b, c]).  One CTA per block.
__global__ void __launch_bounds__(kThreads)
row_starts_kernel(const int* __restrict__ dstl,
                  const float* __restrict__ mask, int* __restrict__ starts,
                  int emax, int tile_m) {
  extern __shared__ int s_start[];  // tile_m + 1
  __shared__ int s_nvalid;
  const int tid = threadIdx.x;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * emax;
  for (int m = tid; m < tile_m; m += kThreads) s_start[m] = INT_MAX;
  if (tid == 0) s_nvalid = emax;
  __syncthreads();
  // slot e starts its row if it is valid and its predecessor (valid, as
  // valid slots come first) has another row; the first pad slot is n_valid
  for (int base = tid; base < emax; base += kThreads * kUnroll) {
    float mk[kUnroll], mp[kUnroll];
    int r[kUnroll], rp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * kThreads;
      const bool in = e < emax, prev = in && e > 0;
      mk[u] = in ? __ldcs(mask + slot0 + e) : 0.f;
      mp[u] = prev ? __ldg(mask + slot0 + e - 1) : 0.f;
      r[u] = in ? __ldcs(dstl + slot0 + e) : -1;
      rp[u] = prev ? __ldg(dstl + slot0 + e - 1) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * kThreads;
      if (e >= emax) continue;
      if (mk[u] != 0.f) {
        if (e == 0 || rp[u] != r[u]) s_start[r[u]] = e;
      } else if (e == 0 || mp[u] != 0.f) {
        s_nvalid = e;
      }
    }
  }
  __syncthreads();
  // suffix minimum over rows: an empty row starts where the next row does
  if (tid < 32) {
    const int nvalid = s_nvalid;
    int carry = nvalid;
    for (int base = (tile_m - 1) / 32 * 32; base >= 0; base -= 32) {
      const int m = base + tid;
      int v = m < tile_m ? s_start[m] : INT_MAX;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int o = __shfl_down_sync(0xffffffffu, v, off);
        if (tid + off < 32) v = min(v, o);
      }
      v = min(v, carry);
      if (m < tile_m) s_start[m] = v;
      carry = __shfl_sync(0xffffffffu, v, 0);
    }
    if (tid == 0) s_start[tile_m] = nvalid;
  }
  __syncthreads();
  int* out = starts + static_cast<int64_t>(blockIdx.x) * (tile_m + 1);
  for (int m = tid; m <= tile_m; m += kThreads) out[m] = s_start[m];
}

// One CTA per (destination block, column slice).  A unit is kLanes lanes;
// lane li owns columns c0 + (cc * kLanes + li) * VEC .. + VEC - 1 of the
// slice for cc < C.  T is the element type of x and out (float or bf16);
// the fold is f32 either way.
template <typename T, int VEC, int C>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const T* __restrict__ x, int f, const int* __restrict__ src,
            const float* __restrict__ mask,
            const float* __restrict__ weight,
            const int* __restrict__ starts, T* __restrict__ out,
            int emax, int tile_m, int slice_cols) {
  constexpr int L = kLanes;
  constexpr int kUnits = kThreads / L;  // fold units of a CTA
  constexpr int kBatch = L;             // slots a unit gathers at once
  static_assert(C * VEC <= 8, "a lane holds at most 8 values of a slot");
  extern __shared__ int s_start[];      // tile_m + 1
  const int tid = threadIdx.x;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x) * emax;
  const int* blk = starts + static_cast<int64_t>(blockIdx.x) * (tile_m + 1);
  for (int m = tid; m <= tile_m; m += kThreads) s_start[m] = __ldg(blk + m);
  __syncthreads();

  // this unit's rows [r_lo, r_hi): unit k starts at the first row whose
  // slots start at or after k / kUnits of the block's valid slots
  const int unit = tid / L, li = tid % L;
  const int nvalid = s_start[tile_m];
  auto first_row = [&](int k) {
    if (k == 0) return 0;
    if (k == kUnits) return tile_m;
    const int target =
        static_cast<int>(static_cast<int64_t>(k) * nvalid / kUnits);
    int lo = 0, hi = tile_m;  // s_start[tile_m] = nvalid >= target
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (s_start[mid] >= target) hi = mid;
      else lo = mid + 1;
    }
    return lo;
  };
  const int r_lo = first_row(unit), r_hi = first_row(unit + 1);
  const int e_lo = s_start[r_lo], e_hi = s_start[r_hi];
  // Every lane of a warp runs the same number of batches (the most any of
  // its units needs), so the shuffles below are full-warp and need no
  // convergence check; a unit past its end just adds nothing.
  int batches = (e_hi - e_lo + kBatch - 1) / kBatch;
#pragma unroll
  for (int off = L; off < 32; off *= 2)
    batches = max(batches, __shfl_xor_sync(0xffffffffu, batches, off));

  const int c0 = blockIdx.y * slice_cols;
  const int cols = min(slice_cols, f - c0);
  const T* xs = x + c0;
  T* out_blk = out + static_cast<int64_t>(blockIdx.x) * tile_m * f + c0;
  // a lane whose columns lie past the slice loads column 0 (the same line
  // as its unit's other loads) and never stores
  int col_ld[C];
#pragma unroll
  for (int cc = 0; cc < C; ++cc) {
    const int col = (cc * L + li) * VEC;
    col_ld[cc] = col < cols ? col : 0;
  }
  float acc[C][VEC];
#pragma unroll
  for (int cc = 0; cc < C; ++cc)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[cc][q] = 0.f;
  auto store_row = [&](int r) {
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      const int col = (cc * L + li) * VEC;
      if (col < cols)
        store_vec<VEC>(out_blk + static_cast<int64_t>(r) * f + col, acc[cc]);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[cc][q] = 0.f;
    }
  };

  int row = r_lo;
  int next = r_lo < r_hi ? s_start[r_lo + 1] : 0;  // first slot past `row`
  int p_src = 0;  // always a valid row of x: 0 or a loaded src
  float p_coef = 0.f;
  auto fetch = [&](int e) {  // lane li: slot e + li of the next batch
    if (e + li < e_hi) {
      const int64_t s = slot0 + e + li;
      p_src = __ldg(src + s);
      const float m = __ldg(mask + s);
      p_coef = weight != nullptr ? m * __ldg(weight + s) : m;
    }
  };
  fetch(e_lo);
  for (int i = 0; i < batches; ++i) {
    const int e = e_lo + i * kBatch;
    const int cur_src = p_src;
    const float cur_coef = p_coef;
    fetch(e + kBatch);  // the next batch's indices load during this one
    const int n = min(kBatch, e_hi - e);  // <= 0 once this unit is done
    float v[kBatch][C][VEC];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int su = __shfl_sync(0xffffffffu, cur_src, u, L);
      const T* xr = xs + static_cast<int64_t>(su) * f;
#pragma unroll
      for (int cc = 0; cc < C; ++cc) load_vec<VEC>(v[u][cc], xr + col_ld[cc]);
    }
    // when every lane's coefficient is 1 (no edge weight: the common case)
    // the products are the gathered values themselves (1 * x == x, bit for
    // bit) and no coefficient needs broadcasting; the vote and the branch
    // are warp-uniform, so the shuffles stay full-warp
    const bool ones = __all_sync(0xffffffffu, cur_coef == 1.f);
    float cf[kBatch];
    if (ones) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) cf[u] = 1.f;
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        cf[u] = __shfl_sync(0xffffffffu, cur_coef, u, L);
    }
    if (n == kBatch && e + kBatch <= next) {
      // the whole batch adds into the current row: no per-slot checks
      if (ones) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int cc = 0; cc < C; ++cc)
#pragma unroll
            for (int q = 0; q < VEC; ++q)
              acc[cc][q] = __fadd_rn(acc[cc][q], v[u][cc][q]);
      } else {
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int cc = 0; cc < C; ++cc)
#pragma unroll
            for (int q = 0; q < VEC; ++q)
              acc[cc][q] =
                  __fadd_rn(acc[cc][q], __fmul_rn(cf[u], v[u][cc][q]));
      }
    } else {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u < n) {
          while (e + u >= next) {  // row `row` is complete (or empty)
            store_row(row);
            next = s_start[++row + 1];
          }
          // no contraction into an FMA: each term is rounded as the plain
          // version rounds it (coef * x, then the add)
#pragma unroll
          for (int cc = 0; cc < C; ++cc)
#pragma unroll
            for (int q = 0; q < VEC; ++q)
              acc[cc][q] =
                  __fadd_rn(acc[cc][q], __fmul_rn(cf[u], v[u][cc][q]));
        }
      }
    }
  }
  for (; row < r_hi; ++row) store_row(row);  // the last row, empty rows
}

template <typename T, int VEC, int C>
int launch(const T* x, const int* src, const int* dstl, const float* mask,
           const float* weight, int* starts, T* out, int nblocks,
           int emax, int f, int tile_m, int slice_cols, cudaStream_t stream) {
  const int smem = (tile_m + 1) * static_cast<int>(sizeof(int));
  row_starts_kernel<<<nblocks, kThreads, smem, stream>>>(dstl, mask, starts,
                                                         emax, tile_m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nblocks, (f + slice_cols - 1) / slice_cols);
  fold_kernel<T, VEC, C><<<grid, kThreads, smem, stream>>>(
      x, f, src, mask, weight, starts, out, emax, tile_m, slice_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (V, f) f32; src, dstl: (nblocks, emax) int32; mask: (nblocks, emax) f32;
// weight: (nblocks, emax) f32 or null; starts: (nblocks, tile_m + 1) int32
// scratch; out: (nblocks * tile_m, f) f32.  Columns go in slices of
// slice_cols (a multiple of vec; the last may be narrower), each lane vec
// floats wide, c loads per slot: vec in {1, 2, 4} with f % vec == 0 and x
// vec * 4-byte aligned, 8 * vec * c >= slice_cols and vec * c <= 8.
// Returns the first cudaGetLastError() of the two launches
// (cudaErrorInvalidValue for another (vec, c)).
extern "C" int seg_agg_f32(const float* x, const int* src, const int* dstl,
                           const float* mask, const float* weight,
                           int* starts, float* out, int nblocks, int emax,
                           int f, int tile_m, int slice_cols, int vec, int c,
                           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_SEG_AGG(V, CC)                                                 \
  if (vec == V && c == CC)                                                   \
    return launch<float, V, CC>(x, src, dstl, mask, weight, starts, out,    \
                                nblocks, emax, f, tile_m, slice_cols, st);
  REPRO_SEG_AGG(4, 1)
  REPRO_SEG_AGG(4, 2)
  REPRO_SEG_AGG(2, 1)
  REPRO_SEG_AGG(2, 2)
  REPRO_SEG_AGG(2, 3)
  REPRO_SEG_AGG(2, 4)
  REPRO_SEG_AGG(1, 1)
  REPRO_SEG_AGG(1, 2)
  REPRO_SEG_AGG(1, 3)
  REPRO_SEG_AGG(1, 4)
  REPRO_SEG_AGG(1, 5)
  REPRO_SEG_AGG(1, 6)
  REPRO_SEG_AGG(1, 7)
  REPRO_SEG_AGG(1, 8)
#undef REPRO_SEG_AGG
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same with x and out bf16 (f32 fold, one rounding at the store): vec
// bf16 elements a load, vec in {1, 2, 4, 8} with f % vec == 0 and x
// vec * 2-byte aligned, 8 * vec * c >= slice_cols and vec * c <= 8.
extern "C" int seg_agg_bf16(const void* x, const int* src, const int* dstl,
                            const float* mask, const float* weight,
                            int* starts, void* out, int nblocks, int emax,
                            int f, int tile_m, int slice_cols, int vec, int c,
                            void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* xb = static_cast<const bf16*>(x);
  auto* ob = static_cast<bf16*>(out);
#define REPRO_SEG_AGG(V, CC)                                                 \
  if (vec == V && c == CC)                                                   \
    return launch<bf16, V, CC>(xb, src, dstl, mask, weight, starts, ob,     \
                               nblocks, emax, f, tile_m, slice_cols, st);
  REPRO_SEG_AGG(8, 1)
  REPRO_SEG_AGG(4, 1)
  REPRO_SEG_AGG(4, 2)
  REPRO_SEG_AGG(2, 1)
  REPRO_SEG_AGG(2, 2)
  REPRO_SEG_AGG(2, 3)
  REPRO_SEG_AGG(2, 4)
  REPRO_SEG_AGG(1, 1)
  REPRO_SEG_AGG(1, 2)
  REPRO_SEG_AGG(1, 3)
  REPRO_SEG_AGG(1, 4)
  REPRO_SEG_AGG(1, 5)
  REPRO_SEG_AGG(1, 6)
  REPRO_SEG_AGG(1, 7)
  REPRO_SEG_AGG(1, 8)
#undef REPRO_SEG_AGG
  return static_cast<int>(cudaErrorInvalidValue);
}
