// The in-order column fold both kernels share.
//
// A destination block of the plan's blocked layout (core/dataflow.py
// BlockedGraph) owns tile_m output rows and emax edge slots.  Valid slots
// (mask != 0) come first and in destination order, because the layout is
// built from a destination-sorted edge list; pad slots point at source 0
// with mask 0.  fold_block_column walks the slots of one block in order for
// ONE column, keeping the running sum of the current destination row in a
// register and handing it to `store(row, value)` when the row changes.  Rows
// that receive no edge are stored as 0, so every row of the block is stored
// exactly once and the result does not depend on scheduling.
//
// Precondition: over the valid slots of a block, dstl is non-decreasing
// (block_graph's layout guarantees it).  Pad slots are skipped, never
// multiplied by 0, so a non-finite row 0 cannot leak into them.
#pragma once

#include <cstdint>

namespace repro_torch {

constexpr int kStage = 256;   // slots staged in shared memory per pass
constexpr int kUnroll = 8;    // gathered loads kept in flight per thread

struct StagedSlots {
  int src[kStage];
  int row[kStage];     // local destination row, -1 for a pad slot
  float coef[kStage];  // mask, times the edge weight when there is one
};

template <typename Store>
__device__ __forceinline__ void fold_block_column(
    const float* __restrict__ x, int64_t x_stride, int col, bool active,
    const int* __restrict__ src, const int* __restrict__ dstl,
    const float* __restrict__ mask, const float* __restrict__ weight,
    int64_t slot0, int emax, int tile_m, StagedSlots& st, Store store) {
  int cur = 0;
  float acc = 0.f;
  for (int base = 0; base < emax; base += kStage) {
    const int n = min(kStage, emax - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int64_t s = slot0 + base + i;
      const float m = mask[s];
      st.src[i] = src[s];
      st.row[i] = (m != 0.f) ? dstl[s] : -1;
      st.coef[i] = weight != nullptr ? m * weight[s] : m;
    }
    __syncthreads();
    if (active) {
      for (int i = 0; i < n; i += kUnroll) {
        float v[kUnroll];
        int r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = i + u;
          r[u] = j < n ? st.row[j] : -1;
          // __fmul_rn/__fadd_rn: no contraction into an FMA, so each term is
          // rounded as the plain version rounds it (coef * x, then the add)
          v[u] = r[u] >= 0
                     ? __fmul_rn(st.coef[j],
                                 __ldg(x + static_cast<int64_t>(st.src[j]) * x_stride + col))
                     : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r[u] < 0) continue;
          if (r[u] != cur) {
            store(cur, acc);
            for (int q = cur + 1; q < r[u]; ++q) store(q, 0.f);
            cur = r[u];
            acc = 0.f;
          }
          acc = __fadd_rn(acc, v[u]);
        }
      }
    }
    __syncthreads();
  }
  if (active) {
    store(cur, acc);
    for (int q = cur + 1; q < tile_m; ++q) store(q, 0.f);
  }
}

}  // namespace repro_torch
