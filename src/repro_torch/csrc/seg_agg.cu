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
// What bounds it on the H100: bytes.  It does one add per gathered element
// and reads 4 bytes for it, far below the card's ~20 FLOP/byte f32 balance.
// The reference's byte model (core/phases.py aggregate_cost) charges
// (E + V) * F * 4 + V * F * 4 + 8 * E bytes with no reuse: at Reddit's
// layer-0 F=128 that is about 6.27 GB, 1.9 ms at 3.35 TB/s.  The sources are
// power-law, so many gathered rows hit the 50 MB L2 and the true traffic is
// lower; the strict floor is each input read once.
//
// What the design does about it:
//   * The gather happens here: x[src] is read straight from x, so the
//     (nblocks, emax, F) slab the TPU path builds in HBM is never written or
//     read back.  That slab alone is as large as the gathered bytes.
//   * One CTA owns one destination block and every output row of it, so no
//     atomics and no second pass; a second grid dimension splits F into
//     column chunks so narrow features still fill the SMs.
//   * Each thread owns one column: a warp reads 32 neighbouring floats of a
//     gathered row, one coalesced 128-byte line, and keeps kUnroll gathered
//     loads in flight (blocked_fold.cuh).  The fold is in slot order, so the
//     result is deterministic.  Every output element is written once.
#include <cuda_runtime.h>

#include "blocked_fold.cuh"

namespace {

__global__ void seg_agg_kernel(const float* __restrict__ x, int f,
                               const int* __restrict__ src,
                               const int* __restrict__ dstl,
                               const float* __restrict__ mask,
                               const float* __restrict__ weight,
                               float* __restrict__ out, int emax, int tile_m) {
  __shared__ repro_torch::StagedSlots st;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  float* out_blk = out + static_cast<int64_t>(blockIdx.x) * tile_m * f;
  repro_torch::fold_block_column(
      x, f, col, col < f, src, dstl, mask, weight,
      static_cast<int64_t>(blockIdx.x) * emax, emax, tile_m, st,
      [&](int row, float v) { out_blk[static_cast<int64_t>(row) * f + col] = v; });
}

}  // namespace

// x: (V, f) f32; src, dstl: (nblocks, emax) int32; mask: (nblocks, emax) f32;
// weight: (nblocks, emax) f32 or null; out: (nblocks * tile_m, f) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int seg_agg_f32(const float* x, const int* src, const int* dstl,
                           const float* mask, const float* weight, float* out,
                           int nblocks, int emax, int f, int tile_m,
                           void* stream) {
  const int warps = (f + 31) / 32;
  const int threads = 32 * (warps < 4 ? warps : 4);
  const dim3 grid(nblocks, (f + threads - 1) / threads);
  seg_agg_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, f, src, dstl, mask, weight, out, emax, tile_m);
  return static_cast<int>(cudaGetLastError());
}
