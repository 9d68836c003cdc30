// fused_agg_combine: per destination block, the segmented sum of gathered
// rows followed by "@ W" before the aggregate leaves the SM.
//
// Replaces the TPU kernel
// src/repro/kernels/fused_agg_combine.py::fused_agg_combine_blocked (body
// _fused_kernel), which folds a block's pre-gathered rows into a VMEM
// accumulator with a one-hot MXU matmul and multiplies it by a W pinned in
// VMEM.  Its GPU sibling, src/repro/kernels/gpu_agg.py::
// fused_agg_combine_gpu_blocked, has the same contract and is served here.
//
//   out[b * tile_m + m, :] = (sum over slots e of block b with
//                             dstl[b, e] == m and mask[b, e] != 0 of
//                             mask[b, e] * x[src[b, e], :]) @ W
//
// What bounds it on the H100: at the main path's shapes, operations.  The
// product is 2 * tile_m * nblocks * F_in * F_out FLOPs in full f32 (no TF32,
// no tensor cores: 67 TFLOP/s); Reddit's 602 -> 128 layer is about 36 GFLOP
// against about 0.8 GB of inputs read once.  Without reuse the gather moves
// E * F_in * 4 bytes (28 GB at Reddit's F_in = 602), which the power-law
// sources cut through L2 hits.
//
// What the design does about it:
//   * W cannot be pinned on chip as the TPU pins it in VMEM: Reddit's
//     602 x 128 f32 W is 308 KB and Citeseer's 3703 x 128 is 1.9 MB, while
//     a CTA gets at most 227 KB.  So the kernel K-tiles: for each slab of
//     kSlab input columns it folds the block's edges into a (tile_m, kSlab)
//     shared-memory tile (one column per thread, in slot order, as seg_agg
//     does), then multiplies that tile by W[slab, :] read from L2 and adds
//     the result into a (tile_m, F_out) accumulator in shared memory.  The
//     (tile_m, F_in) aggregate never exists in device memory; the output is
//     written once.
//   * The product is plain f32 FMA.  A warp covers 32 output columns and
//     each thread kRows rows, so one W value read from L2 feeds kRows FMAs,
//     and the aggregate values it meets are shared-memory broadcasts.
//   * One CTA per block: no atomics, deterministic sums.
#include <cuda_runtime.h>

#include "blocked_fold.cuh"

namespace {

constexpr int kSlab = 256;            // input columns per slab = threads
constexpr int kWarps = kSlab / 32;
constexpr int kRows = 4;              // output rows per thread per pass

__global__ void __launch_bounds__(kSlab)
fused_agg_combine_kernel(const float* __restrict__ x, int f_in,
                         const int* __restrict__ src,
                         const int* __restrict__ dstl,
                         const float* __restrict__ mask,
                         const float* __restrict__ w, int f_out,
                         float* __restrict__ out, int emax, int tile_m) {
  extern __shared__ float smem[];
  float* s_agg = smem;                   // (tile_m, kSlab) aggregate slab
  float* s_out = smem + tile_m * kSlab;  // (tile_m, f_out) output sums
  __shared__ repro_torch::StagedSlots st;

  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  for (int i = t; i < tile_m * f_out; i += kSlab) s_out[i] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < f_in; k0 += kSlab) {
    const int ks = min(kSlab, f_in - k0);
    repro_torch::fold_block_column(
        x, f_in, k0 + t, t < ks, src, dstl, mask, nullptr,
        static_cast<int64_t>(blockIdx.x) * emax, emax, tile_m, st,
        [&](int row, float v) { s_agg[row * kSlab + t] = v; });
    __syncthreads();
    for (int n = lane; n < f_out; n += 32) {
      for (int m0 = warp; m0 < tile_m; m0 += kWarps * kRows) {
        float p[kRows] = {};
        for (int k = 0; k < ks; ++k) {
          const float wv = __ldg(w + static_cast<int64_t>(k0 + k) * f_out + n);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int m = m0 + r * kWarps;
            if (m < tile_m) p[r] = fmaf(s_agg[m * kSlab + k], wv, p[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int m = m0 + r * kWarps;
          if (m < tile_m) s_out[m * f_out + n] += p[r];
        }
      }
    }
    __syncthreads();
  }
  float* out_blk = out + static_cast<int64_t>(blockIdx.x) * tile_m * f_out;
  for (int i = t; i < tile_m * f_out; i += kSlab) out_blk[i] = s_out[i];
}

}  // namespace

// Dynamic shared memory one launch needs, in bytes (the wrapper checks it
// against the card's per-block limit before launching).
extern "C" int fused_agg_combine_smem_bytes(int tile_m, int f_out) {
  return (tile_m * kSlab + tile_m * f_out) * static_cast<int>(sizeof(float));
}

// x: (V, f_in) f32; src, dstl: (nblocks, emax) int32; mask: (nblocks, emax)
// f32; w: (f_in, f_out) f32; out: (nblocks * tile_m, f_out) f32.
// Returns the first CUDA error of the attribute call or the launch.
extern "C" int fused_agg_combine_f32(const float* x, const int* src,
                                     const int* dstl, const float* mask,
                                     const float* w, float* out, int nblocks,
                                     int emax, int f_in, int f_out, int tile_m,
                                     void* stream) {
  const int smem = fused_agg_combine_smem_bytes(tile_m, f_out);
  cudaError_t err = cudaFuncSetAttribute(
      fused_agg_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_agg_combine_kernel<<<nblocks, kSlab, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, f_in, src, dstl, mask, w, f_out, out, emax, tile_m);
  return static_cast<int>(cudaGetLastError());
}
