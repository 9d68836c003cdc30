// fused_agg_combine: per tile of 64 destination rows, the segmented sum of
// gathered rows followed by "@ W" before the aggregate leaves the SM.
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
// Layout (core/dataflow.py BlockedGraph, as block_graph builds it): in each
// block the valid slots (mask != 0) come first and are sorted by dstl; pad
// slots follow and are never read past, so never multiplied by 0.
//
// What bounds it on the H100: operations at the data sheet's peaks, the
// gathers in practice.  At Reddit's 602 -> 128 layer the adds are E * F_in
// = 7.0 G (0.10 ms at 67 TFLOP/s f32) and the product 2 * V * F_in * F_out
// = 35.9 GFLOP (0.22 ms at 165 TFLOP/s, the tensor cores' 495 TF32
// TFLOP/s over three products), against 0.83 GB of inputs read once (0.25
// ms): a bound of 0.32 ms.  But the gathered rows are E * F_in * 4 = 28 GB,
// so what the kernel reaches is set by where those gathers hit, L2 or HBM,
// and by how many of them are in flight, as for K1 (csrc/seg_agg.cu).
//
// What the design does (a prepass that splits W, then the fused kernel):
//   * One CTA per 64 destination rows, one wgmma M: 64 / tile_m whole
//     blocks when tile_m <= 64 (two at the planner's tile_m = 32; the last
//     CTA may hold fewer), else one 64-row piece of a block (rows past the
//     block's end are padding).  A CTA owns its rows: no atomics, and the
//     sums are deterministic.
//   * Once per CTA: each block's slot range is found with a warp-wide
//     search (valid slots are sorted by row), the CTA's valid slots are
//     numbered as one run, their src is staged in shared memory when they
//     fit (a CTA with more reads them from L2 in every slice), the start
//     of each of the 64 rows is found (no atomics), and a CTA-wide vote
//     says whether every coefficient is 1.  Every K-slice reuses all four.
//   * Per K-slice of 64 input columns, K1's fold: fold units split the
//     rows by slot count and fold them in slot order with full-warp
//     shuffles, 16/8/4-byte gathers by F_in % 4, no barrier inside the
//     fold; each term is __fmul_rn(coef, x) then __fadd_rn (the multiply
//     is skipped when every coefficient is 1, as 1 * x == x); an edgeless
//     row is 0.  A unit is 16 lanes gathering 16 slots at once (4 floats a
//     lane), so that a lane holds 64 floats in flight in 64 registers, as
//     K1's 8-lane units do; 16 units of 4 rows on average.  A finished row
//     goes to shared memory as the wgmma A operand, split into
//     hi = tf32_rna(v) and lo = tf32_rna(v - hi) tiles.
//   * The product is 3xTF32 on the tensor cores: per k8 step
//     A_lo W_hi + A_hi W_lo + A_hi W_hi (only lo * lo, ~2^-22 relative, is
//     dropped; one TF32 product keeps 10 mantissa bits).  Each of the two
//     warpgroups owns half of the output columns (N = F_out rounded up to
//     8, split in two) with wgmma.mma_async m64nNk8 .tf32, A and B from
//     shared memory, both K-major with the 128-byte swizzle (a swizzle row
//     holds 32 tf32 values, so a 64-column slice is two regions).  wgmma
//     only truncates a 32-bit operand, so both parts are rounded with
//     cvt.rna.tf32.f32 first.
//   * The tensor cores' f32 accumulation truncates: with one accumulator
//     across all of K, each row's error grew in proportion to K on the
//     H100, past the per-row limit at K = 1433.  So each slice's partial
//     product starts from zero (8 k8
//     steps of three products) and is added to an f32 running sum in
//     shared memory with __fadd_rn, slice by slice in order; the sum is
//     written to out once.  This also keeps the accumulator out of the
//     fold's registers.
//   * W is split and transposed once per call by split_w_kernel into
//     scratch, already in the swizzled shared-memory image of each stage
//     (32 K columns, hi and lo parts, zero past F_in and F_out), so the
//     fused kernel copies a stage with flat 16-byte cp.async; a slice's
//     first stage is copied while the slice folds, its second after the
//     first stage's products.  F_out > 128 runs one fused launch per 128
//     columns.
//   * Occupancy: 256 threads, 128 registers, and at F_out = 128 113 KB of
//     shared memory (32 KB of A, 32 KB of W stage, 34 KB of running sum,
//     13 KB of staged src: 3,328 slots, more than the mean CTA's 3,188 at
//     Reddit), so two CTAs share an SM and one's barriers and products
//     overlap the other's gathers.
//
//   * bf16.  Three (x, W) pairs are instantiated, the output in W's type
//     as the reference's (which folds in f32, multiplies in f32 and rounds
//     once): (f32, f32); (bf16, bf16), a bf16 plan's fused layer; and
//     (f32, bf16), a bf16 plan's fused dedup layer, whose [x ; partials]
//     rows are f32.  bf16 loads convert exactly to f32 (a fold lane loads
//     at most 4 elements, 8 bytes of bf16); the fold, the A tiles and the
//     running sum are the f32 ones above; the store rounds once.  A bf16 W
//     has 8 mantissa bits, so TF32 holds it exactly: its lo part is 0 and
//     the bf16-W instances drop the A_hi W_lo product -- two TF32 products
//     per k8 step, not three (chip_smoke.py phase 2 counts the HGMMAs of
//     each instance).
//
// Measured (chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md): Reddit
// 602 -> 128 5.87 ms (the plain-FMA design before it: 15.32), 128 -> 41
// 0.98, 128 -> 128 1.03; Citeseer 3703 -> 128 0.38, under its plain
// version.  Each row within ~2e-6 of its largest element, against ~6e-4
// for one TF32 product.  Staging the indices saves 6% at 602 -> 128.  The
// fold is what bounds it: seg_agg at F = 602 then torch.matmul takes 4.64
// ms, because seg_agg's slice-major grid keeps the CTAs in flight on one
// slice of x in L2, while here each CTA walks every slice of its rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kRows = 64;      // destination rows of a CTA: one wgmma M
constexpr int kSlice = 64;     // input columns of a K-slice
constexpr int kLanes = 16;     // lanes of a fold unit: 2 units share a warp
constexpr int kHalf = kSlice / 2;  // K columns of a W stage
constexpr int kUnits = kThreads / kLanes;
constexpr int kBatch = kLanes;  // slots a unit gathers at once
constexpr int kMaxCols = 128;   // output columns of one fused launch
constexpr int kATile = kRows * kSlice * 4;  // one A part (hi or lo), bytes
constexpr int kMeta = 1024;     // row starts and segment tables, bytes

// Row stride, in floats, of the f32 running sum of an nw-column launch
__host__ __device__ constexpr int tot_ld(int nw) { return nw + 8; }

// Shared memory of one fused launch with an nw-row W image and cap staged
// slots: alignment slack, A (hi, lo), one W stage (32 K columns, hi and
// lo), the running sum, meta, src.  kernels/fused_agg_combine.py
// smem_bytes mirrors it (the wrapper checks it and sizes cap with it).
constexpr int smem_bytes_for(int nw, int cap) {
  return 1024 + 2 * kATile + nw * kHalf * 8 + kRows * tot_ld(nw) * 4 +
         kMeta + cap * 4;
}

// Output columns of a warpgroup for ncols (<= kMaxCols) columns of a
// launch: half of them rounded up to 8, from the instantiated wgmma widths.
int cols_per_wg(int ncols) {
  const int half = ((ncols + 7) / 8 * 8 + 1) / 2;
  for (int nt : {8, 16, 24, 32, 48, 64})
    if (nt >= half) return nt;
  return -1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Byte offset of element (r, c), c < 64, of a K-major tile of `rows` rows
// (a multiple of 8): two regions of 32 columns, rows of 128 bytes, the
// 128-byte swizzle (bits 4-6 XOR bits 7-9; region bases 1024-aligned).
__device__ __forceinline__ uint32_t tile_off(int r, int c, int rows) {
  const uint32_t off = (c / 32) * rows * 128 + r * 128 + (c % 32) * 4;
  return off ^ (((off >> 7) & 7) << 4);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  // K-major, 128-byte swizzle: LBO unused (16), SBO = 8 rows of 128 bytes
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// k8 step ks of a K-major tile of `rows` rows at shared address base
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int ks) {
  return make_desc(base + (ks / 4) * rows * 128 + (ks % 4) * 32);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// wgmma.mma_async m64nNk8, f32 += tf32 x tf32, A and B K-major in shared
// memory, accumulating into d (N / 2 registers a thread)
template <int N>
__device__ __forceinline__ void mma_tf32(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void mma_tf32<8>(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_tf32<16>(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_tf32<24>(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_tf32<32>(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}template <>
__device__ __forceinline__ void mma_tf32<48>(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void mma_tf32<64>(float* d, uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

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

// two bf16 of a 32-bit word, the lower address in the low half; bf16 is
// the top half of an f32, so the conversion is exact
__device__ __forceinline__ void unpack2(float* d, uint32_t w) {
  d[0] = __uint_as_float(w << 16);
  d[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) {
  return __uint_as_float(
      static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p)))
      << 16);
}

template <int VEC>
__device__ __forceinline__ void load_vec(float* d, const bf16* p) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    unpack2(d, t.x), unpack2(d + 2, t.y);
  } else if constexpr (VEC == 2) {
    unpack2(d, __ldg(reinterpret_cast<const unsigned int*>(p)));
  } else {
    d[0] = load1(p);
  }
}

__device__ __forceinline__ unsigned short to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// First slot e of block slot range [slot0, slot0 + emax) that is a pad slot
// or holds a row >= m (emax if none): valid slots come first, sorted by
// row, so the predicate is monotone.  All 32 lanes of a warp call it; each
// round probes 32 slots and narrows the range 32-fold.
__device__ int row_lower_bound(const int* __restrict__ dstl,
                               const float* __restrict__ mask, int64_t slot0,
                               int emax, int m, int lane) {
  int lo = 0, hi = emax;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool t = p >= hi || __ldg(mask + slot0 + p) == 0.f ||
                   __ldg(dstl + slot0 + p) >= m;
    const unsigned bal = __ballot_sync(0xffffffffu, t);
    if (bal == 0) {  // every probe false, the last one below hi
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(bal) - 1;
    const int nlo = f == 0 ? lo : lo + (f - 1) * step + 1;
    hi = min(lo + f * step, hi);
    lo = nlo;
  }
  return lo;
}

// Shared-memory W image of one launch: for each W stage (32 K columns),
// the hi part then the lo part, each nw rows (output columns n0 ..) of 128
// bytes, swizzled as tile_off lays them out; zero past F_in and F_out.
// One thread per 4 K values of one column.  A bf16 W's lo part is 0.
template <typename TW>
__global__ void split_w_kernel(const TW* __restrict__ w, int f_in,
                               int f_out, int n0, int nw, int nslices,
                               uint4* __restrict__ img) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(nslices) * 16 * nw) return;
  const int n = static_cast<int>(i % nw);
  const int q = static_cast<int>(i / nw);  // 4-column chunk along K
  const int h = q / 8, c = q % 8;          // stage, chunk in the stage
  const int col = n0 + n;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int kk = h * kHalf + c * 4 + t;
    const float v = kk < f_in && col < f_out
                        ? load1(w + static_cast<int64_t>(kk) * f_out + col)
                        : 0.f;
    hi[t] = tf32_rna(v);
    lo[t] = tf32_rna(__fsub_rn(v, __uint_as_float(hi[t])));
  }
  // 16-byte units: stage h is nw * 16 of them, hi first
  const int64_t off = static_cast<int64_t>(h) * nw * 16 + n * 8 + (c ^ (n % 8));
  img[off] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  img[off + nw * 8] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// One CTA per 64 destination rows (see the note at the top).  Lane li of a
// fold unit owns columns (cc * kLanes + li) * VEC .. + VEC - 1 of a slice,
// cc < C.  Warpgroup g computes output columns n0 + g * NT .. + NT - 1.
// TX is x's element type, TW W's and out's; a bf16 W is exact in TF32, so
// its instances skip the A_hi W_lo product.
template <typename TX, typename TW, int VEC, int NT>
__global__ void __launch_bounds__(kThreads, 2)
fused_kernel(const TX* __restrict__ x, int f_in,
             const int* __restrict__ src, const int* __restrict__ dstl,
             const float* __restrict__ mask, const uint4* __restrict__ wimg,
             TW* __restrict__ out, int f_out, int n0, int ncols,
             int nblocks, int emax, int tile_m, int cap, int terms) {
  constexpr int L = kLanes;
  constexpr int C = kSlice / (L * VEC);
  constexpr bool kWExact = std::is_same<TW, bf16>::value;
  static_assert(C >= 1, "a fold lane loads at most kSlice / kLanes elements");
  constexpr int NW = kWarpgroups * NT;       // W image rows
  constexpr int kWBytes = NW * kHalf * 8;    // one W stage, hi and lo
  constexpr int kTotLd = tot_ld(NW);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* a_hi = base;
  uint8_t* a_lo = base + kATile;
  uint8_t* w_s = base + 2 * kATile;
  float* s_tot = reinterpret_cast<float*>(w_s + kWBytes);  // kRows x kTotLd
  int* s_start = reinterpret_cast<int*>(s_tot + kRows * kTotLd);  // kRows+1
  int* s_pre = s_start + kRows + 1;   // segment i: slots [s_pre[i], s_pre[i+1])
  int* s_elo = s_pre + kRows + 1;     // its first slot within its block
  int* s_src = s_start + kMeta / 4;  // cap

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = tid / 128;
  const int nslices = (f_in + kSlice - 1) / kSlice;

  // W stage h (K columns 32 h .. 32 h + 31) into shared memory: a flat
  // copy of the prepared image
  auto load_w = [&](int h) {
    const uint4* g = wimg + static_cast<int64_t>(h) * (kWBytes / 16);
    const uint32_t d = smem_u32(w_s);
    for (int i = tid; i < kWBytes / 16; i += kThreads)
      cp_async16(d + i * 16, g + i);
    cp_async_commit();
  };
  load_w(0);

  // this CTA's segments: whole blocks when tile_m <= 64, else one 64-row
  // piece of a block; its rows are out rows out_row0 .. out_row0 + m_real
  const bool whole = tile_m <= kRows;
  int blk0, nseg, row0, seg_rows;
  if (whole) {
    const int bpc = kRows / tile_m;
    blk0 = blockIdx.x * bpc;
    nseg = min(bpc, nblocks - blk0);
    row0 = 0;
    seg_rows = tile_m;
  } else {
    const int spc = (tile_m + kRows - 1) / kRows;
    blk0 = blockIdx.x / spc;
    nseg = 1;
    row0 = blockIdx.x % spc * kRows;
    seg_rows = min(kRows, tile_m - row0);
  }
  const int m_real = nseg * seg_rows;
  const int64_t out_row0 = static_cast<int64_t>(blk0) * tile_m + row0;

  for (int i = tid; i < 2 * kATile / 16; i += kThreads)
    reinterpret_cast<uint4*>(base)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int r = tid; r < m_real; r += kThreads) s_start[r] = INT_MAX;
  for (int i = warp; i < nseg; i += kThreads / 32) {
    const int64_t slot0 = static_cast<int64_t>(blk0 + i) * emax;
    const int lo = row0 == 0 ? 0
                             : row_lower_bound(dstl, mask, slot0, emax, row0,
                                               lane);
    const int hi = row_lower_bound(dstl, mask, slot0, emax, row0 + seg_rows,
                                   lane);
    if (lane == 0) {
      s_elo[i] = lo;
      s_pre[i + 1] = hi - lo;
    }
  }
  __syncthreads();
  if (tid == 0) {
    s_pre[0] = 0;
    for (int i = 0; i < nseg; ++i) s_pre[i + 1] += s_pre[i];
    s_start[m_real] = s_pre[nseg];
  }
  __syncthreads();
  const int nvalid = s_pre[nseg];
  const bool staged = nvalid <= cap;

  // global slot of CTA slot e; seg is a hint that only moves forward
  auto gslot = [&](int e, int& seg) {
    while (e >= s_pre[seg + 1]) ++seg;
    return static_cast<int64_t>(blk0 + seg) * emax + s_elo[seg] +
           (e - s_pre[seg]);
  };

  // stage src, find where each row starts, see whether every coefficient
  // is 1 (then the products are the gathered values themselves)
  bool ones;
  {
    int seg = 0, not_one = 0;
    for (int e = tid; e < nvalid; e += kThreads) {
      const int64_t g = gslot(e, seg);
      const int d = __ldg(dstl + g);
      if (staged) s_src[e] = __ldg(src + g);
      not_one |= __ldg(mask + g) != 1.f;
      if (e == s_pre[seg] || __ldg(dstl + g - 1) != d)
        s_start[seg * seg_rows + d - row0] = e;
    }
    ones = !__syncthreads_or(not_one);
    if (tid < 32) {  // suffix minimum: an empty row starts where the next does
      int carry = nvalid;
      for (int b = (m_real - 1) / 32 * 32; b >= 0; b -= 32) {
        const int m = b + tid;
        int v = m < m_real ? s_start[m] : INT_MAX;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const int o = __shfl_down_sync(0xffffffffu, v, off);
          if (tid + off < 32) v = min(v, o);
        }
        v = min(v, carry);
        if (m < m_real) s_start[m] = v;
        carry = __shfl_sync(0xffffffffu, v, 0);
      }
    }
    __syncthreads();
  }

  // this unit's rows [r_lo, r_hi): unit k starts at the first row whose
  // slots start at or after k / kUnits of the CTA's valid slots
  const int unit = tid / L, li = tid % L;
  auto first_row = [&](int k) {
    if (k == 0) return 0;
    if (k == kUnits) return m_real;
    const int target =
        static_cast<int>(static_cast<int64_t>(k) * nvalid / kUnits);
    int lo = 0, hi = m_real;  // s_start[m_real] = nvalid >= target
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (s_start[mid] >= target) hi = mid;
      else lo = mid + 1;
    }
    return lo;
  };
  const int r_lo = first_row(unit), r_hi = first_row(unit + 1);
  const int e_lo = s_start[r_lo], e_hi = s_start[r_hi];
  // every lane of a warp runs as many batches as its busiest unit, so the
  // shuffles are full-warp; a unit past its end adds nothing
  int batches = (e_hi - e_lo + kBatch - 1) / kBatch;
#pragma unroll
  for (int off = L; off < 32; off *= 2)
    batches = max(batches, __shfl_xor_sync(0xffffffffu, batches, off));

  const bool mma = wg * NT < ncols;  // this warpgroup has columns
  const uint32_t sa_hi = smem_u32(a_hi), sa_lo = smem_u32(a_lo);
  const uint32_t sb_hi = smem_u32(w_s) + wg * NT * 128;
  const uint32_t sb_lo = sb_hi + NW * 128;

  for (int k = 0; k < nslices; ++k) {
    const int c0 = k * kSlice;
    const int cols = min(kSlice, f_in - c0);
    const TX* xs = x + c0;
    // a lane whose columns lie past the slice loads column 0 (the line its
    // unit reads anyway) and stores zeros there
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
    // row r of the slice's aggregate into the A tiles as hi and lo parts
    auto store_row = [&](int r) {
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        const int col = (cc * L + li) * VEC;
        uint32_t hi[VEC], lo[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float v = col < cols ? acc[cc][q] : 0.f;
          hi[q] = tf32_rna(v);
          lo[q] = tf32_rna(__fsub_rn(v, __uint_as_float(hi[q])));
          acc[cc][q] = 0.f;
        }
        const uint32_t off = tile_off(r, col, kRows);
        if constexpr (VEC == 4) {
          *reinterpret_cast<uint4*>(a_hi + off) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(a_lo + off) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        } else if constexpr (VEC == 2) {
          *reinterpret_cast<uint2*>(a_hi + off) = make_uint2(hi[0], hi[1]);
          *reinterpret_cast<uint2*>(a_lo + off) = make_uint2(lo[0], lo[1]);
        } else {
          *reinterpret_cast<uint32_t*>(a_hi + off) = hi[0];
          *reinterpret_cast<uint32_t*>(a_lo + off) = lo[0];
        }
      }
    };

    int row = r_lo;
    int next = r_lo < r_hi ? s_start[r_lo + 1] : 0;  // first slot past `row`
    int p_src = 0;  // always a valid row of x: 0 or a loaded src
    float p_coef = 1.f;
    int fseg = 0;
    auto fetch = [&](int e) {  // lane li: slot e + li of the next batch
      if (li < kBatch && e + li < e_hi) {
        if (staged && ones) {
          p_src = s_src[e + li];
        } else {
          const int64_t g = gslot(e + li, fseg);
          p_src = staged ? s_src[e + li] : __ldg(src + g);
          if (!ones) p_coef = __ldg(mask + g);
        }
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
        const TX* xr = xs + static_cast<int64_t>(su) * f_in;
#pragma unroll
        for (int cc = 0; cc < C; ++cc) load_vec<VEC>(v[u][cc], xr + col_ld[cc]);
      }
      float cf[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        cf[u] = ones ? 1.f : __shfl_sync(0xffffffffu, cur_coef, u, L);
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
            // no contraction into an FMA: each term is rounded as the
            // plain version rounds it (coef * x, then the add)
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

    // the slice's A tiles are in shared memory: multiply, one W stage of
    // 32 K columns at a time.  A fresh accumulator per slice: the tensor
    // cores' f32 accumulation truncates, so its error grows with the k8
    // steps it spans; across slices the partial products are added in f32
    // to nearest.
    const int ksteps = (cols + 7) / 8;
    float d[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) d[i] = 0.f;
    for (int h = 0; h * 4 < ksteps; ++h) {
      if (h > 0) load_w(2 * k + h);
      cp_async_wait0();
      fence_proxy_async();  // this thread's smem writes -> wgmma's proxy
      __syncthreads();
      if (mma) {
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ks = 4 * h + q;
          if (ks < ksteps) {
            const uint64_t ah = desc_k(sa_hi, kRows, ks);
            const uint64_t bh = desc_k(sb_hi, NW, q);
            if (terms == 3) {  // the small terms first
              mma_tf32<NT>(d, desc_k(sa_lo, kRows, ks), bh);
              if constexpr (!kWExact)  // a bf16 W's lo part is 0
                mma_tf32<NT>(d, ah, desc_k(sb_lo, NW, q));
            }
            mma_tf32<NT>(d, ah, bh);
          }
        }
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) fence_reg(d[i]);
      }
      __syncthreads();  // every warpgroup is done with this W stage
    }
    if (mma) {
      // d[4 j + 2 half + c] is row 16 w + lane / 4 + 8 half, column
      // g * NT + 8 j + 2 (lane % 4) + c of this launch: add it into the
      // running sum of the earlier slices
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * (warp % 4) + lane / 4 + 8 * half;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          float2* t = reinterpret_cast<float2*>(
              s_tot + r * kTotLd + wg * NT + 8 * j + 2 * (lane % 4));
          float2 v = make_float2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
          if (k > 0) {
            const float2 o = *t;
            v.x = __fadd_rn(o.x, v.x), v.y = __fadd_rn(o.y, v.y);
          }
          *t = v;
        }
      }
    }
    if (k + 1 < nslices) load_w(2 * (k + 1));
  }
  __syncthreads();  // the running sums are complete

  // the CTA's rows of out, written once (a bf16 out rounded once here)
  TW* orow0 = out + out_row0 * f_out + n0;
  if constexpr (kWExact) {
    if (f_out % 2 == 0 && ncols % 2 == 0) {
      for (int i = tid; i < m_real * (ncols / 2); i += kThreads) {
        const int r = i / (ncols / 2), c = i % (ncols / 2) * 2;
        const float* t = s_tot + r * kTotLd + c;
        __stcs(reinterpret_cast<unsigned int*>(
                   orow0 + static_cast<int64_t>(r) * f_out + c),
               static_cast<unsigned int>(to_bf16_bits(t[0])) |
                   (static_cast<unsigned int>(to_bf16_bits(t[1])) << 16));
      }
    } else {
      for (int i = tid; i < m_real * ncols; i += kThreads) {
        const int r = i / ncols, c = i % ncols;
        __stcs(reinterpret_cast<unsigned short*>(
                   orow0 + static_cast<int64_t>(r) * f_out + c),
               to_bf16_bits(s_tot[r * kTotLd + c]));
      }
    }
  } else if (f_out % 4 == 0 && ncols % 4 == 0) {
    for (int i = tid; i < m_real * (ncols / 4); i += kThreads) {
      const int r = i / (ncols / 4), c = i % (ncols / 4) * 4;
      __stcs(reinterpret_cast<float4*>(orow0 + static_cast<int64_t>(r) * f_out + c),
             *reinterpret_cast<const float4*>(s_tot + r * kTotLd + c));
    }
  } else {
    for (int i = tid; i < m_real * ncols; i += kThreads) {
      const int r = i / ncols, c = i % ncols;
      __stcs(orow0 + static_cast<int64_t>(r) * f_out + c, s_tot[r * kTotLd + c]);
    }
  }
}

template <typename TX, typename TW, int VEC, int NT>
int launch_fused(const TX* x, const int* src, const int* dstl,
                 const float* mask, const uint4* wimg, TW* out,
                 int nblocks, int emax, int f_in, int f_out, int n0,
                 int ncols, int tile_m, int cap, int terms,
                 cudaStream_t stream) {
  auto kernel = fused_kernel<TX, TW, VEC, NT>;
  const int smem = smem_bytes_for(kWarpgroups * NT, cap);
  // the largest carveout, so that two CTAs' shared memory fits an SM
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = tile_m <= kRows
                       ? (nblocks + kRows / tile_m - 1) / (kRows / tile_m)
                       : nblocks * ((tile_m + kRows - 1) / kRows);
  kernel<<<ctas, kThreads, smem, stream>>>(x, f_in, src, dstl, mask, wimg,
                                           out, f_out, n0, ncols, nblocks,
                                           emax, tile_m, cap, terms);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW, int VEC>
int dispatch_nt(int nt, const TX* x, const int* src, const int* dstl,
                const float* mask, const uint4* wimg, TW* out,
                int nblocks, int emax, int f_in, int f_out, int n0,
                int ncols, int tile_m, int cap, int terms,
                cudaStream_t stream) {
  switch (nt) {
#define REPRO_K2_NT(N)                                                      \
  case N:                                                                   \
    return launch_fused<TX, TW, VEC, N>(x, src, dstl, mask, wimg, out,      \
                                        nblocks, emax, f_in, f_out, n0,     \
                                        ncols, tile_m, cap, terms, stream);
    REPRO_K2_NT(8)
    REPRO_K2_NT(16)
    REPRO_K2_NT(24)
    REPRO_K2_NT(32)
    REPRO_K2_NT(48)
    REPRO_K2_NT(64)
#undef REPRO_K2_NT
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The prepass and the fused launches of one (x, W) pair, per 128 columns
template <typename TX, typename TW>
int run(const TX* x, const int* src, const int* dstl, const float* mask,
        const TW* w, TW* out, uint4* img, int nblocks, int emax, int f_in,
        int f_out, int tile_m, int vec, int cap, int terms,
        cudaStream_t st) {
  const int nslices = (f_in + kSlice - 1) / kSlice;
  for (int n0 = 0; n0 < f_out; n0 += kMaxCols) {
    const int ncols = f_out - n0 < kMaxCols ? f_out - n0 : kMaxCols;
    const int nt = cols_per_wg(ncols);
    const int64_t units = static_cast<int64_t>(nslices) * 16 * kWarpgroups * nt;
    split_w_kernel<TW><<<static_cast<unsigned>((units + 255) / 256), 256, 0,
                         st>>>(w, f_in, f_out, n0, kWarpgroups * nt, nslices,
                               img);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    int rc;
    if (vec == 4)
      rc = dispatch_nt<TX, TW, 4>(nt, x, src, dstl, mask, img, out, nblocks,
                                  emax, f_in, f_out, n0, ncols, tile_m, cap,
                                  terms, st);
    else if (vec == 2)
      rc = dispatch_nt<TX, TW, 2>(nt, x, src, dstl, mask, img, out, nblocks,
                                  emax, f_in, f_out, n0, ncols, tile_m, cap,
                                  terms, st);
    else if (vec == 1)
      rc = dispatch_nt<TX, TW, 1>(nt, x, src, dstl, mask, img, out, nblocks,
                                  emax, f_in, f_out, n0, ncols, tile_m, cap,
                                  terms, st);
    else
      rc = static_cast<int>(cudaErrorInvalidValue);
    if (rc) return rc;
  }
  return 0;
}

}  // namespace

// x: (V, f_in) (vec elements aligned, f_in % vec == 0; vec in 1, 2, 4);
// src, dstl: (nblocks, emax) int32; mask: (nblocks, emax) f32; w: (f_in,
// f_out); out: (nblocks * tile_m, f_out) in w's type; wimg: scratch of
// ceil(f_in / 64) * 512 * 2 * cols_per_wg(min(f_out, 128)) bytes, 16-byte
// aligned.  pair: 0 x f32, w f32; 1 x bf16, w bf16; 2 x f32, w bf16.
// CTAs stage up to cap slots' src in shared memory (more are read from
// L2).  terms = 3: 3xTF32 (two products for a bf16 W, exact in TF32); 1:
// one TF32 product (a control that must fail the f32 checks).  Returns
// the first CUDA error of the launches.
extern "C" int fused_agg_combine(const void* x, const int* src,
                                 const int* dstl, const float* mask,
                                 const void* w, void* out, void* wimg,
                                 int nblocks, int emax, int f_in, int f_out,
                                 int tile_m, int vec, int cap, int terms,
                                 int pair, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (terms != 1 && terms != 3) return static_cast<int>(cudaErrorInvalidValue);
  auto* img = static_cast<uint4*>(wimg);
  switch (pair) {
    case 0:
      return run(static_cast<const float*>(x), src, dstl, mask,
                 static_cast<const float*>(w), static_cast<float*>(out), img,
                 nblocks, emax, f_in, f_out, tile_m, vec, cap, terms, st);
    case 1:
      return run(static_cast<const bf16*>(x), src, dstl, mask,
                 static_cast<const bf16*>(w), static_cast<bf16*>(out), img,
                 nblocks, emax, f_in, f_out, tile_m, vec, cap, terms, st);
    case 2:
      return run(static_cast<const float*>(x), src, dstl, mask,
                 static_cast<const bf16*>(w), static_cast<bf16*>(out), img,
                 nblocks, emax, f_in, f_out, tile_m, vec, cap, terms, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
