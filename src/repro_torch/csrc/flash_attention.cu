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
// Both kernels below loop only over KV tiles that hold an unmasked key for
// some row of the q tile (tiles above the causal edge, before the window or
// past kv_len[b] are never loaded), and launch causal q tiles heaviest
// first, so the tail of the grid is short.  Ragged Sq and Sk are
// bounds-checked; nothing is padded in memory.
//
// What bounds it on the H100: operations.  At gemma2's prefill (Hq = 16,
// D = 256, S = 6144, causal) the two products are ~309 GFLOP against
// ~151 MB of q, k, v and o in bf16 (302 MB in f32): far above the ridge of
// the tensor cores, so the bound is 0.31 ms in bf16 (989 TFLOP/s) and
// 1.87 ms in f32, whose 3xTF32 products run at 495 / 3 = 165 TFLOP/s.
//
// bf16: wgmma_kernel, both products on the tensor cores.
//   * A consumer warpgroup (128 threads) owns 64 query rows of one head,
//     the M of one wgmma.  S = Q K^T is wgmma.mma_async m64nTKk16 with
//     A = the q tile and B = the K tile, both in shared memory (K-major);
//     O += P V is m64nDk16 with A = P in registers and B = the V tile in
//     its natural (key, d) layout, read MN-major through wgmma's transpose
//     flag.  The S accumulator's fragment is the A fragment of the second
//     product, so P never leaves registers.
//   * At D = 256 with an even GQA group (Hq / Hkv), a CTA is two
//     warpgroups, one for each query head of a pair, and both read every
//     K/V tile it loads: that halves the L2 -> shared memory traffic of K
//     and V (one warpgroup per CTA took 1.36 ms at gemma2's global layer,
//     two take 1.20 on the H100).  Otherwise a CTA is one warpgroup and two
//     CTAs share an SM: at D = 128 a two-warpgroup CTA's registers fill the
//     SM alone, and it measured slower (0.61 against 0.57 ms).
//   * Shared memory is in the layout wgmma's descriptors expect: rows of
//     64 columns (128 bytes; 32/64 bytes at D = 16/32) with the 128-byte
//     (64-, 32-byte) swizzle, one region per 64 columns.  q is staged once,
//     scaled and rounded to bf16 by the threads; K and V tiles come by
//     cp.async (16 bytes a thread, rows past Sk zero-filled) into a ring of
//     two stages, so the next tile's load overlaps this tile's products.
//     cp.async needs no tensor map, so the library links no -lcuda.
//   * Tiles: TK = 64 keys, but 32 for one warpgroup at D = 256 so that two
//     such CTAs share an SM.  Two warpgroups at D = 256 take 2 x 32 KB of
//     q and 2 x (32 + 32) KB of K/V stages, 193 KB: one CTA an SM.  The O
//     accumulator is D / 2 f32 registers a thread (128 at D = 256), S
//     another TK / 2, P TK / 4.  A producer warp with setmaxnreg and
//     ping-pong scheduling of the two warpgroups are the next step.
//   * P's precision: P is rounded to bf16 for the tensor cores, as
//     flex_attention does, and the row sum l adds the ROUNDED p, so the
//     output is a convex combination of V rows with the weights the
//     product used.  The max and sum stay f32; O is accumulated in f32.
//     On the H100 every row at chip_smoke.py's shapes (up to 6144 keys)
//     is within one bf16 ulp of its largest magnitude of the plain f32-P
//     version: the final rounding to bf16 sets that floor, not P's.
//   * Softcap: tanh(x) = 1 - 2 / (2^(2x log2 e) + 1) with ex2.approx and
//     rcp.approx: absolute error ~2e-7, so a logit moves by ~cap * 2e-7,
//     at two MUFU operations.  tanh.approx.f32 (relative error ~2^-11,
//     up to 0.02 at cap = 50) is not used.  exp is ex2.approx with a
//     log2(e) prescale.
//   * Masks are evaluated per element only in KV tiles that straddle the
//     causal edge, the window start or kv_len[b]; whole tiles need none.
//
// f32: tf32x3_kernel, both products on the tensor cores in 3xTF32.
//   * Why 3xTF32: one TF32 product keeps 10 mantissa bits, ~20x past the
//     f32 per-row limit (3e-5).  Each operand x is split into hi =
//     rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32: wgmma itself only
//     truncates a 32-bit operand), and each k8 step issues A_lo B_hi +
//     A_hi B_lo + A_hi B_hi with wgmma.mma_async m64nNk8 .f32.tf32, the
//     small terms first (only lo * lo, ~2^-22 relative, is dropped).
//   * The tensor cores' f32 accumulation truncates, so no accumulator
//     spans a long K: S = Q K^T takes a fresh accumulator per 64 columns
//     of D and adds the partials in f32 to nearest; P V takes a fresh
//     accumulator per KV tile and per chunk of output columns (64 at
//     D = 256, else 32: 32 or 16 registers beside O), two chunks in
//     flight, and O = O alpha + partial is one fmaf on the CUDA cores.  A 6144-key prefill is ~190 tiles: accumulating
//     P V across them in the tensor cores would drift (K2 measured it).
//   * A CTA owns 64 query rows of one head (the M of one wgmma).  q is
//     scaled by D^-0.5 in f32 and split once into hi and lo images (K-major,
//     128-byte swizzle: a swizzle row holds 32 tf32 values).  S is the SS
//     form: A = the q images, B = the K tile's images (32 keys, K-major as
//     stored).  P V is the RS form: A = P split in registers, B = V^T.
//     tf32 wgmma takes only K-major operands and has no transpose flag, so
//     V is staged transposed, (D x 32 keys, keys contiguous); within each
//     8 keys its columns are permuted (vt_col) so that the S accumulator's
//     fragment (row, keys 2t and 2t + 1) is P's A fragment as it is.
//   * Shared memory: 64 x D x 4 x 2 of q images (128 KB at D = 256), one
//     buffer of 32-key hi/lo images that holds the K tile, then the V^T
//     tile (64 KB), and one raw f32 tile (32 KB) that cp.async fills with
//     V while S runs and with the next K while P V runs; the threads split
//     it into the buffer between the products.  225 KB at D = 256: one CTA
//     an SM; 113 KB and two CTAs at D = 128.
//   * At D = 256 the CTA is two warpgroups, so that an SM runs 8 warps and
//     O takes D / 4 = 64 registers a thread, not 128 (one warpgroup a CTA
//     spilled registers, and its 4 warps could not hide the latency of the
//     serial softmax and split work).  Each takes two of the four 64-column
//     slices of S, and the two sums are added through the K buffer (the
//     SS form reads A from shared memory, so S computed twice was the
//     slower choice), so both hold the same S, max, sum and P bit for bit;
//     each multiplies P by its half of V^T.  Below D = 256 a CTA is one
//     warpgroup and two CTAs share an SM.
//   * P is split from the f32 p; the row sum l adds the f32 p.  tanh and
//     exp are tanhf and expf: the bf16 path's ex2/rcp tanh errs by ~2e-7
//     of cap, ~1e-5 of a logit at cap 50, a third of the f32 per-row limit.
//   * Determinism: no atomics, one CTA owns its rows; two launches on the
//     same inputs are equal bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kRows = 64;  // query rows of a warpgroup: one wgmma M
constexpr float kLog2e = 1.4426950408889634f;

// WGS consumer warpgroups per CTA: 2 at D = 256 when the GQA group is even
// (the two query heads of a pair share every K/V tile), else 1
template <int D, int WGS = 1>
struct Cfg {
  static constexpr int kThreads = 128 * WGS;
  // keys per KV tile; 32 at D = 256 for one warpgroup, so that two CTAs
  // share an SM
  static constexpr int kTileK = D == 256 && WGS == 1 ? 32 : 64;
  static constexpr int kPitch = D < 64 ? 2 * D : 128;  // bytes per row
  static constexpr int kChunksPerRow = kPitch / 16;    // 16-byte chunks
  static constexpr int kStepsPerRow = kPitch / 32;     // k16 steps a row
  static constexpr uint64_t kMode = kPitch == 128 ? 1 : (kPitch == 64 ? 2 : 3);
  static constexpr int kQBytes = kRows * D * 2;        // one head's q tile
  static constexpr int kTileBytes = kTileK * D * 2;    // one K or V tile
  // q tiles, two stages of K and V, and slack to align the base to 1024
  static constexpr int kSmem = WGS * kQBytes + 4 * kTileBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c8 (columns 8 c8 .. 8 c8 + 7) of row r in a
// tile of `rows` rows: regions of kPitch-byte rows, one per 64 columns,
// swizzled as wgmma reads them (XOR of address bits 4.. with bits 7..;
// every region starts on a multiple of its 8-row swizzle atom).
template <int D>
__device__ __forceinline__ uint32_t chunk_off(int r, int c8, int rows) {
  using C = Cfg<D>;
  const uint32_t off = (c8 / C::kChunksPerRow) * rows * C::kPitch +
                       r * C::kPitch + (c8 % C::kChunksPerRow) * 16;
  return off ^ (((off >> 7) & (C::kChunksPerRow - 1)) << 4);
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (mode << 62);
}

// K-major operand (q or K: rows x D, D contiguous), k16 step ks
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int ks) {
  using C = Cfg<D>;
  const uint32_t addr = base + (ks / C::kStepsPerRow) * rows * C::kPitch +
                        (ks % C::kStepsPerRow) * 32;
  return make_desc(addr, 16, 8 * C::kPitch, C::kMode);
}

// MN-major operand (V: keys x D read as B = (keys, D) with the transpose
// flag), keys 16 kk .. 16 kk + 15: LBO steps between 64-column regions,
// SBO between 8-key groups
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int rows, int kk) {
  using C = Cfg<D>;
  return make_desc(base + kk * 16 * C::kPitch, rows * C::kPitch,
                   8 * C::kPitch, C::kMode);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
// 4 bytes, zero-filled when !in (a row's lse or delta)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// Registers a wgmma reads or writes asynchronously: keep the compiler from
// moving their uses across the wait (or reusing them before it).
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// tanh(x) = 1 - 2 / (e^{2x} + 1); e^{2x} overflows to inf -> 1, underflows
// to 0 -> -1.  Absolute error ~2e-7 (ex2.approx and rcp.approx are good to
// ~2^-22 relative).
__device__ __forceinline__ float tanh_ex2(float x) {
  return fmaf(-2.f, rcp(ex2(x * (2.f * kLog2e)) + 1.f), 1.f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi,
                                              float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const float2 f = __bfloat1622float2(h);
  sum += f.x + f.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16.  ss: A and B from shared
// memory (both K-major); rs: A from registers, B MN-major (transposed).
// scale_d = 0 ignores the accumulator's old value.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

template <int D, int WGS>
__global__ void __launch_bounds__(128 * WGS, WGS == 1 ? 2 : 1)
wgmma_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
             float* __restrict__ lse, int hq, int group, int sq, int sk,
             int causal, int window, float cap, float scale) {
  using C = Cfg<D, WGS>;
  constexpr int TK = C::kTileK;
  constexpr int kThreads = C::kThreads;
  static_assert(C::kSmem <= 232448, "shared memory over the opt-in limit");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;
  uint8_t* q_tiles = smem_raw + (s_q - raw);
  auto s_k = [&](int st) {
    return s_q + WGS * C::kQBytes + st * 2 * C::kTileBytes;
  };
  auto s_v = [&](int st) { return s_k(st) + C::kTileBytes; };

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // this thread's warpgroup: head h0 + wgi
  const int warp = tid % 128 / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int cb = 2 * (lane % 4);          // and columns cb, cb + 1 of each 8
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const int h0 = blockIdx.y * WGS;
  const int h = h0 + wgi;
  const int b = blockIdx.z;
  const int hkv = hq / group;
  const int nq = min(kRows, sq - q0);
  const int len = kv_len[b];
  const int q_lo = len - sq + q0;  // absolute position of the tile's row 0

  const int64_t kv_off =
      (static_cast<int64_t>(b) * hkv + h0 / group) * sk * D;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;

  // KV tiles holding an unmasked key for some row of this q tile
  int k_end = min(len, sk);
  if (causal) k_end = min(k_end, q_lo + nq);
  int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_beg -= k_beg % TK;
  const int ntiles = k_end > k_beg ? (k_end - k_beg + TK - 1) / TK : 0;

  auto load_kv = [&](int tile, int st) {
    const int k0 = k_beg + tile * TK;
    for (int i = tid; i < TK * D / 8; i += kThreads) {
      const int r = i / (D / 8), c8 = i % (D / 8);
      const bool in = k0 + r < sk;
      const int64_t g = static_cast<int64_t>(in ? k0 + r : 0) * D + c8 * 8;
      const uint32_t off = chunk_off<D>(r, c8, TK);
      cp_async16(s_k(st) + off, kb + g, in);
      cp_async16(s_v(st) + off, vb + g, in);
    }
    cp_async_commit();
  };
  if (ntiles > 0) load_kv(0, 0);

  // q * D^-0.5 rounded to bf16, as the reference forms it; rows past Sq 0
  for (int i = tid; i < WGS * kRows * D / 8; i += kThreads) {
    const int w = i / (kRows * D / 8), j = i % (kRows * D / 8);
    const int r = j / (D / 8), c8 = j % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < sq) {
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<int64_t>(b) * hq + h0 + w) * sq + q0 + r) * D +
          c8 * 8);
      __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(hv[e]);
        hv[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(q_tiles + w * C::kQBytes +
                              chunk_off<D>(r, c8, kRows)) = val;
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    const int k0 = k_beg + t * TK;
    if (t + 1 < ntiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // this thread's smem writes -> wgmma's proxy
    __syncthreads();

    // S = Q K^T
    float s[TK / 2];
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<TK>(s, desc_k<D>(s_q + wgi * C::kQBytes, kRows, ks),
                   desc_k<D>(s_k(st), TK, ks), 1);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) fence_reg(s[i]);

    // softcap, masks, online softmax; s[4 j + 2 half + c] is row
    // row0 + 8 half, key k0 + 8 j + cb + c
    const bool whole = k0 + TK <= min(len, sk) &&
                       (!causal || k0 + TK - 1 <= q_lo) &&
                       (window <= 0 || k0 > q_lo + kRows - 1 - window);
    float ms2[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = q_lo + row0 + 8 * half;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * half + c];
          if (cap > 0.f) x = cap * tanh_ex2(x * inv_cap);
          if (!whole) {
            const int kpos = k0 + 8 * j + cb + c;
            const bool ok = kpos < len && kpos < sk &&
                            (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            x = ok ? x : kNegInf;
          }
          s[4 * j + 2 * half + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      // guard all-masked rows (m_new is still the sentinel)
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float alpha =
          m_run[half] <= kNegInf / 2 ? 0.f
                                     : ex2((m_run[half] - m_safe) * kLog2e);
      m_run[half] = m_new;
      ms2[half] = m_safe * kLog2e;
      l_run[half] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * half] *= alpha;
        o[4 * j + 2 * half + 1] *= alpha;
      }
    }
    // p = exp(s - m_safe) rounded to bf16: pfrag[x] packs s[2x], s[2x + 1]
    // (row half x & 1), which is the A fragment of the P V product
    // (k16 step kk = pfrag[4 kk .. 4 kk + 3]).  A masked score (-1e30)
    // gives exactly 0.
    uint32_t pfrag[TK / 4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < TK / 4; ++x) {
      const int half = x & 1;
      pfrag[x] = pack_bf16(ex2(fmaf(s[2 * x], kLog2e, -ms2[half])),
                           ex2(fmaf(s[2 * x + 1], kLog2e, -ms2[half])),
                           psum[half]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      psum[half] += __shfl_xor_sync(0xffffffffu, psum[half], 1);
      psum[half] += __shfl_xor_sync(0xffffffffu, psum[half], 2);
      l_run[half] += psum[half];
    }

    // O += P V
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<D>(o, pfrag + 4 * kk, desc_mn<D>(s_v(st), TK, kk));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
#pragma unroll
    for (int i = 0; i < TK / 4; ++i) fence_reg(pfrag[i]);
    __syncthreads();  // every warp is done with this stage's K and V
  }

  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * hq + h) * sq * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= nq) continue;
    const float denom = l_run[half] == 0.f ? 1.f : l_run[half];
    // the row's logsumexp for the backward: m + log(l_safe), -1e30 for an
    // all-masked row (the four lanes of a row hold the same m and l)
    if (lse != nullptr && lane % 4 == 0)
      lse[(static_cast<int64_t>(b) * hq + h) * sq + q0 + row] =
          m_run[half] + logf(denom);
    __nv_bfloat16* orow = ob + static_cast<int64_t>(q0 + row) * D + cb;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] / denom,
                                o[4 * j + 2 * half + 1] / denom);
  }
}

template <int D, int WGS>
int launch_wgs(const void* q, const void* k, const void* v, const int* kv_len,
               void* out, float* lse, int b, int hq, int hkv, int sq, int sk,
               int causal, int window, float cap, float scale,
               cudaStream_t stream) {
  using C = Cfg<D, WGS>;
  auto kernel = wgmma_kernel<D, WGS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kRows - 1) / kRows, hq / WGS, b);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_len,
      static_cast<__nv_bfloat16*>(out), lse, hq, hq / hkv, sq, sk, causal,
      window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

// two warpgroups per CTA at D = 256 when the two heads of a pair share a KV
// head; below D = 256 two one-warpgroup CTAs share an SM instead (a
// two-warpgroup CTA's registers would fill the SM alone)
template <int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* lse, int b, int hq, int hkv, int sq, int sk,
           int causal, int window, float cap, float scale,
           cudaStream_t stream) {
  if constexpr (D == 256) {
    if ((hq / hkv) % 2 == 0)
      return launch_wgs<D, 2>(q, k, v, kv_len, out, lse, b, hq, hkv, sq, sk,
                              causal, window, cap, scale, stream);
  }
  return launch_wgs<D, 1>(q, k, v, kv_len, out, lse, b, hq, hkv, sq, sk,
                          causal, window, cap, scale, stream);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: 3xTF32 wgmma
// ---------------------------------------------------------------------------

namespace tf {

using wg::cp_async16;
using wg::cp_async_commit;
using wg::cp_async_wait;
using wg::fence_proxy_async;
using wg::fence_reg;
using wg::smem_u32;
using wg::wgmma_commit;
using wg::wgmma_fence;

constexpr int kRows = 64;     // query rows of the warpgroup: one wgmma M
constexpr int kTileK = 32;    // keys of a KV tile: one 128-byte swizzle row
constexpr int kSlice = 64;    // D columns of one S accumulator

template <int D>
struct Cfg {
  // q and K images: rows of kDp columns in regions of 32 (128 bytes)
  static constexpr int kDp = (D + 31) / 32 * 32;
  static constexpr int kQPart = kRows * kDp * 4;    // q hi or lo image
  static constexpr int kKPart = kTileK * kDp * 4;   // K hi or lo image
  static constexpr int kVPart = D * kTileK * 4;     // V^T hi or lo image
  static constexpr int kBufPart = kKPart > kVPart ? kKPart : kVPart;
  static constexpr int kStage = kTileK * D * 4;     // one raw f32 K or V tile
  // warpgroups of a CTA: at D = 256 two, each computing the same S and P
  // and the P V product of its half of D (see the note at the top)
  static constexpr int kWgs = D == 256 ? 2 : 1;
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kDw = D / kWgs;              // output columns of one
                                                    // warpgroup
  // alignment slack, q hi and lo, one K / V^T buffer (hi and lo), the raw
  // tile that cp.async brings in while the products run
  static constexpr int kSmem = 1024 + 2 * kQPart + 2 * kBufPart + kStage;
  // float4s of a tile each thread splits
  static constexpr int kNv4 = kTileK * D / 4 / kThreads;
  // 16-byte chunks of a raw row, and the XOR that spreads a column of them
  // over the banks
  static constexpr int kChunks = D / 4;
  static constexpr int kSwz = kChunks < 8 ? kChunks : 8;
  // output columns of one P V accumulator (two are in flight)
  static constexpr int kNc = D < 32 ? D : (D == 256 ? 64 : 32);
};

// a value the compiler cannot see through, so that what is derived from it
// is not hoisted out of a loop
__device__ __forceinline__ void opaque(uint32_t& x) {
  asm volatile("" : "+r"(x));
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22: hi = rna(x), lo = rna(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// Byte offset of element (r, c) of a K-major image of `rows` rows (a
// multiple of 8): regions of 32 columns, rows of 128 bytes, the 128-byte
// swizzle (bits 4-6 XOR bits 7-9; region bases 1024-aligned)
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

// k8 step ks of a K-major image of `rows` rows at shared address base
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int ks) {
  return make_desc(base + (ks / 4) * rows * 128 + (ks % 4) * 32);
}

// Column of key j (< 32) in the V^T image: within each group of 8 keys,
// even keys take positions 0-3 and odd keys 4-7, so that position t and
// t + 4 of a k8 step hold keys 2t and 2t + 1 -- the two columns a thread
// holds of the S accumulator, which is then P's A fragment as it is
__device__ __forceinline__ int vt_col(int j) {
  return (j & ~7) + ((j & 7) >> 1) + 4 * (j & 1);
}

// S += A B, m64n32k8, f32 += tf32 x tf32, A and B K-major in shared memory
__device__ __forceinline__ void mma_ss_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// O-chunk += P V, m64n16k8, A (P) from registers, B (V^T) K-major
__device__ __forceinline__ void mma_rs_n16(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O-chunk += P V, m64n32k8, A (P) from registers, B (V^T) K-major
__device__ __forceinline__ void mma_rs_n32(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O-chunk += P V, m64n64k8, A (P) from registers, B (V^T) K-major
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db) {
  if constexpr (N == 16) mma_rs_n16(d, a, db);
  else if constexpr (N == 32) mma_rs_n32(d, a, db);
  else mma_rs_n64(d, a, db);
}

// One CTA per (64 query rows, head, batch); see the note at the top.
// terms = 3: 3xTF32; 1: one TF32 product (a control that must fail the
// f32 checks).
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, D == 256 ? 1 : 2)
tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ kv_len,
              float* __restrict__ out, float* __restrict__ lse, int hq,
              int group, int sq, int sk, int causal, int window, float cap,
              float scale, int terms) {
  using C = Cfg<D>;
  constexpr int TK = kTileK;
  constexpr int NS = (D + kSlice - 1) / kSlice;  // S accumulators
  constexpr int kThreads = C::kThreads;
  constexpr int NCH = C::kDw / C::kNc;           // P V accumulators
  constexpr int SPW = NS / C::kWgs;              // S slices of a warpgroup
  static_assert(C::kSmem <= 232448, "shared memory over the opt-in limit");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* q_hi = base;
  uint8_t* q_lo = base + C::kQPart;
  uint8_t* buf_hi = base + 2 * C::kQPart;  // K tile, then V^T tile
  uint8_t* buf_lo = buf_hi + C::kBufPart;
  uint8_t* stage = buf_lo + C::kBufPart;   // the next raw tile
  const uint32_t sq_hi = smem_u32(q_hi), sq_lo = smem_u32(q_lo);
  const uint32_t sb_hi = smem_u32(buf_hi), sb_lo = smem_u32(buf_lo);
  const uint32_t s_stage = smem_u32(stage);

  const int tid = threadIdx.x;
  // this warpgroup: output columns wgi * kDw ..
  const int wgi = C::kWgs == 1 ? 0 : tid / 128;
  const int warp = tid % 128 / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int cb = 2 * (lane % 4);          // and columns cb, cb + 1 of each 8
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = hq / group;
  const int nq = min(kRows, sq - q0);
  const int len = kv_len[b];
  const int q_lo_pos = len - sq + q0;  // absolute position of the tile's row 0

  const int64_t kv_off = (static_cast<int64_t>(b) * hkv + h / group) * sk * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  // KV tiles holding an unmasked key for some row of this q tile
  int k_end = min(len, sk);
  if (causal) k_end = min(k_end, q_lo_pos + nq);
  int k_beg = window > 0 ? max(0, q_lo_pos - window + 1) : 0;
  k_beg -= k_beg % TK;
  const int ntiles = k_end > k_beg ? (k_end - k_beg + TK - 1) / TK : 0;

  // 16-byte chunk c4 of raw row j in the stage, XOR-swizzled so that the
  // split passes, which read one chunk column of 8 rows at a time, hit
  // distinct banks
  auto raw_off = [](int j, int c4) {
    return static_cast<uint32_t>((j * C::kChunks + (c4 ^ (j % C::kSwz))) * 16);
  };
  // tile `tile` of K or V into the stage by cp.async (coalesced rows; keys
  // past Sk are zero-filled)
  auto load_raw = [&](const float* src, int tile) {
    const int k0 = k_beg + tile * TK;
    for (int i = tid; i < TK * C::kChunks; i += kThreads) {
      const int j = i / C::kChunks, c4 = i % C::kChunks;
      const bool in = k0 + j < sk;
      cp_async16(s_stage + raw_off(j, c4),
                 src + static_cast<int64_t>(in ? k0 + j : 0) * D + 4 * c4, in);
    }
    cp_async_commit();
  };
  // the stage split into the buffer's hi and lo images: K as it is (keys x
  // D, K-major), V transposed (D x keys); 32 keys across the lanes
  auto split_k = [&]() {
#pragma unroll
    for (int i = 0; i < C::kNv4; ++i) {
      const int idx = tid + kThreads * i, j = idx % TK, c4 = idx / TK;
      const float4 x = *reinterpret_cast<const float4*>(stage + raw_off(j, c4));
      uint4 hi, lo;
      split(x.x, hi.x, lo.x), split(x.y, hi.y, lo.y);
      split(x.z, hi.z, lo.z), split(x.w, hi.w, lo.w);
      const uint32_t off = tile_off(j, 4 * c4, TK);
      *reinterpret_cast<uint4*>(buf_hi + off) = hi;
      *reinterpret_cast<uint4*>(buf_lo + off) = lo;
    }
  };
  auto split_v = [&]() {
#pragma unroll
    for (int i = 0; i < C::kNv4; ++i) {
      const int idx = tid + kThreads * i, j = idx % TK, c4 = idx / TK;
      const float4 x = *reinterpret_cast<const float4*>(stage + raw_off(j, c4));
      const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t hi, lo;
        split(e[t], hi, lo);
        const uint32_t off = tile_off(4 * c4 + t, vt_col(j), D);
        *reinterpret_cast<uint32_t*>(buf_hi + off) = hi;
        *reinterpret_cast<uint32_t*>(buf_lo + off) = lo;
      }
    }
  };

  if (ntiles > 0) load_raw(kb, 0);
  // q * D^-0.5 in f32, as the reference forms it, split; rows past Sq 0
  const float* qb = q + ((static_cast<int64_t>(b) * hq + h) * sq + q0) * D;
  for (int i = tid; i < kRows * C::kChunks; i += kThreads) {
    const int r = i / C::kChunks, c4 = i % C::kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nq) {
      x = __ldg(reinterpret_cast<const float4*>(qb + r * D + 4 * c4));
      x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
    }
    uint4 hi, lo;
    split(x.x, hi.x, lo.x), split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z), split(x.w, hi.w, lo.w);
    const uint32_t off = tile_off(r, 4 * c4, kRows);
    *reinterpret_cast<uint4*>(q_hi + off) = hi;
    *reinterpret_cast<uint4*>(q_lo + off) = lo;
  }
  if (ntiles > 0) {
    cp_async_wait<0>();
    __syncthreads();
    split_k();
  }

  float o[C::kDw / 2];
#pragma unroll
  for (int i = 0; i < C::kDw / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_beg + t * TK;
    fence_proxy_async();  // this thread's smem writes -> wgmma's proxy
    __syncthreads();      // K_t (and q) split; the stage is free
    load_raw(vb, t);      // V_t's raw tile arrives while S runs

    // S = Q K^T: a fresh accumulator per 64 columns of D (the tensor cores'
    // f32 adds truncate), two in flight, the partials added in f32 to
    // nearest in slice order; with two warpgroups each takes half of the
    // slices and the two sums are added through shared memory.
    // s[4 j + 2 half + c] is row row0 + 8 half, key k0 + 8 j + cb + c.
    float s[TK / 2], acc[2][TK / 2];
    auto issue_s = [&](int sl, float* a) {
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) a[i] = 0.f;
      // opaque copies of the bases: the descriptors are formed at each
      // wgmma, not hoisted out of the tile loop into ~D registers
      uint32_t qh = sq_hi, ql = sq_lo, bh0 = sb_hi, bl0 = sb_lo;
      opaque(qh), opaque(ql), opaque(bh0), opaque(bl0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / 8; ++kk) {
        const int ks = sl * kSlice / 8 + kk;
        if (ks < D / 8) {
          const uint64_t ah = desc_k(qh, kRows, ks);
          const uint64_t bh = desc_k(bh0, TK, ks);
          if (terms == 3) {  // the small terms first
            mma_ss_n32(a, desc_k(ql, kRows, ks), bh);
            mma_ss_n32(a, ah, desc_k(bl0, TK, ks));
          }
          mma_ss_n32(a, ah, bh);
        }
      }
      wgmma_commit();
    };
    auto add_s = [&](int l, float* a) {
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) {
        fence_reg(a[i]);
        s[i] = l == 0 ? a[i] : __fadd_rn(s[i], a[i]);
      }
    };
    // this warpgroup's slices sl0 .. sl0 + SPW - 1, sl0 a constant
    auto run_s = [&](auto sl0_c) {
      constexpr int sl0 = decltype(sl0_c)::value;
#pragma unroll
      for (int l = 0; l < SPW; ++l) {
        issue_s(sl0 + l, acc[l & 1]);
        if (l > 0) {
          wgmma_wait<1>();
          add_s(l - 1, acc[(l - 1) & 1]);
        }
      }
      wgmma_wait<0>();
      add_s(SPW - 1, acc[(SPW - 1) & 1]);
    };
    if (wgi == 1)
      run_s(std::integral_constant<int, SPW>());
    else
      run_s(std::integral_constant<int, 0>());
    if constexpr (C::kWgs == 2) {
      // each warpgroup's sum into the K buffer, which no product reads any
      // more; S = sum of warpgroup 0 + sum of warpgroup 1, the same bits
      // in both
      __syncthreads();
      float4* xs = reinterpret_cast<float4*>(buf_hi);
#pragma unroll
      for (int i = 0; i < TK / 8; ++i)
        xs[(wgi * TK / 8 + i) * 128 + tid % 128] =
            make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < TK / 8; ++i) {
        const float4 x = xs[((1 - wgi) * TK / 8 + i) * 128 + tid % 128];
        s[4 * i] = __fadd_rn(s[4 * i], x.x);
        s[4 * i + 1] = __fadd_rn(s[4 * i + 1], x.y);
        s[4 * i + 2] = __fadd_rn(s[4 * i + 2], x.z);
        s[4 * i + 3] = __fadd_rn(s[4 * i + 3], x.w);
      }
    }

    // softcap, masks, online softmax in f32 (accurate tanhf and expf)
    const bool whole = k0 + TK <= min(len, sk) &&
                       (!causal || k0 + TK - 1 <= q_lo_pos) &&
                       (window <= 0 || k0 > q_lo_pos + kRows - 1 - window);
    float alpha[2], m_safe[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = q_lo_pos + row0 + 8 * half;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * half + c];
          if (cap > 0.f) x = cap * tanhf(x / cap);
          if (!whole) {
            const int kpos = k0 + 8 * j + cb + c;
            const bool ok = kpos < len && kpos < sk &&
                            (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            x = ok ? x : kNegInf;
          }
          s[4 * j + 2 * half + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[half], mx);
      // guard all-masked rows (m_new is still the sentinel)
      m_safe[half] = m_new <= kNegInf / 2 ? 0.f : m_new;
      alpha[half] = m_run[half] <= kNegInf / 2
                        ? 0.f
                        : expf(m_run[half] - m_safe[half]);
      m_run[half] = m_new;
    }
    // p = exp(s - m_safe) in f32 (a masked score, -1e30, gives exactly 0);
    // the row sum adds the f32 p.  P's A fragment of k8 step kk holds
    // (row0, key pos t), (row0 + 8, t), (row0, t + 4), (row0 + 8, t + 4),
    // t = lane % 4, which vt_col maps to the keys s[4 kk + 0, 2, 1, 3]
    // hold: fragment slot x takes s index 4 (x / 4) + {0, 2, 1, 3}[x % 4].
    uint32_t p_hi[TK / 2], p_lo[TK / 2];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      const int half = (i >> 1) & 1;
      const float p = expf(s[i] - m_safe[half]);
      psum[half] += p;
      const int slot = (i & ~3) | ((i & 1) << 1) | ((i >> 1) & 1);
      split(p, p_hi[slot], p_lo[slot]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      psum[half] += __shfl_xor_sync(0xffffffffu, psum[half], 1);
      psum[half] += __shfl_xor_sync(0xffffffffu, psum[half], 2);
      l_run[half] = l_run[half] * alpha[half] + psum[half];
    }

    cp_async_wait<0>();
    __syncthreads();  // V_t's raw tile is in; every warp is done with K_t
    split_v();
    fence_proxy_async();
    __syncthreads();  // V_t^T split; the stage is free
    if (t + 1 < ntiles) load_raw(kb, t + 1);  // arrives while P V runs

    // O = O alpha + P V, kNc columns at a time: a fresh accumulator per
    // tile and chunk, two in flight, each added to O by fmaf on the CUDA
    // cores
    float part[2][C::kNc / 2];
    auto issue_pv = [&](int c, float* a) {
#pragma unroll
      for (int i = 0; i < C::kNc / 2; ++i) a[i] = 0.f;
      const uint32_t n0 = wgi * C::kDw + c * C::kNc;  // V^T rows
      uint32_t vh = sb_hi + n0 * 128, vl = sb_lo + n0 * 128;
      opaque(vh), opaque(vl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) {
        const uint64_t bh = make_desc(vh + kk * 32);
        if (terms == 3) {
          mma_rs<C::kNc>(a, p_lo + 4 * kk, bh);
          mma_rs<C::kNc>(a, p_hi + 4 * kk, make_desc(vl + kk * 32));
        }
        mma_rs<C::kNc>(a, p_hi + 4 * kk, bh);
      }
      wgmma_commit();
    };
    auto add_pv = [&](int c, float* a) {
#pragma unroll
      for (int j = 0; j < C::kNc / 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          fence_reg(a[4 * j + x]);
          float& od = o[4 * (c * C::kNc / 8 + j) + x];
          od = fmaf(od, alpha[x >> 1], a[4 * j + x]);
        }
    };
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      issue_pv(c, part[c & 1]);
      if (c > 0) {
        wgmma_wait<1>();
        add_pv(c - 1, part[(c - 1) & 1]);
      }
    }
    wgmma_wait<0>();
    add_pv(NCH - 1, part[(NCH - 1) & 1]);
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) fence_reg(p_hi[i]), fence_reg(p_lo[i]);

    if (t + 1 < ntiles) {
      cp_async_wait<0>();
      __syncthreads();  // K_{t+1}'s raw tile is in; every warp is done with V
      split_k();
    }
  }

  float* ob = out + (static_cast<int64_t>(b) * hq + h) * sq * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= nq) continue;
    const float denom = l_run[half] == 0.f ? 1.f : l_run[half];
    // the row's logsumexp for the backward, as in wgmma_kernel; both
    // warpgroups hold the same m and l, the first stores them
    if (lse != nullptr && wgi == 0 && lane % 4 == 0)
      lse[(static_cast<int64_t>(b) * hq + h) * sq + q0 + row] =
          m_run[half] + logf(denom);
    float* orow = ob + static_cast<int64_t>(q0 + row) * D + wgi * C::kDw + cb;
#pragma unroll
    for (int j = 0; j < C::kDw / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(o[4 * j + 2 * half] / denom,
                      o[4 * j + 2 * half + 1] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* lse, int b, int hq, int hkv, int sq, int sk,
           int causal, int window, float cap, float scale, int terms,
           cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = tf32x3_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kRows - 1) / kRows, hq, b);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_len, static_cast<float*>(out), lse,
      hq, hq / hkv, sq, sk, causal, window, cap, scale, terms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf

// ---------------------------------------------------------------------------
// Backward, f32: two passes on the tensor cores (3xTF32 wgmma)
// ---------------------------------------------------------------------------
//
// No TPU kernel: the reference differentiates its XLA flash path
// (src/repro/nn/flash_vjp.py::_flash_bwd), whose two passes these follow,
// on K5's contract (q scaled by D^-0.5 in f32, GQA, right alignment to
// kv_len[b], causal mask, window, softcap).  Per tile, in f32:
//
//   Z = qs K^T, S = cap tanh(Z / cap), P = exp(S - lse) where unmasked,
//   dP = dO V^T, dS = P (dP - delta) (1 - (S / cap)^2),
//   dq = scale dS K,  dk = dS^T qs,  dv = P^T dO,
//
// delta = rowsum(dO O).  Two passes and no atomics, so two launches are
// equal bit for bit.  Every product is a 3xTF32 wgmma.mma_async m64nNk8
// .f32.tf32.tf32, as tf32x3_kernel's: each operand x split into hi =
// rna(x) and lo = rna(x - hi), per k8 step A_lo B_hi + A_hi B_lo + A_hi
// B_hi, the small terms first (only lo * lo, ~2^-22 relative, is dropped).
//   * No accumulator spans a long reduction (the tensor cores truncate
//     each sum into the f32 accumulator; see the forward's note): S and dP
//     take a fresh accumulator per kSliceKs k8 steps of D, dQ one per KV
//     tile, dK and dV one per q tile, each added on the CUDA cores in f32
//     to nearest, in a fixed order.  Within an accumulator every step's
//     small terms are issued first and then every step's A_hi B_hi
//     (mma_steps), so that it truncates about once a step at its full
//     size, not three times.
//   * tf32 wgmma takes only K-major operands, with no transpose flag: a
//     product that reduces over the keys (dQ = dS K) or over the q rows
//     (dK, dV) would need its streamed tile a second time, transposed, as
//     hi and lo images (at D = 256 one image of a 64-row tile is 64 KB).
//     These three are formed transposed instead -- dQ^T = K^T dS^T, dV^T
//     = dO^T P, dK^T = qs^T dS, M = 64 columns of D (rows past D zero
//     below D = 64) -- so that their A operand comes from registers,
//     loaded in any order from the streamed tile's own hi and lo images,
//     and their B operand is the dS (P) tile, which the threads write as
//     hi and lo images anyway.  Each staged tile is one pair of images.
//   * The resident 64-row tile of a pass (qs and dO in the dq pass, K and
//     V in the dk/dv pass) is the A operand of S and dP, read from
//     registers (the RS form): raw f32 in a per-thread fragment order, one
//     16-byte load a k8 step, split in registers (as hi and lo images it
//     would take 256 KB at D = 256; split once below D = 256 measured no
//     faster).  The streamed tile (K and V, or qs and dO) is the B
//     operand: hi and lo images, loaded from device memory into registers
//     while the tile before is formed, split and stored between tiles.
//   * A CTA is two warpgroups, one product each: warpgroup 0 forms S (S^T
//     in the dk/dv pass), warpgroup 1 dP (dP^T), each over all of D; each
//     writes its result into the dS (P, dS^T) images, and all 256 threads
//     form P and dS from them in place.  Then in the dq pass the two split
//     dQ^T's columns of D (its q rows below D = 128); in the dk/dv pass
//     warpgroup 0 forms dV^T and warpgroup 1 dK^T.
//   * tf32x3_bwd_dq_kernel: a CTA per (64 query rows, q head, batch),
//     heaviest first, over the KV tiles the forward visits, kTK keys a
//     tile (16 at D = 256, where qs and dO take 128 KB, else 32).  It
//     stores delta (summed in f64, rounded once) for the second pass.
//   * tf32x3_bwd_dkdv_kernel: a CTA per (64 keys, KV head, batch), over
//     the group's query heads and the q tiles that see its keys, kTQ rows a
//     tile (16 at D = 256, 32 at D = 128, else 64); qs = q D^-0.5 is formed
//     again as each tile is staged.
// Shared memory at D = 256: 209.5 KB (dq), 225.1 KB (dk/dv); one CTA an
// SM.  P and dS are split from the f32 values; tanh and exp are tanhf and
// expf (the bf16 path's ex2 / rcp tanh errs by ~1e-5 of a logit at cap
// 50).  Masks are evaluated per element only in tiles that straddle the
// causal edge, the window start, kv_len[b] or Sq; a masked element's P is
// selected to 0, so an all-masked row (lse -1e30) gets zero gradients.
// On the H100 at chip_smoke.py's shapes every row is within ~4e-5 of its
// scale of the plain version evaluated in f64, whose f32 evaluation is
// itself up to ~1.1e-4 off it.
//
// What bounds it: operations.  Five products of 2 Sq Sk D a head over the
// unmasked pairs at 495 / 3 = 165 TFLOP/s; the passes compute seven (S and
// dP in both), so 5/7 of the bound is this design's ceiling.  Within it:
// at D = 256 the S and dP products are N = 16 wide (no wider KV or q tile
// fits beside the 128 KB resident tile), which the tensor cores run far
// below their rate; the warpgroups wait for their products before the
// elementwise work; and every tile ends in barriers, with the tensor cores
// idle while the next tile is split and staged.
namespace tfb {

using tf::desc_k;
using tf::opaque;
using tf::split;
using tf::tile_off;
using tf::wgmma_wait;
using wg::fence_proxy_async;
using wg::fence_reg;
using wg::smem_u32;
using wg::wgmma_commit;
using wg::wgmma_fence;

constexpr int kRows = 64;      // rows of the resident tile: one wgmma M
constexpr int kThreads = 256;  // two warpgroups, one product each

// columns of an image: rounded up to a 128-byte swizzle row
constexpr int padded(int n) { return (n + 31) / 32 * 32; }

// dq pass: qs and dO raw (64 x D each), the KV tile's hi and lo images
// (kTK x D), the dS images (64 x kTK), each row's lse and delta
template <int D>
struct DqCfg {
  static constexpr int kTK = D == 256 ? 16 : 32;  // keys of a KV tile
  static constexpr int kSliceKs = 4;  // k8 steps of one S or dP accumulator
  static constexpr int kRes = kRows * D * 4;
  static constexpr int kImg = kTK * padded(D) * 4;
  static constexpr int kXImg = kRows * padded(kTK) * 4;
  static constexpr int kSmem =
      1024 + 2 * kRes + 4 * kImg + 2 * kXImg + 2 * kRows * 4;
  // transposed products in flight (dQ^T's chunks; one at D = 256, where
  // two would take the registers of the next tile's loads)
  static constexpr int kInflight = D == 256 ? 1 : 2;
};

// dk/dv pass: K and V raw (64 x D each), the q tile's qs and dO hi and lo
// images (kTQ x D), the P^T and dS^T images (64 x kTQ), the tile rows' lse
// and delta
template <int D>
struct KvCfg {
  static constexpr int kTQ = D == 256 ? 16 : (D == 128 ? 32 : 64);
  // at D = 256 the dK^T and dV^T accumulators take 128 registers a thread
  static constexpr int kSliceKs = D == 256 ? 2 : 4;
  static constexpr int kRes = kRows * D * 4;
  static constexpr int kImg = kTQ * padded(D) * 4;
  static constexpr int kXImg = kRows * padded(kTQ) * 4;
  static constexpr int kSmem =
      1024 + 2 * kRes + 4 * kImg + 4 * kXImg + 2 * kTQ * 4;
  // one transposed product in flight from D = 128, where the dK^T and
  // dV^T accumulators take 64 and 128 registers a thread
  static constexpr int kInflight = D >= 128 ? 1 : 2;
};

// d (+)= A B, m64nNk8, f32 += tf32 x tf32: A from registers (this thread's
// fragment), B K-major in shared memory; scale_d = 0 ignores d's old value
__device__ __forceinline__ void mma_n16(float* d, const uint32_t* a,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_n32(float* d, const uint32_t* a,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_n64(float* d, const uint32_t* a,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                    int scale_d) {
  if constexpr (N == 16) mma_n16(d, a, db, scale_d);
  else if constexpr (N == 32) mma_n32(d, a, db, scale_d);
  else mma_n64(d, a, db, scale_d);
}

// KS k8 steps into one fresh accumulator d: 3xTF32 (terms = 3) or one
// TF32 product (terms = 1).  Every step's small terms A_lo B_hi + A_hi B_lo
// are issued first, then every step's A_hi B_hi: the tensor cores
// truncate each sum into d, so in this order d truncates about once a
// step at its full size, not three times (a small term added after a
// large one loses its low bits at the large one's scale).  ah[kk], al[kk]:
// step kk's A fragment; its B descriptors are desc_k(b_hi / b_lo, rows,
// ks0 + kk); steps at or past `valid` are skipped.
template <int N, int KS>
__device__ __forceinline__ void mma_steps(float* d, uint32_t (*ah)[4],
                                          uint32_t (*al)[4], uint32_t b_hi,
                                          uint32_t b_lo, int rows, int ks0,
                                          int valid, int terms) {
  if (terms == 3) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      if (kk < valid) {
        mma<N>(d, al[kk], desc_k(b_hi, rows, ks0 + kk), kk > 0);
        mma<N>(d, ah[kk], desc_k(b_lo, rows, ks0 + kk), 1);
      }
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (kk < valid)
      mma<N>(d, ah[kk], desc_k(b_hi, rows, ks0 + kk), terms == 3 || kk > 0);
}

// x split into hi and lo, 16 bytes stored at each image
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo,
                                            float4 x) {
  uint4 h, l;
  split(x.x, h.x, l.x), split(x.y, h.y, l.y);
  split(x.z, h.z, l.z), split(x.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// The resident tile (64 rows x D) in fragment order: thread lt of a
// warpgroup finds its A fragment of k8 step ks -- elements (16 (lt / 32) +
// lt % 32 / 4 + 8 (j & 1), 8 ks + lt % 4 + 4 (j >> 1)), j = 0..3 -- as the
// 16 bytes at (ks 128 + lt) 16, so one conflict-free load brings it.
// Byte offset of element (m, k):
__device__ __forceinline__ uint32_t frag_off(int m, int k) {
  const int lt = 32 * (m / 16) + 4 * (m % 8) + k % 4;
  const int j = (m / 8) % 2 + 2 * ((k % 8) / 4);
  return ((k / 8) * 128 + lt) * 16 + j * 4;
}

// Columns 4 c4 .. 4 c4 + 3 of row r of the resident tile, x, into its
// fragment-order image
__device__ __forceinline__ void put_res(uint8_t* tile, int r, int c4,
                                        float4 x) {
  const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<float*>(tile + frag_off(r, 4 * c4 + c)) = e[c];
}

// This thread's A fragment of k8 step kk of a transposed product over the
// 64-column chunk of D from column c0: element j, (m, k) = (row0 + 8 (j &
// 1), t + 4 (j >> 1)), is column c0 + m of row 8 kk + k of a streamed
// tile's hi and lo images (KR rows), at tile_off's offset written out for
// row0 = 16 warp + lane / 4 and t = lane % 4; columns past D are 0
template <int D, int KR>
__device__ __forceinline__ void frag_t(const uint8_t* hi_img,
                                       const uint8_t* lo_img, int c0,
                                       uint32_t warp, uint32_t lane, int kk,
                                       uint32_t* hi, uint32_t* lo) {
  const uint32_t t = lane % 4, s = lane / 4;
  const uint32_t base = (c0 / 32 + warp / 2) * KR * 128 + 128 * t + 1024 * kk;
  const uint32_t xa = 64 * (warp % 2) + 4 * s;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int jl = j & 1, jh = j >> 1;
    if (D >= 64 || static_cast<int>(16 * warp + s) + 8 * jl < D) {
      const uint32_t off =
          base + 512 * jh + ((xa + 32 * jl) ^ (16 * t + 64 * jh));
      hi[j] = *reinterpret_cast<const uint32_t*>(hi_img + off);
      lo[j] = *reinterpret_cast<const uint32_t*>(lo_img + off);
    } else {
      hi[j] = lo[j] = 0u;
    }
  }
}

// x = A B^T over all of D: A the resident tile `a` (raw, fragment order,
// split in registers), B the streamed tile's hi and lo images at shared
// addresses sb_hi, sb_lo (N rows, K-major).  A
// fresh accumulator per SK k8 steps (mma_steps' order), two in flight, the
// partials added in f32 to nearest in order.  x[4 j + 2 half + c] is row
// row0 + 8 half, column 8 j + 2 t + c.
template <int D, int N, int SK>
__device__ __forceinline__ void product_s(float* x, const uint8_t* a,
                                          uint32_t sb_hi, uint32_t sb_lo,
                                          int terms) {
  constexpr int KS = D / 8;  // k8 steps over D
  constexpr int NSL = (KS + SK - 1) / SK;  // accumulators
  float part[2][N / 2];
  uint32_t ah[2][SK][4], al[2][SK][4];
  auto issue = [&](int sl, int slot) {
    // opaque copies of the bases and the thread's offset: the addresses
    // and descriptors are formed at each use, not hoisted out of the tile
    // loop into registers
    uint32_t bh0 = sb_hi, bl0 = sb_lo, lt = threadIdx.x % 128;
    opaque(bh0), opaque(bl0), opaque(lt);
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      const int ks = sl * SK + kk;
      if (ks < KS) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + (ks * 128 + lt) * 16);
        split(v.x, ah[slot][kk][0], al[slot][kk][0]);
        split(v.y, ah[slot][kk][1], al[slot][kk][1]);
        split(v.z, ah[slot][kk][2], al[slot][kk][2]);
        split(v.w, ah[slot][kk][3], al[slot][kk][3]);
      }
    }
    wgmma_fence();
    mma_steps<N, SK>(part[slot], ah[slot], al[slot], bh0, bl0, N, sl * SK,
                     KS - sl * SK, terms);
    wgmma_commit();
  };
  auto add = [&](int sl, int slot) {
#pragma unroll
    for (int kk = 0; kk < SK; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        fence_reg(ah[slot][kk][j]), fence_reg(al[slot][kk][j]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      fence_reg(part[slot][i]);
      x[i] = sl == 0 ? part[slot][i] : __fadd_rn(x[i], part[slot][i]);
    }
  };
#pragma unroll
  for (int l = 0; l < NSL; ++l) {
    issue(l, l & 1);
    if (l > 0) {
      wgmma_wait<1>();
      add(l - 1, (l - 1) & 1);
    }
  }
  wgmma_wait<0>();
  add(NSL - 1, (NSL - 1) & 1);
}

// acc += A B for NC 64-row chunks of a transposed product, chunk c from
// column c0 + 64 c of D: A[m][k] is column c0 + 64 c + m of row k of a
// streamed tile's images (KR rows, frag_t), B the dS or P images at sb_hi,
// sb_lo (64 rows, K-major, N read from there).  A fresh accumulator a
// chunk (mma_steps' order), P in flight, each added to its chunk of acc in
// f32 to nearest.
template <int D, int KR, int N, int NC, int P>
__device__ __forceinline__ void product_t(float* acc, const uint8_t* a_hi,
                                          const uint8_t* a_lo, int c0,
                                          uint32_t sb_hi, uint32_t sb_lo,
                                          int terms) {
  constexpr int KK = KR / 8;
  float part[P][N / 2];
  uint32_t ah[P][KK][4], al[P][KK][4];
  auto issue = [&](int c, int slot) {
    // opaque copies, as in product_s
    uint32_t bh0 = sb_hi, bl0 = sb_lo, warp = threadIdx.x % 128 / 32,
             lane = threadIdx.x % 32;
    opaque(bh0), opaque(bl0), opaque(warp), opaque(lane);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      frag_t<D, KR>(a_hi, a_lo, c0 + 64 * c, warp, lane, kk, ah[slot][kk],
                    al[slot][kk]);
    wgmma_fence();
    mma_steps<N, KK>(part[slot], ah[slot], al[slot], bh0, bl0, kRows, 0, KK,
                     terms);
    wgmma_commit();
  };
  auto add = [&](int c, int slot) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        fence_reg(ah[slot][kk][j]), fence_reg(al[slot][kk][j]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      fence_reg(part[slot][i]);
      acc[c * N / 2 + i] = __fadd_rn(acc[c * N / 2 + i], part[slot][i]);
    }
  };
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    issue(c, c % P);
    if (c >= P - 1) {
      if constexpr (P == 2) wgmma_wait<1>();
      else wgmma_wait<0>();
      add(c - P + 1, (c - P + 1) % P);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = NC - P + 1; c < NC; ++c)
    if (c >= 0) add(c, c % P);
}

// P = exp(S' - lse) and dS = P (dP - delta) (1 - (S' / cap)^2), S' =
// cap tanh(S / cap) (S' = S without a softcap); p = 0 where !ok
__device__ __forceinline__ void p_ds(float s, float dp, float l, float dl,
                                     float cap, bool ok, float& p,
                                     float& ds) {
  float jac = 1.f;
  if (cap > 0.f) {
    const float th = tanhf(s / cap);
    s = cap * th;
    jac = 1.f - th * th;
  }
  p = ok ? expf(s - l) : 0.f;
  ds = p * (dp - dl) * jac;
}

// One CTA per (64 query rows, q head, batch); see the note above.
// terms = 3: 3xTF32; 1: one TF32 product (a control that must fail the
// f32 checks).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
tf32x3_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ lse,
                     const float* __restrict__ dout,
                     const int* __restrict__ kv_len,
                     float* __restrict__ delta, float* __restrict__ dq,
                     int hq, int group, int sq, int sk, int causal,
                     int window, float cap, float scale, int terms) {
  using C = DqCfg<D>;
  constexpr int TK = C::kTK;
  constexpr int kC4 = D / 4;  // float4s of a row
  constexpr int kF = (TK * kC4 + kThreads - 1) / kThreads;  // staged a thread
  // dQ^T of a warpgroup: NW chunks of 64 columns of D and NN q rows
  constexpr int NW = D >= 128 ? D / 128 : 1;
  constexpr int NN = D >= 128 ? kRows : kRows / 2;
  static_assert(C::kSmem <= 232448, "shared memory over the opt-in limit");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* s_qs = base;              // raw qs (64 x D), fragment order
  uint8_t* s_do = s_qs + C::kRes;    // raw dO
  uint8_t* k_hi = s_do + C::kRes;    // the KV tile's images (TK x D)
  uint8_t* k_lo = k_hi + C::kImg;
  uint8_t* v_hi = k_lo + C::kImg;
  uint8_t* v_lo = v_hi + C::kImg;
  uint8_t* x_hi = v_lo + C::kImg;    // S, then dS's hi image (64 x TK)
  uint8_t* x_lo = x_hi + C::kXImg;   // dP, then dS's lo image
  float* s_lse = reinterpret_cast<float*>(x_lo + C::kXImg);
  float* s_dl = s_lse + kRows;

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // 0: S, 1: dP
  const int warp = tid % 128 / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int t4 = lane % 4, cb = 2 * t4;   // and columns cb, cb + 1 of each 8
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / group;
  const int nq = min(kRows, sq - q0);
  const int len = kv_len[b];
  const int q_pos = len - sq + q0;  // absolute position of the tile's row 0
  const int64_t row_off = (static_cast<int64_t>(b) * hq + h) * sq;
  const int64_t kv_off = (static_cast<int64_t>(b) * hkv + h / group) * sk * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  // the KV tiles the forward visits for these rows
  int k_end = min(len, sk);
  if (causal) k_end = min(k_end, q_pos + nq);
  int k_beg = window > 0 ? max(0, q_pos - window + 1) : 0;
  k_beg -= k_beg % TK;
  const int ntiles = k_end > k_beg ? (k_end - k_beg + TK - 1) / TK : 0;

  // qs = q D^-0.5 in f32 and dO (0 past Sq), and delta = rowsum(dO O) of
  // the f32 values, summed in f64 and rounded once: the kL lanes of a row
  // are neighbours, each adding its kPer float4s' products in order, then a
  // butterfly over them
  constexpr int kL = kC4 < 32 ? kC4 : 32;
  constexpr int kPer = kC4 / kL;
  for (int i = tid; i < kRows * kL; i += kThreads) {
    const int r = i / kL, l = i % kL;
    double part = 0.0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c4 = l + kL * e;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), dv = qv;
      if (r < nq) {
        const int64_t g = (row_off + q0 + r) * D + 4 * c4;
        qv = __ldg(reinterpret_cast<const float4*>(q + g));
        qv.x *= scale, qv.y *= scale, qv.z *= scale, qv.w *= scale;
        dv = __ldg(reinterpret_cast<const float4*>(dout + g));
        const float4 ov = __ldg(reinterpret_cast<const float4*>(o + g));
        const double d4[4] = {dv.x, dv.y, dv.z, dv.w};
        const double o4[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) part = __fma_rn(d4[c], o4[c], part);
      }
      put_res(s_qs, r, c4, qv);
      put_res(s_do, r, c4, dv);
    }
#pragma unroll
    for (int m = 1; m < kL; m *= 2)
      part += __shfl_xor_sync(0xffffffffu, part, m);
    if (l == 0) {
      s_dl[r] = static_cast<float>(part);
      if (r < nq) delta[row_off + q0 + r] = static_cast<float>(part);
    }
  }
  // lse 0 past Sq: those rows have qs = dO = 0, so dS = 0, and are not
  // stored
  if (tid < kRows) s_lse[tid] = tid < nq ? lse[row_off + q0 + tid] : 0.f;

  // KV tile `tile` into registers (keys past Sk 0), then split into the
  // images once the last tile's products are done
  float4 fk[kF], fv[kF];
  auto fetch = [&](int tile) {
    const int k0 = k_beg + tile * TK;
#pragma unroll
    for (int e = 0; e < kF; ++e) {
      const int i = tid + kThreads * e, j = i / kC4, c4 = i % kC4;
      fk[e] = fv[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < TK * kC4 && k0 + j < sk) {
        const int64_t g = static_cast<int64_t>(k0 + j) * D + 4 * c4;
        fk[e] = __ldg(reinterpret_cast<const float4*>(kb + g));
        fv[e] = __ldg(reinterpret_cast<const float4*>(vb + g));
      }
    }
  };
  auto stage = [&]() {
    uint32_t z = 0;
    opaque(z);
#pragma unroll
    for (int e = 0; e < kF; ++e) {
      const int i = tid + kThreads * e;
      if (i < TK * kC4) {
        const uint32_t off = z + tile_off(i / kC4, 4 * (i % kC4), TK);
        store_split(k_hi + off, k_lo + off, fk[e]);
        store_split(v_hi + off, v_lo + off, fv[e]);
      }
    }
  };

  // dQ^T / scale: chunk c, element 4 j + 2 half + cc is column d0 + 64 c +
  // row0 + 8 half of D, q row n0 + 8 j + cb + cc
  float acc[NW * NN / 2];
#pragma unroll
  for (int i = 0; i < NW * NN / 2; ++i) acc[i] = 0.f;
  const int d0 = D >= 128 ? wgi * NW * 64 : 0;
  const int n0 = D >= 128 ? 0 : wgi * NN;
  // S = qs K^T (warpgroup 0) or dP = dO V^T (warpgroup 1), and where it goes
  const uint8_t* a_res = wgi ? s_do : s_qs;
  const uint32_t b_hi = smem_u32(wgi ? v_hi : k_hi);
  const uint32_t b_lo = smem_u32(wgi ? v_lo : k_lo);
  uint8_t* x_out = wgi ? x_lo : x_hi;
  const uint32_t sx_hi = smem_u32(x_hi) + n0 * 128;
  const uint32_t sx_lo = smem_u32(x_lo) + n0 * 128;

  if (ntiles > 0) {
    fetch(0);
    stage();
  }
  fence_proxy_async();  // this thread's smem writes -> wgmma's proxy
  __syncthreads();

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_beg + t * TK;

    if (t + 1 < ntiles) fetch(t + 1);  // in flight while this tile runs
    float x[TK / 2];
    product_s<D, TK, C::kSliceKs>(x, a_res, b_hi, b_lo, terms);
    uint32_t z = 0;  // an opaque 0: the addresses are formed here
    opaque(z);
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            x_out + z + tile_off(row0 + 8 * half, 8 * j + cb, kRows)) =
            make_float2(x[4 * j + 2 * half], x[4 * j + 2 * half + 1]);
    __syncthreads();  // S and dP of every row

    // P and dS in place, 4 keys a step: dS's hi and lo images
    const bool whole = k0 + TK <= min(len, sk) &&
                       (!causal || k0 + TK - 1 <= q_pos) &&
                       (window <= 0 || k0 > q_pos + kRows - 1 - window);
#pragma unroll
    for (int e = 0; e < kRows * TK / 4 / kThreads; ++e) {
      const int i = tid + kThreads * e, r = i / (TK / 4), c4 = i % (TK / 4);
      const uint32_t off = z + tile_off(r, 4 * c4, kRows);
      const float4 s4 = *reinterpret_cast<const float4*>(x_hi + off);
      const float4 d4 = *reinterpret_cast<const float4*>(x_lo + off);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      const float dpv[4] = {d4.x, d4.y, d4.z, d4.w};
      const int qpos = q_pos + r;
      float p, ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + 4 * c4 + c;
        const bool ok = whole || (r < nq && kpos < len && kpos < sk &&
                                  (!causal || kpos <= qpos) &&
                                  (window <= 0 || kpos > qpos - window));
        p_ds(sv[c], dpv[c], s_lse[r], s_dl[r], cap, ok, p, ds[c]);
      }
      store_split(x_hi + off, x_lo + off,
                  make_float4(ds[0], ds[1], ds[2], ds[3]));
    }
    fence_proxy_async();
    __syncthreads();  // dS's images of every row

    // dQ^T += K^T dS^T
    product_t<D, TK, NN, NW, C::kInflight>(acc, k_hi, k_lo, d0, sx_hi, sx_lo,
                                           terms);
    __syncthreads();  // every warp is done with this tile's images
    if (t + 1 < ntiles) {
      stage();
      fence_proxy_async();
      __syncthreads();
    }
  }

  float* dqb = dq + row_off * D;
#pragma unroll
  for (int c = 0; c < NW; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = d0 + 64 * c + row0 + 8 * half;
      if (D < 64 && d >= D) continue;
#pragma unroll
      for (int j = 0; j < NN / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int r = n0 + 8 * j + cb + cc;
          if (r < nq)
            dqb[static_cast<int64_t>(q0 + r) * D + d] =
                acc[c * NN / 2 + 4 * j + 2 * half + cc] * scale;
        }
    }
}

// One CTA per (64 keys, KV head, batch); see the note above.  terms as in
// tf32x3_bwd_dq_kernel.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
tf32x3_bwd_dkdv_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ lse,
                       const float* __restrict__ dout,
                       const int* __restrict__ kv_len,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int hq, int group, int sq, int sk, int causal,
                       int window, float cap, float scale, int terms) {
  using C = KvCfg<D>;
  constexpr int TQ = C::kTQ;
  constexpr int kC4 = D / 4;
  constexpr int kF = (TQ * kC4 + kThreads - 1) / kThreads;
  constexpr int NC = D >= 64 ? D / 64 : 1;  // 64-column chunks of dK^T, dV^T
  static_assert(C::kSmem <= 232448, "shared memory over the opt-in limit");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* s_k = base;              // raw K (64 keys x D), fragment order
  uint8_t* s_v = s_k + C::kRes;     // raw V
  uint8_t* qs_hi = s_v + C::kRes;   // the q tile's images (TQ x D)
  uint8_t* qs_lo = qs_hi + C::kImg;
  uint8_t* do_hi = qs_lo + C::kImg;
  uint8_t* do_lo = do_hi + C::kImg;
  uint8_t* p_hi = do_lo + C::kImg;  // S^T, then P^T's hi image (64 x TQ)
  uint8_t* p_lo = p_hi + C::kXImg;
  uint8_t* g_hi = p_lo + C::kXImg;  // dP^T, then dS^T's hi image
  uint8_t* g_lo = g_hi + C::kXImg;
  float* s_ld = reinterpret_cast<float*>(g_lo + C::kXImg);  // lse, delta

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // 0: S^T and dV^T, 1: dP^T and dK^T
  const int warp = tid % 128 / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // this thread's keys: row0, row0 + 8
  const int t4 = lane % 4, cb = 2 * t4;   // and columns cb, cb + 1 of each 8
  const int k0 = blockIdx.x * kRows;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / group;
  const int len = kv_len[b];
  const int k_valid = min(len, sk);  // keys past this are masked
  const int64_t kv_off = (static_cast<int64_t>(b) * hkv + hk) * sk * D;

  // the q rows with an unmasked key in this tile: qpos = len - sq + i sees
  // key kpos iff kpos <= qpos (causal) and kpos > qpos - window
  int i_lo = 0, i_hi = -1;
  if (k0 < k_valid) {
    const int k_last = min(k0 + kRows, k_valid) - 1;
    i_lo = causal ? max(0, k0 - (len - sq)) : 0;
    i_hi = window > 0 ? min(sq - 1, k_last + window - 1 - (len - sq))
                      : sq - 1;
  }
  const int t_lo = i_lo / TQ;
  const int ntq = i_hi < i_lo ? 0 : i_hi / TQ - t_lo + 1;
  const int nitems = group * ntq;  // (query head, q tile) pairs

  // K and V (keys past Sk 0)
  for (int i = tid; i < kRows * kC4; i += kThreads) {
    const int r = i / kC4, c4 = i % kC4;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (k0 + r < sk) {
      const int64_t g = kv_off + static_cast<int64_t>(k0 + r) * D + 4 * c4;
      kx = __ldg(reinterpret_cast<const float4*>(k + g));
      vx = __ldg(reinterpret_cast<const float4*>(v + g));
    }
    put_res(s_k, r, c4, kx);
    put_res(s_v, r, c4, vx);
  }

  // item's q tile into registers -- qs = q D^-0.5 in f32 and dO, 0 past
  // Sq, and the rows' lse (threads 0 .. TQ - 1) and delta (TQ .. 2 TQ - 1),
  // 0 past Sq -- then split into the images once the last item is done
  float4 fq[kF], fo[kF];
  float fl = 0.f;
  auto fetch = [&](int item) {
    const int h = hk * group + item / ntq;
    const int qq0 = (t_lo + item % ntq) * TQ;
    const int64_t row_off = (static_cast<int64_t>(b) * hq + h) * sq;
#pragma unroll
    for (int e = 0; e < kF; ++e) {
      const int i = tid + kThreads * e, j = i / kC4, c4 = i % kC4;
      fq[e] = fo[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < TQ * kC4 && qq0 + j < sq) {
        const int64_t g = (row_off + qq0 + j) * D + 4 * c4;
        fq[e] = __ldg(reinterpret_cast<const float4*>(q + g));
        fq[e].x *= scale, fq[e].y *= scale, fq[e].z *= scale,
            fq[e].w *= scale;
        fo[e] = __ldg(reinterpret_cast<const float4*>(dout + g));
      }
    }
    const int r = tid % TQ;
    fl = 0.f;
    if (tid < 2 * TQ && qq0 + r < sq)
      fl = (tid < TQ ? lse : delta)[row_off + qq0 + r];
  };
  auto stage = [&]() {
    uint32_t z = 0;
    opaque(z);
#pragma unroll
    for (int e = 0; e < kF; ++e) {
      const int i = tid + kThreads * e;
      if (i < TQ * kC4) {
        const uint32_t off = z + tile_off(i / kC4, 4 * (i % kC4), TQ);
        store_split(qs_hi + off, qs_lo + off, fq[e]);
        store_split(do_hi + off, do_lo + off, fo[e]);
      }
    }
    if (tid < 2 * TQ) s_ld[tid] = fl;
  };

  // warpgroup 0: dV^T, 1: dK^T; chunk c, element 4 j + 2 half + cc is
  // column 64 c + row0 + 8 half of D, key 8 j + cb + cc
  float acc[NC * kRows / 2];
#pragma unroll
  for (int i = 0; i < NC * kRows / 2; ++i) acc[i] = 0.f;
  // S^T = K qs^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), and where
  // it goes
  const uint8_t* a_res = wgi ? s_v : s_k;
  const uint32_t b_hi = smem_u32(wgi ? do_hi : qs_hi);
  const uint32_t b_lo = smem_u32(wgi ? do_lo : qs_lo);
  uint8_t* x_out = wgi ? g_hi : p_hi;
  // dV^T = dO^T P (warpgroup 0) or dK^T = qs^T dS (warpgroup 1)
  const uint8_t* ta_hi = wgi ? qs_hi : do_hi;
  const uint8_t* ta_lo = wgi ? qs_lo : do_lo;
  const uint32_t tb_hi = smem_u32(wgi ? g_hi : p_hi);
  const uint32_t tb_lo = smem_u32(wgi ? g_lo : p_lo);

  if (nitems > 0) {
    fetch(0);
    stage();
  }
  fence_proxy_async();  // this thread's smem writes -> wgmma's proxy
  __syncthreads();

  for (int it = 0; it < nitems; ++it) {
    const int qq0 = (t_lo + it % ntq) * TQ;
    const int q_pos = len - sq + qq0;  // absolute position of row 0
    float x[TQ / 2];
    product_s<D, TQ, C::kSliceKs>(x, a_res, b_hi, b_lo, terms);
    uint32_t z = 0;  // an opaque 0: the addresses are formed here
    opaque(z);
#pragma unroll
    for (int j = 0; j < TQ / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            x_out + z + tile_off(row0 + 8 * half, 8 * j + cb, kRows)) =
            make_float2(x[4 * j + 2 * half], x[4 * j + 2 * half + 1]);
    __syncthreads();  // S^T and dP^T of every key

    // P^T and dS^T in place, 4 q rows a step: their hi and lo images
    const bool whole = k0 + kRows <= k_valid && qq0 + TQ <= sq &&
                       (!causal || k0 + kRows - 1 <= q_pos) &&
                       (window <= 0 || k0 > q_pos + TQ - 1 - window);
#pragma unroll
    for (int e = 0; e < kRows * TQ / 4 / kThreads; ++e) {
      const int i = tid + kThreads * e, r = i / (TQ / 4), c4 = i % (TQ / 4);
      const uint32_t off = z + tile_off(r, 4 * c4, kRows);
      const float4 s4 = *reinterpret_cast<const float4*>(p_hi + off);
      const float4 d4 = *reinterpret_cast<const float4*>(g_hi + off);
      const float4 l4 = *reinterpret_cast<const float4*>(s_ld + 4 * c4);
      const float4 dl4 = *reinterpret_cast<const float4*>(s_ld + TQ + 4 * c4);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      const float dpv[4] = {d4.x, d4.y, d4.z, d4.w};
      const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
      const float dlv[4] = {dl4.x, dl4.y, dl4.z, dl4.w};
      const int kpos = k0 + r;
      float p[4], ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qi = 4 * c4 + c, qpos = q_pos + qi;
        const bool ok = whole || (kpos < k_valid && qq0 + qi < sq &&
                                  (!causal || kpos <= qpos) &&
                                  (window <= 0 || kpos > qpos - window));
        p_ds(sv[c], dpv[c], lv[c], dlv[c], cap, ok, p[c], ds[c]);
      }
      store_split(p_hi + off, p_lo + off, make_float4(p[0], p[1], p[2], p[3]));
      store_split(g_hi + off, g_lo + off,
                  make_float4(ds[0], ds[1], ds[2], ds[3]));
    }
    fence_proxy_async();
    __syncthreads();  // P^T's and dS^T's images of every key

    // the next item's loads are in flight while this one's transposed
    // products run (not earlier: at D = 256 the dK^T and dV^T accumulators
    // leave no registers for them beside S^T's, dP^T's and dS's)
    if (it + 1 < nitems) fetch(it + 1);
    // dV^T += dO^T P or dK^T += qs^T dS
    product_t<D, TQ, kRows, NC, C::kInflight>(acc, ta_hi, ta_lo, 0, tb_hi,
                                              tb_lo, terms);
    __syncthreads();  // every warp is done with this item's images
    if (it + 1 < nitems) {
      stage();
      fence_proxy_async();
      __syncthreads();
    }
  }

  float* dst = wgi ? dk : dv;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = 64 * c + row0 + 8 * half;
      if (D < 64 && d >= D) continue;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int key = k0 + 8 * j + cb + cc;
          if (key < sk)
            dst[kv_off + static_cast<int64_t>(key) * D + d] =
                acc[c * kRows / 2 + 4 * j + 2 * half + cc];
        }
    }
}

// pass 0: dq and delta; pass 1: dk and dv
template <int D>
int launch_pass(int pass, const void* q, const void* k, const void* v,
                const void* o, const float* lse, const void* dout,
                const int* kv_len, float* delta, void* dq, void* dk,
                void* dv, int b, int hq, int hkv, int sq, int sk, int causal,
                int window, float cap, float scale, int terms,
                cudaStream_t stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  if (pass == 0) {
    constexpr int smem = DqCfg<D>::kSmem;
    auto kernel = tf32x3_bwd_dq_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sq + kRows - 1) / kRows, hq, b);
    kernel<<<grid, kThreads, smem, stream>>>(
        qf, kf, vf, static_cast<const float*>(o), lse, df, kv_len, delta,
        static_cast<float*>(dq), hq, hq / hkv, sq, sk, causal, window, cap,
        scale, terms);
  } else {
    constexpr int smem = KvCfg<D>::kSmem;
    auto kernel = tf32x3_bwd_dkdv_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sk + kRows - 1) / kRows, hkv, b);
    kernel<<<grid, kThreads, smem, stream>>>(
        qf, kf, vf, lse, df, kv_len, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), hq, hq / hkv, sq, sk, causal, window, cap,
        scale, terms);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tfb

// ---------------------------------------------------------------------------
// Backward, bf16: two passes on the tensor cores (wgmma)
// ---------------------------------------------------------------------------
//
// The bf16 instance of K5's backward; like tfb:: above (the f32 one) it
// replaces no TPU kernel.  Same function, same two
// passes and no atomics (two launches are equal bit for bit), every
// product a wgmma.mma_async m64nNk16 .f32.bf16.bf16:
//   * wgmma_bwd_dq_kernel: a warpgroup owns 64 query rows of one head (the
//     M of one wgmma).  Its prologue stages qs (q * D^-0.5 rounded to bf16,
//     as the forward stages it) and dO, forms delta = rowsum(dO O) in f32,
//     and stores delta and qs for the second pass.  Per KV tile: S = qs K^T
//     and dP = dO V^T are SS products (A and B K-major in shared memory),
//     committed as two groups, so that the softcap, masks, P = exp(S - lse)
//     and P (1 - (S / cap)^2) run while dP is still in the tensor cores;
//     then dS = P (dP - delta)(1 - (S / cap)^2) in registers, and dQ += dS K
//     is an RS product whose A is the S accumulator's fragment (as the
//     forward's P) and whose B is the same K tile read MN-major through the
//     transpose flag.  At D = 256 with an even GQA group a CTA is two
//     warpgroups, the two query heads of a pair, sharing every K/V tile
//     (the forward's WGS = 2).
//   * wgmma_bwd_dkdv_kernel: a CTA owns 64 keys of one KV head, stages K and
//     V once and loops over the group's query heads and the q tiles that
//     see its keys (key tiles launched in order, heaviest first under the
//     causal mask).  S^T = K qs^T and dP^T = V dO^T are SS products; dV +=
//     P^T dO is issued as soon as P is formed, while dP^T finishes, then dS
//     and dK += dS^T qs: RS products, B being the streamed qs and dO tiles
//     read MN-major.  At D = 256 the dK and dV accumulators (64 x 256 f32
//     each, 256 registers a thread for one warpgroup) are split: two
//     warpgroups, each holding 128 columns of both and forming S^T and dP^T
//     over all of D itself.  Forming half of D each and adding the halves
//     through shared memory (the f32 forward's trick) needs 64 KB for the
//     partial tiles, which the ring of qs / dO stages holds; the exchange
//     that fits (one warpgroup forms S^T, the other dP^T, 32 KB) was slower
//     on the H100 than the redundant products at gemma2's global layer
//     (scripts/flash_bwd_variants.py times the two), so it was not kept.
// Both stage every operand once a tile in the forward's natural image (rows
// x D, D contiguous, 128-byte swizzle; 64/32 bytes at D = 32/16) and read it
// K-major or MN-major as the product needs; streamed tiles (and the dk/dv
// pass's rows of lse and delta) come by cp.async into a ring of two stages.
// Storing qs in the dq pass spares the dk/dv pass a scaling pass over each
// q tile in shared memory.
// Precision: P is rounded to bf16 before dV, dS before dQ and dK, as the
// forward rounds P; S, the softcap and its Jacobian, lse, delta and the
// accumulators stay f32, and each output is rounded once.  Masks are
// evaluated per element only in tiles that straddle the causal edge, the
// window start, kv_len[b] or Sq; a masked element's P is selected to 0, so
// an all-masked row (lse -1e30) gets zero gradients, never exp(+1e30).
//
// What bounds it: operations.  Five products of 2 Sq Sk D a head over the
// unmasked pairs at 989 TFLOP/s; the two passes compute seven (S and dP in
// both; nine at D = 256 in dk/dv, where each warpgroup forms S^T and dP^T),
// so 0.71 (0.56) of the bound is the ceiling of this design.  Within it,
// a warpgroup still waits for its products before the elementwise work
// and the two warpgroups of a CTA meet at every tile: a producer warp with
// TMA and setmaxnreg, and ping-pong scheduling of the warpgroups, are the
// next steps.
namespace wgb {

using wg::chunk_off;
using wg::cp_async16;
using wg::cp_async4;
using wg::cp_async_commit;
using wg::cp_async_wait;
using wg::desc_k;
using wg::desc_mn;
using wg::ex2;
using wg::fence_proxy_async;
using wg::fence_reg;
using wg::kLog2e;
using wg::kRows;
using wg::smem_u32;
using wg::tanh_ex2;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_rs;
using wg::wgmma_ss;
using wg::wgmma_wait0;

// dq pass: WGS warpgroups (query heads) a CTA, each 64 rows of qs and dO;
// KV tiles of kTileK keys in two stages
template <int D, int WGS>
struct DqCfg {
  static constexpr int kThreads = 128 * WGS;
  static constexpr int kTileK = D == 256 ? 32 : 64;
  static constexpr int kRowBytes = kRows * D * 2;    // one q or dO tile
  static constexpr int kTileBytes = kTileK * D * 2;  // one K or V tile
  // alignment slack, q and dO tiles, two stages of K and V, delta per row
  static constexpr int kSmem =
      1024 + 2 * WGS * kRowBytes + 4 * kTileBytes + WGS * kRows * 4;
};

// dk/dv pass: 64 keys a CTA, kWgs warpgroups splitting D; q / dO tiles of
// kTileQ rows in two stages, with their rows' lse and delta
template <int D>
struct KvCfg {
  static constexpr int kWgs = D == 256 ? 2 : 1;
  static constexpr int kThreads = 128 * kWgs;
  static constexpr int kDw = D / kWgs;  // dK and dV columns of a warpgroup
  static constexpr int kTileQ = 64;
  static constexpr int kKvBytes = kRows * D * 2;   // the CTA's K or V tile
  static constexpr int kQBytes = kTileQ * D * 2;   // one q or dO tile
  // alignment slack, K and V, two stages of q and dO, and of lse and delta
  static constexpr int kSmem = 1024 + 2 * kKvBytes + 4 * kQBytes +
                               4 * kTileQ * 4;
};

// rounds lo, hi to bf16 and packs them (lo in the low half): an A fragment
// register of the RS products
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 bf16 values of q scaled by `scale` and rounded to bf16, as the forward
// forms qs
__device__ __forceinline__ uint4 scale_bf16x8(uint4 val, float scale) {
  __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(hv[e]);
    hv[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }
  return val;
}

template <int D, int WGS>
__global__ void __launch_bounds__(128 * WGS, D <= 128 ? 2 : 1)
wgmma_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ o,
                    const float* __restrict__ lse,
                    const __nv_bfloat16* __restrict__ dout,
                    const int* __restrict__ kv_len, float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ qs,
                    __nv_bfloat16* __restrict__ dq, int hq, int group, int sq,
                    int sk, int causal, int window, float cap, float scale) {
  using C = DqCfg<D, WGS>;
  constexpr int TK = C::kTileK;
  constexpr int kThreads = C::kThreads;
  constexpr int kC8 = D / 8;  // 16-byte chunks of a row
  static_assert(C::kSmem <= 232448, "shared memory over the opt-in limit");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;        // WGS qs tiles
  const uint32_t s_do = s_q + WGS * C::kRowBytes;    // WGS dO tiles
  uint8_t* base = smem_raw + (s_q - raw);
  auto s_k = [&](int st) {
    return s_do + WGS * C::kRowBytes + st * 2 * C::kTileBytes;
  };
  auto s_v = [&](int st) { return s_k(st) + C::kTileBytes; };
  float* s_delta = reinterpret_cast<float*>(base + 2 * WGS * C::kRowBytes +
                                            4 * C::kTileBytes);

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // this thread's warpgroup: head h0 + wgi
  const int warp = tid % 128 / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int cb = 2 * (lane % 4);          // and columns cb, cb + 1 of each 8
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest first
  const int h0 = blockIdx.y * WGS;
  const int h = h0 + wgi;
  const int b = blockIdx.z;
  const int hkv = hq / group;
  const int nq = min(kRows, sq - q0);
  const int len = kv_len[b];
  const int q_lo = len - sq + q0;  // absolute position of the tile's row 0

  const int64_t kv_off =
      (static_cast<int64_t>(b) * hkv + h0 / group) * sk * D;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;

  // the KV tiles the forward visits for these rows
  int k_end = min(len, sk);
  if (causal) k_end = min(k_end, q_lo + nq);
  int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_beg -= k_beg % TK;
  const int ntiles = k_end > k_beg ? (k_end - k_beg + TK - 1) / TK : 0;

  auto load_kv = [&](int tile, int st) {
    const int k0 = k_beg + tile * TK;
    for (int i = tid; i < TK * kC8; i += kThreads) {
      const int r = i / kC8, c8 = i % kC8;
      const bool in = k0 + r < sk;
      const int64_t g = static_cast<int64_t>(in ? k0 + r : 0) * D + c8 * 8;
      const uint32_t off = chunk_off<D>(r, c8, TK);
      cp_async16(s_k(st) + off, kb + g, in);
      cp_async16(s_v(st) + off, vb + g, in);
    }
    cp_async_commit();
  };
  if (ntiles > 0) load_kv(0, 0);

  // qs and dO of each head's rows (0 past Sq; qs also stored for the dk/dv
  // pass), and delta = rowsum(dO O) in f32: the kC8 chunks of a row are kC8 neighbouring lanes (kC8 divides
  // 32), each adding its 8 products in order, then a butterfly over them
  for (int i = tid; i < WGS * kRows * kC8; i += kThreads) {
    const int w = i / (kRows * kC8), j = i % (kRows * kC8);
    const int r = j / kC8, c8 = j % kC8;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u), dv = qv;
    float part = 0.f;
    const int64_t row_off = (static_cast<int64_t>(b) * hq + h0 + w) * sq;
    if (r < nq) {
      const int64_t g = (row_off + q0 + r) * D + c8 * 8;
      qv = scale_bf16x8(*reinterpret_cast<const uint4*>(q + g), scale);
      *reinterpret_cast<uint4*>(qs + g) = qv;  // for the dk/dv pass
      dv = *reinterpret_cast<const uint4*>(dout + g);
      const uint4 ov = *reinterpret_cast<const uint4*>(o + g);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(d2[e]);
        const float2 c = __bfloat1622float2(o2[e]);
        part = fmaf(a.x, c.x, part);
        part = fmaf(a.y, c.y, part);
      }
    }
    const uint32_t off = chunk_off<D>(r, c8, kRows);
    *reinterpret_cast<uint4*>(base + w * C::kRowBytes + off) = qv;
    *reinterpret_cast<uint4*>(base + (WGS + w) * C::kRowBytes + off) = dv;
#pragma unroll
    for (int m = 1; m < kC8 && m < 32; m *= 2)
      part += __shfl_xor_sync(0xffffffffu, part, m);
    if (c8 == 0) {
      s_delta[w * kRows + r] = part;
      if (r < nq) delta[row_off + q0 + r] = part;
    }
  }
  __syncthreads();  // delta of every row
  // this thread's two rows: lse (0 past Sq: those rows have qs = dO = 0,
  // so dS = 0, and are not stored) and delta, both times log2(e) where the
  // exponent takes them
  float lse2[2], dl[2];
  const int64_t h_rows = (static_cast<int64_t>(b) * hq + h) * sq;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    lse2[half] = r < nq ? lse[h_rows + q0 + r] * kLog2e : 0.f;
    dl[half] = s_delta[wgi * kRows + r];
  }

  float acc[D / 2];  // dQ / scale
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  const uint32_t a_q = s_q + wgi * C::kRowBytes;
  const uint32_t a_do = s_do + wgi * C::kRowBytes;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    const int k0 = k_beg + t * TK;
    if (t + 1 < ntiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // this thread's smem writes -> wgmma's proxy
    __syncthreads();

    // S = qs K^T and dP = dO V^T; s[4 j + 2 half + c] is row row0 + 8 half,
    // key k0 + 8 j + cb + c (dp alike)
    float s[TK / 2], dp[TK / 2];  // the first k16 step ignores them
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<TK>(s, desc_k<D>(a_q, kRows, ks), desc_k<D>(s_k(st), TK, ks),
                   ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<TK>(dp, desc_k<D>(a_do, kRows, ks), desc_k<D>(s_v(st), TK, ks),
                   ks > 0);
    wgmma_commit();
    tf::wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) fence_reg(s[i]);

    // dS = P (dP - delta) (1 - (S / cap)^2), rounded to bf16: dsf[x] packs
    // elements 2x, 2x + 1 (row half x & 1), the A fragment of dS K
    const bool whole = k0 + TK <= min(len, sk) &&
                       (!causal || k0 + TK - 1 <= q_lo) &&
                       (window <= 0 || k0 > q_lo + kRows - 1 - window);
    uint32_t dsf[TK / 4];
#pragma unroll
    for (int x = 0; x < TK / 4; ++x) {
      const int half = x & 1;
      const int qpos = q_lo + row0 + 8 * half;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * x + c;
        float z = s[e], jac = 1.f;
        if (cap > 0.f) {
          const float th = tanh_ex2(z * inv_cap);
          z = cap * th;
          jac = fmaf(-th, th, 1.f);
        }
        float p = ex2(fmaf(z, kLog2e, -lse2[half]));
        if (!whole) {
          const int kpos = k0 + 8 * (x / 2) + cb + c;
          const bool ok = kpos < len && kpos < sk &&
                          (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          p = ok ? p : 0.f;
        }
        s[e] = p * jac;
      }
    }
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) fence_reg(dp[i]);
#pragma unroll
    for (int x = 0; x < TK / 4; ++x)
      dsf[x] = pack2(s[2 * x] * (dp[2 * x] - dl[x & 1]),
                     s[2 * x + 1] * (dp[2 * x + 1] - dl[x & 1]));

    // dQ += dS K: B is the K tile read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      wgmma_rs<D>(acc, dsf + 4 * kk, desc_mn<D>(s_k(st), TK, kk));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int i = 0; i < TK / 4; ++i) fence_reg(dsf[i]);
    __syncthreads();  // every warp is done with this stage's K and V
  }

  __nv_bfloat16* dqb = dq + h_rows * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= nq) continue;
    __nv_bfloat16* drow = dqb + static_cast<int64_t>(q0 + row) * D + cb;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * scale,
                                acc[4 * j + 2 * half + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(KvCfg<D>::kThreads, D <= 128 ? 2 : 1)
wgmma_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ qs,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ lse,
                      const __nv_bfloat16* __restrict__ dout,
                      const int* __restrict__ kv_len,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int hq, int group,
                      int sq, int sk, int causal, int window, float cap) {
  using C = KvCfg<D>;
  constexpr int TQ = C::kTileQ;
  constexpr int kThreads = C::kThreads;
  constexpr int kC8 = D / 8;
  static_assert(C::kSmem <= 232448, "shared memory over the opt-in limit");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u;
  const uint32_t s_v = s_k + C::kKvBytes;
  uint8_t* base = smem_raw + (s_k - raw);
  auto s_q = [&](int st) { return s_v + C::kKvBytes + st * 2 * C::kQBytes; };
  auto s_do = [&](int st) { return s_q(st) + C::kQBytes; };
  // lse and delta of each stage's rows
  const uint32_t s_ls = s_v + C::kKvBytes + 4 * C::kQBytes;
  const uint32_t s_dl = s_ls + 2 * TQ * 4;
  const float* ls_rows = reinterpret_cast<const float*>(
      base + 2 * C::kKvBytes + 4 * C::kQBytes);
  const float* dl_rows = ls_rows + 2 * TQ;

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // this warpgroup: columns wgi * kDw ..
  const int warp = tid % 128 / 32, lane = tid % 32;
  const int row0 = 16 * warp + lane / 4;  // this thread's keys: row0, row0 + 8
  const int cb = 2 * (lane % 4);          // and q rows cb, cb + 1 of each 8
  const int k0 = blockIdx.x * kRows;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int hkv = hq / group;
  const int len = kv_len[b];
  const int k_valid = min(len, sk);  // keys past this are masked
  const int64_t kv_off = (static_cast<int64_t>(b) * hkv + hk) * sk * D;

  // the q rows with an unmasked key in this tile: qpos = len - sq + i sees
  // key kpos iff kpos <= qpos (causal) and kpos > qpos - window
  int i_lo = 0, i_hi = -1;
  if (k0 < k_valid) {
    const int k_last = min(k0 + kRows, k_valid) - 1;
    i_lo = causal ? max(0, k0 - (len - sq)) : 0;
    i_hi = window > 0 ? min(sq - 1, k_last + window - 1 - (len - sq))
                      : sq - 1;
  }
  const int t_lo = i_lo / TQ;
  const int ntq = i_hi < i_lo ? 0 : i_hi / TQ - t_lo + 1;
  const int nitems = group * ntq;  // (query head, q tile) pairs

  for (int i = tid; i < kRows * kC8; i += kThreads) {
    const int r = i / kC8, c8 = i % kC8;
    const bool in = k0 + r < sk;
    const int64_t g = kv_off + static_cast<int64_t>(in ? k0 + r : 0) * D +
                      c8 * 8;
    const uint32_t off = chunk_off<D>(r, c8, kRows);
    cp_async16(s_k + off, k + g, in);
    cp_async16(s_v + off, v + g, in);
  }
  cp_async_commit();

  auto load_q = [&](int item, int st) {
    const int h = hk * group + item / ntq;
    const int qq0 = (t_lo + item % ntq) * TQ;
    const int64_t row_off = (static_cast<int64_t>(b) * hq + h) * sq;
    for (int i = tid; i < TQ * kC8; i += kThreads) {
      const int r = i / kC8, c8 = i % kC8;
      const bool in = qq0 + r < sq;
      const int64_t g = (row_off + (in ? qq0 + r : 0)) * D + c8 * 8;
      const uint32_t off = chunk_off<D>(r, c8, TQ);
      cp_async16(s_q(st) + off, qs + g, in);
      cp_async16(s_do(st) + off, dout + g, in);
    }
    // rows past Sq: lse 0 and delta 0 (their qs and dO are 0, and masked)
    if (tid < 2 * TQ) {
      const int r = tid % TQ;
      const bool in = qq0 + r < sq;
      const int64_t g = row_off + (in ? qq0 + r : 0);
      if (tid < TQ)
        cp_async4(s_ls + (st * TQ + r) * 4, lse + g, in);
      else
        cp_async4(s_dl + (st * TQ + r) * 4, delta + g, in);
    }
    cp_async_commit();
  };

  float acc_k[C::kDw / 2], acc_v[C::kDw / 2];
#pragma unroll
  for (int i = 0; i < C::kDw / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  // this warpgroup's columns of the q and dO tiles (B of dK and dV)
  const uint32_t col_off = wgi * (C::kDw / 64) * TQ * wg::Cfg<D>::kPitch;

  if (nitems > 0) load_q(0, 0);
  for (int it = 0; it < nitems; ++it) {
    const int st = it & 1;
    const int qq0 = (t_lo + it % ntq) * TQ;
    const int q_lo = len - sq + qq0;  // absolute position of row 0
    if (it + 1 < nitems) {
      load_q(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();  // this thread's smem writes -> wgmma's proxy
    __syncthreads();

    // S^T = K qs^T and dP^T = V dO^T; s[4 j + 2 half + c] is key row0 +
    // 8 half, q row qq0 + 8 j + cb + c (dp alike)
    float s[TQ / 2], dp[TQ / 2];  // the first k16 step ignores them
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<TQ>(s, desc_k<D>(s_k, kRows, ks), desc_k<D>(s_q(st), TQ, ks),
                   ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss<TQ>(dp, desc_k<D>(s_v, kRows, ks), desc_k<D>(s_do(st), TQ, ks),
                   ks > 0);
    wgmma_commit();
    tf::wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < TQ / 2; ++i) fence_reg(s[i]);

    // P and dS, rounded to bf16: pf[x] and dsf[x] pack elements 2x, 2x + 1
    // (key half x & 1), the A fragments of P^T dO and dS^T qs
    const bool whole = k0 + kRows <= k_valid && qq0 + TQ <= sq &&
                       (!causal || k0 + kRows - 1 <= q_lo) &&
                       (window <= 0 || k0 > q_lo + TQ - 1 - window);
    const float* ls = ls_rows + st * TQ;
    const float* dl = dl_rows + st * TQ;
    uint32_t pf[TQ / 4], dsf[TQ / 4];
#pragma unroll
    for (int x = 0; x < TQ / 4; ++x) {
      const int half = x & 1;
      const int kpos = k0 + row0 + 8 * half;
      const int i0 = 8 * (x / 2) + cb;  // this pair's first q row
      const float2 l2 = *reinterpret_cast<const float2*>(ls + i0);
      float p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * x + c;
        float z = s[e], jac = 1.f;
        if (cap > 0.f) {
          const float th = tanh_ex2(z * inv_cap);
          z = cap * th;
          jac = fmaf(-th, th, 1.f);
        }
        p[c] = ex2(fmaf(z, kLog2e, -(c ? l2.y : l2.x) * kLog2e));
        if (!whole) {
          const int i = i0 + c, qpos = q_lo + i;
          const bool ok = kpos < k_valid && qq0 + i < sq &&
                          (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          p[c] = ok ? p[c] : 0.f;
        }
        s[e] = p[c] * jac;
      }
      pf[x] = pack2(p[0], p[1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk)
      wgmma_rs<C::kDw>(acc_v, pf + 4 * kk,
                       desc_mn<D>(s_do(st) + col_off, TQ, kk));
    wgmma_commit();
    tf::wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < TQ / 2; ++i) fence_reg(dp[i]);
#pragma unroll
    for (int x = 0; x < TQ / 4; ++x) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(dl + 8 * (x / 2) + cb);
      dsf[x] = pack2(s[2 * x] * (dp[2 * x] - d2.x),
                     s[2 * x + 1] * (dp[2 * x + 1] - d2.y));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk)
      wgmma_rs<C::kDw>(acc_k, dsf + 4 * kk,
                       desc_mn<D>(s_q(st) + col_off, TQ, kk));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < C::kDw / 2; ++i) fence_reg(acc_k[i]), fence_reg(acc_v[i]);
#pragma unroll
    for (int i = 0; i < TQ / 4; ++i) fence_reg(pf[i]), fence_reg(dsf[i]);
    __syncthreads();  // every warp is done with this stage
  }
  if (nitems == 0) cp_async_wait<0>();  // K and V, unread

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + row0 + 8 * half;
    if (key >= sk) continue;
    const int64_t g = kv_off + static_cast<int64_t>(key) * D +
                      wgi * C::kDw + cb;
#pragma unroll
    for (int j = 0; j < C::kDw / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + g + 8 * j) =
          __floats2bfloat162_rn(acc_k[4 * j + 2 * half],
                                acc_k[4 * j + 2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + g + 8 * j) =
          __floats2bfloat162_rn(acc_v[4 * j + 2 * half],
                                acc_v[4 * j + 2 * half + 1]);
    }
  }
}

template <int D, int WGS>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, const int* kv_len,
              float* delta, void* qs, void* dq, int b, int hq, int hkv,
              int sq, int sk, int causal, int window, float cap, float scale,
              cudaStream_t stream) {
  using C = DqCfg<D, WGS>;
  auto kernel = wgmma_bwd_dq_kernel<D, WGS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kRows - 1) / kRows, hq / WGS, b);
  using T = __nv_bfloat16;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o), lse,
      static_cast<const T*>(dout), kv_len, delta, static_cast<T*>(qs),
      static_cast<T*>(dq), hq, hq / hkv, sq, sk, causal, window, cap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const void* qs, const void* k, const void* v,
                const float* lse, const void* dout, const int* kv_len,
                const float* delta, void* dk, void* dv, int b, int hq,
                int hkv, int sq, int sk, int causal, int window, float cap,
                cudaStream_t stream) {
  using C = KvCfg<D>;
  auto kernel = wgmma_bwd_dkdv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kRows - 1) / kRows, hkv, b);
  using T = __nv_bfloat16;
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k),
      static_cast<const T*>(v), lse, static_cast<const T*>(dout), kv_len,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), hq, hq / hkv, sq, sk,
      causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

// pass 0: dq (and delta and qs), two heads a CTA at D = 256 when the GQA
// group is even; pass 1: dk, dv
template <int D>
int launch_pass(int pass, const void* q, const void* k, const void* v,
                const void* o, const float* lse, const void* dout,
                const int* kv_len, float* delta, void* qs, void* dq,
                void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
                int causal, int window, float cap, float scale,
                cudaStream_t stream) {
  if (pass == 1)
    return launch_dkdv<D>(qs, k, v, lse, dout, kv_len, delta, dk, dv, b, hq,
                          hkv, sq, sk, causal, window, cap, stream);
  if constexpr (D == 256) {
    if ((hq / hkv) % 2 == 0)
      return launch_dq<D, 2>(q, k, v, o, lse, dout, kv_len, delta, qs, dq, b,
                             hq, hkv, sq, sk, causal, window, cap, scale,
                             stream);
  }
  return launch_dq<D, 1>(q, k, v, o, lse, dout, kv_len, delta, qs, dq, b, hq,
                         hkv, sq, sk, causal, window, cap, scale, stream);
}

}  // namespace wgb

// Launch<D>::run calls the f32 or the bf16 launcher at head dim D
template <int D>
struct LaunchTf32 {
  static int run(const void* q, const void* k, const void* v,
                 const int* kv_len, void* out, float* lse, int b, int hq,
                 int hkv, int sq, int sk, int causal, int window, float cap,
                 float scale, int terms, cudaStream_t stream) {
    return tf::launch<D>(q, k, v, kv_len, out, lse, b, hq, hkv, sq, sk,
                         causal, window, cap, scale, terms, stream);
  }
};
template <int D>
struct LaunchWgmma {
  static int run(const void* q, const void* k, const void* v,
                 const int* kv_len, void* out, float* lse, int b, int hq,
                 int hkv, int sq, int sk, int causal, int window, float cap,
                 float scale, int /*terms*/, cudaStream_t stream) {
    return wg::launch<D>(q, k, v, kv_len, out, lse, b, hq, hkv, sq, sk,
                         causal, window, cap, scale, stream);
  }
};

template <template <int> class Launch>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const int* kv_len, void* out, float* lse, int b, int hq,
               int hkv, int sq, int sk, int causal, int window, float cap,
               float scale, int terms, cudaStream_t stream) {
  switch (d) {
#define REPRO_FLASH_D(DV)                                                  \
  case DV:                                                                 \
    return Launch<DV>::run(q, k, v, kv_len, out, lse, b, hq, hkv, sq, sk,  \
                           causal, window, cap, scale, terms, stream);
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

// The backward at head dim d, both dtypes on the tensor cores: bf16
// wgb::, f32 tfb:: (3xTF32, or one TF32 product with terms = 1); pass 0
// writes dq and delta, pass 1 dk and dv
int bwd_run(int pass, const void* q, const void* k, const void* v,
            const void* o, const float* lse, const void* dout,
            const int* kv_len, float* delta, void* qs, void* dq, void* dk,
            void* dv, int b, int hq, int hkv, int sq, int sk, int d,
            int causal, int window, float cap, float scale, int bf16,
            int terms, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (terms != 3 && (bf16 || terms != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
#define REPRO_FLASH_BWD_D(DV)                                               \
  case DV:                                                                  \
    return bf16 ? wgb::launch_pass<DV>(pass, q, k, v, o, lse, dout, kv_len, \
                                       delta, qs, dq, dk, dv, b, hq, hkv,   \
                                       sq, sk, causal, window, cap, scale,  \
                                       st)                                  \
                : tfb::launch_pass<DV>(pass, q, k, v, o, lse, dout,       \
                                       kv_len, delta, dq, dk, dv, b, hq,    \
                                       hkv, sq, sk, causal, window, cap,    \
                                       scale, terms, st);
    REPRO_FLASH_BWD_D(16)
    REPRO_FLASH_BWD_D(32)
    REPRO_FLASH_BWD_D(64)
    REPRO_FLASH_BWD_D(128)
    REPRO_FLASH_BWD_D(256)
#undef REPRO_FLASH_BWD_D
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (b, hq, sq, d); k, v: (b, hkv, sk, d); out: (b, hq, sq, d), all of one
// type (bf16 = 0: f32, bf16 = 1: bf16), contiguous and 16-byte aligned;
// kv_len: (b,) int32.  d is one of 16, 32, 64, 128, 256.  bf16 runs
// wgmma_kernel, f32 tf32x3_kernel with terms = 3 (3xTF32) or 1 (one TF32
// product: a control that must fail the f32 checks; bf16 takes 3 only).
// lse: null, or (b, hq, sq) f32 that receives each row's logsumexp
// m + log(l) (-1e30 for an all-masked row) for the backward; out is the
// same bit for bit either way.
// Returns the first CUDA error of the attribute call or the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* kv_len,
                                   void* out, float* lse, int b, int hq,
                                   int hkv, int sq, int sk, int d, int causal,
                                   int window, float cap, float scale,
                                   int bf16, int terms, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (terms != 3 && (bf16 || terms != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return dispatch_d<LaunchWgmma>(d, q, k, v, kv_len, out, lse, b, hq, hkv,
                                   sq, sk, causal, window, cap, scale, terms,
                                   st);
  return dispatch_d<LaunchTf32>(d, q, k, v, kv_len, out, lse, b, hq, hkv, sq,
                                sk, causal, window, cap, scale, terms, st);
}

// The backward's two passes, on K5's shapes and types (bf16 = 0: f32, 1:
// bf16): q, o, dout, dq (b, hq, sq, d); k, v, dk, dv (b, hkv, sk, d), all
// contiguous and 16-byte aligned; lse and delta (b, hq, sq) f32; kv_len
// (b,) int32; qs: bf16 only, (b, hq, sq, d) bf16 scratch (null for f32).
// bf16 runs wgmma_bwd_dq_kernel and wgmma_bwd_dkdv_kernel, f32
// tf32x3_bwd_dq_kernel and tf32x3_bwd_dkdv_kernel with terms = 3 (3xTF32)
// or 1 (one TF32 product: a control that must fail the f32 checks; bf16
// takes 3 only).  flash_attention_bwd_dq writes dq,
// delta (rowsum(dout o)) and, in bf16, qs (q * d^-0.5 rounded to bf16);
// flash_attention_bwd_dkdv reads delta (and qs) and writes dk and dv, so it
// runs after the first on the same stream.  The
// two take the same arguments.  Returns the first CUDA error of the
// attribute call or the launch.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, const int* kv_len, float* delta,
    void* qs, void* dq, void* dk, void* dv, int b, int hq, int hkv, int sq,
    int sk, int d, int causal, int window, float cap, float scale, int bf16,
    int terms, void* stream) {
  return bwd_run(0, q, k, v, o, lse, dout, kv_len, delta, qs, dq, dk, dv, b,
                 hq, hkv, sq, sk, d, causal, window, cap, scale, bf16, terms,
                 stream);
}

extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, const int* kv_len, float* delta,
    void* qs, void* dq, void* dk, void* dv, int b, int hq, int hkv, int sq,
    int sk, int d, int causal, int window, float cap, float scale, int bf16,
    int terms, void* stream) {
  return bwd_run(1, q, k, v, o, lse, dout, kv_len, delta, qs, dq, dk, dv, b,
                 hq, hkv, sq, sk, d, causal, window, cap, scale, bf16, terms,
                 stream);
}
