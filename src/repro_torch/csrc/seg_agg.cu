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
// then added (__fmul_rn/__fadd_rn, no FMA contraction), and the order of
// the adds depends on the layout alone, so the result is deterministic:
// two launches, and a CUDA graph's replays, agree bit for bit.
//
// What bounds it on the H100: bytes.  One add per gathered element, far
// below the card's ~20 FLOP/byte f32 balance.  Each input read once is the
// floor (0.11 ms at Reddit's F = 128), but the gathered rows are E * F * 4
// bytes (5.9 GB at F = 128): a source row is gathered ~50 times, so what
// the kernel can reach is set by where those gathers hit -- HBM (3.35 TB/s)
// or the 50 MB L2.  K1's backward runs over the transposed layout of a
// sampled block, whose rows are the sources: few edges (66,620 in 1145
// blocks of 128 rows at phase 11's block 0), most rows empty, and a hub
// source's row of ~7,000 slots in one block.  Its floor is writing the
// output (75 MB at F = 128); what held it far above was work on one unit:
// the hub row folded by one unit in ~875 batches, and in the sparse
// blocks every empty row after the last slots stored by one unit.
//
// What the design does about it (two kernels: row_starts, then fold;
// a packed launch, below, is the fold alone):
//   * row_starts, one CTA of 128 threads per block (16 an SM, so 1,145
//     blocks are one wave), reads only what it needs: the valid slots come
//     first, so it finds n_valid with a search over mask (128 probes a
//     round, each round cutting the interval below its stride: two rounds
//     at emax = 7,120, three at 2^20), then reads dstl over
//     [0, n_valid) only -- not the pad slots, which at the transposed
//     layout of 1145 x 7120 slots were 65 MB of reads.  It writes per block
//     where each row's slots start (no atomics) and the chunk table.
//   * Units share work, not rows.  A fold CTA of 256 threads is 32 fold
//     units of 8 lanes.  A block is W = n_valid + tile_m positions: each
//     row's store, then its slots.  Unit k starts at position k W / 32, so
//     every unit folds and stores about W / 32 -- a sparse block's empty
//     rows are spread over its units, and a hub row's slots too.
//   * A row of at most T slots is folded whole by the unit that reaches it,
//     one slot at a time in slot order from 0, and stored when it ends with
//     no barrier on its path: bit for bit the sum it had before the split
//     existed -- every forward row of the paper's graphs, and every row on
//     which graph/dedup.py's bitwise contract rests.  A longer row is cut
//     at each unit start inside it: each chunk is folded in slot order from
//     0 and its f32 sum goes to shared memory at its ordinal in the chunk
//     table; after one __syncthreads, which every thread reaches (the
//     branch to it is uniform over the CTA), the row is the left fold of
//     its chunks' sums in chunk order (__fadd_rn), stored once.  The hub
//     of phase 11's block 0 is ~31 chunks of ~226 slots, ~29 batches on
//     its CTA where one unit folded ~875.
//   * T = max(256, ceil(emax / 64)) (kernels/seg_agg.py split_threshold):
//     a function of emax alone, so the chunk table's scratch and the shared
//     memory are fixed by the shapes and a CUDA graph captured over one
//     layout replays over any other of its shape; the cuts themselves are
//     read from the layout in every launch.  At most emax / (T + 1) <= 64
//     rows are split and 31 unit starts cut them, so a block has at most
//     95 chunks, whose sums fit shared memory (95 x 64 columns x 4 B =
//     24 KB); 256 keeps the rows the paper's graphs give the forward whole.
//   * Column slices.  The fold's slow grid dimension is a slice of
//     slice_cols columns, so the CTAs in flight at any moment all gather
//     from one slice of x and a source row's slice is read from HBM about
//     once per slice, not once per edge.  K1's backward over an uncapped
//     transposed layout (a sampled block's) orders its CTAs block by
//     block instead (blocks_first): its layout gathers each row
//     about once (66,620 edges over 146,560 rows at phase 11's block 0),
//     so there is no reuse to keep, and every slice of the hub's block
//     then starts in the first wave, not after every other block's first
//     slice.  Its slices are as narrow as one load a lane a slot
//     (kernels/seg_agg.py backward_slice_cols: 32 columns at F = 128):
//     the hub's block is then folded on more SMs at once, each keeping
//     fewer bytes in flight, and the instance's registers (64, not 110)
//     let 4 CTAs share an SM, not 2, which the many sparse blocks need.
//     Each slice is one more pass over the indices and one more round of
//     per-slot instructions, so the forward's slice
//     is as wide as a fold unit holds: 64 columns, 59.6 MB of x at Reddit,
//     1.19 x the L2.  The power-law sources keep their hot rows resident
//     even so (measured on the H100 at Reddit: 64 columns beat 32 at
//     F = 128 and 602; chip_smoke.py's slice sweep).
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
//     A batch that crosses a row's end adds in runs, with one call site of
//     the row's store: inlined once a slot it cost ~6% at F = 41 and 602.
//     Outputs are streamed (st.cs) so they do not push the slice of x out
//     of L2.
//   * Packed launches: K1's backward over a capped transposed layout
//     (core/dataflow.py _capped; the distributed halos' backward).  Its
//     blocks are packed pieces of source rows: ~12.5 slots a row on
//     average at Reddit's shard sub-layouts, many of one slot, so nearly
//     every batch of a unit crosses a row's end.  A row map out_rows names
//     each block row's output row -- a short source's own row, written
//     once and in place (an empty source by a piece of no slots, stored as
//     zeros), a piece of a long (cut) source a scratch row after the rows,
//     an unused block row none (-1, not stored).  Such a launch differs
//     in three ways, fixed at compile time (PACKED):
//       - A fold unit is a whole warp (32 lanes, 8 units a CTA), so the
//         lanes of a warp meet the same row ends: with 8-lane units the
//         4 units of a warp branch apart at every row end, and the warp
//         runs each unit's path in turn.  A slice is all of F up to 128
//         columns (kernels/seg_agg.py packed_launch), one row a slot per
//         warp, so F = 128 and F = 41 are one slice each.
//       - The launch is one kernel: each CTA builds its block's chunk
//         table in shared memory (chunk_table, the code row_starts_kernel
//         runs) instead of a separate launch writing it to device memory.
//       - A row stored below split_from (the rows stored in place) is
//         never split, so it is bit for bit the in-order f32 fold of its
//         slots; the layout stores in place only rows of at most about a
//         unit's share of a block (packed_split), and cuts the longer
//         ones, whose scratch pieces are split across the units at that
//         threshold.  Whether a row is split is decided once, by the
//         table, and the fold reads it there (row m is split exactly when
//         parts[m + 1] > parts[m]).
//     The second launch, over the fold-back layout (only when a row was
//     cut), reads the scratch rows as its x and adds each cut row's
//     pieces in piece order into its row (its rows, all below split_from,
//     are one in-order fold each).  With no map, block row m of block b
//     is stored at b tile_m + m by 8-lane units after row_starts, as
//     before: the forward's sums and stores are unchanged.
//   * bf16 (the reference's bf16 rows, rounded once at its flush): x and
//     out are bf16, everything between is f32, chunk sums included.  A load
//     converts each element exactly (bf16 is the top half of an f32), the
//     fold is the f32 fold above, and the store of the whole row rounds
//     once (__float2bfloat16_rn).  VEC counts elements, so a 16-byte load
//     holds 8 bf16; a row of an odd-width bf16 matrix may be only 2-byte
//     aligned (F = 41: 82 bytes), and F = 602 rows are 1,204 bytes, 4-byte
//     aligned: 2-element loads.  The seg_agg_bf16_f32 entry is the same
//     fold with an f32 output, stored unrounded: a distributed layer's halo
//     partials over a bf16 wire slab (core/distributed.py), which the
//     reference accumulates in f32 so the wire keeps its 2 bytes.
//
// Limit: a block is one CTA per column slice, so within one layout a row
// is split across the units of one SM and no further.  Across CTAs a
// row is split by its layout: a capped transposed layout cuts a row over
// its cap into pieces, each a block row of its own stored to a scratch
// row, and the fold-back launch adds them (the distributed backward's hub
// rows).  The uncapped transposed layouts (the local plans' and the
// minibatch trainer's) do not: a row far longer than a block's share of
// the grid -- such as full-graph Reddit's top source, ~1.2 M edges under
// the generator's alpha = 1.05 -- still runs on one CTA, ~W / 32 slots a
// unit, while the rest of the grid idles.  No row is written twice and no
// atomics are used anywhere.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;      // a fold CTA
constexpr int kRowThreads = 128;   // a row_starts CTA: 16 an SM, so a
                                   // layout of up to 2,112 blocks is one wave
constexpr int kUnroll = 4;  // slots a row_starts thread loads at once
constexpr int kLanes = 8;   // lanes of a fold unit: 4 units share a warp
constexpr int kUnits = kThreads / kLanes;  // fold units of a CTA
constexpr int kPackedLanes = 32;  // a packed launch's fold unit: a warp
constexpr int kBatch = 8;   // slots a fold unit gathers at once

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
  if constexpr (VEC == 8) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(s[0], s[1], s[2], s[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(s[4], s[5], s[6], s[7]));
  } else if constexpr (VEC == 4)
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

// Work positions: a block of tile_m rows and n_valid valid slots is
// W = n_valid + tile_m positions, row m's store at s_start[m] + m and its
// slots at the positions after it, so a unit's share counts the rows it
// stores (an empty row is a store too) beside the slots it folds.  Unit k
// of `units` starts at position t_k = k W / units (rounded down).
// cuts_before(x, w, units): #{k in 1..units-1 : t_k <= x}.
__device__ __forceinline__ int cuts_before(int x, int w, int units) {
  const int64_t c = (static_cast<int64_t>(units) * (x + 1) - 1) / w;
  return static_cast<int>(min(c, static_cast<int64_t>(units - 1)));
}

// The chunk table of a block, (starts, parts), 2 (tile_m + 1) ints, built
// in shared memory s_tab by the NT threads of a CTA: starts[m] = first slot
// of the block (slot0 .. slot0 + emax - 1) holding a row >= m (n_valid,
// the first pad slot, if none), for m <= tile_m, so rows [a, c) own slots
// [starts[a], starts[c]); parts[m] = chunks of the split rows before m,
// parts[tile_m] = all of them.  A row is split when it has more than
// `split` slots and, under a row map (map: the block's, in shared memory),
// is stored at or after row split_from (a scratch row; a row stored below
// it is folded whole).  A split row is cut at the starts of the `units`
// fold units inside it, so it has one chunk more than it has cuts: row m
// is split exactly when parts[m + 1] > parts[m].  It reads NT mask probes
// a round and dstl on the valid slots; every thread returns after a
// barrier.
template <int NT>
__device__ __forceinline__ void chunk_table(
    int* s_tab, const int* __restrict__ dstl, const float* __restrict__ mask,
    const int* map, int64_t slot0, int emax, int tile_m, int split,
    int split_from, int units) {
  int* s_start = s_tab;
  int* s_part = s_tab + tile_m + 1;
  const int tid = threadIdx.x;
  for (int m = tid; m < tile_m; m += NT) s_start[m] = INT_MAX;
  __syncthreads();
  // n_valid in [lo, hi]: probe NT slots at a stride; the valid ones are a
  // prefix of the probes (valid slots come first), so their count k puts
  // n_valid after probe k - 1 and at or before probe k.  The counting
  // barrier is uniform, and every thread narrows [lo, hi] alike.
  int lo = 0, hi = emax;
  while (lo < hi) {
    const int step = (hi - lo + NT - 1) / NT;
    const int p = lo + tid * step;
    const int k = __syncthreads_count(p < hi && __ldg(mask + slot0 + p) != 0.f);
    const int nlo = k > 0 ? lo + (k - 1) * step + 1 : lo;
    hi = min(hi, lo + k * step);
    lo = nlo;
  }
  const int nvalid = lo;
  // slot e < n_valid starts its row if its predecessor has another row
  for (int base = tid; base < nvalid; base += NT * kUnroll) {
    int r[kUnroll], rp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * NT;
      r[u] = e < nvalid ? __ldcs(dstl + slot0 + e) : -1;
      rp[u] = e < nvalid && e > 0 ? __ldg(dstl + slot0 + e - 1) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * NT;
      if (e < nvalid && (e == 0 || rp[u] != r[u])) s_start[r[u]] = e;
    }
  }
  __syncthreads();
  if (tid < 32) {
    // suffix minimum over rows: an empty row starts where the next row does
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
    __syncwarp();
    // the split rows' chunks, prefix-summed in row order: row m's slots are
    // positions s + m + 1 .. t + m, and a unit start strictly inside them
    // cuts the row
    const int w = nvalid + tile_m;
    int total = 0;
    for (int base = 0; base < tile_m; base += 32) {
      const int m = base + tid;
      int c = 0;
      if (m < tile_m) {
        const int s = s_start[m], t = s_start[m + 1];
        if (t - s > split && (map == nullptr || map[m] >= split_from))
          c = 1 + cuts_before(t + m, w, units) -
              cuts_before(s + m + 1, w, units);
      }
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      if (m < tile_m) s_part[m] = total + incl - c;
      total += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (tid == 0) s_part[tile_m] = total;
  }
  __syncthreads();
}

// The chunk tables of a launch with no row map, tables[b] for block b:
// one CTA of kRowThreads per block, read by the fold kernel's CTAs (every
// column slice of the block).
__global__ void __launch_bounds__(kRowThreads)
row_starts_kernel(const int* __restrict__ dstl,
                  const float* __restrict__ mask, int* __restrict__ tables,
                  int emax, int tile_m, int split) {
  extern __shared__ int s_tab[];  // starts, then parts: 2 (tile_m + 1)
  chunk_table<kRowThreads>(s_tab, dstl, mask, nullptr,
                           static_cast<int64_t>(blockIdx.x) * emax, emax,
                           tile_m, split, 0, kUnits);
  int* out = tables + static_cast<int64_t>(blockIdx.x) * 2 * (tile_m + 1);
  for (int m = threadIdx.x; m < 2 * (tile_m + 1); m += kRowThreads)
    out[m] = s_tab[m];
}

// One CTA per (destination block, column slice).  A unit is L lanes (kLanes,
// or a warp in a PACKED launch); lane li owns columns
// c0 + (cc * L + li) * VEC .. + VEC - 1 of the slice for cc < C.  T is the
// element type of x (float or bf16), TO that of out (T, or float for bf16
// x: the halo's f32 partials over a bf16 wire slab); the fold is f32
// either way.  Block row m is stored to out row b tile_m + m, or in a
// PACKED launch to out_rows[b tile_m + m] (-1: not stored), and the CTA
// builds its block's chunk table itself (chunk_table; else row_starts_kernel
// wrote it to `tables`).  Shared memory: the chunk table, the row map
// (tile_m ints, PACKED), then max_chunks x slice_cols f32 chunk sums (the
// launch sizes it from emax and split).
template <typename T, typename TO, int VEC, int C, bool PACKED>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const T* __restrict__ x, int f, const int* __restrict__ src,
            const int* __restrict__ dstl, const float* __restrict__ mask,
            const float* __restrict__ weight,
            const int* __restrict__ tables, TO* __restrict__ out,
            const int* __restrict__ out_rows, int emax, int tile_m,
            int slice_cols, int blocks_first, int split, int split_from) {
  constexpr int L = PACKED ? kPackedLanes : kLanes;
  constexpr int kU = kThreads / L;      // fold units of the CTA
  static_assert(C * VEC <= 8, "a lane holds at most 8 values of a slot");
  extern __shared__ int s_tab[];
  int* s_start = s_tab;                 // tile_m + 1
  int* s_part = s_tab + tile_m + 1;     // tile_m + 1
  int* s_map = s_tab + 2 * (tile_m + 1);  // tile_m, PACKED
  float* s_sum = reinterpret_cast<float*>(s_map + (PACKED ? tile_m : 0));
  const int tid = threadIdx.x;
  // the grid's fast dimension: blocks (slice-major) or slices
  const int b = blocks_first ? blockIdx.y : blockIdx.x;
  const int slice = blocks_first ? blockIdx.x : blockIdx.y;
  const int64_t slot0 = static_cast<int64_t>(b) * emax;
  if constexpr (PACKED) {
    for (int m = tid; m < tile_m; m += kThreads)
      s_map[m] = __ldg(out_rows + static_cast<int64_t>(b) * tile_m + m);
    chunk_table<kThreads>(s_tab, dstl, mask, s_map, slot0, emax, tile_m,
                          split, split_from, kU);
  } else {
    const int* blk = tables + static_cast<int64_t>(b) * 2 * (tile_m + 1);
    for (int m = tid; m < 2 * (tile_m + 1); m += kThreads)
      s_tab[m] = __ldg(blk + m);
    __syncthreads();
  }

  const int unit = tid / L, li = tid % L;
  const int nvalid = s_start[tile_m];
  const int w = nvalid + tile_m;
  // Where unit k starts: its first slot, that slot's row and, when it
  // starts inside a split row, its chunk of the row.  Position t_k lies in
  // row lo - 1, lo the first row whose store position is at or after it:
  // a split row is cut at the slot there, any other row is left whole to
  // the unit that reached it first.
  auto first_slot = [&](int k, int& r, int& part) {
    part = 0;
    if (k == 0) { r = 0; return 0; }
    if (k == kU) { r = tile_m; return nvalid; }
    const int target = static_cast<int>(static_cast<int64_t>(k) * w / kU);
    int lo = 0, hi = tile_m;  // s_start[tile_m] + tile_m = w >= target
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (s_start[mid] + mid >= target) hi = mid;
      else lo = mid + 1;
    }
    r = lo;
    if (lo > 0) {
      const int m = lo - 1, s = s_start[m], t = s_start[lo];
      const int e = target - m - 1;  // the slot at position target
      if (s_part[lo] > s_part[m] && s <= e && e < t) {
        r = m;
        if (e > s) part = k - cuts_before(s + m + 1, w, kU);
        return e;
      }
    }
    return s_start[lo];
  };
  int row, r_hi, part, next_part;  // next_part: the next unit's, unused
  const int e_lo = first_slot(unit, row, part);
  const int e_hi = first_slot(unit + 1, r_hi, next_part);
  // Every lane of a warp runs the same number of batches (the most any of
  // its units needs), so the shuffles below are full-warp and need no
  // convergence check; a unit past its end just adds nothing.
  int batches = (e_hi - e_lo + kBatch - 1) / kBatch;
#pragma unroll
  for (int off = L; off < 32; off *= 2)
    batches = max(batches, __shfl_xor_sync(0xffffffffu, batches, off));

  const int c0 = slice * slice_cols;
  const int cols = min(slice_cols, f - c0);
  const T* xs = x + c0;
  TO* out_c = out + c0;
  // the out row of block row m: b tile_m + m, or its map entry (-1: none)
  auto out_row = [&](int m) -> int64_t {
    if constexpr (PACKED) return s_map[m];
    return static_cast<int64_t>(b) * tile_m + m;
  };
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

  // The current row ends at `next` (this unit's share of it may end
  // earlier, at e_hi); pslot is the ordinal in the chunk table of this
  // unit's chunk of it when the row is split, -1 when the row is whole.
  // Entering a row reads one entry of shared memory (two when it is split).
  int next = 0, pslot = -1;
  if (row < tile_m) {
    next = s_start[row + 1];
    if (s_part[row + 1] > s_part[row]) pslot = s_part[row] + part;
  }
  // The current row is complete (or empty): a whole row is stored, a
  // chunk's sum goes to shared memory; the next row becomes current.
  // (Past the last row, s_start[tile_m + 1] reads the chunk table's first
  // entry: harmless, as no row is left to use it.)
  auto finish = [&]() {
    if (pslot < 0) {
      const int64_t r = out_row(row);
      if (r >= 0) {
        TO* dst = out_c + r * f;
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const int col = (cc * L + li) * VEC;
          if (col < cols) store_vec<VEC>(dst + col, acc[cc]);
        }
      }
    } else {
      float* dst = s_sum + pslot * slice_cols;
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        const int col = (cc * L + li) * VEC;
        if (col < cols)
#pragma unroll
          for (int q = 0; q < VEC; ++q) dst[col + q] = acc[cc][q];
      }
    }
#pragma unroll
    for (int cc = 0; cc < C; ++cc)
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[cc][q] = 0.f;
    ++row;
    next = s_start[row + 1];
    pslot = row < tile_m && s_part[row + 1] > s_part[row] ? s_part[row] : -1;
  };

  int p_src = 0;  // always a valid row of x: a loaded src
  float p_coef = 0.f;
  // lane li: slot e + li of the next batch, clamped into the unit's slots
  // (or to slot 0 of the block), so the load is unconditional and the
  // gathers need not wait on it; a lane past the unit's end feeds only
  // slots the fold never adds
  const int last = max(e_hi - 1, 0);
  auto fetch = [&](int e) {
    const int64_t s = slot0 + min(e + (li & (kBatch - 1)), last);
    p_src = __ldg(src + s);
    const float m = __ldg(mask + s);
    p_coef = weight != nullptr ? m * __ldg(weight + s) : m;
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
      // the batch crosses the end of a row: its slots go in runs inside one
      // row, each row finished when the next slot is past it (one call site
      // of finish keeps the loop's code small)
      int u0 = 0;
      while (u0 < n) {
        if (e + u0 >= next) {
          finish();
          continue;
        }
        const int u1 = min(n, next - e);
        // no contraction into an FMA: each term is rounded as the plain
        // version rounds it (coef * x, then the add)
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u >= u0 && u < u1) {
#pragma unroll
            for (int cc = 0; cc < C; ++cc)
#pragma unroll
              for (int q = 0; q < VEC; ++q)
                acc[cc][q] =
                    __fadd_rn(acc[cc][q], __fmul_rn(cf[u], v[u][cc][q]));
          }
        }
        u0 = u1;
      }
    }
  }
  // the last row, then the empty rows after it: this unit's rows are those
  // before r_hi and, when the next unit starts inside row r_hi, its share
  // of that row
  while (row < r_hi ||
         (row == r_hi && row < tile_m && max(e_lo, s_start[row]) < e_hi))
    finish();

  // the split rows: each the left fold of its chunks' sums in chunk order,
  // stored once.  The branch is uniform over the CTA, so every thread
  // reaches the barrier.
  if (s_part[tile_m] > 0) {
    __syncthreads();
    for (int i = tid; i < tile_m * cols; i += kThreads) {
      const int m = i / cols, col = i - m * cols;
      const int p0 = s_part[m], p1 = s_part[m + 1];
      if (p0 == p1) continue;
      const int64_t r = out_row(m);
      if (r < 0) continue;
      const float* p = s_sum + p0 * slice_cols + col;
      float sum = p[0];
      for (int j = 1; j < p1 - p0; ++j)
        sum = __fadd_rn(sum, p[j * slice_cols]);
      store_vec<1>(out_c + r * f + col, &sum);
    }
  }
}

// A launch with no row map: row_starts_kernel writes the chunk tables,
// then the fold (kLanes-lane units); with one (PACKED): the fold alone,
// warp-wide units, each CTA building its block's table.
template <typename T, typename TO, int VEC, int C, bool PACKED>
int launch(const T* x, const int* src, const int* dstl, const float* mask,
           const float* weight, int* tables, TO* out, const int* out_rows,
           int nblocks, int emax, int f, int tile_m, int slice_cols,
           int split, int max_chunks, int blocks_first, int split_from,
           cudaStream_t stream) {
  const int tab = 2 * (tile_m + 1) * static_cast<int>(sizeof(int));
  cudaError_t err;
  if constexpr (!PACKED) {
    row_starts_kernel<<<nblocks, kRowThreads, tab, stream>>>(
        dstl, mask, tables, emax, tile_m, split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = fold_kernel<T, TO, VEC, C, PACKED>;
  const int map_bytes = PACKED ? tile_m * static_cast<int>(sizeof(int)) : 0;
  const int smem = tab + map_bytes +
                   max_chunks * slice_cols * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slices = (f + slice_cols - 1) / slice_cols;
  const dim3 grid = blocks_first ? dim3(slices, nblocks)
                                 : dim3(nblocks, slices);
  kernel<<<grid, kThreads, smem, stream>>>(
      x, f, src, dstl, mask, weight, tables, out, out_rows, emax, tile_m,
      slice_cols, blocks_first, split, split_from);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (V, f) f32; src, dstl: (nblocks, emax) int32; mask: (nblocks, emax) f32;
// weight: (nblocks, emax) f32 or null; tables: (nblocks, 2 (tile_m + 1))
// int32 scratch (unused with a row map); out: (nblocks * tile_m, f) f32.
// With a row map out_rows ((nblocks, tile_m) int32, or null) the launch is
// PACKED: block row m of block b is stored to out row
// out_rows[b tile_m + m], or nowhere at -1, and x and the rows stored must
// not overlap.  Columns go in slices of slice_cols (a multiple of vec; the
// last may be narrower), each lane vec floats wide, c loads per slot: vec
// in {1, 2, 4} with f % vec == 0 and x vec * 4-byte aligned; with no map
// a unit is 8 lanes, 8 * vec * c >= slice_cols and vec * c <= 8; PACKED a
// unit is a warp, 32 * vec * c >= slice_cols and (vec, c) one of (4, 1),
// (2, 1), (2, 2), (1, 1) .. (1, 4).  Rows of more than `split` slots are
// cut at the fold units' starts inside them -- PACKED only those stored at
// or after row split_from; max_chunks >= the chunks a block can hold
// (emax / (split + 1) + units - 1) sizes the shared memory
// (kernels/seg_agg.py max_chunks).  blocks_first orders the fold's CTAs
// block by block (all slices of a block together; nblocks <= 65535), else
// slice by slice.  Returns the first CUDA error of the launches
// (cudaErrorInvalidValue for another (vec, c)).
#define REPRO_SEG_AGG_CASE(T, TO, XP, OP, V, CC, P)                          \
  if (vec == V && c == CC)                                                   \
    return launch<T, TO, V, CC, P>(XP, src, dstl, mask, weight, tables, OP,  \
                                   out_rows, nblocks, emax, f, tile_m,       \
                                   slice_cols, split, max_chunks,            \
                                   blocks_first, split_from,                 \
                                   static_cast<cudaStream_t>(stream));
// the PACKED instances of an entry
#define REPRO_SEG_AGG_PACKED(T, TO, XP, OP)                                   \
  if (out_rows != nullptr) {                                                 \
    REPRO_SEG_AGG_CASE(T, TO, XP, OP, 4, 1, true)                            \
    REPRO_SEG_AGG_CASE(T, TO, XP, OP, 2, 1, true)                            \
    REPRO_SEG_AGG_CASE(T, TO, XP, OP, 2, 2, true)                            \
    REPRO_SEG_AGG_CASE(T, TO, XP, OP, 1, 1, true)                            \
    REPRO_SEG_AGG_CASE(T, TO, XP, OP, 1, 2, true)                            \
    REPRO_SEG_AGG_CASE(T, TO, XP, OP, 1, 3, true)                            \
    REPRO_SEG_AGG_CASE(T, TO, XP, OP, 1, 4, true)                            \
    return static_cast<int>(cudaErrorInvalidValue);                         \
  }

extern "C" int seg_agg_f32(const float* x, const int* src, const int* dstl,
                           const float* mask, const float* weight,
                           int* tables, float* out, const int* out_rows,
                           int nblocks, int emax, int f, int tile_m,
                           int slice_cols, int vec, int c, int split,
                           int max_chunks, int blocks_first, int split_from,
                           void* stream) {
  REPRO_SEG_AGG_PACKED(float, float, x, out)
#define REPRO_SEG_AGG(V, CC) \
  REPRO_SEG_AGG_CASE(float, float, x, out, V, CC, false)
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

// The same with x and out bf16 (f32 fold and chunk sums, one rounding at
// the store): vec bf16 elements a load, vec in {1, 2, 4, 8} with
// f % vec == 0 and x vec * 2-byte aligned; with no map 8 * vec * c >=
// slice_cols and vec * c <= 8; PACKED as seg_agg_f32's.
#define REPRO_SEG_AGG_BF16(TO, OP)                    \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 8, 1, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 4, 1, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 4, 2, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 2, 1, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 2, 2, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 2, 3, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 2, 4, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 1, 1, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 1, 2, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 1, 3, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 1, 4, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 1, 5, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 1, 6, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 1, 7, false)   \
  REPRO_SEG_AGG_CASE(bf16, TO, xb, OP, 1, 8, false)

extern "C" int seg_agg_bf16(const void* x, const int* src, const int* dstl,
                            const float* mask, const float* weight,
                            int* tables, void* out, const int* out_rows,
                            int nblocks, int emax, int f, int tile_m,
                            int slice_cols, int vec, int c, int split,
                            int max_chunks, int blocks_first, int split_from,
                            void* stream) {
  auto* xb = static_cast<const bf16*>(x);
  auto* ob = static_cast<bf16*>(out);
  REPRO_SEG_AGG_PACKED(bf16, bf16, xb, ob)
  REPRO_SEG_AGG_BF16(bf16, ob)
  return static_cast<int>(cudaErrorInvalidValue);
}

// x bf16, out f32: the bf16 entry's fold (bf16 loads converted exactly, f32
// sums) stored without the rounding -- the f32 partial sums of a halo hop
// over a bf16 wire slab (core/distributed.py), as the reference's
// promote_types(bf16, f32) accumulator, and the f32 rows of K1's backward
// over a capped layout of bf16 gradients.  Arguments as seg_agg_bf16's;
// out is f32.
extern "C" int seg_agg_bf16_f32(const void* x, const int* src,
                                const int* dstl, const float* mask,
                                const float* weight, int* tables, float* out,
                                const int* out_rows, int nblocks, int emax,
                                int f, int tile_m, int slice_cols, int vec,
                                int c, int split, int max_chunks,
                                int blocks_first, int split_from,
                                void* stream) {
  auto* xb = static_cast<const bf16*>(x);
  REPRO_SEG_AGG_PACKED(bf16, float, xb, out)
  REPRO_SEG_AGG_BF16(float, out)
  return static_cast<int>(cudaErrorInvalidValue);
}
