// Per-leaf gradient / hessian / count histogram for Hopper (sm_90a):
// kernel B1 of the leaf-wise builder.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py::pallas_histogram
// (_hist_kernel, pallas_call at :205, and the sub-binned
// _subbin_rows_kernel, pallas_call at :188), and the f64 einsum of
// lightgbm_tpu/ops/histogram.py:39-49 for tpu_use_f64_hist:
//
//   hist[f, b, :] = sum over the leaf's rows r with bins[r, f] == b
//                   of (g_r, h_r, 1)
//
// The TPU has no fast scatter, so the Pallas kernel turns the scatter
// into one-hot MXU contractions with a bf16 hi/lo payload split. Hopper
// scatters into shared memory with atomics, but only 32-bit integer ones
// are native: an f32 or f64 shared atomicAdd is a compare-and-swap loop
// (ATOMS.CAST.SPIN) on sm_90a. So the f32 path takes the fixed-point
// design of aligned.cu's slot histogram (fixed_point.cuh), fit to the
// leaf-wise builder, which histograms many small gathered leaves a tree:
//   - Tiles. The leaf's rows are cut into equal tiles of at most 16,384
//     rows (ops/histogram.py::launch_shape). A scale pass reads a tile's
//     gh rows (through indices for a gathered leaf) and takes an integer
//     max over the bits of |g| and |h|; the sum pass splits each value
//     into hi/lo int32 words at that scale and adds them, and the count,
//     to 20-byte shared cells with native ATOMS.ADD. The tile's error is
//     at most 1.9e-6 of its largest |v|, so a leaf's at most 1.9e-6 of
//     its sum of |v|.
//   - Non-finite tiles. A tile whose largest |g| or |h| is NaN or Inf adds
//     that stat straight to the f64 sums, so NaN and Inf reach each cell
//     as they reach the plain twin's.
//   - One launch a call. At a tile's end each cell is decoded and added to
//     the call's f64 sums in device memory (native RED.E.ADD.F64) and its
//     count to a u32 count. Each CTA then takes its feature tile's ticket;
//     the tile's last CTA rounds the tile's f64 sums to the f32 output
//     once and zeroes its sums, counts and ticket, so the scratch is zero
//     again for the next call on the stream. No fold kernel, no partial
//     slabs, no memset.
//   - CTAs. One CTA of 1024 threads an SM (the occupancy calculator's
//     count, ops/histogram.py), one row a thread. An SM adds about 1.8
//     (row, feature) sites a clock into its cells, so a small leaf on one
//     or two CTAs would wait on two SMs' atomics: a leaf is spread over
//     about sqrt(7.2 x rows / bins) CTAs, which balances the rows' adds
//     against each tile's flush of F x B cells (a 20,000-row child takes
//     48 CTAs at 63 bins; the 10.5M root all SMs, 5 tiles each), never
//     more CTAs than tiles.
//   - Feature tiles (blockIdx.y): the fewest equal tiles whose cells fit
//     the shared-memory opt-in (HIGGS 28 x 255 bins: one; MSLR 137 x 255:
//     four).
//   - Row reads. A row's bins are read as aligned 32-bit words, four
//     features a load: whole words where every tile's row slice starts
//     on a 4-byte boundary (F % 4 == 0), else the words that hold its
//     bytes. Warps start on different features (rotated by the warp's
//     index) so that they add to different cells.
//
// The f64 path (tpu_use_f64_hist) must stay equal to its plain twin, which
// fixed point cannot promise, so it keeps f64 shared sums (CAS loops); f64
// sums of f32 payloads are exact at realistic leaf sizes, so their order
// does not matter, and it shares the launch structure above: tiles taken
// in turn without a per-tile flush, one flush a CTA into the f64 sums, the
// last CTA's f64 output.
//
// The integer path (tpu_quant_hist=on; the Pallas kernel's integer
// payload, pallas_hist.py:167-171) takes gh as the int8 or int16 [N, 2]
// of ops/histogram.py::quantize_gh: a quarter or half of the f32 bytes a
// row. Its sums are exact: hist_int_kernel<Q> adds q_g, q_h and the count
// to three 32-bit shared cells with native ATOMS.ADD (three adds a site
// against the f32 path's five, and no scale pass); a CTA flushes its
// cells into int64 sums in device memory (the scratch's f64 words, read
// as int64: zero is zero in both) before they could pass 2^31 (at most
// 2^31 / qmax rows: 16,384 rows of |q| <= 32,767 fit), and the last CTA
// of a feature tile rounds each exact sum to f32 once, as the plain twin
// rounds its int64 sums. So the kernel equals the twin bit for bit. It
// keeps the launch structure above: one launch a call, tickets, no
// memset.
//
// The uint16 route (a matrix whose largest feature has more than 256
// bins, the JAX package's dtype rule): the bin type is a template
// parameter of each kernel, chosen at the launch (lgbt_hist16_*). A row's
// bins are read as 32-bit words, two features a load (`add_row16`): whole
// words where every tile's row slice starts on a 4-byte boundary (F and
// the feature tile even), else the words that hold its halves. Cells are
// 20 (12) bytes as above, so a tile holds fewer features: 511 bins take
// ~10 KB a feature, 1,023 ~20 KB. Where one feature's cells exceed the
// shared-memory opt-in (beyond ~11,600 bins of 20-byte cells) the bin
// axis is tiled too: blockIdx.z takes the bins [b0, b0 + bin_tile) of a
// one-feature tile, whose cells are contiguous in the output, and each
// (feature tile, bin tile) pair has its own ticket. The uint8
// instantiations keep the word reads above and one bin tile.
//
// The gather of the leaf's rows is fused: the kernels read the leaf's
// slice of the partition, indices[begin, begin + count), and the rows of
// bins [N, F] (uint8 or uint16) and gh [N, 2] (f32) it names, or the contiguous rows
// [begin, begin + count) when indices is null (the identity root
// partition). No gathered [P, F] copy is written.
//
// What bounds it on an H100: by the data sheet, bytes. One call must read
// count * (F + 8) bytes of bins rows and gh, plus 4 * count bytes of
// indices for a gathered leaf, and write F * B * 3 outputs; the 3 * F *
// count adds are two orders of magnitude below the card's f32 rate (a
// gathered 28-byte row touches 1.75 32-byte sectors on average, its gh
// one more). What bounds it in fact is each SM's shared-memory atomics,
// five a (row, feature) site: about 1.8 sites a clock, so the 10.5M x 28
// root takes ~0.69 ms against 0.11 ms of bytes (PERF.md, slice 9).
#include <cstdint>
#include <cuda_runtime.h>

#include "fixed_point.cuh"

namespace {

constexpr int kStats = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;   // one CTA an SM

// The leaf's p-th row: indices[begin + p] of a gathered leaf, begin + p of
// the contiguous root
__device__ __forceinline__ long long leaf_row(const int32_t* indices,
                                              long long begin, long long p) {
  return indices != nullptr
      ? static_cast<long long>(__ldg(indices + begin + p)) : begin + p;
}

// One row's bins of the CTA's feature tile (brow, nf features) into the
// cells: add(f * num_bins + bin) for each feature f whose bin lies below
// num_bins, from the warp's feature (rot_w's word or rot_f) on, wrapping;
// the bins are read as 32-bit words, four features a load. words: brow
// is 4-byte aligned and nf % 4 == 0, and the next word is loaded while
// the current one's bins are added.
template <typename Add>
__device__ __forceinline__ void add_row(const uint8_t* brow, int nf,
                                        bool words, int rot_w, int rot_f,
                                        int num_bins, const Add& add) {
  if (words) {
    const unsigned* wrow = reinterpret_cast<const unsigned*>(brow);
    const int nw = nf >> 2;
    int w = rot_w;
    unsigned word = __ldg(wrow + w);
    for (int k = 0; k < nw; ++k) {
      const int nxt = w + 1 == nw ? 0 : w + 1;
      const unsigned next = k + 1 < nw ? __ldg(wrow + nxt) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = (word >> (8 * j)) & 255;
        if (b < num_bins) add((4 * w + j) * num_bins + b);
      }
      w = nxt;
      word = next;
    }
    return;
  }
  // any other row: the aligned words that hold its bytes (a word that
  // holds one of the row's bytes lies inside bins' allocation)
  const int o = static_cast<int>(reinterpret_cast<uintptr_t>(brow) & 3u);
  const unsigned* wrow = reinterpret_cast<const unsigned*>(brow - o);
  int f = rot_f;
  int w = (o + f) >> 2;
  unsigned word = __ldg(wrow + w);
  for (int k = 0; k < nf; ++k) {
    const int pos = o + f;
    if (pos >> 2 != w) {
      w = pos >> 2;
      word = __ldg(wrow + w);
    }
    const int b = (word >> (8 * (pos & 3))) & 255;
    if (b < num_bins) add(f * num_bins + b);
    f = f + 1 == nf ? 0 : f + 1;
  }
}

// One row's uint16 bins of the CTA's tile (brow, nf features) into the
// cells: add(f * nbt + bin - b0) for each feature f whose bin lies in the
// CTA's bin tile [b0, b0 + nbt), from the warp's feature on, wrapping;
// read as 32-bit words, two features a load. words: brow is 4-byte
// aligned and nf is even; else brow is 2-byte aligned and each bin is
// taken from the aligned word that holds it.
template <typename Add>
__device__ __forceinline__ void add_row16(const uint16_t* brow, int nf,
                                          bool words, int rot_w, int rot_f,
                                          int b0, int nbt, const Add& add) {
  if (words) {
    const unsigned* wrow = reinterpret_cast<const unsigned*>(brow);
    const int nw = nf >> 1;
    int w = rot_w;
    unsigned word = __ldg(wrow + w);
    for (int k = 0; k < nw; ++k) {
      const int nxt = w + 1 == nw ? 0 : w + 1;
      const unsigned next = k + 1 < nw ? __ldg(wrow + nxt) : 0u;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int b = static_cast<int>((word >> (16 * j)) & 0xffffu) - b0;
        if (static_cast<unsigned>(b) < static_cast<unsigned>(nbt)) {
          add((2 * w + j) * nbt + b);
        }
      }
      w = nxt;
      word = next;
    }
    return;
  }
  const int o = static_cast<int>((reinterpret_cast<uintptr_t>(brow) & 3u)
                                 >> 1);
  const unsigned* wrow = reinterpret_cast<const unsigned*>(brow - o);
  int f = rot_f;
  int w = (o + f) >> 1;
  unsigned word = __ldg(wrow + w);
  for (int k = 0; k < nf; ++k) {
    const int pos = o + f;
    if (pos >> 1 != w) {
      w = pos >> 1;
      word = __ldg(wrow + w);
    }
    const int b = static_cast<int>((word >> (16 * (pos & 1))) & 0xffffu) - b0;
    if (static_cast<unsigned>(b) < static_cast<unsigned>(nbt)) {
      add(f * nbt + b);
    }
    f = f + 1 == nf ? 0 : f + 1;
  }
}

// A row's bins by their type: uint8 rows take add_row (one bin tile, the
// cell f * num_bins + bin), uint16 rows add_row16
template <typename Add>
__device__ __forceinline__ void add_bins(const uint8_t* brow, int nf,
                                         bool words, int rot_w, int rot_f,
                                         int num_bins, int, int,
                                         const Add& add) {
  add_row(brow, nf, words, rot_w, rot_f, num_bins, add);
}
template <typename Add>
__device__ __forceinline__ void add_bins(const uint16_t* brow, int nf,
                                         bool words, int rot_w, int rot_f,
                                         int, int b0, int nbt,
                                         const Add& add) {
  add_row16(brow, nf, words, rot_w, rot_f, b0, nbt, add);
}

// A CTA's tile: features [f0, f0 + nf) (blockIdx.y) and bins [b0, b0 +
// nbt) (blockIdx.z; one tile of all bins but where the uint16 route tiles
// the bin axis of a one-feature tile), whose cells [base, base + cells)
// of the output are contiguous, and its ticket
struct Tile {
  int f0, nf, b0, nbt, cells, ticket, rot_w, rot_f;
  long long base;
  template <typename Bin>
  __device__ Tile(int num_features, int num_bins, int feat_per_block,
                  int bin_tile, int words, const Bin*) {
    constexpr int kPer = 4 / static_cast<int>(sizeof(Bin));
    f0 = blockIdx.y * feat_per_block;
    nf = min(feat_per_block, num_features - f0);
    b0 = blockIdx.z * bin_tile;
    nbt = min(bin_tile, num_bins - b0);
    cells = nf * nbt;
    base = static_cast<long long>(f0) * num_bins + b0;
    ticket = blockIdx.y * gridDim.z + blockIdx.z;
    const int warp = threadIdx.x >> 5;
    rot_w = words ? warp % (nf / kPer) : 0;
    rot_f = warp % nf;
  }
};

// The end of a call: the tile's last CTA writes its cells [base, base +
// cells) of out [F * B, 3] (`finalize`).
template <typename Out>
__device__ void finish(const Scratch& s, const Tile& t, Out* out) {
  if (last_to_arrive(s.tickets + t.ticket, gridDim.x)) {
    finalize(s.sums + 2 * t.base, s.cnt + t.base, s.tickets + t.ticket,
             t.cells, out + kStats * t.base);
  }
}

// The f32 path. blockIdx.y picks a tile of feat_per_block features; the
// CTAs of one feature tile take the leaf's tiles of tile_rows rows in turn.
template <typename Bin>
__global__ void __launch_bounds__(kThreads, 1)
hist_fixed_kernel(const Bin* __restrict__ bins, int num_features,
                  const float* __restrict__ gh,
                  const int32_t* __restrict__ indices, long long begin,
                  long long count, int num_bins, int bin_tile,
                  int feat_per_block, int tile_rows, int words, Scratch s,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t(num_features, num_bins, feat_per_block, bin_tile, words,
               bins);
  const int f0 = t.f0, nf = t.nf, cells = t.cells;
  const long long base = t.base;
  Cells sm;
  sm.w = reinterpret_cast<unsigned*>(smem_raw);
  sm.sums = s.sums + 2 * base;
  unsigned* run_max = sm.w + kCellWords * cells;
  for (int i = threadIdx.x; i < kCellWords * cells; i += blockDim.x) {
    sm.w[i] = 0u;
  }
  if (threadIdx.x < 2) run_max[threadIdx.x] = 0u;
  const float2* gh2 = reinterpret_cast<const float2*>(gh);
  const long long num_tiles = (count + tile_rows - 1) / tile_rows;
  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long r0 = tile * tile_rows;
    const int n = static_cast<int>(min(static_cast<long long>(tile_rows),
                                       count - r0));
    __syncthreads();                     // the last tile's flush is done
    // 1. the bits of the tile's largest |g| and |h|, which fix its scale
    //    (integer max: NaN and Inf rank above every finite one)
    unsigned mg = 0u, mh = 0u;
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const float2 v = __ldg(gh2 + leaf_row(indices, begin, r0 + q));
      mg = max(mg, __float_as_uint(v.x) & 0x7fffffffu);
      mh = max(mh, __float_as_uint(v.y) & 0x7fffffffu);
    }
    mg = __reduce_max_sync(kFull, mg);
    mh = __reduce_max_sync(kFull, mh);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(run_max, mg);
      atomicMax(run_max + 1, mh);
    }
    __syncthreads();
    const int nb = 32 - __clz(n - 1);    // rows <= 2^nb
    const Fixed fg(run_max[0], nb), fh(run_max[1], nb);
    sm.gx = fg.exact;
    sm.hx = fh.exact;
    // 2. the tile's rows into the cells, one row a thread
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const long long row = leaf_row(indices, begin, r0 + q);
      const float2 v = __ldg(gh2 + row);
      unsigned g_hi, g_lo, h_hi, h_lo;
      fg.split(v.x, g_hi, g_lo);
      fh.split(v.y, h_hi, h_lo);
      add_bins(bins + row * num_features + f0, nf, words != 0, t.rot_w,
               t.rot_f, num_bins, t.b0, t.nbt,
               [&](int c) { sm.add(c, g_hi, g_lo, h_hi, h_lo); });
    }
    __syncthreads();
    if (threadIdx.x < 2) run_max[threadIdx.x] = 0u;
    // 3. the tile into the f64 sums, one atomic a cell and stat
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      unsigned* p = sm.w + kCellWords * c;
      const unsigned k = p[kN];
      if (k == 0u) continue;
      if (!fg.exact) red_add(sm.sums + 2 * c, fg.value(p[kGHi], p[kGLo]));
      if (!fh.exact) {
        red_add(sm.sums + 2 * c + 1, fh.value(p[kHHi], p[kHLo]));
      }
      red_add(s.cnt + base + c, k);
#pragma unroll
      for (int u = 0; u < kCellWords; ++u) p[u] = 0u;
    }
  }
  finish(s, t, out);
}

// The f64 path: shared f64 sums [cells, 2] and u32 counts [cells] (20
// bytes a cell, as the f32 path's), one flush a CTA.
template <typename Bin>
__global__ void __launch_bounds__(kThreads, 1)
hist_f64_kernel(const Bin* __restrict__ bins, int num_features,
                const float* __restrict__ gh,
                const int32_t* __restrict__ indices, long long begin,
                long long count, int num_bins, int bin_tile,
                int feat_per_block, int tile_rows, int words, Scratch s,
                double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t(num_features, num_bins, feat_per_block, bin_tile, words,
               bins);
  const int f0 = t.f0, nf = t.nf, cells = t.cells;
  const long long base = t.base;
  double* sg = reinterpret_cast<double*>(smem_raw);
  unsigned* sn = reinterpret_cast<unsigned*>(sg + 2 * cells);
  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) sg[i] = 0.0;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sn[i] = 0u;
  __syncthreads();
  const float2* gh2 = reinterpret_cast<const float2*>(gh);
  const long long num_tiles = (count + tile_rows - 1) / tile_rows;
  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long r0 = tile * tile_rows;
    const int n = static_cast<int>(min(static_cast<long long>(tile_rows),
                                       count - r0));
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const long long row = leaf_row(indices, begin, r0 + q);
      const float2 v = __ldg(gh2 + row);
      const double g = v.x, h = v.y;
      add_bins(bins + row * num_features + f0, nf, words != 0, t.rot_w,
               t.rot_f, num_bins, t.b0, t.nbt, [&](int c) {
                 atomicAdd(sg + 2 * c, g);
                 atomicAdd(sg + 2 * c + 1, h);
                 atomicAdd(sn + c, 1u);
               });
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const unsigned k = sn[c];
    if (k == 0u) continue;
    red_add(s.sums + 2 * (base + c), sg[2 * c]);
    red_add(s.sums + 2 * (base + c) + 1, sg[2 * c + 1]);
    red_add(s.cnt + base + c, k);
  }
  finish(s, t, out);
}

// The integer path's end of a call: the feature tile's last CTA rounds
// its cells' int64 sums (the scratch's f64 words read as int64) and
// counts to out [F * B, 3] in f32 once and zeroes them and the ticket.
__device__ void finish_int(const Scratch& s, const Tile& t, float* out) {
  if (!last_to_arrive(s.tickets + t.ticket, gridDim.x)) return;
  __threadfence();
  long long* sums = reinterpret_cast<long long*>(s.sums) + 2 * t.base;
  unsigned* cnt = s.cnt + t.base;
  float* dst = out + kStats * t.base;
  for (int i = threadIdx.x; i < t.cells; i += blockDim.x) {
    dst[3 * i] = __ll2float_rn(__ldcg(sums + 2 * i));
    dst[3 * i + 1] = __ll2float_rn(__ldcg(sums + 2 * i + 1));
    dst[3 * i + 2] = static_cast<float>(__ldcg(cnt + i));
    sums[2 * i] = 0;
    sums[2 * i + 1] = 0;
    cnt[i] = 0u;
  }
  if (threadIdx.x == 0) s.tickets[t.ticket] = 0u;
}

__device__ __forceinline__ void red_add_s64(long long* p, long long v) {
  asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// One row's quantized (g, h) pair: two int8 or two int16, read in one load
template <typename Q> struct QPair;
template <> struct QPair<int8_t> { using T = char2; };
template <> struct QPair<int16_t> { using T = short2; };

// The integer path: gh is int8 or int16 [N, 2]; cells [cells, 3] of
// 32-bit words (q_g, q_h, count), flushed into the int64 sums whenever
// the rows added since the last flush could reach 2^31 / qmax, and at the
// CTA's end.
template <typename Q, typename Bin>
__global__ void __launch_bounds__(kThreads, 1)
hist_int_kernel(const Bin* __restrict__ bins, int num_features,
                const Q* __restrict__ gh,
                const int32_t* __restrict__ indices, long long begin,
                long long count, int num_bins, int bin_tile,
                int feat_per_block, int tile_rows, int words, Scratch s,
                float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr long long kQMax = sizeof(Q) == 1 ? 127 : 32767;
  constexpr long long kFlushRows = 0x7fffffffLL / kQMax;
  const Tile t(num_features, num_bins, feat_per_block, bin_tile, words,
               bins);
  const int f0 = t.f0, nf = t.nf, cells = t.cells;
  const long long base = t.base;
  unsigned* w = reinterpret_cast<unsigned*>(smem_raw);
  long long* sums = reinterpret_cast<long long*>(s.sums) + 2 * base;
  for (int i = threadIdx.x; i < kStats * cells; i += blockDim.x) w[i] = 0u;
  using Pair = typename QPair<Q>::T;
  const Pair* gh2 = reinterpret_cast<const Pair*>(gh);
  const long long num_tiles = (count + tile_rows - 1) / tile_rows;
  long long held = 0;                    // rows in the cells since a flush
  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long r0 = tile * tile_rows;
    const int n = static_cast<int>(min(static_cast<long long>(tile_rows),
                                       count - r0));
    if (held + n > kFlushRows) {
      // the cells into the int64 sums before they could overflow
      __syncthreads();
      for (int c = threadIdx.x; c < cells; c += blockDim.x) {
        unsigned* p = w + kStats * c;
        if (p[2] == 0u) continue;
        red_add_s64(sums + 2 * c, static_cast<int>(p[0]));
        red_add_s64(sums + 2 * c + 1, static_cast<int>(p[1]));
        red_add(s.cnt + base + c, p[2]);
        p[0] = p[1] = p[2] = 0u;
      }
      held = 0;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const long long row = leaf_row(indices, begin, r0 + q);
      const Pair v = gh2[row];
      const unsigned g = static_cast<unsigned>(static_cast<int>(v.x));
      const unsigned h = static_cast<unsigned>(static_cast<int>(v.y));
      add_bins(bins + row * num_features + f0, nf, words != 0, t.rot_w,
               t.rot_f, num_bins, t.b0, t.nbt, [&](int c) {
                 unsigned* p = w + kStats * c;
                 atomicAdd(p, g);
                 atomicAdd(p + 1, h);
                 atomicAdd(p + 2, 1u);
               });
    }
    held += n;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const unsigned* p = w + kStats * c;
    if (p[2] == 0u) continue;
    red_add_s64(sums + 2 * c, static_cast<int>(p[0]));
    red_add_s64(sums + 2 * c + 1, static_cast<int>(p[1]));
    red_add(s.cnt + base + c, p[2]);
  }
  finish_int(s, t, out);
}

template <typename Bin, typename Out, typename GH, typename Kernel>
int launch(Kernel kernel, const void* bins, int num_features, const void* gh,
           const void* indices, long long begin, long long count,
           int num_bins, int bin_tile, int feat_per_block, int tile_rows,
           int grid_x, int words, int smem, void* sums, void* cnt,
           void* tickets, void* out, void* stream) {
  if (count <= 0 || num_features <= 0) return 0;
  const int grid_y = (num_features + feat_per_block - 1) / feat_per_block;
  const int grid_z = (num_bins + bin_tile - 1) / bin_tile;
  const Scratch s{static_cast<double*>(sums), static_cast<unsigned*>(cnt),
                  static_cast<unsigned*>(tickets)};
  kernel<<<dim3(grid_x, grid_y, grid_z), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Bin*>(bins), num_features,
      static_cast<const GH*>(gh), static_cast<const int32_t*>(indices),
      begin, count, num_bins, bin_tile, feat_per_block, tile_rows, words, s,
      static_cast<Out*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The kernels, uint8 routes first (the occupancy query's kinds 0-3: f32,
// f64, int8, int16), then the uint16 routes (kinds 4-7)
const void* const kKernels[] = {
    reinterpret_cast<const void*>(hist_fixed_kernel<uint8_t>),
    reinterpret_cast<const void*>(hist_f64_kernel<uint8_t>),
    reinterpret_cast<const void*>(hist_int_kernel<int8_t, uint8_t>),
    reinterpret_cast<const void*>(hist_int_kernel<int16_t, uint8_t>),
    reinterpret_cast<const void*>(hist_fixed_kernel<uint16_t>),
    reinterpret_cast<const void*>(hist_f64_kernel<uint16_t>),
    reinterpret_cast<const void*>(hist_int_kernel<int8_t, uint16_t>),
    reinterpret_cast<const void*>(hist_int_kernel<int16_t, uint16_t>)};
constexpr int kNumKernels = 8;

}  // namespace

#define LGBT_HIST_ARGS                                                      \
  const void *bins, int num_features, const void *gh, const void *indices,  \
      long long begin, long long count, int num_bins
#define LGBT_HIST_TAIL                                                      \
  int feat_per_block, int tile_rows, int grid_x, int words, int smem,       \
      void *sums, void *cnt, void *tickets, void *out, void *stream
#define LGBT_HIST_PASS(bin_tile)                                            \
  bins, num_features, gh, indices, begin, count, num_bins, bin_tile,        \
      feat_per_block, tile_rows, grid_x, words, smem, sums, cnt, tickets,   \
      out, stream

extern "C" {

// uint8 bins [N, F]. out: [F, num_bins, 3] (f32 here, f64 for
// lgbt_hist_f64). sums ([F, num_bins, 2] f64), cnt ([F, num_bins] u32)
// and tickets (u32, one a feature tile): the scratch of calls on this
// stream, zero before the call and zero again when it ends.
// feat_per_block, tile_rows, grid_x and smem are
// ops/histogram.py::launch_shape's; words is 1 where each row's feature
// tiles start on a 4-byte boundary and hold whole words. Needs
// lgbt_hist_setup on the device first. Returns the CUDA error code (0 =
// ok).
int lgbt_hist_f32(LGBT_HIST_ARGS, LGBT_HIST_TAIL) {
  return launch<uint8_t, float, float>(hist_fixed_kernel<uint8_t>,
                                       LGBT_HIST_PASS(num_bins));
}

int lgbt_hist_f64(LGBT_HIST_ARGS, LGBT_HIST_TAIL) {
  return launch<uint8_t, double, float>(hist_f64_kernel<uint8_t>,
                                        LGBT_HIST_PASS(num_bins));
}

// The integer path: gh int8 (lgbt_hist_i8) or int16 (lgbt_hist_i16)
// [N, 2], out f32, the other arguments as lgbt_hist_f32's.
int lgbt_hist_i8(LGBT_HIST_ARGS, LGBT_HIST_TAIL) {
  return launch<uint8_t, float, int8_t>(hist_int_kernel<int8_t, uint8_t>,
                                        LGBT_HIST_PASS(num_bins));
}

int lgbt_hist_i16(LGBT_HIST_ARGS, LGBT_HIST_TAIL) {
  return launch<uint8_t, float, int16_t>(hist_int_kernel<int16_t, uint8_t>,
                                         LGBT_HIST_PASS(num_bins));
}

// The uint16 route: bins uint16 [N, F], bin_tile the bins a CTA takes
// (num_bins but where the bin axis is tiled; then feat_per_block is 1),
// tickets one a (feature tile, bin tile); feat_per_block, bin_tile,
// tile_rows, grid_x and smem are ops/histogram.py::launch_shape16's;
// words is 1 where each row's feature tiles start on a 4-byte boundary
// and hold whole words (F and feat_per_block even). The other arguments
// as lgbt_hist_f32's.
int lgbt_hist16_f32(LGBT_HIST_ARGS, int bin_tile, LGBT_HIST_TAIL) {
  return launch<uint16_t, float, float>(hist_fixed_kernel<uint16_t>,
                                        LGBT_HIST_PASS(bin_tile));
}

int lgbt_hist16_f64(LGBT_HIST_ARGS, int bin_tile, LGBT_HIST_TAIL) {
  return launch<uint16_t, double, float>(hist_f64_kernel<uint16_t>,
                                         LGBT_HIST_PASS(bin_tile));
}

int lgbt_hist16_i8(LGBT_HIST_ARGS, int bin_tile, LGBT_HIST_TAIL) {
  return launch<uint16_t, float, int8_t>(hist_int_kernel<int8_t, uint16_t>,
                                         LGBT_HIST_PASS(bin_tile));
}

int lgbt_hist16_i16(LGBT_HIST_ARGS, int bin_tile, LGBT_HIST_TAIL) {
  return launch<uint16_t, float, int16_t>(
      hist_int_kernel<int16_t, uint16_t>, LGBT_HIST_PASS(bin_tile));
}

// Once per device (the current one): lets the kernels take the
// shared-memory opt-in less their static shared memory as dynamic shared
// memory. Returns those bytes, -1 on a CUDA error.
int lgbt_hist_setup(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  size_t static_max = 0;
  for (const void* k : kKernels) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, k) != cudaSuccess) {
      cudaGetLastError();
      return -1;
    }
    if (attr.sharedSizeBytes > static_max) static_max = attr.sharedSizeBytes;
  }
  const int dynamic = optin - static_cast<int>(static_max);
  for (const void* k : kKernels) {
    if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dynamic) != cudaSuccess) {
      cudaGetLastError();                // clear the error for later launches
      return -1;
    }
  }
  return dynamic;
}

// CTAs of kernel `kind` (kKernels: 0-3 the uint8 f32, f64, int8 and int16
// kernels, 4-7 the uint16 ones) that the CUDA occupancy calculator fits
// on an SM of the current device with `smem` bytes of dynamic shared
// memory each (after lgbt_hist_setup); -1 on a CUDA error.
int lgbt_hist_occupancy(int kind, int smem) {
  if (kind < 0 || kind >= kNumKernels) return -1;
  int n = -1;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kKernels[kind], kThreads, smem);
  return e == cudaSuccess ? n : -1;
}

}  // extern "C"
