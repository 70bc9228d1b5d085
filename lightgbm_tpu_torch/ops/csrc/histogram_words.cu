// Gradient / hessian / count histograms over packed bin words, for the
// level builder, on Hopper (sm_90a): kernel B5.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py::
// pallas_histogram_words, both of its branches: _hist_words_kernel
// (pallas_call at :293, up to 128 bins) and _subbin_words_kernel
// (pallas_call at :276, 16 x 16 sub-bin tiles for more than 128 bins):
//
//   hist[s, f, b, :] = sum over the rows r of segment s with
//                      bin(r, f) == b of (g_r, h_r, 1)
//
// The level builder keeps its rows word-major: words [wcnt, n] int32, the
// bins of features 4w..4w+3 in bits 0-7, 8-15, 16-23, 24-31 of word w,
// and g, h [n] f32 in the same (permuted) row order. A segment is a
// contiguous row range [seg_begin, seg_begin + seg_cnt): the root is one
// segment, and a round's smaller children are one segment each, all in
// one launch.
//
// The TPU builds a bf16 one-hot per feature and contracts it on the MXU
// against a hi/lo split of the payload; more than 128 bins need the
// sub-bin tiles because the one-hot's sublane axis is 128 wide. Hopper
// scatters into shared memory with atomics, but only 32-bit integer ones
// are native: an f32 or f64 shared atomicAdd is a compare-and-swap loop
// (ATOMS.CAST.SPIN) on sm_90a. So the f32 path takes B1's design
// (histogram.cu, fixed_point.cuh) over the segments' concatenated rows:
//   - Rows. The CTAs split the concatenated rows evenly (a CTA's share may
//     span several segments); a CTA cuts its part of each segment into
//     equal row tiles of at most 16,384 rows, so a tile never crosses a
//     segment. Thread t reads row r + t of each word array (coalesced),
//     and g and h.
//   - Cells. A scale pass takes the tile's largest |g| and |h| (integer
//     max over the bits); the sum pass splits each value into hi/lo int32
//     words at that scale and adds them, and the count, to 20-byte shared
//     cells with native ATOMS.ADD (`Cells`, `Fixed`). A tile's error is at
//     most 1.9e-6 of its largest |v|, so a segment's at most 1.9e-6 of
//     its sum of |v|. A tile whose largest |g| or |h| is NaN or Inf adds
//     that stat straight to the f64 sums, so NaN and Inf reach each cell
//     as they reach the plain twin's.
//   - One launch a call. At a tile's end each cell is decoded and added to
//     the segment's f64 sums in a device-memory scratch (PTX red), its
//     count to a u32 count. The CTAs that share a segment are a contiguous
//     range, known from the segment's offset and the row split, so each
//     takes the segment's ticket (one a segment and feature tile) once it
//     is done with it, and the last rounds the segment's cells to f32 once
//     and zeroes them and the ticket: the scratch is zero again for the
//     next call on the stream. A segment that one CTA covers in one tile
//     is written straight from the shared cells. The segment prefix is
//     built in the kernel (each CTA scans the counts), and each empty
//     segment's output is zeroed by one CTA, so the output needs no memset
//     and the call is this one kernel.
//   - CTAs. One CTA of 1024 threads an SM (the occupancy calculator's
//     count), features in the fewest equal tiles of whole words whose
//     cells fit the shared-memory opt-in (blockIdx.y; HIGGS's 28 features
//     are one tile at 63 and at 255 bins), and about sqrt(7.2 x rows /
//     bins) CTAs along the rows (ops/histogram.py::words_launch_shape).
//
// The f64 path (tpu_use_f64_hist) must stay bit-equal to its plain twin,
// which fixed point cannot promise: it keeps f64 shared sums (CAS loops)
// and flushes once a segment a CTA, with the same tickets. f64 sums of f32
// payloads are exact at realistic segment sizes, so their order does not
// matter; either path rounds to the f32 output once.
//
// What bounds it on an H100: by the data sheet, bytes. A call reads rows *
// (4 * wcnt + 8) bytes of words and payload and writes S * F * B * 3 f32
// cells. What bounds it in fact, as B1, is each SM's shared-memory
// atomics, five a (row, feature) site: about 1.8 sites a clock.
#include <cstdint>
#include <cuda_runtime.h>

#include "fixed_point.cuh"

namespace {

constexpr int kStats = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;   // one CTA an SM
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16384; // a tile's rows: the fixed-point bound
constexpr int kSegChunk = kThreads;   // segments scanned at a time

struct Call {
  const int32_t* words;          // [wcnt, n]
  long long n;
  const float* g;                // [n]
  const float* h;                // [n]
  const int32_t* seg_begin;      // [nseg]
  const int32_t* seg_cnt;        // [nseg]
  int nseg;
  int num_features;
  int num_bins;
  int feat_per_block;            // a multiple of 4: whole words
};

// Inclusive sum over the CTA's threads of x; `total` gets the sum of all.
// Every thread calls it.
__device__ __forceinline__ long long block_scan(long long x,
                                                long long* total) {
  __shared__ long long warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warp_sum[warp - 1];
  *total = warp_sum[kWarps - 1];
  __syncthreads();                       // warp_sum is free again
  return x;
}

// One row's bins of the CTA's feature tile (nw words from word w0, nf
// features) into the cells: add(f * num_bins + bin) for each feature f of
// the tile whose bin lies below num_bins, from the warp's word rot_w on,
// wrapping; the next word is loaded while the current one's bins are
// added.
template <typename Add>
__device__ __forceinline__ void add_row(const Call& a, long long row, int w0,
                                        int nw, int nf, int rot_w,
                                        const Add& add) {
  const int32_t* col = a.words + static_cast<long long>(w0) * a.n + row;
  int w = rot_w;
  unsigned word = __ldg(reinterpret_cast<const unsigned*>(col + w * a.n));
  for (int k = 0; k < nw; ++k) {
    const int nxt = w + 1 == nw ? 0 : w + 1;
    const unsigned next = k + 1 < nw
        ? __ldg(reinterpret_cast<const unsigned*>(col + nxt * a.n)) : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = (word >> (8 * j)) & 255;
      if (4 * w + j < nf && b < a.num_bins) add((4 * w + j) * a.num_bins + b);
    }
    w = nxt;
    word = next;
  }
}

// The f32 path's part of one segment: virtual rows [lo, hi) at rows
// base_row + v, in tiles. Returns whether the cells went straight to dst
// (the scratch then holds nothing of the segment).
__device__ __forceinline__ bool piece_fixed(
    const Call& a, Cells& sm, unsigned* run_max, long long lo, long long hi,
    long long base_row, int w0, int nw, int nf, int rot_w, int cells,
    bool sole, unsigned* scnt, float* dst) {
  const long long rows = hi - lo;
  const int ntiles = static_cast<int>((rows + kTileRows - 1) / kTileRows);
  const int tile_rows = static_cast<int>((rows + ntiles - 1) / ntiles);
  bool direct = false;
  for (int t = 0; t < ntiles; ++t) {
    const long long r0 = base_row + lo + static_cast<long long>(t) * tile_rows;
    const int n = static_cast<int>(min(static_cast<long long>(tile_rows),
                                       rows - static_cast<long long>(t)
                                       * tile_rows));
    __syncthreads();                     // the last tile's flush is done
    // 1. the bits of the tile's largest |g| and |h|, which fix its scale
    //    (integer max: NaN and Inf rank above every finite one)
    unsigned mg = 0u, mh = 0u;
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      mg = max(mg, __float_as_uint(__ldg(a.g + r0 + q)) & 0x7fffffffu);
      mh = max(mh, __float_as_uint(__ldg(a.h + r0 + q)) & 0x7fffffffu);
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
      unsigned g_hi, g_lo, h_hi, h_lo;
      fg.split(__ldg(a.g + r0 + q), g_hi, g_lo);
      fh.split(__ldg(a.h + r0 + q), h_hi, h_lo);
      add_row(a, r0 + q, w0, nw, nf, rot_w,
              [&](int c) { sm.add(c, g_hi, g_lo, h_hi, h_lo); });
    }
    __syncthreads();
    if (threadIdx.x < 2) run_max[threadIdx.x] = 0u;
    // 3. the tile out: straight to dst where one CTA covers the segment
    //    in this one finite tile, else into the f64 sums
    direct = sole && !fg.exact && !fh.exact;
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      unsigned* p = sm.w + kCellWords * c;
      const unsigned k = p[kN];
      if (direct) {
        dst[kStats * c] = static_cast<float>(fg.value(p[kGHi], p[kGLo]));
        dst[kStats * c + 1] = static_cast<float>(fh.value(p[kHHi], p[kHLo]));
        dst[kStats * c + 2] = static_cast<float>(k);
      } else if (k != 0u) {
        if (!fg.exact) red_add(sm.sums + 2 * c, fg.value(p[kGHi], p[kGLo]));
        if (!fh.exact) {
          red_add(sm.sums + 2 * c + 1, fh.value(p[kHHi], p[kHLo]));
        }
        red_add(scnt + c, k);
      }
#pragma unroll
      for (int u = 0; u < kCellWords; ++u) p[u] = 0u;
    }
  }
  return direct;
}

// The f64 path's part of one segment: shared f64 sums and u32 counts, one
// flush. Returns whether the cells went straight to dst.
__device__ __forceinline__ bool piece_f64(
    const Call& a, double* sg, unsigned* sn, long long lo, long long hi,
    long long base_row, int w0, int nw, int nf, int rot_w, int cells,
    bool sole, double* ssum, unsigned* scnt, float* dst) {
  __syncthreads();                       // the cells are zero
  for (long long v = lo + threadIdx.x; v < hi; v += blockDim.x) {
    const long long row = base_row + v;
    const double g = __ldg(a.g + row), h = __ldg(a.h + row);
    add_row(a, row, w0, nw, nf, rot_w, [&](int c) {
      atomicAdd(sg + 2 * c, g);
      atomicAdd(sg + 2 * c + 1, h);
      atomicAdd(sn + c, 1u);
    });
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const unsigned k = sn[c];
    if (sole) {
      dst[kStats * c] = static_cast<float>(sg[2 * c]);
      dst[kStats * c + 1] = static_cast<float>(sg[2 * c + 1]);
      dst[kStats * c + 2] = static_cast<float>(k);
    } else if (k != 0u) {
      red_add(ssum + 2 * c, sg[2 * c]);
      red_add(ssum + 2 * c + 1, sg[2 * c + 1]);
      red_add(scnt + c, k);
    }
    sg[2 * c] = 0.0;
    sg[2 * c + 1] = 0.0;
    sn[c] = 0u;
  }
  return sole;
}

// Both paths: blockIdx.y picks a tile of feat_per_block features; the
// CTAs along x split the segments' concatenated rows evenly. out [nseg, F,
// B, 3] f32; the scratch holds [nseg, F, B] cells and nseg * gridDim.y
// tickets.
template <bool kF64>
__device__ __forceinline__ void words_body(const Call& a, const Scratch& s,
                                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long seg_off[kSegChunk + 1];
  __shared__ int zero_list[kSegChunk];
  __shared__ int zero_n, first, last;
  const int B = a.num_bins;
  const int f0 = blockIdx.y * a.feat_per_block;
  const int nf = min(a.feat_per_block, a.num_features - f0);
  const int cells = nf * B;
  const int w0 = f0 >> 2, nw = (nf + 3) >> 2;
  // warps start on different words, so that they add to different cells
  // (a build whose lanes also start on different features was no faster:
  // chip_ab.py words-sweep)
  const int rot_w = (threadIdx.x >> 5) % nw;
  const long long seg_cells = static_cast<long long>(a.num_features) * B;
  // the shared cells, zero
  Cells sm;
  sm.w = reinterpret_cast<unsigned*>(smem_raw);
  unsigned* run_max = sm.w + kCellWords * cells;
  double* sg = reinterpret_cast<double*>(smem_raw);
  unsigned* sn = reinterpret_cast<unsigned*>(sg + 2 * cells);
  for (int i = threadIdx.x; i < kCellWords * cells; i += blockDim.x) {
    sm.w[i] = 0u;
  }
  if (!kF64 && threadIdx.x < 2) run_max[threadIdx.x] = 0u;

  // the CTA's share of the concatenated rows: [v0, v1) of total
  long long total = 0, t = 0;
  for (int i = threadIdx.x; i < a.nseg; i += blockDim.x) {
    t += max(__ldg(a.seg_cnt + i), 0);
  }
  block_scan(t, &total);
  const long long per = total > 0 ? (total + gridDim.x - 1) / gridDim.x : 1;
  const long long v0 = min(total, static_cast<long long>(blockIdx.x) * per);
  const long long v1 = min(total, v0 + per);

  long long run = 0;                     // rows of the segments before c0
  for (int c0 = 0; c0 < a.nseg; c0 += kSegChunk) {
    const int i = c0 + static_cast<int>(threadIdx.x);
    const long long cnt = i < a.nseg ? max(__ldg(a.seg_cnt + i), 0) : 0;
    long long chunk_rows;
    const long long off = run + block_scan(cnt, &chunk_rows) - cnt;
    seg_off[threadIdx.x] = off;
    if (threadIdx.x == 0) {
      seg_off[kSegChunk] = run + chunk_rows;
      zero_n = 0;
      first = kSegChunk;
      last = -1;
    }
    __syncthreads();
    // this chunk's segments that meet [v0, v1), and its empty segments
    // that this CTA zeroes (segment i % gridDim.x)
    if (i < a.nseg) {
      if (cnt == 0) {
        if (i % gridDim.x == blockIdx.x) {
          zero_list[atomicAdd(&zero_n, 1)] = threadIdx.x;
        }
      } else if (off < v1 && off + cnt > v0) {
        atomicMin(&first, static_cast<int>(threadIdx.x));
        atomicMax(&last, static_cast<int>(threadIdx.x));
      }
    }
    __syncthreads();
    for (int z = 0; z < zero_n; ++z) {
      float* dst = out + kStats * ((c0 + zero_list[z]) * seg_cells
                                   + static_cast<long long>(f0) * B);
      for (int j = threadIdx.x; j < kStats * cells; j += blockDim.x) {
        dst[j] = 0.f;
      }
    }
    for (int j = first; j <= last; ++j) {
      const long long so = seg_off[j], se = seg_off[j + 1];
      if (so == se) continue;
      const long long seg = c0 + j;
      const long long lo = max(v0, so), hi = min(v1, se);
      const long long base_row = __ldg(a.seg_begin + seg) - so;
      // the CTAs that share the segment: so / per .. (se - 1) / per
      const unsigned expected =
          static_cast<unsigned>((se - 1) / per - so / per + 1);
      const long long base = seg * seg_cells + static_cast<long long>(f0) * B;
      double* ssum = s.sums + 2 * base;
      unsigned* scnt = s.cnt + base;
      float* dst = out + kStats * base;
      bool direct;
      if (kF64) {
        direct = piece_f64(a, sg, sn, lo, hi, base_row, w0, nw, nf, rot_w,
                           cells, expected == 1u, ssum, scnt, dst);
      } else {
        sm.sums = ssum;
        direct = piece_fixed(a, sm, run_max, lo, hi, base_row, w0, nw, nf,
                             rot_w, cells,
                             expected == 1u && hi - lo <= kTileRows, scnt,
                             dst);
      }
      unsigned* ticket = s.tickets + seg * gridDim.y + blockIdx.y;
      if (!direct && last_to_arrive(ticket, expected)) {
        finalize(ssum, scnt, ticket, cells, dst);
      }
    }
    run = seg_off[kSegChunk];
    __syncthreads();                     // before the next chunk's tables
  }
}

__global__ void __launch_bounds__(kThreads, 1)
words_fixed_kernel(Call a, Scratch s, float* __restrict__ out) {
  words_body<false>(a, s, out);
}

__global__ void __launch_bounds__(kThreads, 1)
words_f64_kernel(Call a, Scratch s, float* __restrict__ out) {
  words_body<true>(a, s, out);
}

int launch(bool f64, const void* words, long long n, const void* g,
           const void* h, const void* seg_begin, const void* seg_cnt,
           int nseg, int num_features, int num_bins, int feat_per_block,
           int grid_x, int smem, void* sums, void* cnt, void* tickets,
           void* out, void* stream) {
  if (nseg <= 0 || num_features <= 0) return 0;
  const Call a{static_cast<const int32_t*>(words), n,
               static_cast<const float*>(g), static_cast<const float*>(h),
               static_cast<const int32_t*>(seg_begin),
               static_cast<const int32_t*>(seg_cnt), nseg, num_features,
               num_bins, feat_per_block};
  const Scratch s{static_cast<double*>(sums), static_cast<unsigned*>(cnt),
                  static_cast<unsigned*>(tickets)};
  const dim3 grid(grid_x, (num_features + feat_per_block - 1)
                  / feat_per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) {
    words_f64_kernel<<<grid, kThreads, smem, st>>>(a, s,
                                                   static_cast<float*>(out));
  } else {
    words_fixed_kernel<<<grid, kThreads, smem, st>>>(
        a, s, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [nseg, F, B, 3] f32, every cell written. words [ceil(F/4), n]
// int32, g and h [n] f32, seg_begin and seg_cnt [nseg] int32. sums
// ([nseg, F, B, 2] f64), cnt ([nseg, F, B] u32) and tickets (u32, nseg
// times the feature tiles): the scratch of calls on this stream, zero
// before the call and zero again when it ends. feat_per_block (a multiple
// of 4), grid_x and smem are ops/histogram.py::words_launch_shape's.
// Needs lgbt_words_setup on the device first. Returns the CUDA error code
// (0 = ok).
int lgbt_words_f32(const void* words, long long n, const void* g,
                   const void* h, const void* seg_begin, const void* seg_cnt,
                   int nseg, int num_features, int num_bins,
                   int feat_per_block, int grid_x, int smem, void* sums,
                   void* cnt, void* tickets, void* out, void* stream) {
  return launch(false, words, n, g, h, seg_begin, seg_cnt, nseg,
                num_features, num_bins, feat_per_block, grid_x, smem, sums,
                cnt, tickets, out, stream);
}

int lgbt_words_f64(const void* words, long long n, const void* g,
                   const void* h, const void* seg_begin, const void* seg_cnt,
                   int nseg, int num_features, int num_bins,
                   int feat_per_block, int grid_x, int smem, void* sums,
                   void* cnt, void* tickets, void* out, void* stream) {
  return launch(true, words, n, g, h, seg_begin, seg_cnt, nseg,
                num_features, num_bins, feat_per_block, grid_x, smem, sums,
                cnt, tickets, out, stream);
}

// Once per device (the current one): lets both kernels take the
// shared-memory opt-in less their static shared memory as dynamic shared
// memory. Returns those bytes, -1 on a CUDA error.
int lgbt_words_setup(int device) {
  int optin = 0;
  cudaFuncAttributes fixed_attr, f64_attr;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess
      || cudaFuncGetAttributes(&fixed_attr, words_fixed_kernel) != cudaSuccess
      || cudaFuncGetAttributes(&f64_attr, words_f64_kernel) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  const int dynamic = optin - static_cast<int>(
      fixed_attr.sharedSizeBytes > f64_attr.sharedSizeBytes
          ? fixed_attr.sharedSizeBytes : f64_attr.sharedSizeBytes);
  if (cudaFuncSetAttribute(words_fixed_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dynamic) != cudaSuccess
      || cudaFuncSetAttribute(words_f64_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              dynamic) != cudaSuccess) {
    cudaGetLastError();                  // clear the error for later launches
    return -1;
  }
  return dynamic;
}

// CTAs of the f32 (f64 == 0) or f64 kernel that the CUDA occupancy
// calculator fits on an SM of the current device with `smem` bytes of
// dynamic shared memory each (after lgbt_words_setup); -1 on a CUDA error.
int lgbt_words_occupancy(int f64, int smem) {
  int n = -1;
  const cudaError_t e = f64
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, words_f64_kernel,
                                                      kThreads, smem)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, words_fixed_kernel,
                                                      kThreads, smem);
  return e == cudaSuccess ? n : -1;
}

}  // extern "C"
