// The aligned engine's three kernels for Hopper (sm_90a): the physical
// left count (B3), the stable two-way partition of every tree block into a
// new chunk-aligned layout (B2) and the slot-mapped histogram (B4).
//
// Replaces the TPU kernels of lightgbm_tpu/ops/aligned.py:
//   B2 move_pass      (_move_kernel, pallas_call at :960)
//   B3 count_pass     (_count_kernel, pallas_call at :1056)
//   B4 slot_hist_pass (_slot_hist_kernel, pallas_call at :1141)
//
// Records are [NC, W, C] int32: chunk-major, and within a chunk each lane
// (a packed bin word, the score, the meta word, ...) is a contiguous run of
// C words, so thread r reading row r of a lane is a coalesced load. Tree
// blocks own disjoint chunk-aligned ranges; per-chunk int32 arrays carry
// the routing (r1: threshold | shift << 8 | default_left << 13 |
// missing_type << 14 | copy << 16; r2: default_bin | (num_bin - 1) << 8;
// wsel: the split word lane; meta: count | first << 20 | last << 21).
//
// What the TPU kernels do that has no counterpart here: the Pallas move
// kernel carries each block's left/right fill from grid step to grid step
// in SMEM, ranks rows with a triangular MXU matmul, moves them with a
// byte-plane one-hot matmul through a 4-chunk staging ring, and builds
// histograms as bf16 hi/lo one-hot contractions. CUDA blocks run in no
// order, so the move is three kernels instead:
//   1. count_kernel: each chunk's left count (B3's work, one CTA a chunk);
//   2. scan_kernel: one CTA, an exclusive scan of the counts within each
//      block (a segmented scan over the [NC] chunk array), which also maps
//      each block's smaller child to its new chunks;
//   3. scatter_kernel: one CTA a chunk ranks its rows with warp ballots
//      and writes each row's used lanes to new_begin * C + prefix + rank;
//      chunks of unsplit blocks are copied whole.
// The smaller child's histogram is then slot_hist_kernel over the child's
// now contiguous chunks. Histograms accumulate by bin in shared memory (the
// ocl/histogram256.cl pattern, as kernel B1 does) and flush once per (CTA,
// slot) with global atomics. g and h accumulate in f64 and counts as
// integers: a CTA adds tens of thousands of rows into one cell, and an f32
// accumulator there drifts by up to ~1e-5 of the slot's sum of |g|
// (measured at 10.5M x 28 on an H100); the f64 sums of f32 payloads round
// to f32 once at the end, so the result does not depend on the order of
// the atomics in practice.
//
// What bounds them on an H100: bytes. The move reads every row's used
// lanes once and writes them once; the count reads one word a row; the
// histogram reads the bin words and the two payload lanes of its rows.
// The 3 adds per (row, feature) are far below the card's f32 rate.
//
// Records of the STANDARD and EXT layouts carry grad/hess lanes, at wcnt +
// gh_off and the lane after (STANDARD: gh_off 2, after score and label;
// EXT, for ranking: gh_off 1, after the score); the kernels read them.
// Gradients of the COMPACT layout are computed in the histogram kernel
// from the score lane and the label bits of the meta lane, with the
// JAX package's f32 op order pinned by __fmul_rn/__fadd_rn/__fdiv_rn (so
// nvcc contracts nothing) and XLA's exp polynomial with true fused
// multiply-adds. The CPU twin computes those fused steps in f64 and
// rounds twice, so a row's gradient may differ in its last bit in rare
// cases; histograms are held to 1e-5 x sum |g| of the slot.
#include <cstdint>
#include <cuda_runtime.h>

#include "xla_math.cuh"

namespace {

constexpr int kStats = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kShift = 8, kDefLeft = 13, kMissing = 14, kCopy = 16;
constexpr int kCntMask = (1 << 20) - 1;
constexpr int kFirst = 20, kLast = 21;
constexpr int kMetaLabel = 24, kMetaLabelMask = 127;
constexpr int kGradLanes = 0, kGradBinary = 1, kGradL2 = 2;
constexpr int kThreads = 256;      // count and scatter CTAs
constexpr int kScanThreads = 1024;

// reference DenseBin::Split numerical routing (dense_bin.hpp:195-283),
// as ops/aligned.py::_goes_left: missing None / Zero / NaN
__device__ __forceinline__ bool goes_left(int binv, int r1, int r2) {
  if ((r1 >> kCopy) & 1) return true;
  const int thr = r1 & 255, dl = (r1 >> kDefLeft) & 1;
  const int mt = (r1 >> kMissing) & 3;
  const int db = r2 & 255, nb = ((r2 >> 8) & 255) + 1;
  const bool is_def = (mt == 1 && binv == db) || (mt == 2 && binv == nb - 1);
  return is_def ? dl != 0 : binv <= thr;
}

// (g, h) of one row: from the grad/hess lanes at wcnt + gh_off (STANDARD:
// 2, EXT: 1) or recomputed from the score lane and the meta label
// (COMPACT)
__device__ __forceinline__ void payload(const int32_t* chunk, int C, int r,
                                        int wcnt, int gh_off, int kind,
                                        float sig, float wp, float wn,
                                        float& g, float& h) {
  if (kind == kGradLanes) {
    g = __int_as_float(chunk[static_cast<long long>(wcnt + gh_off) * C + r]);
    h = __int_as_float(
        chunk[static_cast<long long>(wcnt + gh_off + 1) * C + r]);
    return;
  }
  const float score = __int_as_float(chunk[static_cast<long long>(wcnt) * C
                                           + r]);
  const int meta = chunk[static_cast<long long>(wcnt + 1) * C + r];
  const float label = static_cast<float>((meta >> kMetaLabel)
                                         & kMetaLabelMask);
  if (kind == kGradL2) {
    g = __fsub_rn(score, label);
    h = 1.0f;
    return;
  }
  const bool pos = label > 0.0f;
  const float sl = pos ? 1.0f : -1.0f;
  const float lw = pos ? wp : wn;
  const float resp = __fdiv_rn(
      __fmul_rn(-sl, sig),
      __fadd_rn(1.0f, exp_xla(__fmul_rn(__fmul_rn(sl, sig), score))));
  const float absr = fabsf(resp);
  g = __fmul_rn(resp, lw);
  h = __fmul_rn(__fmul_rn(absr, __fsub_rn(sig, absr)), lw);
}

__device__ __forceinline__ int block_sum(int v) {
  __shared__ int part[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += part[w];
  }
  return s;   // valid in thread 0
}

// Left rows per chunk. count_pass: chunks with kslots in [0, num_slots)
// add their count to slot_out[kslots] (integer atomics: exact). move_pass:
// every split chunk (copy bit clear) writes its own count to chunk_out.
__global__ void count_kernel(const int32_t* __restrict__ rec, int W, int C,
                             const int32_t* __restrict__ r1,
                             const int32_t* __restrict__ r2,
                             const int32_t* __restrict__ meta,
                             const int32_t* __restrict__ wsel,
                             const int32_t* __restrict__ kslots,
                             int num_slots, int bits,
                             int32_t* __restrict__ chunk_out,
                             int32_t* __restrict__ slot_out) {
  const long long c = blockIdx.x;
  const int cnt = meta[c] & kCntMask;
  const int r1c = r1[c];
  const int ks = kslots != nullptr ? kslots[c] : 0;
  const bool active = kslots != nullptr
      ? (ks >= 0 && ks < num_slots) : ((r1c >> kCopy) & 1) == 0;
  if (!active || cnt == 0) {
    if (chunk_out != nullptr && threadIdx.x == 0) chunk_out[c] = 0;
    return;
  }
  const int r2c = r2[c];
  const int shift = (r1c >> kShift) & 31, mask = (1 << bits) - 1;
  const int32_t* word = rec + (c * W + wsel[c]) * static_cast<long long>(C);
  int n = 0;
  for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
    n += goes_left((word[r] >> shift) & mask, r1c, r2c) ? 1 : 0;
  }
  const int total = block_sum(n);
  if (threadIdx.x == 0) {
    if (chunk_out != nullptr) {
      chunk_out[c] = total;
    } else if (total != 0) {
      atomicAdd(slot_out + ks, total);
    }
  }
}

// One CTA: exclusive left/right prefixes of each split chunk within its
// block (a block starts at a chunk with the first bit), and, at each
// block's last chunk, the new chunks of its smaller child (hslots = slot |
// side << 24, slot == num_slots skips) for the histogram pass.
__global__ void scan_kernel(int nc, int C, const int32_t* __restrict__ r1,
                            const int32_t* __restrict__ meta,
                            const int32_t* __restrict__ lcnt,
                            const int32_t* __restrict__ basel,
                            const int32_t* __restrict__ baser,
                            const int32_t* __restrict__ hslots,
                            int num_slots, int32_t* __restrict__ pl,
                            int32_t* __restrict__ pr,
                            int32_t* __restrict__ nslot,
                            int32_t* __restrict__ ncnt) {
  __shared__ int tl[kScanThreads], tv[kScanThreads], th[kScanThreads];
  const int t = threadIdx.x, T = blockDim.x;
  const int per = (nc + T - 1) / T;
  const int lo = min(nc, t * per), hi = min(nc, lo + per);
  int sl = 0, sv = 0, has = 0;
  for (int c = lo; c < hi; ++c) {
    const int m = meta[c];
    if ((m >> kFirst) & 1) { sl = 0; sv = 0; has = 1; }
    if (((r1[c] >> kCopy) & 1) == 0) { sl += lcnt[c]; sv += m & kCntMask; }
  }
  tl[t] = sl; tv[t] = sv; th[t] = has;
  __syncthreads();
  if (t == 0) {       // carries between the threads' ranges, in order
    int cl = 0, cv = 0;
    for (int i = 0; i < T; ++i) {
      const int a = tl[i], b = tv[i], h = th[i];
      tl[i] = cl; tv[i] = cv;
      if (h) { cl = a; cv = b; } else { cl += a; cv += b; }
    }
  }
  __syncthreads();
  int rl = tl[t], rv = tv[t];
  for (int c = lo; c < hi; ++c) {
    const int m = meta[c];
    if ((m >> kFirst) & 1) { rl = 0; rv = 0; }
    const bool split = ((r1[c] >> kCopy) & 1) == 0;
    pl[c] = rl;
    pr[c] = rv - rl;
    if (!split) continue;
    rl += lcnt[c];
    rv += m & kCntMask;
    if (!((m >> kLast) & 1)) continue;
    const int hs = hslots[c], slot = hs & 0xFFFFFF;
    if (slot >= num_slots) continue;
    const int side = (hs >> 24) & 1;
    const int tot = side ? rv - rl : rl;
    const int base = side ? baser[c] : basel[c];
    for (int j = 0; j * C < tot; ++j) {
      nslot[base + j] = slot;
      ncnt[base + j] = min(C, tot - j * C);
    }
  }
}

// One CTA a chunk: split chunks partition their rows stably (left rows to
// basel's chunks, right rows to baser's, after the block's earlier rows);
// copy chunks move whole to basel.
__global__ void scatter_kernel(const int32_t* __restrict__ rec, int W, int C,
                               int w_used, int bits,
                               const int32_t* __restrict__ r1,
                               const int32_t* __restrict__ r2,
                               const int32_t* __restrict__ meta,
                               const int32_t* __restrict__ wsel,
                               const int32_t* __restrict__ basel,
                               const int32_t* __restrict__ baser,
                               const int32_t* __restrict__ pl,
                               const int32_t* __restrict__ pr,
                               int32_t* __restrict__ out) {
  __shared__ int wl[kThreads / 32], wr[kThreads / 32];
  const long long c = blockIdx.x;
  const int cnt = meta[c] & kCntMask;
  if (cnt == 0) return;
  const int r1c = r1[c];
  const long long cw = static_cast<long long>(W) * C;
  const int32_t* src = rec + c * cw;
  if ((r1c >> kCopy) & 1) {
    int32_t* dst = out + static_cast<long long>(basel[c]) * cw;
    for (long long i = threadIdx.x; i < cw; i += blockDim.x) dst[i] = src[i];
    return;
  }
  const int r2c = r2[c];
  const int shift = (r1c >> kShift) & 31, mask = (1 << bits) - 1;
  const int32_t* word = src + static_cast<long long>(wsel[c]) * C;
  const long long bl = basel[c], br = baser[c];
  int run_l = pl[c], run_r = pr[c];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int t0 = 0; t0 < cnt; t0 += blockDim.x) {
    const int r = t0 + threadIdx.x;
    const bool valid = r < cnt;
    const bool left = valid && goes_left((word[valid ? r : 0] >> shift)
                                         & mask, r1c, r2c);
    const unsigned ml = __ballot_sync(kFull, left);
    const unsigned mr = __ballot_sync(kFull, valid && !left);
    if (lane == 0) { wl[warp] = __popc(ml); wr[warp] = __popc(mr); }
    __syncthreads();
    int off_l = 0, off_r = 0, tot_l = 0, tot_r = 0;
    for (int w = 0; w < nwarps; ++w) {
      if (w < warp) { off_l += wl[w]; off_r += wr[w]; }
      tot_l += wl[w];
      tot_r += wr[w];
    }
    if (valid) {
      long long d, base;
      if (left) {
        d = run_l + off_l + __popc(ml & below);
        base = bl;
      } else {
        d = run_r + off_r + __popc(mr & below);
        base = br;
      }
      int32_t* dst = out + (base + d / C) * cw + d % C;
      for (int u = 0; u < w_used; ++u) {
        dst[static_cast<long long>(u) * C] = src[static_cast<long long>(u) * C
                                                 + r];
      }
    }
    run_l += tot_l;
    run_r += tot_r;
    __syncthreads();
  }
}

// Histograms of the chunks mapped to slots: (g, h) into gh [num_slots, F,
// B, 2] f64 and the row count into cnt [num_slots, F, B] over the valid
// rows (meta count) of every chunk with slots[c] in [0, num_slots). A CTA
// walks a fixed range of chunks for one feature tile and flushes its
// shared sub-histogram whenever the slot changes.
__global__ void slot_hist_kernel(const int32_t* __restrict__ rec, int W,
                                 int C, int wcnt, int gh_off, int bits,
                                 int num_features, int num_bins,
                                 int feat_per_block, int chunks_per_block,
                                 int nc, const int32_t* __restrict__ slots,
                                 const int32_t* __restrict__ meta,
                                 int num_slots, int kind, float sig, float wp,
                                 float wn, double* __restrict__ gh_out,
                                 unsigned* __restrict__ cnt_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f0 = blockIdx.y * feat_per_block;
  const int nf = min(feat_per_block, num_features - f0);
  const int cells = nf * num_bins;
  double* sh = reinterpret_cast<double*>(smem_raw);             // [cells, 2]
  unsigned* sc = reinterpret_cast<unsigned*>(sh + 2 * cells);   // [cells]
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    sh[2 * i] = 0.0;
    sh[2 * i + 1] = 0.0;
    sc[i] = 0u;
  }
  __syncthreads();
  const int bpw = 32 / bits, mask = (1 << bits) - 1;
  const int c0 = blockIdx.x * chunks_per_block;
  const int c1 = min(nc, c0 + chunks_per_block);
  int cur = -1;
  bool dirty = false;

  auto flush = [&]() {
    __syncthreads();
    const long long base = (static_cast<long long>(cur) * num_features + f0)
        * num_bins;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      if (sc[i] != 0u) {
        atomicAdd(gh_out + 2 * (base + i), sh[2 * i]);
        atomicAdd(gh_out + 2 * (base + i) + 1, sh[2 * i + 1]);
        atomicAdd(cnt_out + base + i, sc[i]);
      }
      sh[2 * i] = 0.0;
      sh[2 * i + 1] = 0.0;
      sc[i] = 0u;
    }
    __syncthreads();
  };

  for (int c = c0; c < c1; ++c) {
    const int s = slots[c];
    if (s < 0 || s >= num_slots) continue;
    const int cnt = meta[c] & kCntMask;
    if (cnt == 0) continue;
    if (s != cur) {
      if (dirty) flush();
      cur = s;
    }
    dirty = true;
    const int32_t* chunk = rec + static_cast<long long>(c) * W * C;
    for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
      float g, h;
      payload(chunk, C, r, wcnt, gh_off, kind, sig, wp, wn, g, h);
      int wi = -1, word = 0;
      for (int f = 0; f < nf; ++f) {
        const int ff = f0 + f, w = ff / bpw;
        if (w != wi) {
          word = chunk[static_cast<long long>(w) * C + r];
          wi = w;
        }
        const int b = (word >> ((ff - w * bpw) * bits)) & mask;
        if (b < num_bins) {
          const int cell = f * num_bins + b;
          atomicAdd(sh + 2 * cell, static_cast<double>(g));
          atomicAdd(sh + 2 * cell + 1, static_cast<double>(h));
          atomicAdd(sc + cell, 1u);
        }
      }
    }
  }
  if (dirty) flush();
}

// out [cells, 3] f32 = (g, h, count), each rounded once
__global__ void hist_finalize_kernel(const double* __restrict__ gh,
                                     const unsigned* __restrict__ cnt,
                                     long long cells,
                                     float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  out[kStats * i] = static_cast<float>(gh[2 * i]);
  out[kStats * i + 1] = static_cast<float>(gh[2 * i + 1]);
  out[kStats * i + 2] = static_cast<float>(cnt[i]);
}

int check() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// B3: slot_out[num_slots] (zeroed by the caller) += left rows of each chunk
// whose kslots entry is a slot. Returns the CUDA error code (0 = ok).
int lgbt_count_pass(const void* rec, int nc, int W, int C, const void* r1,
                    const void* r2, const void* meta, const void* wsel,
                    const void* kslots, int num_slots, int bits,
                    void* slot_out, void* stream) {
  if (nc == 0) return 0;
  count_kernel<<<nc, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rec), W, C,
      static_cast<const int32_t*>(r1), static_cast<const int32_t*>(r2),
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(wsel),
      static_cast<const int32_t*>(kslots), num_slots, bits, nullptr,
      static_cast<int32_t*>(slot_out));
  return check();
}

// B2, the partition: per-chunk left counts, the block scan and the
// scatter into out ([NC, W, C], chunks outside the new layout untouched).
// lcnt, pl, pr: [NC] scratch; nslot ([NC], filled with num_slots by the
// caller) and ncnt ([NC], zeroed) receive the smaller children's map.
int lgbt_move_partition(const void* rec, int nc, int W, int C, int w_used,
                        int bits, const void* r1, const void* r2,
                        const void* meta, const void* wsel,
                        const void* basel, const void* baser,
                        const void* hslots, int num_slots, void* lcnt,
                        void* pl, void* pr, void* nslot, void* ncnt,
                        void* out, void* stream) {
  if (nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* rr = static_cast<const int32_t*>(rec);
  const int32_t* a1 = static_cast<const int32_t*>(r1);
  const int32_t* a2 = static_cast<const int32_t*>(r2);
  const int32_t* am = static_cast<const int32_t*>(meta);
  const int32_t* aw = static_cast<const int32_t*>(wsel);
  const int32_t* bl = static_cast<const int32_t*>(basel);
  const int32_t* br = static_cast<const int32_t*>(baser);
  count_kernel<<<nc, kThreads, 0, s>>>(rr, W, C, a1, a2, am, aw, nullptr,
                                       num_slots, bits,
                                       static_cast<int32_t*>(lcnt), nullptr);
  int err = check();
  if (err != 0) return err;
  scan_kernel<<<1, kScanThreads, 0, s>>>(
      nc, C, a1, am, static_cast<const int32_t*>(lcnt), bl, br,
      static_cast<const int32_t*>(hslots), num_slots,
      static_cast<int32_t*>(pl), static_cast<int32_t*>(pr),
      static_cast<int32_t*>(nslot), static_cast<int32_t*>(ncnt));
  err = check();
  if (err != 0) return err;
  scatter_kernel<<<nc, kThreads, 0, s>>>(
      rr, W, C, w_used, bits, a1, a2, am, aw, bl, br,
      static_cast<const int32_t*>(pl), static_cast<const int32_t*>(pr),
      static_cast<int32_t*>(out));
  return check();
}

// B4 (and B2's smaller-child histograms): out [num_slots, F, B, 3] f32;
// gh ([num_slots, F, B, 2] f64) and cnt ([num_slots, F, B] u32) are
// accumulators zeroed by the caller. kind 0 reads the grad/hess lanes at
// wcnt + gh_off; 1 (binary logloss) and 2 (l2) recompute them from the
// score and meta lanes.
int lgbt_slot_hist(const void* rec, int nc, int W, int C, int wcnt,
                   int gh_off, int bits,
                   int num_features, int num_bins, int feat_per_block,
                   int blocks_x, int threads, const void* slots,
                   const void* meta, int num_slots, int kind, float sig,
                   float wp, float wn, void* gh, void* cnt, void* out,
                   void* stream) {
  if (nc == 0 || num_features == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(feat_per_block) * num_bins
      * (2 * sizeof(double) + sizeof(unsigned));
  cudaError_t e = cudaFuncSetAttribute(
      slot_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid_y = (num_features + feat_per_block - 1) / feat_per_block;
  const int cpb = (nc + blocks_x - 1) / blocks_x;
  slot_hist_kernel<<<dim3(blocks_x, grid_y), threads, smem, s>>>(
      static_cast<const int32_t*>(rec), W, C, wcnt, gh_off, bits,
      num_features, num_bins, feat_per_block, cpb, nc,
      static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(meta), num_slots, kind, sig, wp, wn,
      static_cast<double*>(gh), static_cast<unsigned*>(cnt));
  const int err = check();
  if (err != 0) return err;
  const long long cells =
      static_cast<long long>(num_slots) * num_features * num_bins;
  const int fin_threads = 256;
  hist_finalize_kernel<<<static_cast<unsigned>((cells + fin_threads - 1)
                                               / fin_threads),
                         fin_threads, 0, s>>>(
      static_cast<const double*>(gh), static_cast<const unsigned*>(cnt),
      cells, static_cast<float*>(out));
  return check();
}

// Largest dynamic shared memory a block may opt in to on `device`.
int lgbt_aligned_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

}  // extern "C"
