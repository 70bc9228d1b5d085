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
// now contiguous chunks; the tree's root (B4) is the same kernel over
// every chunk.
//
// slot_hist_kernel's design is P1's (proto.cu, redesigned for Hopper
// first), carried over to the engine's records:
//   - Accumulation in 32-bit shared cells with native integer atomics. On
//     sm_90a an f32 or f64 atomicAdd on shared memory, and a 64-bit
//     integer one, compiles to a compare-and-swap loop (ATOMS.CAST.SPIN);
//     a 32-bit integer add is one ATOMS.ADD. Each run of one slot's chunks
//     within a tile takes a scale from its largest |g| and |h| (a first
//     pass that computes the payload as the second does), and each value
//     is split into hi and lo int32 words, v * 2^e = hi + lo * 2^-l. With
//     at most 2^nb rows in a run and m its largest |v|, the run's sum is
//     off by at most m * 2^(3 nb - 61): tiles hold at most 16,384 rows
//     (nb 14), so at most 1.9e-6 m, and a slot's sum over many tiles at
//     most 1.9e-6 of its sum of |v|. Counts are u32. At the end of a run
//     each cell is decoded in f64 and added to the global f64 sums
//     (native); hist_finalize_kernel rounds each to f32 once. The result
//     is not bit-equal to the plain twin's f64 sums rounded once; it is
//     held to 1e-5 x the slot's sum of |g| (|h|).
//   - COMPACT payloads. The scale pass recomputes g and h with the same
//     payload() as the sum, so the scale is the run's true largest |g|;
//     a bound from the objective (|g| <= sigmoid x the larger weight)
//     would need no second evaluation but holds for binary only, not for
//     l2, whose g = score - label is unbounded.
//   - NaN and Inf. The scale pass takes an integer max over the bits, so
//     a non-finite g or h ranks above every finite one; such a run adds
//     that stat of each of its rows straight to the f64 sums with global
//     atomics, so NaN and Inf reach each cell as they reach the twin's.
//   - Feature tiles. A CTA holds 20 B a cell (hi/lo of g and h, a count)
//     for feat_per_block features (blockIdx.y), sized by ops/aligned.py
//     within the card's shared-memory opt-in (MSLR's 137 x 256 bins take
//     four tiles); one CTA of 1024 threads an SM, from the occupancy
//     calculator. A thread takes one row at a time; warps start on
//     different features (rotated by the warp's index) so that they add
//     to different cells, and the next bin word is loaded while the
//     current one's sites are added.
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

#include "fixed_point.cuh"
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
constexpr int kHistThreads = 1024;  // slot_hist CTAs (ops/aligned.py)

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

// ---------------------------------------------------------------------------
// The slot histogram (B4, and B2's smaller children): fixed-point shared
// cells, P1's design (proto.cu) for the engine's records
// ---------------------------------------------------------------------------
// The cells (`Cells`) and the fixed-point split (`Fixed`) are in
// fixed_point.cuh, shared with histogram.cu (B1).

// How a warp walks its feature tile's sites: the tile's features f0 ..
// f0 + nf - 1 from f0 + rot on (rot the warp's index mod nf), wrapping to
// f0; (w_rot, p_rot) and (w0, p0) are the bin word and the site in it of
// features f0 + rot and f0.
struct TileWalk {
  int bits, bpw, mask, nf, rot;
  int w_rot, p_rot, w0, p0;   // word and site of features f0 + rot, f0
  __device__ TileWalk(int b, int f0, int nf_, int warp) {
    bits = b;
    bpw = 32 / b;
    mask = (1 << b) - 1;
    nf = nf_;
    rot = warp % nf_;
    w0 = f0 / bpw;
    p0 = f0 - w0 * bpw;
    w_rot = (f0 + rot) / bpw;
    p_rot = f0 + rot - w_rot * bpw;
  }
};

// One valid row r of a chunk into the sub-histogram: each of the tile's
// features whose bin lies below num_bins, starting at the warp's feature;
// the next bin word is loaded before the current one's sites are added.
__device__ __forceinline__ void add_row(const int32_t* chunk, int C, int r,
                                        const TileWalk& t, int num_bins,
                                        const Cells& sm, unsigned gh,
                                        unsigned gl, unsigned hh,
                                        unsigned hl) {
  int fl = t.rot, w = t.w_rot, pos = t.p_rot;
  int word = __ldg(chunk + static_cast<long long>(w) * C + r);
  for (int k = 0; k < t.nf;) {
    // the sites of this word: up to the word's end, the tile's wrap or
    // the warp's last feature
    const int run = min(min(t.bpw - pos, t.nf - fl), t.nf - k);
    int nw, npos, nfl;
    if (fl + run == t.nf) {
      nfl = 0;
      nw = t.w0;
      npos = t.p0;
    } else {
      nfl = fl + run;
      nw = w + 1;
      npos = 0;
    }
    const int next = k + run < t.nf
        ? __ldg(chunk + static_cast<long long>(nw) * C + r) : 0;
    for (int j = 0; j < run; ++j) {
      const int b = (word >> ((pos + j) * t.bits)) & t.mask;
      if (b < num_bins) sm.add((fl + j) * num_bins + b, gh, gl, hh, hl);
    }
    k += run;
    fl = nfl;
    w = nw;
    pos = npos;
    word = next;
  }
}

// (g, h) into gh [num_slots, F, B, 2] f64 and the row count into cnt
// [num_slots, F, B] u32 over the valid rows (meta count) of every chunk
// with slots[c] in [0, num_slots). blockIdx.y picks a tile of
// feat_per_block features; the CTAs of one feature tile take tiles of
// tile_chunks chunks (at most 16,384 rows) in turn. Each run of one
// slot's chunks within a tile is scaled to its largest |g| and |h| (a
// first pass over the run's payloads), summed in the shared cells and
// added to the f64 sums (a stat with a non-finite value straight into
// them).
__global__ void __launch_bounds__(kHistThreads, 1)
slot_hist_kernel(const int32_t* __restrict__ rec, int W, int C, int wcnt,
                 int gh_off, int bits, int num_features, int num_bins,
                 int feat_per_block, int tile_chunks, int nc,
                 const int32_t* __restrict__ slots,
                 const int32_t* __restrict__ meta, int num_slots, int kind,
                 float sig, float wp, float wn, double* __restrict__ gh_out,
                 unsigned* __restrict__ cnt_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f0 = blockIdx.y * feat_per_block;
  const int nf = min(feat_per_block, num_features - f0);
  const int cells = nf * num_bins;
  Cells sm;
  sm.w = reinterpret_cast<unsigned*>(smem_raw);
  int* tslot = reinterpret_cast<int*>(sm.w + kCellWords * cells);
  int* tcnt = tslot + tile_chunks;                     // [tile_chunks]
  unsigned* run_max = reinterpret_cast<unsigned*>(tcnt + tile_chunks);
  for (int i = threadIdx.x; i < kCellWords * cells; i += blockDim.x) {
    sm.w[i] = 0u;
  }
  if (threadIdx.x < 2) run_max[threadIdx.x] = 0u;
  const TileWalk walk(bits, f0, nf, threadIdx.x >> 5);
  const long long cw = static_cast<long long>(W) * C;
  const int num_tiles = (nc + tile_chunks - 1) / tile_chunks;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int t0 = tile * tile_chunks;
    const int n = min(tile_chunks, nc - t0);
    __syncthreads();                     // the last tile's readers are done
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = t0 + i, s = slots[c], k = min(meta[c] & kCntMask, C);
      tslot[i] = s >= 0 && s < num_slots && k > 0 ? s : -1;
      tcnt[i] = k;
    }
    __syncthreads();
    for (int i = 0; i < n;) {            // uniform over the CTA
      const int s = tslot[i];
      int j = i + 1;
      while (j < n && tslot[j] == s) ++j;
      if (s >= 0) {
        const int nq = (j - i) * C;
        const int32_t* run = rec + static_cast<long long>(t0 + i) * cw;
        // 1. the bits of the run's largest |g| and |h|, which fix its
        //    scale (integer max: NaN and Inf rank above every finite one)
        unsigned mg = 0u, mh = 0u;
        for (int q = threadIdx.x; q < nq; q += blockDim.x) {
          const int ci = q / C, r = q - ci * C;
          if (r < tcnt[i + ci]) {
            float g, h;
            payload(run + ci * cw, C, r, wcnt, gh_off, kind, sig, wp, wn, g,
                    h);
            mg = max(mg, __float_as_uint(g) & 0x7fffffffu);
            mh = max(mh, __float_as_uint(h) & 0x7fffffffu);
          }
        }
        mg = __reduce_max_sync(kFull, mg);
        mh = __reduce_max_sync(kFull, mh);
        if ((threadIdx.x & 31) == 0) {
          atomicMax(run_max, mg);
          atomicMax(run_max + 1, mh);
        }
        __syncthreads();
        const int nb = 32 - __clz(nq - 1);   // rows <= 2^nb
        const Fixed fg(run_max[0], nb), fh(run_max[1], nb);
        const long long base =
            (static_cast<long long>(s) * num_features + f0) * num_bins;
        sm.sums = gh_out + 2 * base;
        sm.gx = fg.exact;
        sm.hx = fh.exact;
        // 2. the run's rows into the sub-histogram, one row a thread
        for (int q = threadIdx.x; q < nq; q += blockDim.x) {
          const int ci = q / C, r = q - ci * C;
          if (r >= tcnt[i + ci]) continue;
          const int32_t* chunk = run + ci * cw;
          float g, h;
          payload(chunk, C, r, wcnt, gh_off, kind, sig, wp, wn, g, h);
          unsigned gh, gl, hh, hl;
          fg.split(g, gh, gl);
          fh.split(h, hh, hl);
          add_row(chunk, C, r, walk, num_bins, sm, gh, gl, hh, hl);
        }
        __syncthreads();
        if (threadIdx.x < 2) run_max[threadIdx.x] = 0u;
        // 3. the run into the f64 sums, one atomic a cell and stat
        for (int c = threadIdx.x; c < cells; c += blockDim.x) {
          unsigned* p = sm.w + kCellWords * c;
          const unsigned k = p[kN];
          if (k == 0u) continue;
          if (!fg.exact) {
            atomicAdd(gh_out + 2 * (base + c), fg.value(p[kGHi], p[kGLo]));
          }
          if (!fh.exact) {
            atomicAdd(gh_out + 2 * (base + c) + 1,
                      fh.value(p[kHHi], p[kHLo]));
          }
          atomicAdd(cnt_out + base + c, k);
#pragma unroll
          for (int u = 0; u < kCellWords; ++u) p[u] = 0u;
        }
        __syncthreads();
      }
      i = j;
    }
  }
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
// score and meta lanes. feat_per_block, tile_chunks, grid_x and smem are
// the launch shape of ops/aligned.py::slot_hist_launch_shape.
int lgbt_slot_hist(const void* rec, int nc, int W, int C, int wcnt,
                   int gh_off, int bits, int num_features, int num_bins,
                   int feat_per_block, int tile_chunks, int grid_x, int smem,
                   const void* slots, const void* meta, int num_slots,
                   int kind, float sig, float wp, float wn, void* gh,
                   void* cnt, void* out, void* stream) {
  if (nc == 0 || num_features == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      slot_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid_y = (num_features + feat_per_block - 1) / feat_per_block;
  slot_hist_kernel<<<dim3(grid_x, grid_y), kHistThreads, smem, s>>>(
      static_cast<const int32_t*>(rec), W, C, wcnt, gh_off, bits,
      num_features, num_bins, feat_per_block, tile_chunks, nc,
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

// CTAs of slot_hist_kernel that the CUDA occupancy calculator fits on an
// SM of the current device with `smem` bytes of dynamic shared memory
// each; 0 where they do not fit, -1 on a CUDA error.
int lgbt_slot_hist_occupancy(int smem) {
  int n = -1;
  if (cudaFuncSetAttribute(slot_hist_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess) {
    cudaGetLastError();                  // too much: clear the error
    return 0;
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, slot_hist_kernel, kHistThreads, smem) != cudaSuccess) {
    return -1;
  }
  return n;
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
