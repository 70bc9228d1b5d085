// The prototype kernels of the chunk-aligned pipeline for Hopper (sm_90a):
// the slot-mapped histogram (P1), the stable two-way partition of every
// block of chunks (P2) and the in-chunk split into two rings (P3).
//
// Replaces the TPU kernels of the measurement harnesses under tools/:
//   P1 slot_hist (_slot_hist_kernel, pallas_call at proto_aligned.py:127)
//   P2 move      (_move_kernel, pallas_call at proto_aligned.py:299)
//   P3 bench     (kernel_route4c and kernel_compact_roll, pallas_call at
//                 proto_roll.py:141)
// which the aligned engine's B4 and B2 (aligned.cu) were derived from.
//
// Records are [nc, 16, C] int32, chunk-major with each lane a contiguous
// run of C words: seven packed bin words (byte f & 3 of word f >> 2 is the
// bin of feature f), then g and h as f32 bit patterns in lanes 7 and 8.
//
// What the TPU kernels do that has no counterpart here: they walk the
// chunks in grid order on one core and carry state from step to step (the
// slot's output block, each block's left/right fills, the ring cursors);
// they rank rows with a triangular MXU matmul and move them with
// byte-plane one-hot matmuls through staging rings in VMEM, flushed by
// DMA. CUDA blocks run in no order, so each sequential dependence becomes
// a count and a scan:
//   P1 run_start_kernel marks, for each slot, the first chunk of its last
//      run of consecutive chunks (the Pallas kernel zeroes the slot's
//      block at each run's first chunk, so only the last run survives);
//      slot_hist_kernel then sums the chunks of those runs as B4 does:
//      shared-memory f64 g/h and u32 counts per feature tile, flushed with
//      global atomics when the slot changes, rounded to f32 once;
//   P2 move_count_kernel counts each chunk's left rows, move_scan_kernel
//      (one CTA) scans them within each block, move_scatter_kernel ranks
//      each chunk's rows with warp ballots and writes all 16 lanes of a
//      row to its destination: B2's design without the histogram; no
//      staging ring is needed;
//   P3 ring_count_kernel counts each chunk's left rows, ring_scan_kernel
//      (one CTA) gives every row its index among its side's rows (left
//      row L sits at ring position L mod 2C of its lap L / 2C), and
//      ring_laps_kernel finds, for each lap, the first position the
//      non-wrapping variant writes (the rows of a chunk that began in the
//      lap before pass the ring's end and are dropped). ring_resolve_
//      kernel then gives each of the 4C ring positions one warp, which
//      finds the last row written there (the last lap that reaches it,
//      the chunk by binary search, the row by ballots over its lane 0) and
//      copies that row's 16 lanes. Only lane 0 of every row is read, and
//      whole rows only for the 4C rows that end in the staging.
//
// What bounds them on an H100: bytes. P1 reads the seven bin words and
// the two payload lanes of every valid row (36 B) and writes the slots'
// histograms; P2 reads and writes every valid row (64 B each way); P3
// reads lane 0 of every row. The arithmetic is a few integer operations a
// row (P1: 3 adds a row and feature) and far below the card's rates.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 16;                 // record lanes
constexpr int kWords = 7;              // packed bin words (28 features)
constexpr int kLaneG = kWords, kLaneH = kWords + 1;
constexpr int kStats = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;          // move count/scatter CTAs
constexpr int kScanThreads = 1024;
constexpr int kRollThreshold = 31;     // P3: left iff (lane 0 & 255) <= 31
// move params columns
constexpr int kWsel = 0, kShift = 1, kThr = 2, kBaseL = 3, kBaseR = 4;
constexpr int kFirst = 5, kLast = 6, kCnt = 7, kParams = 8;

int check() { return static_cast<int>(cudaGetLastError()); }

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

// ---------------------------------------------------------------------------
// P1: slot-mapped histogram
// ---------------------------------------------------------------------------
// last_start[s] (-1 by the caller) = the first chunk of slot s's last run
// of consecutive chunks; every chunk of slot s before it is dropped.
__global__ void run_start_kernel(const int32_t* __restrict__ slots, int nc,
                                 int num_slots,
                                 int32_t* __restrict__ last_start) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < nc;
       c += gridDim.x * blockDim.x) {
    const int s = slots[c];
    if (s < 0 || s >= num_slots) continue;
    if (c == 0 || slots[c - 1] != s) atomicMax(last_start + s, c);
  }
}

// (g, h) into gh [num_slots, F, b_pad, 2] f64 and the count into cnt
// [num_slots, F, b_pad] u32 over the rows r < cnts[c] of every kept chunk.
// A CTA walks a fixed range of chunks for one feature tile and flushes its
// shared sub-histogram whenever the slot changes.
__global__ void slot_hist_kernel(const int32_t* __restrict__ rec, int C,
                                 int nc, int num_features, int b_pad,
                                 int feat_per_block, int chunks_per_block,
                                 const int32_t* __restrict__ slots,
                                 const int32_t* __restrict__ cnts,
                                 const int32_t* __restrict__ last_start,
                                 int num_slots, double* __restrict__ gh_out,
                                 unsigned* __restrict__ cnt_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f0 = blockIdx.y * feat_per_block;
  const int nf = min(feat_per_block, num_features - f0);
  const int cells = nf * b_pad;
  double* sh = reinterpret_cast<double*>(smem_raw);             // [cells, 2]
  unsigned* sc = reinterpret_cast<unsigned*>(sh + 2 * cells);   // [cells]
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    sh[2 * i] = 0.0;
    sh[2 * i + 1] = 0.0;
    sc[i] = 0u;
  }
  __syncthreads();
  const int c0 = blockIdx.x * chunks_per_block;
  const int c1 = min(nc, c0 + chunks_per_block);
  int cur = -1;
  bool dirty = false;

  auto flush = [&]() {
    __syncthreads();
    const long long base = (static_cast<long long>(cur) * num_features + f0)
        * b_pad;
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

  for (int c = c0; c < c1; ++c) {        // uniform over the CTA
    const int s = slots[c];
    if (s < 0 || s >= num_slots || c < last_start[s]) continue;
    const int cnt = min(cnts[c], C);
    if (cnt <= 0) continue;
    if (s != cur) {
      if (dirty) flush();
      cur = s;
    }
    dirty = true;
    const int32_t* chunk = rec + static_cast<long long>(c) * kW * C;
    for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
      const double g = __int_as_float(chunk[kLaneG * C + r]);
      const double h = __int_as_float(chunk[kLaneH * C + r]);
      int wi = -1, word = 0;
      for (int f = 0; f < nf; ++f) {
        const int ff = f0 + f, w = ff >> 2;
        if (w != wi) {
          word = chunk[w * C + r];
          wi = w;
        }
        const int b = (word >> ((ff & 3) * 8)) & 255;
        if (b < b_pad) {
          const int cell = f * b_pad + b;
          atomicAdd(sh + 2 * cell, g);
          atomicAdd(sh + 2 * cell + 1, h);
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

// ---------------------------------------------------------------------------
// P2: move
// ---------------------------------------------------------------------------
// the rows of chunk c: (wsel, shift, thr) of its params, valid rows
// min(cnt, C)
struct MoveChunk {
  const int32_t* word;   // nullptr: word 0 (wsel >= 7)
  int shift, thr, cnt;
};

__device__ __forceinline__ MoveChunk move_chunk(const int32_t* rec, int C,
                                                const int32_t* p,
                                                long long c) {
  MoveChunk m;
  const int wsel = p[kWsel];
  m.word = wsel < kWords
      ? rec + (c * kW + wsel) * static_cast<long long>(C) : nullptr;
  m.shift = p[kShift];
  m.thr = p[kThr];
  m.cnt = min(p[kCnt], C);
  return m;
}

__device__ __forceinline__ bool move_left(const MoveChunk& m, int r) {
  const int word = m.word != nullptr ? m.word[r] : 0;
  return ((word >> m.shift) & 255) <= m.thr;      // arithmetic shift
}

__device__ __forceinline__ bool move_block_start(const int32_t* params,
                                                 int c) {
  return c == 0 || params[c * kParams + kFirst] != 0
      || params[(c - 1) * kParams + kLast] != 0;
}

// left rows per chunk, one CTA a chunk
__global__ void move_count_kernel(const int32_t* __restrict__ rec, int C,
                                  const int32_t* __restrict__ params,
                                  int32_t* __restrict__ lcnt) {
  const long long c = blockIdx.x;
  const MoveChunk m = move_chunk(rec, C, params + c * kParams, c);
  int n = 0;
  for (int r = threadIdx.x; r < m.cnt; r += blockDim.x) {
    n += move_left(m, r) ? 1 : 0;
  }
  const int total = block_sum(n);
  if (threadIdx.x == 0) lcnt[c] = total;
}

// One CTA: exclusive left/right prefixes of each chunk within its block.
__global__ void move_scan_kernel(int nc, int C,
                                 const int32_t* __restrict__ params,
                                 const int32_t* __restrict__ lcnt,
                                 int32_t* __restrict__ pl,
                                 int32_t* __restrict__ pr) {
  __shared__ int tl[kScanThreads], tv[kScanThreads], th[kScanThreads];
  const int t = threadIdx.x, T = blockDim.x;
  const int per = (nc + T - 1) / T;
  const int lo = min(nc, t * per), hi = min(nc, lo + per);
  int sl = 0, sv = 0, has = 0;
  for (int c = lo; c < hi; ++c) {
    if (move_block_start(params, c)) { sl = 0; sv = 0; has = 1; }
    sl += lcnt[c];
    sv += min(params[c * kParams + kCnt], C);
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
    if (move_block_start(params, c)) { rl = 0; rv = 0; }
    pl[c] = rl;
    pr[c] = rv - rl;
    rl += lcnt[c];
    rv += min(params[c * kParams + kCnt], C);
  }
}

// One CTA a chunk: its valid rows go, in row order, to the left rows'
// chunks from baseL or the right rows' from baseR, after the block's
// earlier rows; every lane moves, and a destination chunk outside
// [0, nc_out) drops the row.
__global__ void move_scatter_kernel(const int32_t* __restrict__ rec, int C,
                                    int nc_out,
                                    const int32_t* __restrict__ params,
                                    const int32_t* __restrict__ pl,
                                    const int32_t* __restrict__ pr,
                                    int32_t* __restrict__ out) {
  __shared__ int wl[kThreads / 32], wr[kThreads / 32];
  const long long c = blockIdx.x;
  const int32_t* p = params + c * kParams;
  const MoveChunk m = move_chunk(rec, C, p, c);
  if (m.cnt <= 0) return;
  const long long cw = static_cast<long long>(kW) * C;
  const int32_t* src = rec + c * cw;
  const long long bl = p[kBaseL], br = p[kBaseR];
  int run_l = pl[c], run_r = pr[c];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int t0 = 0; t0 < m.cnt; t0 += blockDim.x) {
    const int r = t0 + threadIdx.x;
    const bool valid = r < m.cnt;
    const bool left = valid && move_left(m, r);
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
      const long long d = left ? run_l + off_l + __popc(ml & below)
                               : run_r + off_r + __popc(mr & below);
      const long long dc = (left ? bl : br) + d / C;
      if (dc >= 0 && dc < nc_out) {
        int32_t* dst = out + dc * cw + d % C;
        for (int u = 0; u < kW; ++u) {
          dst[static_cast<long long>(u) * C] =
              src[static_cast<long long>(u) * C + r];
        }
      }
    }
    run_l += tot_l;
    run_r += tot_r;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// P3: ring staging
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool roll_left(int key) {
  return (key & 255) <= kRollThreshold;
}

// left rows per chunk, one warp a chunk (lane 0 of its record)
__global__ void ring_count_kernel(const int32_t* __restrict__ rec, int n,
                                  int C, int32_t* __restrict__ kl) {
  const long long c =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= n) return;                   // whole warps
  const int32_t* key = rec + c * kW * C;
  int k = 0;
  for (int r = lane; r < C; r += 32) k += roll_left(key[r]) ? 1 : 0;
  for (int o = 16; o > 0; o >>= 1) k += __shfl_down_sync(kFull, k, o);
  if (lane == 0) kl[c] = k;
}

// One CTA: prefix[c] = left rows of the chunks before c, prefix[n] = all.
__global__ void ring_scan_kernel(int n, const int32_t* __restrict__ kl,
                                 int32_t* __restrict__ prefix) {
  __shared__ int part[kScanThreads];
  const int t = threadIdx.x, T = blockDim.x;
  const int per = (n + T - 1) / T;
  const int lo = min(n, t * per), hi = min(n, lo + per);
  int s = 0;
  for (int c = lo; c < hi; ++c) s += kl[c];
  part[t] = s;
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int i = 0; i < T; ++i) {
      const int a = part[i];
      part[i] = run;
      run += a;
    }
  }
  __syncthreads();
  int run = part[t];
  for (int c = lo; c < hi; ++c) {
    prefix[c] = run;
    run += kl[c];
  }
  if (lo < hi && hi == n) prefix[n] = run;
}

// the side's rows before chunk c (left: the scan; right: the rest)
__device__ __forceinline__ int side_prefix(const int32_t* prefix, int C,
                                           int side, int c) {
  return side ? c * C - prefix[c] : prefix[c];
}

// laps[side][m] (0x7f7f7f7f, above any position, where set by the
// memset) = the first ring position written in lap m: prefix - m * 2C of
// the first chunk that starts in the lap; the side's rows m * 2C .. before
// it belong to a chunk that began in lap m - 1, whose non-wrapping cursor
// passes the ring's end there.
__global__ void ring_laps_kernel(int n, int C,
                                 const int32_t* __restrict__ prefix,
                                 int32_t* __restrict__ laps_l,
                                 int32_t* __restrict__ laps_r) {
  const int C2 = 2 * C;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += gridDim.x * blockDim.x) {
    for (int side = 0; side < 2; ++side) {
      const int pc = side_prefix(prefix, C, side, c);
      const int pp = c == 0 ? -1 : side_prefix(prefix, C, side, c - 1);
      const int m = pc / C2;
      if (static_cast<long long>(m) * C2 > pp) {
        (side ? laps_r : laps_l)[m] = pc - m * C2;
      }
    }
  }
}

// One warp a ring position q of the staging [16, 4C] (left ring [0, 2C),
// right ring [2C, 4C)): the side's row L that was written there last, its
// 16 lanes; 0 where no row was. A row L (the L-th of its side, in chunk
// and row order) goes to position L mod 2C in lap L / 2C; with wrap every
// row is written, without wrap only from the lap's first position on.
__global__ void ring_resolve_kernel(const int32_t* __restrict__ rec, int n,
                                    int C, int wrap,
                                    const int32_t* __restrict__ prefix,
                                    const int32_t* __restrict__ laps_l,
                                    const int32_t* __restrict__ laps_r,
                                    int32_t* __restrict__ stag) {
  const int q = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const int C2 = 2 * C;
  if (q >= 2 * C2) return;              // whole warps
  const int side = q >= C2 ? 1 : 0;
  const int p = q - side * C2;
  const int total = side ? n * C - prefix[n] : prefix[n];
  int m = total > p ? (total - 1 - p) / C2 : -1;   // last lap reaching p
  if (!wrap) {
    const int32_t* laps = side ? laps_r : laps_l;
    while (m >= 0) {                    // uniform over the warp
      const int mm = m - lane;
      const unsigned hit = __ballot_sync(kFull, mm >= 0 && laps[mm] <= p);
      if (hit != 0u) {
        m -= __ffs(hit) - 1;
        break;
      }
      m -= 32;
    }
  }
  int32_t val = 0;
  if (m >= 0) {
    const int L = m * C2 + p;
    int lo = 0, hi = n - 1;             // last chunk with prefix <= L
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (side_prefix(prefix, C, side, mid) <= L) lo = mid; else hi = mid - 1;
    }
    const int32_t* chunk = rec + static_cast<long long>(lo) * kW * C;
    int j = L - side_prefix(prefix, C, side, lo);
    int r = -1;
    for (int r0 = 0; r0 < C; r0 += 32) {
      const int rr = r0 + lane;
      const bool mine = rr < C && (roll_left(chunk[rr]) != (side != 0));
      const unsigned b = __ballot_sync(kFull, mine);
      const int k = __popc(b);
      if (j < k) {
        const unsigned me = __ballot_sync(
            kFull, mine && __popc(b & ((1u << lane) - 1u)) == j);
        r = r0 + __ffs(me) - 1;
        break;
      }
      j -= k;
    }
    if (lane < kW && r >= 0) val = chunk[static_cast<long long>(lane) * C + r];
  }
  if (lane < kW) stag[static_cast<long long>(lane) * 2 * C2 + q] = val;
}

}  // namespace

extern "C" {

// P1: out [num_slots, F, b_pad, 3] f32. last_start [num_slots] i32, gh
// [num_slots, F, b_pad, 2] f64 and cnt [num_slots, F, b_pad] u32 are
// scratch (set here). Returns the CUDA error code (0 = ok).
int lgbt_proto_slot_hist(const void* rec, int nc, int C, const void* slots,
                         const void* cnts, int num_slots, int num_features,
                         int b_pad, int feat_per_block, int blocks_x,
                         int threads, void* last_start, void* gh, void* cnt,
                         void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells =
      static_cast<long long>(num_slots) * num_features * b_pad;
  cudaError_t e = cudaMemsetAsync(last_start, 0xff, sizeof(int32_t)
                                  * static_cast<size_t>(num_slots), s);
  if (e == cudaSuccess) {
    e = cudaMemsetAsync(gh, 0, 2 * sizeof(double) * cells, s);
  }
  if (e == cudaSuccess) {
    e = cudaMemsetAsync(cnt, 0, sizeof(unsigned) * cells, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  if (nc > 0) {
    run_start_kernel<<<(nc + 255) / 256, 256, 0, s>>>(
        sl, nc, num_slots, static_cast<int32_t*>(last_start));
    int err = check();
    if (err != 0) return err;
    const size_t smem = static_cast<size_t>(feat_per_block) * b_pad
        * (2 * sizeof(double) + sizeof(unsigned));
    e = cudaFuncSetAttribute(slot_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int grid_y = (num_features + feat_per_block - 1) / feat_per_block;
    const int cpb = (nc + blocks_x - 1) / blocks_x;
    slot_hist_kernel<<<dim3(blocks_x, grid_y), threads, smem, s>>>(
        static_cast<const int32_t*>(rec), C, nc, num_features, b_pad,
        feat_per_block, cpb, sl, static_cast<const int32_t*>(cnts),
        static_cast<const int32_t*>(last_start), num_slots,
        static_cast<double*>(gh), static_cast<unsigned*>(cnt));
    err = check();
    if (err != 0) return err;
  }
  const int fin_threads = 256;
  hist_finalize_kernel<<<static_cast<unsigned>((cells + fin_threads - 1)
                                               / fin_threads),
                         fin_threads, 0, s>>>(
      static_cast<const double*>(gh), static_cast<const unsigned*>(cnt),
      cells, static_cast<float*>(out));
  return check();
}

// P2: out [nc_out, 16, C]; params [nc, 8] int32 (wsel, shift, thr,
// baseL, baseR, first, last, cnt), checked by the caller (shift in
// [0, 32), cnt >= 0); lcnt, pl, pr: [nc] scratch.
int lgbt_proto_move(const void* rec, int nc, int C, const void* params,
                    int nc_out, void* lcnt, void* pl, void* pr, void* out,
                    void* stream) {
  if (nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* rr = static_cast<const int32_t*>(rec);
  const int32_t* pa = static_cast<const int32_t*>(params);
  move_count_kernel<<<nc, kThreads, 0, s>>>(rr, C, pa,
                                            static_cast<int32_t*>(lcnt));
  int err = check();
  if (err != 0) return err;
  move_scan_kernel<<<1, kScanThreads, 0, s>>>(
      nc, C, pa, static_cast<const int32_t*>(lcnt),
      static_cast<int32_t*>(pl), static_cast<int32_t*>(pr));
  err = check();
  if (err != 0) return err;
  move_scatter_kernel<<<nc, kThreads, 0, s>>>(
      rr, C, nc_out, pa, static_cast<const int32_t*>(pl),
      static_cast<const int32_t*>(pr), static_cast<int32_t*>(out));
  return check();
}

// P3: stag [16, 4C] = the two rings after every chunk of rec [n, 16, C]
// (wrap 0: kernel_route4c, 1: kernel_compact_roll); kl [n], prefix
// [n + 1], laps_l and laps_r [n + 2] int32 scratch (set here).
int lgbt_proto_ring_stage(const void* rec, int n, int C, int wrap, void* kl,
                          void* prefix, void* laps_l, void* laps_r,
                          void* stag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    return static_cast<int>(cudaMemsetAsync(
        stag, 0, sizeof(int32_t) * kW * 4 * static_cast<size_t>(C), s));
  }
  const int32_t* rr = static_cast<const int32_t*>(rec);
  int32_t* pk = static_cast<int32_t*>(kl);
  int32_t* pp = static_cast<int32_t*>(prefix);
  int32_t* ll = static_cast<int32_t*>(laps_l);
  int32_t* lr = static_cast<int32_t*>(laps_r);
  const int warps_per_cta = kThreads / 32;
  ring_count_kernel<<<(n + warps_per_cta - 1) / warps_per_cta, kThreads, 0,
                      s>>>(rr, n, C, pk);
  int err = check();
  if (err != 0) return err;
  ring_scan_kernel<<<1, kScanThreads, 0, s>>>(n, pk, pp);
  err = check();
  if (err != 0) return err;
  if (!wrap) {
    const size_t laps_bytes = sizeof(int32_t) * (static_cast<size_t>(n) + 2);
    cudaError_t e = cudaMemsetAsync(ll, 0x7f, laps_bytes, s);  // > any p
    if (e == cudaSuccess) e = cudaMemsetAsync(lr, 0x7f, laps_bytes, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    ring_laps_kernel<<<(n + 255) / 256, 256, 0, s>>>(n, C, pp, ll, lr);
    err = check();
    if (err != 0) return err;
  }
  const int positions = 4 * C;
  ring_resolve_kernel<<<(positions + warps_per_cta - 1) / warps_per_cta,
                        kThreads, 0, s>>>(rr, n, C, wrap, pp, ll, lr,
                                          static_cast<int32_t*>(stag));
  return check();
}

// Largest dynamic shared memory a block may opt in to on `device`.
int lgbt_proto_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

}  // extern "C"
