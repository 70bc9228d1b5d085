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
//      slot_hist_kernel then sums the chunks of those runs into f64 (its
//      design is below) and hist_finalize_kernel rounds them to f32 once;
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
// row (P1: 3 adds a row and feature) and far below the card's rates. What
// holds P1 back in practice is its shared-memory atomics: five for every
// (row, feature) whose bin lies below b_pad.
//
// P1's design (it was B4's until it was redesigned for Hopper):
//   - Accumulation in 32-bit shared cells with native integer atomics. On
//     sm_90a an f32 or f64 atomicAdd on shared memory, and a 64-bit
//     integer one, compiles to a compare-and-swap loop (ATOMS.CAST.SPIN,
//     .64); a 32-bit integer add is one ATOMS.ADD (cuobjdump -sass). So
//     each run of one slot's chunks takes a scale from its largest |g|
//     and |h| (a first pass over the run's two payload lanes), and each
//     value v is split into two int32 words, v * 2^e = hi + lo * 2^-l,
//     rounded once, in lo. With at most 2^nb rows in a run, m < 2^ex the
//     run's largest |v|, e = 30 - nb - ex and l = 31 - nb, neither word's
//     sum can overflow and a run's sum is off by at most m * 2^(3 nb -
//     61): 1.9e-6 m for runs of up to 16384 rows, where m is at most the
//     slot's sum of |v|. Counts are u32 (ATOMS.POPC.INC). At the end of
//     a run each cell is decoded in f64 and added to the global f64 sums
//     (REDG.E.ADD.F64, native); hist_finalize_kernel rounds once.
//   - NaN and Inf. The first pass takes the largest |value| as an integer
//     max over the bits (fmaxf would skip a NaN), so a non-finite g or h
//     ranks above every finite one; such a run adds that stat of each of
//     its rows straight to the f64 sums with global atomics, and NaN and
//     Inf reach each cell as they reach the plain version's f64 sum.
//   - One CTA of 1024 threads an SM (at most 64 registers a thread; ptxas
//     gives it 61), which on the H100 ran faster at every b_pad than CTAs
//     of 256 or 512 threads with more registers, one or more to an SM. CTAs take tiles of 16384
//     rows (whole chunks) in turn, and stage a tile's slot, kept flag and
//     count per chunk in shared memory once.
//   - A thread takes one row at a time (consecutive threads, consecutive
//     rows: each lane's loads coalesce) and loads all nine lanes before it
//     adds, so the row's loads are in flight together. Two rows a thread
//     (two row pointers, or one pointer to rows 2k and 2k + 1) ran out of
//     registers and lost on the H100 at b_pad 64 and 256.
//   - Warps start on different bin words (rotated by the warp's index).
//     A warp adds a word's 4 feature sites one by one when the busiest
//     lane has more than two of them in a bin, else in a loop over each
//     lane's sites that are, which issues as many atomics as the busiest
//     lane has sites: at a small b_pad most bins fall outside it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 16;                 // record lanes
constexpr int kWords = 7;              // packed bin words (28 features)
constexpr int kLaneG = kWords, kLaneH = kWords + 1;
constexpr int kStats = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;          // move count/scatter CTAs
constexpr int kHistThreads = 1024;     // P1 slot_hist CTAs (ops/proto.py)
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

// The CTA's sub-histogram: per cell the hi and lo int32 words of g and h
// in fixed point and a u32 count, each added with one native
// shared-memory integer atomic. A run whose g (h) holds a non-finite value
// adds that stat straight to the slot's f64 sums instead (gx, hx), so that
// NaN and Inf reach its cells as they reach an f64 sum.
struct Cells {
  unsigned *ghi, *glo, *hhi, *hlo, *n;   // [cells] each
  double* sums;                          // the run's slot: [cells, 2] f64
  bool gx, hx;
  __device__ void add(int cell, unsigned gh, unsigned gl, unsigned hh,
                      unsigned hl) const {
    if (gx) {
      atomicAdd(sums + 2 * cell, static_cast<double>(__uint_as_float(gh)));
    } else {
      atomicAdd(ghi + cell, gh);
      atomicAdd(glo + cell, gl);
    }
    if (hx) {
      atomicAdd(sums + 2 * cell + 1,
                static_cast<double>(__uint_as_float(hh)));
    } else {
      atomicAdd(hhi + cell, hh);
      atomicAdd(hlo + cell, hl);
    }
    atomicAdd(n + cell, 1u);
  }
};

// The fixed-point form of one run's f32 values, at most 2^nb of them,
// whose largest |v| has the bits mbits (those of |v| order as the values
// do, and NaN and Inf lie above every finite one): v * 2^e = hi + lo *
// 2^-l, hi and lo rounded to integers, so that 2^nb of either sum within
// 2^30. A non-finite largest |v| makes the run exact: split passes the
// value's bits through in hi.
struct Fixed {
  int e, l;
  bool exact;
  __device__ Fixed(unsigned mbits, int nb) {
    exact = mbits >= 0x7f800000u;
    int ex = 0;
    if (!exact) frexpf(__uint_as_float(mbits), &ex);   // |v| < 2^ex
    e = 30 - nb - ex;
    l = 31 - nb;
  }
  __device__ void split(float v, unsigned& hi, unsigned& lo) const {
    if (exact) {
      hi = __float_as_uint(v);
      lo = 0u;
      return;
    }
    const float x = scalbnf(v, e);
    const float r = rintf(x);
    hi = static_cast<unsigned>(static_cast<int>(r));
    lo = static_cast<unsigned>(__float2int_rn(scalbnf(x - r, l)));
  }
  __device__ double value(unsigned hi, unsigned lo) const {
    return ldexp(static_cast<double>(static_cast<int>(hi))
                 + ldexp(static_cast<double>(static_cast<int>(lo)), -l), -e);
  }
};

// One row of a chunk (none when !valid) into the sub-histogram; every
// lane of the warp calls it. Word slot w holds bin word (w + rot) mod
// nwords. Of a word's 4 feature sites, those whose bin lies below b_pad
// are added: site by site when the busiest lane has more than two of
// them, else in a loop over each lane's own.
__device__ __forceinline__ void add_row(const int32_t* p, int C, bool valid,
                                        int num_features, int nwords,
                                        int rot, int b_pad, const Cells& sm,
                                        const Fixed& fg, const Fixed& fh) {
  const float g = __int_as_float(__ldg(p + kLaneG * C));
  const float h = __int_as_float(__ldg(p + kLaneH * C));
  int word[kWords], lane_of[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    int lw = w + rot;
    lw -= lw >= nwords ? nwords : 0;
    lane_of[w] = lw;
    word[w] = w < nwords ? __ldg(p + static_cast<long long>(lw) * C) : 0;
  }
  unsigned gh, gl, hh, hl;
  fg.split(g, gh, gl);
  fh.split(h, hh, hl);
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    if (w >= nwords) break;
    const int f0 = 4 * lane_of[w];
    unsigned m = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = (word[w] >> (8 * j)) & 255;
      if (valid && f0 + j < num_features && b < b_pad) m |= 1u << j;
    }
    if (__reduce_max_sync(kFull, __popc(m)) > 2) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((m >> j) & 1u) {
          sm.add((f0 + j) * b_pad + ((word[w] >> (8 * j)) & 255), gh, gl, hh,
                 hl);
        }
      }
    } else {
      while (m != 0u) {
        const int j = __ffs(m) - 1;
        m &= m - 1u;
        sm.add((f0 + j) * b_pad + ((word[w] >> (8 * j)) & 255), gh, gl, hh,
               hl);
      }
    }
  }
}

// (g, h) into gh [num_slots, F, b_pad, 2] f64 and the count into cnt
// [num_slots, F, b_pad] u32 over the rows r < cnts[c] of every kept chunk.
// CTAs take tiles of tile_chunks chunks in turn; each run of one slot
// within a tile is scaled, summed in the shared cells and added to the
// f64 sums (a stat with a non-finite value straight into them).
__global__ void __launch_bounds__(kHistThreads)
slot_hist_kernel(const int32_t* __restrict__ rec, int C, int nc,
                 int num_features, int b_pad, int tile_chunks,
                 const int32_t* __restrict__ slots,
                 const int32_t* __restrict__ cnts,
                 const int32_t* __restrict__ last_start, int num_slots,
                 double* __restrict__ gh_out, unsigned* __restrict__ cnt_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cells = num_features * b_pad;
  Cells sm;
  sm.ghi = reinterpret_cast<unsigned*>(smem_raw);
  sm.glo = sm.ghi + cells;
  sm.hhi = sm.glo + cells;
  sm.hlo = sm.hhi + cells;
  sm.n = sm.hlo + cells;
  int* tslot = reinterpret_cast<int*>(sm.n + cells);   // [tile_chunks]
  int* tcnt = tslot + tile_chunks;                     // [tile_chunks]
  unsigned* run_max = reinterpret_cast<unsigned*>(tcnt + tile_chunks);
  for (int i = threadIdx.x; i < 5 * cells; i += blockDim.x) sm.ghi[i] = 0u;
  if (threadIdx.x < 2) run_max[threadIdx.x] = 0u;
  const int nwords = (num_features + 3) >> 2;
  const int rot = (threadIdx.x >> 5) % nwords;
  const int num_tiles = (nc + tile_chunks - 1) / tile_chunks;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int t0 = tile * tile_chunks;
    const int n = min(tile_chunks, nc - t0);
    __syncthreads();                     // the last tile's readers are done
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = t0 + i, s = slots[c], k = min(cnts[c], C);
      const bool keep = s >= 0 && s < num_slots && k > 0
          && c >= last_start[s];
      tslot[i] = keep ? s : -1;
      tcnt[i] = k;
    }
    __syncthreads();
    for (int i = 0; i < n;) {            // uniform over the CTA
      const int s = tslot[i];
      int j = i + 1;
      while (j < n && tslot[j] == s) ++j;
      if (s >= 0) {
        const int nq = (j - i) * C;
        const int32_t* run = rec + static_cast<long long>(t0 + i) * kW * C;
        // row q of the run: its address, and whether it is valid
        auto row = [&](int q, const int32_t*& p) {
          const int qq = min(q, nq - 1);
          const int ci = qq / C;
          const int r = qq - ci * C;
          p = run + static_cast<long long>(ci) * kW * C + r;
          return q < nq && r < tcnt[i + ci];
        };
        // 1. the bits of the run's largest |g| and |h|, which fix its
        //    scale (integer max: NaN and Inf rank above every finite one)
        unsigned mg = 0u, mh = 0u;
        for (int q = threadIdx.x; q < nq; q += blockDim.x) {
          const int32_t* p;
          if (row(q, p)) {
            mg = max(mg, static_cast<unsigned>(__ldg(p + kLaneG * C))
                         & 0x7fffffffu);
            mh = max(mh, static_cast<unsigned>(__ldg(p + kLaneH * C))
                         & 0x7fffffffu);
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
        const long long base = static_cast<long long>(s) * cells;
        sm.sums = gh_out + 2 * base;
        sm.gx = fg.exact;
        sm.hx = fh.exact;
        // 2. the run's rows into the sub-histogram (whole warps)
        for (int q0 = 0; q0 < nq; q0 += blockDim.x) {
          const int32_t* p;
          const bool valid = row(q0 + threadIdx.x, p);
          add_row(p, C, valid, num_features, nwords, rot, b_pad, sm, fg, fh);
        }
        __syncthreads();
        if (threadIdx.x < 2) run_max[threadIdx.x] = 0u;
        // 3. the run into the f64 sums, one atomic a cell and stat
        for (int c = threadIdx.x; c < cells; c += blockDim.x) {
          const unsigned k = sm.n[c];
          if (k == 0u) continue;
          if (!fg.exact) {
            atomicAdd(gh_out + 2 * (base + c), fg.value(sm.ghi[c], sm.glo[c]));
          }
          if (!fh.exact) {
            atomicAdd(gh_out + 2 * (base + c) + 1,
                      fh.value(sm.hhi[c], sm.hlo[c]));
          }
          atomicAdd(cnt_out + base + c, k);
          sm.ghi[c] = 0u;
          sm.glo[c] = 0u;
          sm.hhi[c] = 0u;
          sm.hlo[c] = 0u;
          sm.n[c] = 0u;
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
// scratch (set here). tile_chunks, grid and smem are the launch shape of
// ops/proto.py::slot_hist_launch_shape. Returns the CUDA error code (0 =
// ok).
int lgbt_proto_slot_hist(const void* rec, int nc, int C, const void* slots,
                         const void* cnts, int num_slots, int num_features,
                         int b_pad, int tile_chunks, int grid, int smem,
                         void* last_start, void* gh, void* cnt, void* out,
                         void* stream) {
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
    e = cudaFuncSetAttribute(slot_hist_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    slot_hist_kernel<<<grid, kHistThreads, smem, s>>>(
        static_cast<const int32_t*>(rec), C, nc, num_features, b_pad,
        tile_chunks, sl, static_cast<const int32_t*>(cnts),
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

// CTAs of slot_hist_kernel that the CUDA occupancy calculator fits on an
// SM of the current device with `smem` bytes of dynamic shared memory
// each; 0 where they do not fit, -1 on a CUDA error.
int lgbt_proto_slot_hist_occupancy(int smem) {
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

}  // extern "C"
