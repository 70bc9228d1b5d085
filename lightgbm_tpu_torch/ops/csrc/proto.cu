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
//   P2 move_kernel is B2's one-launch partition (aligned.cu; helpers in
//      partition.cuh) over all 16 lanes, after one memset of its flag
//      words and ticket, with one change: a CTA takes a tile of chunks
//      (2,048 rows) by ticket, ranks the whole tile from the chunks'
//      split words read straight from global memory, publishes one flag
//      a tile and walks back over the tiles before it (segmented at the
//      first bit and after the last bit) while the bulk copies of its
//      first two chunks land, then stores the chunks in turn, each
//      lane's left and right runs contiguous, each stage refilled two
//      chunks ahead; rows whose destination chunk lies outside
//      [0, nc_out) are dropped. B2's chunk a CTA (each CTA's ticket,
//      copy, rank, walk and stores in series) ran at 0.76 ms on an
//      H100 at the harness's C = 256, a persistent grid that took its
//      next chunk before finishing the current one at 1.02 (the early
//      ticket's flag waited for that CTA, and the next walks with it),
//      the tiles at 0.52; 16-byte stores of four rows, streaming
//      stores and more CTAs an SM did not help (PERF.md). It replaced a
//      count, a one-CTA scan and a scatter;
//   P3 ring_kernel is one launch and no memset (it replaced a count, a
//      one-CTA scan, two memsets and a lap kernel, and a resolve), after
//      B3's count pass (aligned.cu::count_kernel): a persistent grid
//      whose warps count each chunk's left rows from lane 0 (16-byte
//      loads) into kl, each CTA adding its total into part. The staging
//      depends only on each side's total and on a tail of chunks, so
//      after a grid barrier (a cooperative launch) the first CTA of each
//      SM walks back from the last chunk over kl in windows of 1,024
//      chunks (route4c 2,048; a chunk's start is the total less a suffix
//      sum), finds the chunks whose rows end in the staging and takes
//      its share of their copies, a lane of a chunk a warp
//      (ring_finish). With wrap the tail holds each side's last 2C rows;
//      in route4c a position keeps the last lap whose first chunk
//      started at or below it, which may lie hundreds of laps back. On
//      an H100 at the harness's 20,000 chunks of 512 (PERF.md): 0.033 /
//      0.028 ms with a cold L2 (route4c / compact_roll), of which the
//      count and the barrier take 0.022 (lane 0 is 2 KB of every 32 KB),
//      route4c's walk ~0.008 (windows of 1,024 chunks cost it 0.002
//      more, and compact_roll 0.002 if it took 2,048) and the copies
//      ~0.003. Every CTA repeating the walk (an SM shared by four) took
//      0.049, the last CTA alone copying 0.17. Skewed chunks cost more:
//      a left row in 8 chunks walks ~10,000 chunks (0.10 / 0.09 ms),
//      C - 1 left rows a chunk copy from ~1,000 chunks (0.08 / 0.07).
//
// What bounds them on an H100: bytes. P1 reads the seven bin words and
// the two payload lanes of every valid row (36 B) and writes the slots'
// histograms; P2 reads and writes every valid row (64 B each way: 0.30 ms
// at the harness's 7.9M valid rows), and the split word once more; P3
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
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "partition.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kW = 16;                 // record lanes
constexpr int kWords = 7;              // packed bin words (28 features)
constexpr int kLaneG = kWords, kLaneH = kWords + 1;
constexpr int kStats = 3;
constexpr int kMoveThreads = 256;      // P2 CTAs, 4 an SM
constexpr int kMaxTile = 32;           // P2 chunks a tile (warp 0's scan)
constexpr int kHistThreads = 1024;     // P1 slot_hist CTAs (ops/proto.py)
constexpr int kRollThreshold = 31;     // P3: left iff (lane 0 & 255) <= 31
constexpr int kRingThreads = 256;      // P3 CTAs (ops/proto.py)
constexpr int kRingWarps = kRingThreads / 32;
// P3 chunks a thread a walk window: compact_roll's walk stops within
// its last 2C rows a side, route4c's reaches further back (a lap must
// start at position 0), so it takes wider windows
constexpr int kRingPerWrap = 4, kRingPerDrop = 8;
constexpr int kRingRows = 16;          // P3 rows a lane a copy segment
constexpr int kRingMinCtas = 2;        // P3 CTAs an SM (128 registers)
// move params columns
constexpr int kWsel = 0, kShift = 1, kThr = 2, kBaseL = 3, kBaseR = 4;
constexpr int kFirst = 5, kLast = 6, kCnt = 7, kParams = 8;

int check() { return static_cast<int>(cudaGetLastError()); }

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
// P2: move, B2's one-launch partition (the helpers are in partition.cuh)
// ---------------------------------------------------------------------------
// Whether chunk c starts a block: chunk 0, a chunk with the first bit, or
// one after a chunk with the last bit.
__device__ __forceinline__ bool move_block_start(const int32_t* params,
                                                 long long c) {
  return c == 0 || params[c * kParams + kFirst] != 0
      || params[(c - 1) * kParams + kLast] != 0;
}

// One CTA a tile of `tile` consecutive chunks (at most kMaxTile), tiles
// taken by ticket. Chunk c's rows r < min(cnt, C) go left when ((word >>
// shift) & 255) <= thr (word: lane wsel of the chunk, 0 from lane 7 on;
// the shift arithmetic), the left rows to the chunks from baseL and the
// right rows to the chunks from baseR (its own params), after the rows
// of its block's earlier chunks, all 16 lanes, each lane's left and right
// runs contiguous; a row whose destination chunk lies outside
// [0, nc_out) is dropped.
//
// Only the split words are on the look-back's path: the CTA starts the
// bulk copies of its first chunks, ranks every chunk of the tile from its
// split word read straight from global memory (4 B a row), publishes the
// tile's flag (a segmented sum: inclusive from the tile's last block
// start, if it holds one) and walks back over the tiles before it, while
// the copies land; it then stores the chunks one after another, each
// stage refilled with the chunk `stages` ahead as soon as its stores are
// issued. flags [tiles] and *ticket come in zeroed. Shared memory: two
// mbarriers (16 B), the stages (stages x 16 x C words), the permutations
// (tile x C u16, padded to 16 B), the ballots and their prefix (2 x tile x
// ceil(C / 32) words).
__global__ void __launch_bounds__(kMoveThreads, 4)
move_kernel(const int32_t* __restrict__ rec, long long nc, int C, int tile,
            int stages, int nc_out, const int32_t* __restrict__ params,
            unsigned long long* __restrict__ flags,
            unsigned* __restrict__ ticket, int32_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char move_smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(move_smem);
  const long long cw = static_cast<long long>(kW) * C;
  int32_t* stage0 = reinterpret_cast<int32_t*>(move_smem + 16);
  unsigned short* perm =
      reinterpret_cast<unsigned short*>(stage0 + stages * cw);
  const int nw = (C + 31) >> 5;
  unsigned* ballot = reinterpret_cast<unsigned*>(
      reinterpret_cast<unsigned char*>(perm) + ((2 * tile * C + 15) & ~15));
  int* prefix = reinterpret_cast<int*>(ballot + tile * nw);
  __shared__ long long s_tile;
  // each chunk of the tile: valid and left rows, the rows of its block
  // before it (left, valid), split word lane, shift, threshold, block start
  __shared__ int s_cnt[kMaxTile], s_left[kMaxTile], s_pl[kMaxTile],
      s_pv[kMaxTile], s_wsel[kMaxTile], s_shift[kMaxTile], s_thr[kMaxTile];
  __shared__ bool s_start[kMaxTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kMoveThreads / 32;
  if (tid == 0) {
    const long long t = atomicAdd(ticket, 1u);
    s_tile = t;
    stage_init(bar);
    if (stages == 2) stage_init(bar + 1);
    const long long c0 = t * tile;
    const int n = static_cast<int>(min(static_cast<long long>(tile),
                                       nc - c0));
    for (int j = 0; j < min(stages, n); ++j) {
      stage_load(stage0 + j * cw, rec + (c0 + j) * cw,
                 4u * static_cast<unsigned>(cw), bar + j);
    }
  }
  __syncthreads();
  const long long t = s_tile;
  const long long c0 = t * tile;
  const int n = static_cast<int>(min(static_cast<long long>(tile),
                                     nc - c0));
  if (tid < n) {
    const int32_t* p = params + (c0 + tid) * kParams;
    s_cnt[tid] = min(p[kCnt], C);
    s_wsel[tid] = p[kWsel];
    s_shift[tid] = p[kShift];
    s_thr[tid] = p[kThr];
    s_start[tid] = move_block_start(params, c0 + tid);
  }
  __syncthreads();
  // 1. a ballot a word of 32 rows of every chunk of the tile, four words
  //    of a warp's loads in flight at a time
  const int words = n * nw;
  for (int g0 = warp; g0 < words; g0 += 4 * kWarps) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int g = g0 + u * kWarps;
      const int j = g / nw, r = (g - j * nw) * 32 + lane;
      v[u] = g < words && r < s_cnt[j] && s_wsel[j] < kWords
          ? __ldg(rec + ((c0 + j) * kW + s_wsel[j]) * C + r) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int g = g0 + u * kWarps;
      if (g >= words) break;                       // uniform over the warp
      const int j = g / nw, r = (g - j * nw) * 32 + lane;
      const bool left = r < s_cnt[j]
          && (s_wsel[j] >= kWords
              || ((v[u] >> s_shift[j]) & 255) <= s_thr[j]);
      const unsigned b = __ballot_sync(kFull, left);
      if (lane == 0) ballot[g] = b;
    }
  }
  __syncthreads();
  // 2. each chunk's left rows before each of its words
  for (int j = warp; j < n; j += kWarps) {
    const int left = ballot_prefix(ballot + j * nw, prefix + j * nw, nw,
                                   lane);
    if (lane == 0) s_left[j] = left;
  }
  __syncthreads();
  // 3. warp 0: the tile's segmented sums, its flag, the walk back over
  //    earlier tiles and each chunk's rows of its block before it; the
  //    other warps invert the ranks meanwhile
  if (warp == 0) {
    const bool in = lane < n;
    const int own_l = in ? s_left[lane] : 0, own_v = in ? s_cnt[lane] : 0;
    int l = own_l, v = own_v;
    bool f = in && s_start[lane];                  // a start at or before
    for (int o = 1; o < 32; o <<= 1) {
      const int yl = __shfl_up_sync(kFull, l, o);
      const int yv = __shfl_up_sync(kFull, v, o);
      const bool yf = __shfl_up_sync(kFull, f, o);
      if (lane >= o && !f) {
        l += yl;
        v += yv;
      }
      if (lane >= o) f = f || yf;
    }
    const int tot_l = __shfl_sync(kFull, l, n - 1);
    const int tot_v = __shfl_sync(kFull, v, n - 1);
    const bool cut = __shfl_sync(kFull, f, n - 1); // a start in the tile
    if (lane == 0) {
      publish(flags + t, flag_word(cut ? kInclusive : kAggregate, tot_l,
                                   tot_v));
    }
    int ex_left = 0, ex_valid = 0;
    if (!s_start[0]) {
      look_back(flags, t, lane, ex_left, ex_valid);
      if (lane == 0 && !cut) {
        publish(flags + t, flag_word(kInclusive, ex_left + tot_l,
                                     ex_valid + tot_v));
      }
    }
    if (in) {
      s_pl[lane] = l - own_l + (f ? 0 : ex_left);
      s_pv[lane] = v - own_v + (f ? 0 : ex_valid);
    }
  } else {
    for (int j = 0; j < n; ++j) {
      if (s_wsel[j] < kWords) {
        invert_ranks(s_cnt[j], s_left[j], tid - 32, kMoveThreads - 32,
                     ballot + j * nw, prefix + j * nw, perm + j * C);
      }
    }
  }
  __syncthreads();
  // 4. the chunks in turn: each lane's left run to baseL's chunks from
  //    the block's left rows before it, its right run to baseR's;
  //    destinations outside [0, nc_out) dropped; a block's rows, and so
  //    d, stay below 2^31 (the flag words' fields)
  for (int j = 0; j < n; ++j) {
    const int si = j % stages;
    stage_wait(bar + si, (j / stages) & 1);
    const int32_t* stage = stage0 + si * cw;
    const int32_t* p = params + (c0 + j) * kParams;
    const long long bl = p[kBaseL], br = p[kBaseR];
    const int cnt = s_cnt[j], agg_left = s_left[j];
    const int pl = s_pl[j], pr = s_pv[j] - s_pl[j];
    const bool all_left = s_wsel[j] >= kWords;
    const unsigned short* pj = perm + j * C;
    for (int k = tid; k < cnt; k += kMoveThreads) {
      const bool left = k < agg_left;
      const int d = left ? pl + k : pr + (k - agg_left);
      const int q = d / C;
      const long long dc = (left ? bl : br) + q;
      if (dc < 0 || dc >= nc_out) continue;
      int32_t* dst = out + dc * cw + (d - q * C);
      const int32_t* from = stage + (all_left ? k : pj[k]);
#pragma unroll
      for (int u = 0; u < kW; ++u) {
        dst[static_cast<long long>(u) * C] =
            from[static_cast<long long>(u) * C];
      }
    }
    if (j + stages < n) {
      __syncthreads();                 // the stage's readers are done
      if (tid == 0) {
        stage_load(stage0 + si * cw, rec + (c0 + j + stages) * cw,
                   4u * static_cast<unsigned>(cw), bar + si);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// P3: ring staging, one launch
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool roll_left(int key) {
  return (key & 255) <= kRollThreshold;
}

// Left rows of one chunk (lane 0 of its record), one warp: 16-byte loads
// (vec: C % 4 == 0 and the records 16-byte aligned, so every lane of
// every chunk is), four in flight a thread, or one word at a time. Valid
// in every lane.
__device__ __forceinline__ int ring_left_rows(const int32_t* key, int C,
                                              bool vec, int lane) {
  int k = 0;
  if (vec) {
    const int4* k4 = reinterpret_cast<const int4*>(key);
    const int n4 = C >> 2;
    for (int i0 = lane; i0 < n4; i0 += 4 * 32) {
      int4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + 32 * j;
        v[j] = i < n4 ? __ldg(k4 + i) : make_int4(255, 255, 255, 255);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k += roll_left(v[j].x) + roll_left(v[j].y) + roll_left(v[j].z)
            + roll_left(v[j].w);
      }
    }
  } else {
    for (int r = lane; r < C; r += 32) k += roll_left(__ldg(key + r));
  }
  return __reduce_add_sync(kFull, k);
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery: l = ceil(log2 d), m = 2^32 (2^l - d) / d + 1), for the
// ring's 2C, which the walk divides by some 20 times a chunk.
struct FastDiv {
  int d, l;
  unsigned m;
  __device__ explicit FastDiv(int d_) : d(d_), l(0) {
    while ((1u << l) < static_cast<unsigned>(d)) ++l;
    m = static_cast<unsigned>((1ull << 32) * ((1ull << l) - d) / d) + 1u;
  }
  __device__ int div(int n) const {
    const unsigned t = __umulhi(m, static_cast<unsigned>(n));
    return static_cast<int>((t + static_cast<unsigned>(n)) >> l);
  }
};

// A side (left or right ring) over the whole call: T its rows; mlast the
// lap (T / 2C rounded down, of the side's last row) of its last row, -1
// when T = 0; tlast = T - mlast 2C, the positions that lap reaches; a the
// first position written in lap mlast (its first chunk's start, tlast
// while that chunk is not found).
struct RingSide {
  int T, mlast, tlast, a;
};

// The rows of one side of one chunk that end in the staging: the chunk's
// rows j of that side (in row order) in [j0, j1) of either run go to
// position p0 + j - j0, mod 2C.
struct RingRuns {
  int j0[2], j1[2], p0[2];
};

// The side's rows j < k of the chunk that starts at side row P are the
// rows P + j, at position (P + j) mod 2C of lap (P + j) / 2C.
//   wrap: a position keeps the largest row that reaches it, so the
//     side's last 2C rows, L >= T - 2C, end in the staging;
//   route4c: the chunk writes positions [lo, min(lo + k, 2C)) of lap m
//     (P = m 2C + lo), and a later lap m' < mlast writes [g(m'), 2C),
//     g(m') the first position written in it, lap mlast [a, tlast). A
//     row is final unless a later lap writes its position: below G, the
//     least g(m') over the laps m < m' < mlast, and outside [a, tlast).
__device__ __forceinline__ RingRuns ring_runs(int wrap, const FastDiv& c2,
                                              const RingSide& s, int P,
                                              int k, int G) {
  const int C2 = c2.d;
  RingRuns r = {{0, 0}, {0, 0}, {0, 0}};
  if (wrap) {
    r.j0[0] = max(0, s.T - C2 - P);
    r.j1[0] = k;
    r.p0[0] = P + r.j0[0] - c2.div(P + r.j0[0]) * C2;
    return r;
  }
  const int m = c2.div(P), lo = P - m * C2;
  r.p0[0] = lo;
  if (m > s.mlast) return r;                       // no row (P = T)
  if (m == s.mlast) {
    r.j1[0] = min(k, C2 - lo);
    return r;
  }
  const int hi = min(min(lo + k, C2), G);
  r.j1[0] = max(0, min(hi, s.a) - lo);
  const int b = max(lo, s.tlast);
  r.j0[1] = b - lo;
  r.j1[1] = max(b, hi) - lo;
  r.p0[1] = b;
  return r;
}

// Exclusive sum of v over the CTA's threads in thread order; *total gets
// the whole CTA's. Every thread calls it; part holds a word a warp.
__device__ __forceinline__ int block_scan(int v, int* part, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  int pre = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kRingWarps; ++w) {
    const int p = part[w];
    if (w < warp) pre += p;
    all += p;
  }
  __syncthreads();
  *total = all;
  return pre + x - v;
}

// The exclusive minimum of two values at once over the CTA's threads in
// thread order (identity id), as block_scan; part2 holds two words a warp.
__device__ __forceinline__ void block_scan_min2(const int* v, int id,
                                                int* part2, int* ex,
                                                int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x0 = v[0], x1 = v[1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y0 = __shfl_up_sync(kFull, x0, o);
    const int y1 = __shfl_up_sync(kFull, x1, o);
    if (lane >= o) {
      x0 = min(x0, y0);
      x1 = min(x1, y1);
    }
  }
  if (lane == 31) {
    part2[2 * warp] = x0;
    part2[2 * warp + 1] = x1;
  }
  __syncthreads();
  int p0 = id, p1 = id, a0 = id, a1 = id;
#pragma unroll
  for (int w = 0; w < kRingWarps; ++w) {
    const int q0 = part2[2 * w], q1 = part2[2 * w + 1];
    if (w < warp) {
      p0 = min(p0, q0);
      p1 = min(p1, q1);
    }
    a0 = min(a0, q0);
    a1 = min(a1, q1);
  }
  __syncthreads();
  const int y0 = __shfl_up_sync(kFull, x0, 1);
  const int y1 = __shfl_up_sync(kFull, x1, 1);
  ex[0] = lane == 0 ? p0 : min(p0, y0);
  ex[1] = lane == 0 ? p1 : min(p1, y1);
  total[0] = a0;
  total[1] = a1;
}

// A chunk of the walk's window with rows that end in the staging: its
// index, its left rows before it, and G of each side (ring_runs).
struct RingEntry {
  int c, pl, g0, g1;
};

struct RingShared {
  RingEntry ent[kRingThreads * kRingPerDrop];
  int part[kRingWarps];
  int part2[2 * kRingWarps];
  RingSide side[2];
  int S;          // left rows of the chunks above the window
  int G[2];       // least g(m) over the laps below mlast walked
  int n_ent;
  int done;       // bit s: side s has every position's row
};

// One warp: lane u of the rows of chunk e that end in the staging. The
// warp reads the chunk's lane 0 and lane u together, 16 rows a thread
// (16-byte loads where vec), ranks each side's rows with a scan over the
// warp and stores the final ones.
__device__ void ring_copy(const int32_t* __restrict__ rec, int C, int vec,
                          int wrap, const RingSide* sides, RingEntry e,
                          int u, int32_t* __restrict__ stag) {
  const int lane = threadIdx.x & 31;
  const FastDiv c2(2 * C);
  const int C2 = c2.d;
  // k = C bounds the rows: a chunk's rows j >= its k do not exist
  const RingRuns rl = ring_runs(wrap, c2, sides[0], e.pl, C, e.g0);
  const RingRuns rr = ring_runs(wrap, c2, sides[1], e.c * C - e.pl, C,
                                e.g1);
  const int32_t* key = rec + static_cast<long long>(e.c) * kW * C;
  const int32_t* src = key + static_cast<long long>(u) * C;
  int32_t* dst = stag + static_cast<long long>(u) * 2 * C2;
  int cl = 0, cr = 0;                   // each side's rows before r0
  for (int r0 = 0; r0 < C; r0 += 32 * kRingRows) {
    const int base = r0 + lane * kRingRows;
    int w0[kRingRows], wu[kRingRows];
    if (vec && base + kRingRows <= C) {
#pragma unroll
      for (int q = 0; q < kRingRows / 4; ++q) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(key + base) + q);
        const int4 y = __ldg(reinterpret_cast<const int4*>(src + base) + q);
        w0[4 * q] = x.x;
        w0[4 * q + 1] = x.y;
        w0[4 * q + 2] = x.z;
        w0[4 * q + 3] = x.w;
        wu[4 * q] = y.x;
        wu[4 * q + 1] = y.y;
        wu[4 * q + 2] = y.z;
        wu[4 * q + 3] = y.w;
      }
    } else {
#pragma unroll
      for (int v = 0; v < kRingRows; ++v) {
        const bool in = base + v < C;
        w0[v] = in ? __ldg(key + base + v) : 0;
        wu[v] = in ? __ldg(src + base + v) : 0;
      }
    }
    unsigned lm = 0u, rm = 0u;
#pragma unroll
    for (int v = 0; v < kRingRows; ++v) {
      if (base + v < C) {
        if (roll_left(w0[v])) lm |= 1u << v; else rm |= 1u << v;
      }
    }
    // each side's rows of the lanes before: left | right << 16 (a side
    // has at most 32 x 16 rows in a segment)
    const int cnt = __popc(lm) | (__popc(rm) << 16);
    int x = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    const int tot = __shfl_sync(kFull, x, 31);
    int jl = cl + ((x - cnt) & 0xffff), jr = cr + ((x - cnt) >> 16);
#pragma unroll
    for (int v = 0; v < kRingRows; ++v) {
      const bool isl = (lm >> v) & 1u, isr = (rm >> v) & 1u;
      if (!isl && !isr) continue;
      const int j = isl ? jl++ : jr++;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j0 = isl ? rl.j0[q] : rr.j0[q];
        const int j1 = isl ? rl.j1[q] : rr.j1[q];
        if (j >= j0 && j < j1) {
          int p = (isl ? rl.p0[q] : rr.p0[q]) + j - j0;
          if (p >= C2) p -= C2;
          dst[(isl ? 0 : C2) + p] = wu[v];
        }
      }
    }
    cl += tot & 0xffff;
    cr += tot >> 16;
  }
}

// The finish, from each chunk's left rows kl [n] and the counting CTAs'
// left totals part [nparts], by `ctas` CTAs, this one the cta-th: each
// walks, and takes its share of the zeroing and the copies.
//   1. The totals; the positions no row reaches, [min(T, 2C), 2C) of each
//      side, are zeroed.
//   2. A walk back from the last chunk in windows of kRingThreads x kPer
//      chunks (the first window's counts load beside the totals):
//      each chunk's left rows before it (the total less a suffix sum
//      scanned over the window), the chunks that start a lap (route4c:
//      g(m) and a, then G by a suffix minimum), and the chunks with rows
//      that end in the staging (entries). The walk stops when each side
//      has every position's row: wrap, when the chunks walked hold the
//      side's last 2C rows; route4c, when the positions below G left to
//      find lie in [a, tlast) (G = 0, or a = 0 and G <= tlast), at the
//      latest at chunk 0 (lap 0 starts there: g = 0).
//   3. Each window's entries are copied by warps, a lane each.
template <int kPer>
__device__ __forceinline__ void ring_window(const int32_t* __restrict__ kl,
                                            int whi, int* k) {
  // this thread's chunks whi - 1 - (tid kPer + i), downwards, and the
  // one below them (whether the lowest starts a lap)
#pragma unroll
  for (int i = 0; i <= kPer; ++i) {
    const int c = whi - 1 - (static_cast<int>(threadIdx.x) * kPer + i);
    k[i] = c >= 0 ? __ldcg(kl + c) : 0;
  }
}

template <int kPer>
__device__ void ring_finish(const int32_t* __restrict__ rec, int n, int C,
                            int wrap, int vec,
                            const int32_t* __restrict__ kl,
                            const int32_t* __restrict__ part, int nparts,
                            int32_t* __restrict__ stag, int cta, int ctas,
                            RingShared& st) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const FastDiv c2(2 * C);
  const int C2 = c2.d;
  int k[kPer + 1];
  ring_window<kPer>(kl, n, k);
  int s = 0;
  for (int i = tid; i < nparts; i += kRingThreads) s += __ldcg(part + i);
  int T0;
  block_scan(s, st.part, &T0);
  if (tid == 0) {
    for (int side = 0; side < 2; ++side) {
      RingSide& sd = st.side[side];
      sd.T = side ? n * C - T0 : T0;
      sd.mlast = sd.T > 0 ? (sd.T - 1) / C2 : -1;
      sd.tlast = sd.T > 0 ? sd.T - sd.mlast * C2 : 0;
      sd.a = sd.tlast;
      st.G[side] = C2;
    }
    st.S = 0;
    st.done = (st.side[0].T == 0 ? 1 : 0) | (st.side[1].T == 0 ? 2 : 0);
  }
  __syncthreads();
  {
    const long long t0 = static_cast<long long>(cta) * kRingThreads + tid;
    const long long step = static_cast<long long>(ctas) * kRingThreads;
    for (int side = 0; side < 2; ++side) {
      const int z0 = min(st.side[side].T, C2), z = C2 - z0;
      for (long long i = t0; i < static_cast<long long>(kW) * z; i += step) {
        const long long u = i / z;
        stag[u * 2 * C2 + side * C2 + z0 + (i - u * z)] = 0;
      }
    }
  }
  for (int whi = n; whi > 0 && st.done != 3;) {
    const int wlo = max(0, whi - kRingThreads * kPer);
    const RingSide s0 = st.side[0], s1 = st.side[1];
    const int S = st.S, G0 = st.G[0], G1 = st.G[1];
    if (whi < n) ring_window<kPer>(kl, whi, k);
    int loc = 0, incl[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (whi - 1 - (tid * kPer + i) >= wlo) loc += k[i];
      incl[i] = loc;
    }
    int wtot;
    const int ex = block_scan(loc, st.part, &wtot);
    int pl[kPer], g[2][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = whi - 1 - (tid * kPer + i);
      pl[i] = s0.T - (S + ex + incl[i]);
      g[0][i] = g[1][i] = C2;
      if (c < wlo || wrap) continue;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const RingSide& sd = side ? s1 : s0;
        const int P = side ? c * C - pl[i] : pl[i];
        const int kp = side ? C - k[i + 1] : k[i + 1];
        const int m = c2.div(P);
        if (c > 0 && c2.div(P - kp) == m) continue;   // not a lap's first
        if (m == sd.mlast) {
          st.side[side].a = P - m * C2;     // one chunk in the whole walk
        } else if (m < sd.mlast) {
          g[side][i] = P - m * C2;
        }
      }
    }
    int gx[2][kPer], gtot[2] = {C2, C2};
    if (!wrap) {
      int run[2] = {C2, C2};
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          gx[side][i] = run[side];
          run[side] = min(run[side], g[side][i]);
        }
      }
      int exm[2];
      block_scan_min2(run, C2, st.part2, exm, gtot);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        gx[0][i] = min(min(gx[0][i], exm[0]), G0);
        gx[1][i] = min(min(gx[1][i], exm[1]), G1);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) gx[0][i] = gx[1][i] = C2;
    }
    // st.side[].a is final here: its chunk lies above every chunk of an
    // earlier lap, in this window or an earlier one (a scan's barriers
    // stand between its store and these loads)
    RingSide a0 = s0, a1 = s1;
    a0.a = st.side[0].a;
    a1.a = st.side[1].a;
    unsigned has = 0u;
    int ne = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = whi - 1 - (tid * kPer + i);
      if (c < wlo) continue;
      const RingRuns rl = ring_runs(wrap, c2, a0, pl[i], k[i], gx[0][i]);
      const RingRuns rr = ring_runs(wrap, c2, a1, c * C - pl[i], C - k[i],
                                    gx[1][i]);
      if (rl.j1[0] > rl.j0[0] || rl.j1[1] > rl.j0[1]
          || rr.j1[0] > rr.j0[0] || rr.j1[1] > rr.j0[1]) {
        has |= 1u << i;
        ++ne;
      }
    }
    int ntot;
    int e = block_scan(ne, st.part, &ntot);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if ((has >> i) & 1u) {
        st.ent[e++] = {whi - 1 - (tid * kPer + i), pl[i], gx[0][i],
                       gx[1][i]};
      }
    }
    if (tid == 0) {
      st.S = S + wtot;
      st.G[0] = min(G0, gtot[0]);
      st.G[1] = min(G1, gtot[1]);
      st.n_ent = ntot;
      int done = st.done;
      for (int side = 0; side < 2; ++side) {
        const RingSide& sd = side ? a1 : a0;
        bool fin;
        if (wrap) {   // the side's rows in the chunks from wlo on
          const int rows = side ? (n - wlo) * C - st.S : st.S;
          fin = rows >= min(sd.T, C2);
        } else {
          const int G = st.G[side];
          fin = G == 0 || (sd.a == 0 && G <= sd.tlast);
        }
        if (fin) done |= 1 << side;
      }
      st.done = done;
    }
    __syncthreads();
    const int units = st.n_ent * kW;
    for (int i = cta + warp * ctas; i < units; i += kRingWarps * ctas) {
      ring_copy(rec, C, vec, wrap, st.side, st.ent[i / kW], i % kW, stag);
    }
    __syncthreads();                 // entries read before the next window
    whi = wlo;
  }
}

// P3, one launch: a persistent grid of kRingThreads-thread CTAs, all on
// the card at once (a cooperative launch); each warp counts every (grid
// warps)-th chunk's left rows into kl, each CTA its left total into
// part[blockIdx.x]; after a grid barrier the first `fin` CTAs, one an SM
// (the walk each of them repeats then shares no SM), finish
// (ring_finish).
template <int kPer>
__global__ void __launch_bounds__(kRingThreads, kRingMinCtas)
ring_kernel(const int32_t* __restrict__ rec, int n, int C, int wrap,
            int vec, int fin, int32_t* __restrict__ kl,
            int32_t* __restrict__ part, int32_t* __restrict__ stag) {
  __shared__ RingShared st;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int mine = 0;
  for (long long c = static_cast<long long>(blockIdx.x) * kRingWarps + warp;
       c < n; c += static_cast<long long>(gridDim.x) * kRingWarps) {
    const int k = ring_left_rows(rec + c * kW * C, C, vec != 0, lane);
    if (lane == 0) kl[c] = k;
    mine += k;
  }
  if (lane == 0) st.part[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kRingWarps; ++w) s += st.part[w];
    part[blockIdx.x] = s;
  }
  __threadfence();
  cg::this_grid().sync();
  if (static_cast<int>(blockIdx.x) >= fin) return;
  ring_finish<kPer>(rec, n, C, wrap, vec, kl, part, gridDim.x, stag,
                    blockIdx.x, fin, st);
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
// [0, 32), cnt >= 0); rec 16-byte aligned. One memset of scratch (the
// flag words of the ceil(nc / tile) tiles, u64, then the ticket), then
// one launch of move_kernel, a CTA a tile of `tile` chunks with `stages`
// chunk stages and `smem` bytes of dynamic shared memory
// (ops/proto.py::move_smem).
int lgbt_proto_move(const void* rec, int nc, int C, int tile, int stages,
                    int smem, const void* params, int nc_out, void* scratch,
                    void* out, void* stream) {
  if (nc == 0) return 0;
  if (tile < 1 || tile > kMaxTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (nc + tile - 1) / tile;
  cudaError_t e = cudaMemsetAsync(
      scratch, 0,
      sizeof(unsigned long long) * (static_cast<size_t>(tiles) + 1), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(move_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned long long* flags = static_cast<unsigned long long*>(scratch);
  move_kernel<<<tiles, kMoveThreads, smem, s>>>(
      static_cast<const int32_t*>(rec), nc, C, tile, stages, nc_out,
      static_cast<const int32_t*>(params), flags,
      reinterpret_cast<unsigned*>(flags + tiles),
      static_cast<int32_t*>(out));
  return check();
}

// P3: stag [16, 4C] = the two rings after every chunk of rec [n, 16, C]
// (wrap 0: kernel_route4c, 1: kernel_compact_roll): one cooperative
// launch of `grid` CTAs (ops/proto.py::ring_launch_shape), no memset, of
// which `fin` finish; part [grid] and kl [n] are scratch. vec: C % 4 ==
// 0 and rec 16-byte aligned.
int lgbt_proto_ring_stage(const void* rec, int n, int C, int wrap, int vec,
                          int grid, int fin, void* part, void* kl,
                          void* stag, void* stream) {
  const int32_t* r = static_cast<const int32_t*>(rec);
  int32_t* k = static_cast<int32_t*>(kl);
  int32_t* p = static_cast<int32_t*>(part);
  int32_t* out = static_cast<int32_t*>(stag);
  void* args[] = {&r, &n, &C, &wrap, &vec, &fin, &k, &p, &out};
  const void* fn =
      wrap ? reinterpret_cast<const void*>(&ring_kernel<kRingPerWrap>)
           : reinterpret_cast<const void*>(&ring_kernel<kRingPerDrop>);
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kRingThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? static_cast<int>(e) : check();
}

// CTAs of P3's kernels (both variants) that the CUDA occupancy
// calculator fits on an SM of the current device (a cooperative launch
// takes at most that many an SM); -1 on a CUDA error.
int lgbt_proto_ring_occupancy() {
  int a = -1, b = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &a, ring_kernel<kRingPerWrap>, kRingThreads, 0) != cudaSuccess
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, ring_kernel<kRingPerDrop>, kRingThreads, 0) != cudaSuccess) {
    return -1;
  }
  return min(a, b);
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
