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
// missing_type << 14 | copy << 16 | categorical << 25; r2: default_bin |
// (num_bin - 1) << 8 | bundle offset << 16 | packed << 24; wsel: the
// split word lane; meta: count | first << 20 | last << 21). A
// categorical split routes a row left iff its bin's bit is set in the
// split's bitset: 8 words over bins, row k of the round's
// compact table cbits (int32 [(K + 1) * 8]; a null table reads as zeros),
// k the chunk's kslots entry (B3) or its hslots slot (B2). A chunk is
// categorical or not as a whole, so the numerical chunks' predicate stays
// free of the table: B3's warp takes the chunk's 8 words into lanes 0-7
// and gives each row its word by a shuffle, B2's CTA puts them into
// shared memory beside the ballots. Under exclusive feature bundling the
// words hold bundled storage columns (io/bundling.py): the Bundled
// instantiations of B2's and B3's kernels, chosen at the launch, map the
// split word's value to the split feature's own bin (unpack_bundle, from
// r2's offset and packed bit) before the numerical routing, replacing the
// bundled=True branch of the TPU kernels (lightgbm_tpu/ops/aligned.py:
// 709-710 and 1018-1019). The JAX package never bundles a categorical
// feature, so a bundled launch has no categorical chunk: each kernel has
// three kinds, numerical, categorical and bundled.
//
// What the TPU kernels do that has no counterpart here: the Pallas move
// kernel carries each block's left/right fill from grid step to grid step
// in SMEM, ranks rows with a triangular MXU matmul, moves them with a
// byte-plane one-hot matmul through a 4-chunk staging ring, and builds
// histograms as bf16 hi/lo one-hot contractions. CUDA blocks run in no
// order, so the partition carries the fill with a decoupled look-back
// instead, in one launch (partition_kernel, after one memset of its
// scratch):
//   - each CTA takes a chunk by an atomic ticket, not by blockIdx, so
//     every chunk before it has a running CTA;
//   - a split chunk's used lanes (one contiguous run of w_used x C words)
//     come into shared memory by one bulk copy (cp.async.bulk, TMA's 1-D
//     form, completing on an mbarrier); the CTA ranks its rows with warp
//     ballots over the staged split word and publishes its (left, valid)
//     aggregate in a 64-bit flag word, then walks back over its
//     predecessors' flags one warp-wide window of 32 at a time until an
//     inclusive prefix, which a block's first chunk publishes at once
//     (the scan is segmented at the meta first bit), and publishes its
//     own inclusive prefix;
//   - meanwhile the CTA inverts its ranks into a row permutation (left
//     rows, then right rows, each in row order), so each lane's left run
//     and right run go out as contiguous, coalesced stores; a run of at
//     most C rows spans at most two destination chunks;
//   - a copy chunk moves its w_used lanes with 16-byte loads and stores;
//   - a block's last chunk writes the smaller child's chunk map (nslot,
//     ncnt), which slot_hist_kernel reads next.
// No CTA waits on a chunk after its own, so the walk cannot deadlock, and
// the result is the stable partition in (chunk, row) order whatever the
// order the CTAs run in (the helpers are in partition.cuh, shared with
// P2's move in proto.cu). The smaller child's histogram is then
// slot_hist_kernel over the child's now contiguous chunks; the tree's
// root (B4) is the same kernel over every chunk.
//
// The count pass (B3, count_kernel) replaces _count_kernel
// (lightgbm_tpu/ops/aligned.py:986, pallas_call at :1056), which walks the
// chunks in grid order and adds each one's left rows to its slot's SMEM
// cell. It reads one word a counted row (~42 MB, 12.6 us at the widest
// big-n round of HIGGS), so a CTA a chunk spent more on scheduling and a
// block-wide reduction than on its 4 KB: one launch of a persistent grid
// (the CTAs an SM the occupancy calculator fits), each warp taking whole
// chunks with four 16-byte loads in flight a thread, shared u32 counters
// a slot, one red a touched slot into a per-stream scratch, and the last
// CTA by ticket writing the output and zeroing the scratch (fixed_point.cuh's
// last_to_arrive), so the output needs no memset.
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
// What bounds them on an H100: bytes. The partition reads every row's
// used lanes once and writes them once (the staged split word is ranked
// from shared memory); the count reads one word a counted row; the
// histogram
// reads the bin words and the two payload lanes of its rows.
// The 3 adds per (row, feature) are far below the card's f32 rate.
//
// Records of the STANDARD and EXT layouts carry grad/hess lanes, at wcnt +
// gh_off and the lane after (STANDARD: gh_off 2, after score and label;
// EXT, for ranking: gh_off 1, after the score); the kernels read them.
//
// Bagging (the JAX package's bag_lane, lightgbm_tpu/ops/aligned.py:350):
// the histogram takes only the rows in the bag, in its scale pass and
// its sums alike, so the scale is the in-bag rows' largest |g|; COMPACT
// records mark them by bit 31 of the meta word (bag_lane -2), STANDARD
// and EXT by an f32 0/1 lane (bag_lane >= 0). slot_hist_kernel is
// instantiated once a mode (kBagNone, kBagMeta, kBagLane), chosen at the
// launch, so the unbagged route is the code it was. The partition moves
// every row with its meta word or bag lane, and the count pass counts
// every physical row: under bagging it drives the layout, since the
// histogram counts are in-bag counts.
// Multiclass (the JAX package's _payload_gh with num_class > 1,
// lightgbm_tpu/ops/aligned.py:361-367, and its engine's _mc_payload_fn):
// K-class COMPACT records hold K score lanes, under softmax K probability
// lanes after them, then the meta lane, whose bits 24-30 are the integer
// class. Class k's histogram reads one lane, val_lane, and the meta lane,
// meta_lane (an argument, no longer the lane after the score): softmax
// (kMcProb) g = p - [label == k], h = (2 p)(1 - p); one-vs-all (kMcScore)
// the logistic loss of class k's score with the label [label == k] and
// that class's sigmoid and weights. The class kinds are a template
// parameter chosen at the launch, as the bag mode is, so the single-class
// routes keep their code; multiclass is COMPACT only, bagged by the meta
// bit.
// Gradients of the COMPACT layout are computed in the histogram kernel
// from the score lane and the label bits of the meta lane, by the kind of
// the objective (`pointwise`: the JAX package's _payload_gh calls the
// objective's own gradient in its kernel, so each pointwise objective is
// a branch of it: binary logloss, l2, huber, fair, poisson, gamma,
// tweedie and xentropy, and l1 and quantile, which train on the host
// learner), with the JAX package's f32 op order pinned by
// __fmul_rn/__fadd_rn/__fdiv_rn (so nvcc contracts nothing but the
// products XLA contracts, __fmaf_rn) and XLA's exp polynomial with true
// fused multiply-adds. The kind is a runtime argument: a few scalar ops a
// row in the scale pass and the sum. Poisson's, gamma's and tweedie's
// exp may overflow to Inf; such a run takes the non-finite path above.
// The CPU twin computes those fused steps in f64 and
// rounds twice, so a row's gradient may differ in its last bit in rare
// cases; histograms are held to 1e-5 x sum |g| of the slot.
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

#include "fixed_point.cuh"
#include "partition.cuh"
#include "xla_math.cuh"

namespace {

constexpr int kStats = 3;
constexpr int kShift = 8, kDefLeft = 13, kMissing = 14, kCopy = 16;
constexpr int kCat = 25;
constexpr int kCntMask = (1 << 20) - 1;
constexpr int kFirst = 20, kLast = 21;
constexpr int kMetaLabel = 24, kMetaLabelMask = 127;
constexpr int kGradLanes = 0, kGradBinary = 1, kGradL2 = 2, kGradProb = 3,
              kGradScore = 4, kGradL1 = 5, kGradHuber = 6, kGradFair = 7,
              kGradPoisson = 8, kGradQuantile = 9, kGradGamma = 10,
              kGradTweedie = 11, kGradXentropy = 12;
constexpr int kMcNone = 0, kMcProb = 1, kMcScore = 2;
constexpr int kCountThreads = 256;  // count CTAs, 4 an SM
constexpr int kMoveThreads = 256;  // partition CTAs, 4 an SM
constexpr int kHistThreads = 1024;  // slot_hist CTAs (ops/aligned.py)
constexpr int kBagNone = 0, kBagMeta = 1, kBagLane = 2;

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

// A bundled storage value -> the split feature's bin, as
// ops/aligned.py::unpack_bundle: the feature owns [boff, boff + nb - 1)
// with its default bin skipped, anything else reads as the default; an
// unpacked feature (bpk 0) keeps the value.
__device__ __forceinline__ int unpack_bundle(int binv, int r2) {
  if (!((r2 >> 24) & 1)) return binv;
  const int db = r2 & 255, nb = ((r2 >> 8) & 255) + 1;
  const int p = binv - ((r2 >> 16) & 255);
  if (p < 0 || p >= nb - 1) return db;
  return p >= db ? p + 1 : p;
}

// The logistic loss's (g, h) of one score with label pos
// (binary_objective.hpp, in the JAX package's f32 op order)
__device__ __forceinline__ void logistic(float score, bool pos, float sig,
                                         float wp, float wn, float& g,
                                         float& h) {
  const float sl = pos ? 1.0f : -1.0f;
  const float lw = pos ? wp : wn;
  const float resp = __fdiv_rn(
      __fmul_rn(-sl, sig),
      __fadd_rn(1.0f, exp_xla(__fmul_rn(__fmul_rn(sl, sig), score))));
  const float absr = fabsf(resp);
  g = __fmul_rn(resp, lw);
  h = __fmul_rn(__fmul_rn(absr, __fsub_rn(sig, absr)), lw);
}

// sign(x) as jnp.sign and torch.sign: +-1, 0 at 0, NaN at NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : x < 0.0f ? -1.0f : x == 0.0f ? 0.0f : x;
}

// The (g, h) of a single-class pointwise objective of kind `kind` at score
// s and label y (ops/objectives.py::PointGrad, in the JAX package's f32 op
// order; the products XLA contracts are __fmaf_rn, every other step
// rounded on its own), its constants c0, c1, c2 (the PointGrad's):
// l2; l1; huber (alpha); fair (c, c^2); poisson (max_delta_step);
// quantile (1 - alpha, -alpha); gamma; tweedie (1 - rho, 2 - rho);
// xentropy; anything else the logistic loss (sigmoid, w_pos, w_neg).
__device__ __forceinline__ void pointwise(int kind, float s, float y,
                                          float c0, float c1, float c2,
                                          float& g, float& h) {
  switch (kind) {
    case kGradL2:
      g = __fsub_rn(s, y);
      h = 1.0f;
      return;
    case kGradL1:
      g = sign_of(__fsub_rn(s, y));
      h = 1.0f;
      return;
    case kGradHuber: {
      const float d = __fsub_rn(s, y);
      g = fabsf(d) <= c0 ? d : __fmul_rn(sign_of(d), c0);
      h = 1.0f;
      return;
    }
    case kGradFair: {
      const float x = __fsub_rn(s, y);
      const float d = __fadd_rn(fabsf(x), c0);
      g = __fdiv_rn(__fmul_rn(c0, x), d);
      h = __fdiv_rn(c1, __fmul_rn(d, d));
      return;
    }
    case kGradPoisson:
      g = __fsub_rn(exp_xla(s), y);
      h = exp_xla(__fadd_rn(s, c0));
      return;
    case kGradQuantile:
      g = __fsub_rn(s, y) >= 0.0f ? c0 : c1;
      h = 1.0f;
      return;
    case kGradGamma: {
      const float m = __fmul_rn(y, exp_xla(-s));
      g = __fsub_rn(1.0f, m);
      h = m;
      return;
    }
    case kGradTweedie: {
      const float e1 = exp_xla(__fmul_rn(c0, s));
      const float e2 = exp_xla(__fmul_rn(c1, s));
      g = __fmaf_rn(-y, e1, e2);
      h = __fmaf_rn(__fmul_rn(-y, c0), e1, __fmul_rn(c1, e2));
      return;
    }
    case kGradXentropy: {
      const float z = __fdiv_rn(1.0f, __fadd_rn(1.0f, exp_xla(-s)));
      g = __fsub_rn(z, y);
      h = __fmul_rn(z, __fsub_rn(1.0f, z));
      return;
    }
    default:
      logistic(s, y > 0.0f, c0, c1, c2, g, h);
  }
}

// (g, h) of one row: from the grad/hess lanes at wcnt + gh_off (STANDARD:
// 2, EXT: 1), recomputed from the score lane and the meta label (COMPACT,
// `pointwise`), or for class cls (Mc) from its lane val_lane and whether
// the label of the meta lane is cls (c0, c1, c2 that class's sigmoid and
// label weights)
template <int Mc>
__device__ __forceinline__ void payload(const int32_t* chunk, int C, int r,
                                        int wcnt, int gh_off, int kind,
                                        float c0, float c1, float c2,
                                        int cls, int val_lane, int meta_lane,
                                        float& g, float& h) {
  if (Mc != kMcNone) {
    const float v =
        __int_as_float(chunk[static_cast<long long>(val_lane) * C + r]);
    const int meta = chunk[static_cast<long long>(meta_lane) * C + r];
    const bool lab = ((meta >> kMetaLabel) & kMetaLabelMask) == cls;
    if (Mc == kMcProb) {
      g = __fsub_rn(v, lab ? 1.0f : 0.0f);
      h = __fmul_rn(__fmul_rn(2.0f, v), __fsub_rn(1.0f, v));
    } else {
      logistic(v, lab, c0, c1, c2, g, h);
    }
    return;
  }
  if (kind == kGradLanes) {
    g = __int_as_float(chunk[static_cast<long long>(wcnt + gh_off) * C + r]);
    h = __int_as_float(
        chunk[static_cast<long long>(wcnt + gh_off + 1) * C + r]);
    return;
  }
  const float score = __int_as_float(chunk[static_cast<long long>(wcnt) * C
                                           + r]);
  const int meta = chunk[static_cast<long long>(meta_lane) * C + r];
  const float label = static_cast<float>((meta >> kMetaLabel)
                                         & kMetaLabelMask);
  pointwise(kind, score, label, c0, c1, c2, g, h);
}

// Row r of a chunk is in the bag: every row (kBagNone), bit 31 of the
// COMPACT meta word at lane meta_lane (kBagMeta), or the f32 lane bag_lane
// above 0.5 (kBagLane)
template <int Bag>
__device__ __forceinline__ bool in_bag(const int32_t* chunk, int C, int r,
                                       int meta_lane, int bag_lane) {
  if (Bag == kBagMeta) {
    return chunk[static_cast<long long>(meta_lane) * C + r] < 0;
  }
  if (Bag == kBagLane) {
    return __int_as_float(chunk[static_cast<long long>(bag_lane) * C + r])
        > 0.5f;
  }
  return true;
}

// Row r (of a chunk's cnt valid rows) with split word v goes left: a
// numerical split by goes_left (Bundled: of the unpacked bin); a
// categorical one (Cat) by bit b & 31 of its bitset's word b >> 5, which
// lane b >> 5 of the warp holds in cw (every lane of the warp must call
// it).
template <bool Cat, bool Bundled>
__device__ __forceinline__ int row_left(int v, int r, int cnt, int shift,
                                        int mask, int r1c, int r2c,
                                        unsigned cw) {
  const int b = (v >> shift) & mask;
  if (Cat) {
    const unsigned w = __shfl_sync(kFull, cw, b >> 5);
    return (r < cnt) & static_cast<int>((w >> (b & 31)) & 1u);
  }
  return r < cnt && goes_left(Bundled ? unpack_bundle(b, r2c) : b, r1c, r2c);
}

// The left rows of one chunk's rows r < cnt, one warp: the split word's
// lane read with 16-byte loads (vec: C % 4 == 0 and the records 16-byte
// aligned, so every lane of every chunk is), four in flight a thread, or
// one word at a time; each thread counts its rows, one warp sum. A
// categorical chunk (Cat, its bitset word j in lane j's cw) walks the rows
// in warp-uniform steps, since each row's word comes by a shuffle, with
// two loads in flight (the shuffles' operands would otherwise raise the
// kernel's registers). Valid in every lane.
template <bool Cat, bool Bundled>
__device__ __forceinline__ int warp_left_rows(const int32_t* word, int cnt,
                                              bool vec, int shift, int mask,
                                              int r1c, int r2c, unsigned cw,
                                              int lane) {
  constexpr int kLoads = Cat ? 2 : 4;
  // the numerical walk starts each lane at its own row, the categorical
  // one every lane at row 0 of the step (then offset by the lane)
  const int off = Cat ? lane : 0;
  int n = 0;
  if (vec) {
    const int4* w4 = reinterpret_cast<const int4*>(word);
    const int n4 = (cnt + 3) >> 2;     // 4 n4 <= C: within the lane
    for (int i0 = lane - off; i0 < n4; i0 += kLoads * 32) {
      int4 v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int i = i0 + off + 32 * j;
        v[j] = i < n4 ? __ldg(w4 + i) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int r = 4 * (i0 + off + 32 * j);
        n += row_left<Cat, Bundled>(v[j].x, r, cnt, shift, mask, r1c, r2c,
                                    cw)
            + row_left<Cat, Bundled>(v[j].y, r + 1, cnt, shift, mask, r1c,
                                     r2c, cw)
            + row_left<Cat, Bundled>(v[j].z, r + 2, cnt, shift, mask, r1c,
                                     r2c, cw)
            + row_left<Cat, Bundled>(v[j].w, r + 3, cnt, shift, mask, r1c,
                                     r2c, cw);
      }
    }
  } else {
    for (int r0 = lane - off; r0 < cnt; r0 += 32) {
      const int r = r0 + off;
      n += row_left<Cat, Bundled>(r < cnt ? __ldg(word + r) : 0, r, cnt,
                                  shift, mask, r1c, r2c, cw);
    }
  }
  return __reduce_add_sync(kFull, n);
}

// Left rows per slot (B3), one launch: the chunks with kslots in
// [0, num_slots) add their left rows r < min(meta count, C) to
// out[kslots] (a categorical chunk by row kslots of cbits); every other
// slot is 0. A persistent grid of CTAs of
// kCountThreads; each warp takes every (grid warps)-th chunk, counts it
// alone and adds it to the CTA's u32 counter of its slot in shared memory
// (a slot's chunks need not be neighbours). The CTA adds each of its
// non-zero counters to the scratch (u32 [num_slots], zero between calls)
// with one red, takes the ticket, and the last CTA writes out and zeroes
// the scratch and the ticket for the next call on the stream. Integer
// adds: exact, in any order. Bundled: the split values are unpacked
// before the routing (and no chunk is categorical).
template <bool Bundled>
__global__ void __launch_bounds__(kCountThreads, 4)
count_kernel(const int32_t* __restrict__ rec, long long nc, int W, int C,
             const int32_t* __restrict__ r1, const int32_t* __restrict__ r2,
             const int32_t* __restrict__ meta,
             const int32_t* __restrict__ wsel,
             const int32_t* __restrict__ kslots,
             const unsigned* __restrict__ cbits, int num_slots, int bits,
             int vec, unsigned* __restrict__ scratch,
             unsigned* __restrict__ ticket, int32_t* __restrict__ out) {
  extern __shared__ unsigned slot_left[];        // [num_slots]
  for (int i = threadIdx.x; i < num_slots; i += kCountThreads) {
    slot_left[i] = 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x)
      * (kCountThreads / 32);
  const int mask = (1 << bits) - 1;
  for (long long c = static_cast<long long>(blockIdx.x)
           * (kCountThreads / 32) + (threadIdx.x >> 5);
       c < nc; c += warps) {
    const int ks = kslots[c];
    const int cnt = min(meta[c] & kCntMask, C);
    if (ks < 0 || ks >= num_slots || cnt == 0) continue;   // warp-uniform
    const int r1c = r1[c];
    const int32_t* word =
        rec + (c * W + wsel[c]) * static_cast<long long>(C);
    const int shift = (r1c >> kShift) & 31;
    int n;
    // warp-uniform; a copy chunk (never counted by the engine) routes
    // every row left whatever its categorical bit
    if constexpr (Bundled) {
      n = warp_left_rows<false, true>(word, cnt, vec != 0, shift, mask, r1c,
                                      r2[c], 0u, lane);
    } else if (((r1c >> kCat) & 1) && !((r1c >> kCopy) & 1)) {
      const unsigned cw = lane < 8 && cbits != nullptr
          ? __ldg(cbits + 8LL * ks + lane) : 0u;
      n = warp_left_rows<true, false>(word, cnt, vec != 0, shift, mask, r1c,
                                      r2[c], cw, lane);
    } else {
      n = warp_left_rows<false, false>(word, cnt, vec != 0, shift, mask,
                                       r1c, r2[c], 0u, lane);
    }
    if (lane == 0 && n != 0) {
      atomicAdd(slot_left + ks, static_cast<unsigned>(n));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < num_slots; i += kCountThreads) {
    if (slot_left[i] != 0u) red_add(scratch + i, slot_left[i]);
  }
  if (last_to_arrive(ticket, gridDim.x)) {
    __threadfence();
    for (int i = threadIdx.x; i < num_slots; i += kCountThreads) {
      out[i] = static_cast<int32_t>(__ldcg(scratch + i));
      scratch[i] = 0u;
    }
    if (threadIdx.x == 0) *ticket = 0u;
  }
}

// ---------------------------------------------------------------------------
// The partition (B2): one launch, decoupled look-back over chunk tickets
// (the flag words, stage and ranking helpers are in partition.cuh)
// ---------------------------------------------------------------------------
// One CTA a chunk, by ticket. A split chunk (copy bit clear) sends its
// valid rows to the left child's chunks from basel[c] or the right's from
// baser[c], after the rows of its block's earlier chunks, in row order; a
// copy chunk moves its w_used lanes whole to basel[c]. The block's last
// chunk writes the smaller child's map: nslot = slot, ncnt = rows of each
// of its new chunks (hslots = slot | side << 24, slot == num_slots skips).
// A categorical split chunk ranks its rows by row `slot` of cbits.
// flags [nc], *ticket and ncnt come in zeroed. Shared memory: the mbarrier
// (16 B), the stage (lanes x C words), the permutation (C u16), the
// ballots and their prefix (2 x ceil(C / 32) words) and the 8 bitset
// words. Bundled: a split value is unpacked before it is routed (and no
// chunk is categorical).
template <bool Bundled>
__global__ void __launch_bounds__(kMoveThreads, 4)
partition_kernel(const int32_t* __restrict__ rec, int W, int C, int w_used,
                 int lanes, int bits, const int32_t* __restrict__ r1,
                 const int32_t* __restrict__ r2,
                 const int32_t* __restrict__ meta,
                 const int32_t* __restrict__ wsel,
                 const int32_t* __restrict__ basel,
                 const int32_t* __restrict__ baser,
                 const int32_t* __restrict__ hslots,
                 const unsigned* __restrict__ cbits, int num_slots,
                 unsigned long long* __restrict__ flags,
                 unsigned* __restrict__ ticket,
                 int32_t* __restrict__ nslot, int32_t* __restrict__ ncnt,
                 int32_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char part_smem[];
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(part_smem);
  int32_t* stage = reinterpret_cast<int32_t*>(part_smem + 16);
  unsigned short* perm = reinterpret_cast<unsigned short*>(
      stage + static_cast<long long>(lanes) * C);
  const int nw = (C + 31) >> 5;
  unsigned* ballot = reinterpret_cast<unsigned*>(
      part_smem + 16 + 4LL * lanes * C + ((2 * C + 15) & ~15));
  int* prefix = reinterpret_cast<int*>(ballot + nw);
  unsigned* cat_words = reinterpret_cast<unsigned*>(prefix + nw);   // [8]
  __shared__ long long s_chunk;
  __shared__ int s_ex_left, s_ex_valid;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_chunk = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long c = s_chunk;
  const int m = meta[c];
  const int cnt = m & kCntMask;
  const bool first = (m >> kFirst) & 1, last = (m >> kLast) & 1;
  const int r1c = r1[c];
  const bool split = ((r1c >> kCopy) & 1) == 0;
  const bool moves = split && cnt > 0;
  const bool cat = !Bundled && moves && ((r1c >> kCat) & 1);
  const long long cw = static_cast<long long>(W) * C;
  const int32_t* src = rec + c * cw;
  const int groups = (w_used + lanes - 1) / lanes;

  // 1. the first lane group of a split chunk into the stage
  if (moves && tid == 0) {
    stage_init(bar);
    stage_load(stage, src,
               4u * static_cast<unsigned>(min(lanes, w_used) * C), bar);
  }
  // a categorical split's 8 bitset words
  if (cat && tid < 8) {
    cat_words[tid] = cbits != nullptr
        ? __ldg(cbits + 8LL * (hslots[c] & 0xFFFFFF) + tid) : 0u;
  }
  // 2. rank: a ballot of left rows a word of 32 rows, their prefix
  int agg_left = 0, agg_valid = 0;
  if (moves) {
    const int ws = wsel[c];
    const bool staged = ws < lanes;
    if (staged || cat) {
      __syncthreads();         // the barrier's init and the words are seen
    }
    if (staged) stage_wait(bar, 0);
    const int32_t* word = staged ? stage + static_cast<long long>(ws) * C
                                 : src + static_cast<long long>(ws) * C;
    const int r2c = r2[c];
    const int shift = (r1c >> kShift) & 31, mask = (1 << bits) - 1;
    if (cat) {
      agg_left = rank_rows(cnt, nw, kMoveThreads, ballot, prefix,
                           [&](int r) {
        const int b = (word[r < C ? r : 0] >> shift) & mask;
        return ((cat_words[b >> 5] >> (b & 31)) & 1u) != 0u;
      });
    } else {
      agg_left = rank_rows(cnt, nw, kMoveThreads, ballot, prefix,
                           [&](int r) {
        const int b = (word[r < C ? r : 0] >> shift) & mask;
        return goes_left(Bundled ? unpack_bundle(b, r2c) : b, r1c, r2c);
      });
    }
    agg_valid = cnt;
  }
  // 3. publish the aggregate (a block's first chunk: its inclusive prefix)
  if (tid == 0) {
    publish(flags + c, flag_word(first ? kInclusive : kAggregate, agg_left,
                                 agg_valid));
  }
  // 4. the work that needs no prefix: a copy chunk's lanes; a split
  //    chunk's permutation (left rows at their rank, right rows after)
  if (!split && cnt > 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(out + basel[c] * cw);
    const int n4 = w_used * C / 4;
    for (int i = tid; i < n4; i += kMoveThreads) d4[i] = s4[i];
  }
  if (moves) {
    invert_ranks(cnt, agg_left, tid, kMoveThreads, ballot, prefix, perm);
  }
  // 5. the block's rows before this chunk (warp 0), then the inclusive
  //    prefix
  if (warp == 0) {
    int ex_left = 0, ex_valid = 0;
    if (!first) {
      look_back(flags, c, lane, ex_left, ex_valid);
      if (lane == 0) {
        publish(flags + c, flag_word(kInclusive, ex_left + agg_left,
                                     ex_valid + agg_valid));
      }
    }
    if (lane == 0) {
      s_ex_left = ex_left;
      s_ex_valid = ex_valid;
    }
  }
  __syncthreads();
  const int pl = s_ex_left, pr = s_ex_valid - s_ex_left;
  // 6. the smaller child's chunk map, at the block's last chunk
  if (split && last) {
    const int hs = hslots[c], slot = hs & 0xFFFFFF;
    if (slot < num_slots) {
      const int rl = pl + agg_left;
      const int rv = s_ex_valid + agg_valid;
      const bool right = (hs >> 24) & 1;
      const int tot = right ? rv - rl : rl;
      const int base = right ? baser[c] : basel[c];
      for (int j = tid; static_cast<long long>(j) * C < tot;
           j += kMoveThreads) {
        nslot[base + j] = slot;
        ncnt[base + j] = min(C, tot - j * C);
      }
    }
  }
  if (!moves) return;
  // 7. the stores, a lane group at a time: each lane's left run to
  //    basel's chunks from row pl, its right run to baser's from pr
  const long long bl = basel[c], br = baser[c];
  for (int g = 0; g < groups; ++g) {
    const int u0 = g * lanes, nu = min(lanes, w_used - u0);
    if (g > 0) {
      __syncthreads();                 // the last group's readers are done
      if (tid == 0) {
        stage_load(stage, src + static_cast<long long>(u0) * C,
                   4u * static_cast<unsigned>(nu * C), bar);
      }
    }
    if (g > 0 || wsel[c] >= lanes) stage_wait(bar, g & 1);
    for (int k = tid; k < cnt; k += kMoveThreads) {
      const bool left = k < agg_left;
      const int d = left ? pl + k : pr + (k - agg_left);
      const int q = d / C;
      int32_t* dst = out + ((left ? bl : br) + q) * cw + (d - q * C)
          + static_cast<long long>(u0) * C;
      const int32_t* from = stage + perm[k];
      for (int u = 0; u < nu; ++u) {
        dst[static_cast<long long>(u) * C] = from[static_cast<long long>(u)
                                                  * C];
      }
    }
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
// them). A row out of the bag (in_bag<Bag>) is skipped in both passes;
// Mc picks class cls's payload (payload<Mc>).
template <int Bag, int Mc>
__global__ void __launch_bounds__(kHistThreads, 1)
slot_hist_kernel(const int32_t* __restrict__ rec, int W, int C, int wcnt,
                 int gh_off, int bits, int num_features, int num_bins,
                 int feat_per_block, int tile_chunks, int nc,
                 const int32_t* __restrict__ slots,
                 const int32_t* __restrict__ meta, int num_slots, int kind,
                 float sig, float wp, float wn, int cls, int val_lane,
                 int meta_lane, int bag_lane, double* __restrict__ gh_out,
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
          if (r < tcnt[i + ci]
              && in_bag<Bag>(run + ci * cw, C, r, meta_lane, bag_lane)) {
            float g, h;
            payload<Mc>(run + ci * cw, C, r, wcnt, gh_off, kind, sig, wp, wn,
                        cls, val_lane, meta_lane, g, h);
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
          if (!in_bag<Bag>(chunk, C, r, meta_lane, bag_lane)) continue;
          float g, h;
          payload<Mc>(chunk, C, r, wcnt, gh_off, kind, sig, wp, wn, cls,
                      val_lane, meta_lane, g, h);
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

using SlotHistFn = void (*)(const int32_t*, int, int, int, int, int, int,
                            int, int, int, int, const int32_t*,
                            const int32_t*, int, int, float, float, float,
                            int, int, int, int, double*, unsigned*);

// The instantiations: the single-class routes in each bag mode, the class
// kinds unbagged and with COMPACT's meta bit
const SlotHistFn kSlotHist[] = {
    slot_hist_kernel<kBagNone, kMcNone>, slot_hist_kernel<kBagMeta, kMcNone>,
    slot_hist_kernel<kBagLane, kMcNone>, slot_hist_kernel<kBagNone, kMcProb>,
    slot_hist_kernel<kBagMeta, kMcProb>, slot_hist_kernel<kBagNone, kMcScore>,
    slot_hist_kernel<kBagMeta, kMcScore>};

// The instantiation of a launch: its bag mode and payload kind, or null
// for a pair no route takes (a class kind with an f32 bag lane)
SlotHistFn slot_hist_for(int kind, int bag_lane) {
  const int bag = bag_lane == -1 ? 0 : bag_lane == -2 ? 1 : 2;
  if (kind == kGradProb) return bag == 2 ? nullptr : kSlotHist[3 + bag];
  if (kind == kGradScore) return bag == 2 ? nullptr : kSlotHist[5 + bag];
  return kSlotHist[bag];
}

}  // namespace

extern "C" {

// B3: out[num_slots] = left rows of the chunks whose kslots entry is that
// slot, in one launch of `grid` CTAs with num_slots u32 of dynamic shared
// memory (ops/aligned.py::count_launch_shape); cbits the round's bitset
// table (null: none); bundled: the instantiation that unpacks bundled
// split values; scratch (u32 [num_slots]) and ticket are zero before and
// after the call. vec: C % 4 == 0 and rec 16-byte aligned. Returns the
// CUDA error code (0 = ok).
int lgbt_count_pass(const void* rec, long long nc, int W, int C,
                    const void* r1, const void* r2, const void* meta,
                    const void* wsel, const void* kslots, const void* cbits,
                    int num_slots, int bits, int bundled, int vec, int grid,
                    void* scratch, void* ticket, void* out, void* stream) {
  const int smem = static_cast<int>(sizeof(unsigned)) * num_slots;
  auto kernel = bundled ? count_kernel<true> : count_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kCountThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rec), nc, W, C,
      static_cast<const int32_t*>(r1), static_cast<const int32_t*>(r2),
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(wsel),
      static_cast<const int32_t*>(kslots),
      static_cast<const unsigned*>(cbits), num_slots, bits, vec,
      static_cast<unsigned*>(scratch), static_cast<unsigned*>(ticket),
      static_cast<int32_t*>(out));
  return check();
}

// CTAs of count_kernel (its bundled instantiation where `bundled`) that
// the CUDA occupancy calculator fits on an SM of the current device with
// `smem` bytes of dynamic shared memory each; 0 where they do not fit, -1
// on a CUDA error. The kernel's opt-in is raised only above the default
// 48 KB, never lowered (a later call with more slots launches within it).
int lgbt_count_occupancy(int smem, int bundled) {
  int n = -1;
  auto kernel = bundled ? count_kernel<true> : count_kernel<false>;
  if (smem > 48 * 1024
      && cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem) != cudaSuccess) {
    cudaGetLastError();                  // too much: clear the error
    return 0;
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, kCountThreads, smem) != cudaSuccess) {
    return -1;
  }
  return n;
}

// B2, the partition, into out ([NC, W, C], rows outside the new layout
// untouched): one memset of scratch (int32 [4 NC + 2]: the flag words
// [NC] u64, the ticket and a pad word, nslot [NC], ncnt [NC]), then one
// launch of partition_kernel with `lanes` lanes a stage and `smem` bytes
// of dynamic shared memory (ops/aligned.py::move_smem); cbits the round's
// bitset table (null: none); bundled: the instantiation that unpacks
// bundled split values. nslot and ncnt hold the smaller children's map
// (ncnt 0 elsewhere).
int lgbt_move_partition(const void* rec, int nc, int W, int C, int w_used,
                        int lanes, int smem, int bits, const void* r1,
                        const void* r2, const void* meta, const void* wsel,
                        const void* basel, const void* baser,
                        const void* hslots, const void* cbits, int num_slots,
                        int bundled, void* scratch, void* out,
                        void* stream) {
  if (nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, sizeof(int32_t) * (4 * static_cast<size_t>(nc) + 2), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = bundled ? partition_kernel<true> : partition_kernel<false>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int32_t* sc = static_cast<int32_t*>(scratch);
  kernel<<<nc, kMoveThreads, smem, s>>>(
      static_cast<const int32_t*>(rec), W, C, w_used, lanes, bits,
      static_cast<const int32_t*>(r1), static_cast<const int32_t*>(r2),
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(wsel),
      static_cast<const int32_t*>(basel), static_cast<const int32_t*>(baser),
      static_cast<const int32_t*>(hslots),
      static_cast<const unsigned*>(cbits), num_slots,
      reinterpret_cast<unsigned long long*>(sc),
      reinterpret_cast<unsigned*>(sc + 2 * nc), sc + 2 * nc + 2,
      sc + 3 * nc + 2, static_cast<int32_t*>(out));
  return check();
}

// B4 (and B2's smaller-child histograms): out [num_slots, F, B, 3] f32;
// gh ([num_slots, F, B, 2] f64) and cnt ([num_slots, F, B] u32) are
// accumulators zeroed by the caller. kind 0 reads the grad/hess lanes at
// wcnt + gh_off; 1 (binary logloss), 2 (l2) and 5-12 (l1, huber, fair,
// poisson, quantile, gamma, tweedie, xentropy) recompute them from the
// score lane and the meta lane meta_lane, with the kind's constants in
// sig, wp, wn (`pointwise`); 3 (softmax) and 4 (one-vs-all) class cls's
// from lane val_lane and the meta lane. bag_lane -1 takes
// every valid row, -2 the rows with COMPACT's meta bit 31 set, >= 0
// those whose f32 lane bag_lane is above 0.5 (not with kinds 3 and 4).
// feat_per_block, tile_chunks, grid_x and smem are the launch shape of
// ops/aligned.py::slot_hist_launch_shape.
int lgbt_slot_hist(const void* rec, int nc, int W, int C, int wcnt,
                   int gh_off, int bits, int num_features, int num_bins,
                   int feat_per_block, int tile_chunks, int grid_x, int smem,
                   const void* slots, const void* meta, int num_slots,
                   int kind, float sig, float wp, float wn, int cls,
                   int val_lane, int meta_lane, int bag_lane, void* gh,
                   void* cnt, void* out, void* stream) {
  if (nc == 0 || num_features == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SlotHistFn kernel = slot_hist_for(kind, bag_lane);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid_y = (num_features + feat_per_block - 1) / feat_per_block;
  kernel<<<dim3(grid_x, grid_y), kHistThreads, smem, s>>>(
      static_cast<const int32_t*>(rec), W, C, wcnt, gh_off, bits,
      num_features, num_bins, feat_per_block, tile_chunks, nc,
      static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(meta), num_slots, kind, sig, wp, wn, cls,
      val_lane, meta_lane, bag_lane, static_cast<double*>(gh),
      static_cast<unsigned*>(cnt));
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
// each, the fewest of its instantiations; 0 where they do not fit, -1 on
// a CUDA error.
int lgbt_slot_hist_occupancy(int smem) {
  int fewest = -1;
  for (const SlotHistFn kernel : kSlotHist) {
    int n = -1;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess) {
      cudaGetLastError();                // too much: clear the error
      return 0;
    }
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, kHistThreads, smem) != cudaSuccess) {
      return -1;
    }
    if (fewest < 0 || n < fewest) fewest = n;
  }
  return fewest;
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
