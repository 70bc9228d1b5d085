// Kernel B6 for Hopper (sm_90a): the lambdarank gradient, per document
// g and h of the NDCG-weighted pairwise loss over every query.
//
// Replaces the TPU kernel of lightgbm_tpu/ops/pallas_rank.py:
//   B6 make_fused_grad_fn (_rank_tile_kernel, pallas_call at :345)
// and computes the JAX package's bucketed formula (lightgbm_tpu/ops/
// objectives.py, LambdarankNDCG._make_grad_fn) per query, the formula the
// TPU kernel evaluates too.
//
// What the TPU kernel does that has no counterpart here: it packs queries
// into 512-slot tiles of 128-slot subtiles with a static band, keeps row
// and column copies of every input to avoid an in-kernel transpose, and
// looks discounts up with a one-hot MXU product; queries longer than a
// tile go to a padded [Q, S, S] pair-tensor path outside the kernel.
// Here one launch takes every query, by a work list of two kinds of item
// (ops/rank.py::rank_work) that CTAs draw by ticket:
//   - short items: one or several whole queries of at most 512 documents
//     whose labels lie in [0, 32) (every MSLR query), one query at a time
//     in shared memory. One pass over the query counts each document's
//     rank by score (j precedes i when s_j > s_i, or s_j == s_i and j < i:
//     a stable descending sort) and its place in a stable counting sort by
//     label, descending; the documents go to that sorted order with their
//     discount disc[rank]. The pairs with different labels are then the
//     rectangles (higher label group x lower label group), laid end to end;
//     each thread evaluates a register block of 8 consecutive pairs of a
//     chunk of 1,024, whose high member is the row: no select, no lane on
//     an equal-label pair, each unordered pair once. Each document's owner
//     thread then folds its row runs (+lam) and column entries (-lam) of
//     the chunk from shared memory in a fixed order, so the sums are
//     deterministic without floating-point atomics.
//   - long items: the CTAs of a longer query (or one with larger labels),
//     at most 128 a query, each owning row blocks of 64 documents. They
//     count their documents' ranks into the disc_rows scratch, meet on the
//     query's arrival counter (the CTAs of one query have consecutive
//     tickets and are fewer than the card holds at once, so the wait ends),
//     and then walk: thread i owns document i and half of the query's j,
//     each pair seen from both members, the halves added in a fixed order.
//     Nothing is shared between queries, so no CTA reduces into another.
// The reference's quantized sigmoid table (lut_bins cells) applies per
// query: to the queries of at most lut_len documents, the ones the JAX
// package's TPU kernel would take (its bucketed path computes the exact
// sigmoid); 0 tables none.
//
// Numerics: the JAX package computes the pair factors in bf16, rounding
// after every bf16 operation (XLA's CPU backend does so), with the score
// differences taken in f32 first. Each operation here is the f32
// operation pinned by __fsub_rn/__fmul_rn/__fadd_rn/__fdiv_rn (nvcc
// contracts nothing) followed by a round to nearest even bf16, at exactly
// the JAX formula's points, and exp is XLA's polynomial (xla_math.cuh).
// Sums are f32 in a fixed order: they differ from the JAX package's only
// in summation order.
//
// What bounds it on an H100: operations. It reads each document's score,
// label and gain and writes g and h (20 bytes a document), while it
// evaluates one pair factor of some 47 f32 operations (exp's polynomial,
// two divisions, nine bf16 roundings) for each unordered pair with
// different labels, and counts ranks over every pair of a query.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "xla_math.cuh"

namespace {

constexpr int kThreads = 128;     // threads per CTA
constexpr int kRowDocs = 64;      // documents a long row block (BLOCK_DOCS)
constexpr int kMaxDocs = 512;     // the longest short query (SHORT_DOCS)
constexpr int kMaxGroups = 32;    // labels of a short query (MAX_LABELS)
constexpr int kMaxRects = kMaxGroups * (kMaxGroups - 1) / 2;
constexpr int kPairBlock = 8;     // pairs a thread evaluates a chunk
constexpr int kChunk = kThreads * kPairBlock;
constexpr int kOwned = kMaxDocs / kThreads;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (lam, hes) of one pair (hi has the higher label), the JAX package's
// bucketed formula with its bf16 rounding points
__device__ __forceinline__ void pair_terms(float s_hi, float s_lo,
                                           float g_hi, float g_lo,
                                           float d_hi, float d_lo,
                                           float inv_b, bool norm_on,
                                           float two_sig, int lut_bins,
                                           float lut_factor, float& lam,
                                           float& hes) {
  const float ds = bf(__fsub_rn(s_hi, s_lo));
  const float dgap = bf(__fsub_rn(g_hi, g_lo));
  const float pd = bf(fabsf(__fsub_rn(d_hi, d_lo)));
  float delta = bf(__fmul_rn(bf(__fmul_rn(dgap, pd)), inv_b));
  if (norm_on) {
    delta = bf(__fdiv_rn(delta, bf(__fadd_rn(bf(0.01f), fabsf(ds)))));
  }
  float x = ds;
  if (lut_bins > 0) {
    // the reference's quantized sigmoid table (rank_objective.hpp:71):
    // clamp to [-50, 50], floor to a cell's left edge
    const float cx = fminf(fmaxf(x, -50.0f), 50.0f);
    float idx = floorf(__fmul_rn(__fadd_rn(cx, 50.0f), lut_factor));
    idx = fminf(fmaxf(idx, 0.0f), static_cast<float>(lut_bins - 1));
    x = __fsub_rn(__fdiv_rn(idx, lut_factor), 50.0f);
  }
  const float p = bf(__fdiv_rn(
      2.0f, __fadd_rn(1.0f, exp_xla(__fmul_rn(two_sig, x)))));
  const float p_hess = bf(__fmul_rn(p, bf(__fsub_rn(2.0f, p))));
  lam = bf(__fmul_rn(-p, delta));
  hes = bf(__fmul_rn(__fmul_rn(p_hess, 2.0f), delta));
}

struct Params {
  const float* score;
  const int32_t* label;
  const float* gain;
  const int32_t* qoff;
  const float* inv;
  const float* disc;
  float two_sig;
  int lut_bins;
  float lut_factor;
  int lut_len;
  float* disc_rows;
  int32_t* sync;
  float* g;
  float* h;
};

// norm_on = max(s) != min(s) over the c scores at s (every thread)
__device__ bool spread(const float* s, int c, bool from_global) {
  __shared__ float red_hi[kThreads / 32], red_lo[kThreads / 32];
  float hi_v = -CUDART_INF_F, lo_v = CUDART_INF_F;
  for (int j = threadIdx.x; j < c; j += kThreads) {
    const float v = from_global ? __ldg(s + j) : s[j];
    hi_v = fmaxf(hi_v, v);
    lo_v = fminf(lo_v, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    hi_v = fmaxf(hi_v, __shfl_xor_sync(kFull, hi_v, o));
    lo_v = fminf(lo_v, __shfl_xor_sync(kFull, lo_v, o));
  }
  if ((threadIdx.x & 31) == 0) {
    red_hi[threadIdx.x >> 5] = hi_v;
    red_lo[threadIdx.x >> 5] = lo_v;
  }
  __syncthreads();
  float mx = red_hi[0], mn = red_lo[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    mx = fmaxf(mx, red_hi[w]);
    mn = fminf(mn, red_lo[w]);
  }
  __syncthreads();                     // red_* free for the next call
  return mx != mn;
}

// A short query held in shared memory: its documents in their order (s,
// l), then sorted by label, descending (ss, sg, sd and the original index
// sidx), the label groups, the rectangles of pairs of groups and a chunk
// of pair factors.
struct ShortSmem {
  float s[kMaxDocs];
  int l[kMaxDocs];
  float ss[kMaxDocs], sg[kMaxDocs], sd[kMaxDocs];
  unsigned short sidx[kMaxDocs];
  int cnt[kMaxGroups];
  int gstart[kMaxGroups + 1];
  unsigned short rect_of[kMaxGroups * kMaxGroups];  // [a][b], a < b
  int roff[kMaxRects + 1];
  unsigned char ra[kMaxRects], rb[kMaxRects];
  float lam[kChunk], hes[kChunk];
  int ngroups, nrects;
};

// The queries q0 .. q1 - 1, each of at most kMaxDocs documents with
// labels in [0, kMaxGroups), one after the other.
__device__ void short_queries(const Params& p, int q0, int q1,
                              ShortSmem& sm) {
  const int tid = threadIdx.x;
  for (int q = q0; q < q1; ++q) {
    const int lo = p.qoff[q], c = p.qoff[q + 1] - lo;
    if (c <= 0) continue;
    for (int i = tid; i < c; i += kThreads) {
      sm.s[i] = p.score[lo + i];
      sm.l[i] = p.label[lo + i];
    }
    if (tid < kMaxGroups) sm.cnt[tid] = 0;
    __syncthreads();
    const bool norm_on = spread(sm.s, c, false);
    const float inv_b = bf(p.inv[q]);
    const int lut = c <= p.lut_len ? p.lut_bins : 0;   // this query's table
    // 1. rank by score and place by label in one pass over the query
    for (int i = tid; i < c; i += kThreads) {
      const float si = sm.s[i];
      const int li = sm.l[i];
      int rank = 0, pos = 0;
      for (int j = 0; j < c; ++j) {
        const float sj = sm.s[j];
        const int lj = sm.l[j];
        rank += (sj > si || (sj == si && j < i)) ? 1 : 0;
        pos += (lj > li || (lj == li && j < i)) ? 1 : 0;
      }
      sm.ss[pos] = si;
      sm.sg[pos] = bf(p.gain[lo + i]);
      sm.sd[pos] = p.disc[rank];
      sm.sidx[pos] = static_cast<unsigned short>(i);
      atomicAdd(&sm.cnt[li], 1);
    }
    __syncthreads();
    // 2. the groups by label, descending, and their rectangles
    if (tid == 0) {
      int ng = 0, start = 0;
      for (int v = kMaxGroups - 1; v >= 0; --v) {
        if (sm.cnt[v] == 0) continue;
        sm.gstart[ng++] = start;
        start += sm.cnt[v];
      }
      sm.gstart[ng] = start;
      int nr = 0, off = 0;
      for (int a = 0; a < ng; ++a) {
        for (int b = a + 1; b < ng; ++b) {
          sm.rect_of[a * kMaxGroups + b] = static_cast<unsigned short>(nr);
          sm.ra[nr] = static_cast<unsigned char>(a);
          sm.rb[nr] = static_cast<unsigned char>(b);
          sm.roff[nr++] = off;
          off += (sm.gstart[a + 1] - sm.gstart[a])
              * (sm.gstart[b + 1] - sm.gstart[b]);
        }
      }
      sm.roff[nr] = off;
      sm.ngroups = ng;
      sm.nrects = nr;
    }
    __syncthreads();
    const int ng = sm.ngroups, nr = sm.nrects, npairs = sm.roff[nr];
    // the documents this thread owns (sorted places) and their groups
    int grp[kOwned];
    float acc_g[kOwned], acc_h[kOwned];
#pragma unroll
    for (int k = 0; k < kOwned; ++k) {
      const int pl = tid + k * kThreads;
      int a = 0;
      while (a + 1 < ng && sm.gstart[a + 1] <= pl) ++a;
      grp[k] = a;
      acc_g[k] = 0.0f;
      acc_h[k] = 0.0f;
    }
    // 3. chunks of pair factors, then each owner's fixed-order fold
    for (int t0 = 0; t0 < npairs; t0 += kChunk) {
      const int t1 = min(npairs, t0 + kChunk);
      int t = t0 + tid * kPairBlock;
      if (t < t1) {
        int r = 0;                     // the rectangle holding pair t
        while (sm.roff[r + 1] <= t) ++r;
        int a = sm.ra[r], b = sm.rb[r];
        int nb = sm.gstart[b + 1] - sm.gstart[b];
        int i = (t - sm.roff[r]) / nb, j = t - sm.roff[r] - i * nb;
        const int tend = min(t1, t + kPairBlock);
        for (; t < tend; ++t) {
          const int hi = sm.gstart[a] + i, lo2 = sm.gstart[b] + j;
          float lam, hes;
          pair_terms(sm.ss[hi], sm.ss[lo2], sm.sg[hi], sm.sg[lo2],
                     sm.sd[hi], sm.sd[lo2], inv_b, norm_on, p.two_sig, lut,
                     p.lut_factor, lam, hes);
          sm.lam[t - t0] = lam;
          sm.hes[t - t0] = hes;
          if (++j == nb) {
            j = 0;
            if (++i == sm.gstart[a + 1] - sm.gstart[a] && r + 1 < nr) {
              i = 0;
              ++r;
              a = sm.ra[r];
              b = sm.rb[r];
              nb = sm.gstart[b + 1] - sm.gstart[b];
            }
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kOwned; ++k) {
        const int pl = tid + k * kThreads;
        if (pl >= c) continue;
        const int a = grp[k], i = pl - sm.gstart[a];
        const int na = sm.gstart[a + 1] - sm.gstart[a];
        float ag = acc_g[k], ah = acc_h[k];
        // as the higher member: row i of rectangles (a, b), in order (a
        // rectangle outside the chunk is skipped before any index math)
        for (int b = a + 1; b < ng; ++b) {
          const int rr = sm.rect_of[a * kMaxGroups + b];
          if (sm.roff[rr + 1] <= t0 || sm.roff[rr] >= t1) continue;
          const int nb = sm.gstart[b + 1] - sm.gstart[b];
          const int row = sm.roff[rr] + i * nb;
          const int u1 = min(row + nb, t1);
          for (int u = max(row, t0); u < u1; ++u) {
            ag = __fadd_rn(ag, sm.lam[u - t0]);
            ah = __fadd_rn(ah, sm.hes[u - t0]);
          }
        }
        // as the lower member: column i of rectangles (a2, a), in order
        for (int a2 = 0; a2 < a; ++a2) {
          const int rr = sm.rect_of[a2 * kMaxGroups + a];
          if (sm.roff[rr + 1] <= t0 || sm.roff[rr] >= t1) continue;
          const int n2 = sm.gstart[a2 + 1] - sm.gstart[a2];
          const int col = sm.roff[rr] + i;
          const int d0 = t0 - col, d1 = t1 - 1 - col;
          if (d1 < 0) continue;
          const int i2lo = d0 <= 0 ? 0 : (d0 + na - 1) / na;
          const int i2hi = min(n2, d1 / na + 1);
          for (int i2 = i2lo; i2 < i2hi; ++i2) {
            const int u = col + i2 * na - t0;
            ag = __fsub_rn(ag, sm.lam[u]);
            ah = __fadd_rn(ah, sm.hes[u]);
          }
        }
        acc_g[k] = ag;
        acc_h[k] = ah;
      }
      __syncthreads();                 // the chunk's factors are read
    }
#pragma unroll
    for (int k = 0; k < kOwned; ++k) {
      const int pl = tid + k * kThreads;
      if (pl < c) {
        p.g[lo + sm.sidx[pl]] = acc_g[k];
        p.h[lo + sm.sidx[pl]] = acc_h[k];
      }
    }
    __syncthreads();                   // the query's arrays are free
  }
}

// CTA k of the m of a long query q (its arrival and departure counters at
// slot): row blocks k, k + m, ... of kRowDocs documents. Threads t and t +
// 64 own document i0 + t; each takes half of the query's documents j.
__device__ void long_rows(const Params& p, int q, int k, int m, int slot) {
  __shared__ int part_n[kThreads];
  __shared__ float part_g[kThreads], part_h[kThreads];
  const int tid = threadIdx.x, t = tid & (kRowDocs - 1), half = tid >> 6;
  const int lo = p.qoff[q], c = p.qoff[q + 1] - lo;
  const float* s = p.score + lo;
  const int32_t* l = p.label + lo;
  const float* gn = p.gain + lo;
  const int mid = c / 2;
  const int j0 = half ? mid : 0, j1 = half ? c : mid;
  // 1. the ranks of this CTA's documents, their discounts to disc_rows
  for (int i0 = k * kRowDocs; i0 < c; i0 += m * kRowDocs) {
    const int i = i0 + t;
    int rank = 0;
    if (i < c) {
      const float si = __ldg(s + i);
      for (int j = j0; j < j1; ++j) {
        const float sj = __ldg(s + j);
        rank += (sj > si || (sj == si && j < i)) ? 1 : 0;
      }
    }
    part_n[tid] = rank;
    __syncthreads();
    if (half == 0 && i < c) {
      p.disc_rows[lo + i] = p.disc[part_n[t] + part_n[t + kRowDocs]];
    }
    __syncthreads();
  }
  // 2. meet the query's other CTAs: every discount is written
  if (tid == 0) {
    int32_t* arrive = p.sync + 1 + 2 * slot;
    __threadfence();
    atomicAdd(arrive, 1);
    while (*reinterpret_cast<volatile int32_t*>(arrive) < m) {
    }
    __threadfence();
    if (atomicAdd(arrive + 1, 1) == m - 1) {   // the last to leave resets
      *arrive = 0;
      arrive[1] = 0;
    }
  }
  __syncthreads();
  const bool norm_on = spread(s, c, true);
  const float inv_b = bf(p.inv[q]);
  const int lut = c <= p.lut_len ? p.lut_bins : 0;
  const float* dr = p.disc_rows + lo;
  // 3. the walk: every j of this thread's half, in order
  for (int i0 = k * kRowDocs; i0 < c; i0 += m * kRowDocs) {
    const int i = i0 + t;
    float ga = 0.0f, ha = 0.0f;
    if (i < c) {
      const float si = __ldg(s + i), gi = bf(__ldg(gn + i));
      const float di = __ldcg(dr + i);
      const int li = __ldg(l + i);
      for (int j = j0; j < j1; ++j) {
        const int lj = __ldg(l + j);
        if (lj == li) continue;
        const bool up = li > lj;          // doc i is the higher member
        const float sj = __ldg(s + j), gj = bf(__ldg(gn + j));
        const float dj = __ldcg(dr + j);
        float lam, hes;
        pair_terms(up ? si : sj, up ? sj : si, up ? gi : gj, up ? gj : gi,
                   up ? di : dj, up ? dj : di, inv_b, norm_on, p.two_sig,
                   lut, p.lut_factor, lam, hes);
        ga = up ? __fadd_rn(ga, lam) : __fsub_rn(ga, lam);
        ha = __fadd_rn(ha, hes);
      }
    }
    part_g[tid] = ga;
    part_h[tid] = ha;
    __syncthreads();
    if (half == 0 && i < c) {
      p.g[lo + i] = __fadd_rn(part_g[t], part_g[t + kRowDocs]);
      p.h[lo + i] = __fadd_rn(part_h[t], part_h[t + kRowDocs]);
    }
    __syncthreads();
  }
}

// One work item a CTA, drawn by ticket (sync[0]; the CTA that draws the
// last one resets it): items int32 [n, 4] = (0, q0, q1, 0) for short
// queries q0 .. q1 - 1, or (1 | slot << 1, q, k, m) for CTA k of the m of
// a long query.
__global__ void __launch_bounds__(kThreads)
rank_kernel(Params p, const int4* __restrict__ items, int nitems) {
  __shared__ ShortSmem sm;
  __shared__ int s_item;
  if (threadIdx.x == 0) {
    const int t = atomicAdd(p.sync, 1);
    if (t == nitems - 1) atomicExch(p.sync, 0);
    s_item = t;
  }
  __syncthreads();
  const int4 it = items[s_item];
  if ((it.x & 1) == 0) {
    short_queries(p, it.y, it.z, sm);
  } else {
    long_rows(p, it.y, it.z, it.w, it.x >> 1);
  }
}

}  // namespace

extern "C" {

// B6: g, h [N] f32 of every document of queries qoff[q] .. qoff[q + 1]
// (documents outside every query untouched); items int32 [nitems, 4] and
// sync int32 [1 + 2 x long queries] (zeroed once, left zeroed by each
// launch) are `ops/rank.py::rank_work`'s; label int32 [N], gain f32 [N]
// (label_gain[label]), inv f32 [Q] (1 / max DCG at max_position), disc
// f32 (rank-position discounts, at least the longest query long),
// disc_rows f32 [N] scratch (the long queries' documents); the queries of
// at most lut_len documents take the sigmoid table of lut_bins cells.
// Returns the CUDA error code (0 = ok).
int lgbt_rank_grad(const void* score, const void* label, const void* gain,
                   const void* qoff, const void* items, int nitems,
                   const void* inv, const void* disc, float two_sig,
                   int lut_bins, float lut_factor, int lut_len,
                   void* disc_rows, void* sync, void* g, void* h,
                   void* stream) {
  if (nitems == 0) return 0;
  Params p;
  p.score = static_cast<const float*>(score);
  p.label = static_cast<const int32_t*>(label);
  p.gain = static_cast<const float*>(gain);
  p.qoff = static_cast<const int32_t*>(qoff);
  p.inv = static_cast<const float*>(inv);
  p.disc = static_cast<const float*>(disc);
  p.two_sig = two_sig;
  p.lut_bins = lut_bins;
  p.lut_factor = lut_factor;
  p.lut_len = lut_len;
  p.disc_rows = static_cast<float*>(disc_rows);
  p.sync = static_cast<int32_t*>(sync);
  p.g = static_cast<float*>(g);
  p.h = static_cast<float*>(h);
  rank_kernel<<<nitems, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int4*>(items), nitems);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
