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
// Here the work is cut into blocks of kThreads documents of one query
// (CSR offsets qoff; a table lists each block's query and first document,
// so a long query spreads over many CTAs), and two kernels run in turn:
//   1. rank_disc_kernel: each document's rank by counting over its query:
//      j precedes i when s_j > s_i, or s_j == s_i and j < i (a stable
//      descending sort); its discount disc[rank] goes to the disc_rows
//      scratch;
//   2. rank_pair_kernel: the query's max and min score (norm_on = max !=
//      min), then thread i owns document i and walks every j of the query
//      in order, through shared-memory tiles of kThreads documents. A pair
//      with l_i > l_j adds lam to g_i, one with l_j > l_i subtracts it
//      (the JAX package's g = rowsum - colsum), and both add hes to h_i.
//      Each pair is evaluated twice, once for each member, so nothing is
//      shared between CTAs: no atomics, and the result is deterministic.
// Every query length runs here and nothing falls back. The reference's
// quantized sigmoid table (lut_bins cells) applies per query: to the
// queries of at most lut_len documents, the ones the JAX package's TPU
// kernel would take (its bucketed path computes the exact sigmoid); 0
// tables none.
//
// Numerics: the JAX package computes the pair factors in bf16, rounding
// after every bf16 operation (XLA's CPU backend does so), with the score
// differences taken in f32 first. Each operation here is the f32
// operation pinned by __fsub_rn/__fmul_rn/__fadd_rn/__fdiv_rn (nvcc
// contracts nothing) followed by a round to nearest even bf16, at exactly
// the JAX formula's points, and exp is XLA's polynomial (xla_math.cuh).
// Sums are f32 in j order: they differ from the JAX package's only in
// summation order.
//
// What bounds it on an H100: operations. It reads each document's score,
// label, gain and writes g and h (about 28 bytes a document with the
// discount scratch), while it evaluates about 2 x sum(c^2) pair factors
// of some 60 f32 operations each (exp's polynomial, two divisions, nine
// bf16 roundings).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "xla_math.cuh"

namespace {

constexpr int kThreads = 64;    // threads per CTA = documents per tile
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

// (q, i0) of this CTA: query q, its documents i0 .. i0 + kThreads
struct Block {
  int lo, c, i;
};

__device__ __forceinline__ Block block_of(const int32_t* __restrict__ blocks,
                                          const int32_t* __restrict__ qoff) {
  const int q = blocks[2 * blockIdx.x];
  Block b;
  b.lo = qoff[q];
  b.c = qoff[q + 1] - b.lo;
  b.i = blocks[2 * blockIdx.x + 1] + static_cast<int>(threadIdx.x);
  return b;
}

// pass 1: each document's rank by counting, and its discount disc[rank]
// into disc_rows
__global__ void __launch_bounds__(kThreads)
rank_disc_kernel(const float* __restrict__ score,
                 const int32_t* __restrict__ qoff,
                 const int32_t* __restrict__ blocks,
                 const float* __restrict__ disc,
                 float* __restrict__ disc_rows) {
  __shared__ float t_s[kThreads];
  const Block b = block_of(blocks, qoff);
  const float* s = score + b.lo;
  const int t = threadIdx.x;
  const bool act = b.i < b.c;
  const float si = act ? s[b.i] : 0.0f;
  int rank = 0;
  for (int j0 = 0; j0 < b.c; j0 += kThreads) {
    __syncthreads();
    if (j0 + t < b.c) t_s[t] = s[j0 + t];
    __syncthreads();
    const int nj = min(kThreads, b.c - j0);
    if (act) {
      for (int jj = 0; jj < nj; ++jj) {
        const float sj = t_s[jj];
        rank += (sj > si || (sj == si && j0 + jj < b.i)) ? 1 : 0;
      }
    }
  }
  if (act) disc_rows[b.lo + b.i] = disc[rank];
}

// pass 2: norm_on = max(s) != min(s) over the query, then every pair of
// this CTA's documents
__global__ void __launch_bounds__(kThreads)
rank_pair_kernel(const float* __restrict__ score,
                 const int32_t* __restrict__ label,
                 const float* __restrict__ gain,
                 const int32_t* __restrict__ qoff,
                 const int32_t* __restrict__ blocks,
                 const float* __restrict__ inv,
                 const float* __restrict__ disc_rows, float two_sig,
                 int lut_bins, float lut_factor, int lut_len,
                 float* __restrict__ g_out, float* __restrict__ h_out) {
  __shared__ float t_s[kThreads], t_g[kThreads], t_d[kThreads];
  __shared__ int t_l[kThreads];
  __shared__ float red_hi[kThreads / 32], red_lo[kThreads / 32];
  const Block b = block_of(blocks, qoff);
  const int t = threadIdx.x;
  const float* s = score + b.lo;
  const int32_t* l = label + b.lo;
  const float* gn = gain + b.lo;
  const float* dr = disc_rows + b.lo;

  float hi_v = -CUDART_INF_F, lo_v = CUDART_INF_F;
  for (int j = t; j < b.c; j += kThreads) {
    hi_v = fmaxf(hi_v, s[j]);
    lo_v = fminf(lo_v, s[j]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    hi_v = fmaxf(hi_v, __shfl_xor_sync(kFull, hi_v, o));
    lo_v = fminf(lo_v, __shfl_xor_sync(kFull, lo_v, o));
  }
  if ((t & 31) == 0) {
    red_hi[t >> 5] = hi_v;
    red_lo[t >> 5] = lo_v;
  }
  __syncthreads();
  float mx = red_hi[0], mn = red_lo[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    mx = fmaxf(mx, red_hi[w]);
    mn = fminf(mn, red_lo[w]);
  }
  const bool norm_on = mx != mn;

  const float inv_b = bf(inv[blocks[2 * blockIdx.x]]);
  const int lut = b.c <= lut_len ? lut_bins : 0;    // this query's table
  const bool act = b.i < b.c;
  float si = 0.0f, gi = 0.0f, di = 0.0f;
  int li = 0;
  if (act) {
    si = s[b.i];
    li = l[b.i];
    gi = bf(gn[b.i]);
    di = dr[b.i];
  }
  float ga = 0.0f, ha = 0.0f;
  for (int j0 = 0; j0 < b.c; j0 += kThreads) {
    __syncthreads();
    if (j0 + t < b.c) {
      t_s[t] = s[j0 + t];
      t_l[t] = l[j0 + t];
      t_g[t] = bf(gn[j0 + t]);
      t_d[t] = dr[j0 + t];
    }
    __syncthreads();
    const int nj = min(kThreads, b.c - j0);
    if (act) {
      for (int jj = 0; jj < nj; ++jj) {
        const int lj = t_l[jj];
        if (lj == li) continue;
        const bool up = li > lj;          // doc i is the higher member
        const float sj = t_s[jj], gj = t_g[jj], dj = t_d[jj];
        float lam, hes;
        pair_terms(up ? si : sj, up ? sj : si, up ? gi : gj, up ? gj : gi,
                   up ? di : dj, up ? dj : di, inv_b, norm_on, two_sig,
                   lut, lut_factor, lam, hes);
        ga = up ? __fadd_rn(ga, lam) : __fsub_rn(ga, lam);
        ha = __fadd_rn(ha, hes);
      }
    }
  }
  if (act) {
    g_out[b.lo + b.i] = ga;
    h_out[b.lo + b.i] = ha;
  }
}

}  // namespace

extern "C" {

// B6: g, h [N] f32 (zeroed by the caller) of every document of queries
// qoff[q] .. qoff[q + 1]; blocks int32 [num_blocks, 2] lists (q, i0) for
// i0 = 0, kThreads, ... below each query's length (`ops/rank.py::
// query_blocks`); label int32 [N], gain f32 [N] (label_gain[label]), inv
// f32 [Q] (1 / max DCG at max_position), disc f32 (rank-position
// discounts, at least the longest query long), disc_rows f32 [N] scratch;
// the queries of at most lut_len documents take the sigmoid table of
// lut_bins cells. Returns the CUDA error code (0 = ok).
int lgbt_rank_grad(const void* score, const void* label, const void* gain,
                   const void* qoff, const void* blocks, int num_blocks,
                   const void* inv, const void* disc, float two_sig,
                   int lut_bins, float lut_factor, int lut_len,
                   void* disc_rows, void* g, void* h, void* stream) {
  if (num_blocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(score);
  const int32_t* qo = static_cast<const int32_t*>(qoff);
  const int32_t* bl = static_cast<const int32_t*>(blocks);
  rank_disc_kernel<<<num_blocks, kThreads, 0, st>>>(
      sc, qo, bl, static_cast<const float*>(disc),
      static_cast<float*>(disc_rows));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  rank_pair_kernel<<<num_blocks, kThreads, 0, st>>>(
      sc, static_cast<const int32_t*>(label),
      static_cast<const float*>(gain), qo, bl,
      static_cast<const float*>(inv), static_cast<const float*>(disc_rows),
      two_sig, lut_bins, lut_factor, lut_len, static_cast<float*>(g),
      static_cast<float*>(h));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
