// The one-launch stable partition's helpers, shared by B2's partition
// (aligned.cu::partition_kernel) and P2's move (proto.cu::move_kernel).
//
// Both move the rows of chunks of C rows, CTAs taking chunks (B2) or
// tiles of chunks (P2) by ticket: a chunk's lanes come into shared memory
// by one bulk copy on an mbarrier (stage_init, stage_load, stage_wait);
// its rows are ranked with warp ballots (rank_rows in B2) and inverted
// into a permutation (invert_ranks), so each lane's left and right runs
// go out as contiguous stores; the rows of its block before it come from
// a decoupled look-back over 64-bit flag words, one a chunk or tile
// (publish, look_back), segmented where a block's first chunk publishes
// its inclusive prefix at once. No CTA waits on a flag after its own,
// and every flag before it has a running CTA (tickets are taken in
// order), so the walk cannot deadlock.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// A chunk's flag word: state << 62 | valid << 31 | left, state 0 while
// nothing is published, kAggregate for the chunk's own (left, valid) and
// kInclusive for the sums over its block up to and including it. A block
// holds at most 2^31 - 1 rows.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kField = (1ull << 31) - 1;

__device__ __forceinline__ unsigned long long flag_word(
    unsigned long long state, int left, int valid) {
  return state | (static_cast<unsigned long long>(valid) << 31)
      | static_cast<unsigned long long>(left);
}

__device__ __forceinline__ void publish(unsigned long long* flag,
                                        unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(flag) = v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The staging mbarrier: one arrival (the issuing thread) plus the bulk
// copy's transaction bytes complete a phase.
__device__ __forceinline__ void stage_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// src into shared dst by the bulk-copy engine, completing on bar
__device__ __forceinline__ void stage_load(void* dst, const void* src,
                                           unsigned bytes,
                                           unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void stage_wait(unsigned long long* bar,
                                           unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// Warp 0: the sums (left, valid) of the chunks of c's block before c,
// from their flag words, a window of 32 predecessors at a time; stops at
// the nearest inclusive prefix (a block's first chunk publishes one at
// once). Valid in every lane.
__device__ __forceinline__ void look_back(const unsigned long long* flags,
                                          long long c, int lane,
                                          int& ex_left, int& ex_valid) {
  ex_left = 0;
  ex_valid = 0;
  for (long long j = c - 1;; j -= 32) {
    const long long idx = j - lane;
    unsigned long long f = flag_word(kInclusive, 0, 0);
    if (idx >= 0) {
      const volatile unsigned long long* p = flags + idx;
      do {
        f = *p;
      } while ((f >> 62) == 0);
    }
    const unsigned incl = __ballot_sync(kFull, (f >> 62) == 2);
    const int stop = incl != 0u ? __ffs(incl) - 1 : 31;
    int l = lane <= stop ? static_cast<int>(f & kField) : 0;
    int v = lane <= stop ? static_cast<int>((f >> 31) & kField) : 0;
    for (int o = 16; o > 0; o >>= 1) {
      l += __shfl_xor_sync(kFull, l, o);
      v += __shfl_xor_sync(kFull, v, o);
    }
    ex_left += l;
    ex_valid += v;
    if (incl != 0u) return;
  }
}

// One warp: prefix[w] = the left rows before word w of a chunk's ballots
// ballot[0 .. nw) (a word of 32 rows each); returns the chunk's left rows,
// valid in every lane.
__device__ __forceinline__ int ballot_prefix(const unsigned* ballot,
                                             int* prefix, int nw, int lane) {
  int carry = 0;
  for (int w0 = 0; w0 < nw; w0 += 32) {
    const int w = w0 + lane;
    const int v = w < nw ? __popc(ballot[w]) : 0;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (w < nw) prefix[w] = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
  }
  return carry;
}

// The left rows of a chunk of `cnt` valid rows (r < cnt): a ballot a word
// of 32 rows, ballot[w] (nw = ceil(C / 32) of them), and the left rows
// before each word, prefix[w]; `left(r)` decides row r < cnt. Every
// thread of the CTA (`threads` of them) calls it; returns the chunk's left
// rows in every thread.
template <typename Left>
__device__ __forceinline__ int rank_rows(int cnt, int nw, int threads,
                                         unsigned* ballot, int* prefix,
                                         Left left) {
  __shared__ int s_left;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = warp; w < nw; w += threads / 32) {
    const int r = (w << 5) + lane;
    const unsigned b = __ballot_sync(kFull, r < cnt && left(r));
    if (lane == 0) ballot[w] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int total = ballot_prefix(ballot, prefix, nw, lane);
    if (lane == 0) s_left = total;
  }
  __syncthreads();
  return s_left;
}

// perm[k] = the row that goes k-th: the left rows at their rank, then the
// right rows after the chunk's `left` left rows, each in row order; rows
// first, first + stride, ... of the calling threads.
__device__ __forceinline__ void invert_ranks(int cnt, int left, int first,
                                             int stride,
                                             const unsigned* ballot,
                                             const int* prefix,
                                             unsigned short* perm) {
  for (int r = first; r < cnt; r += stride) {
    const unsigned b = ballot[r >> 5];
    const int bit = r & 31;
    const int rank = prefix[r >> 5] + __popc(b & ((1u << bit) - 1u));
    perm[(b >> bit) & 1u ? rank : left + r - rank] =
        static_cast<unsigned short>(r);
  }
}

}  // namespace
