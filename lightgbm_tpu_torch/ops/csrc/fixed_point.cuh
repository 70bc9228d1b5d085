// Fixed-point shared-memory histogram cells that the port's histogram
// kernels share (aligned.cu's slot histogram, B2/B4; histogram.cu's leaf
// histogram, B1; histogram_words.cu's level histogram, B5), and the
// device-memory scratch of B1's and B5's one-launch calls.
//
// On sm_90a an f32 or f64 atomicAdd on shared memory, and a 64-bit integer
// one, compiles to a compare-and-swap loop (ATOMS.CAST.SPIN); a 32-bit
// integer add is one ATOMS.ADD. So each f32 value of a run of at most 2^nb
// rows is split into hi and lo int32 words at a scale taken from the run's
// largest |v| (`Fixed`), the words are added with native integer atomics
// (`Cells`), and at the run's end each cell is decoded in f64 and added to
// global f64 sums. The run's sum is off by at most m * 2^(3 nb - 61), m
// its largest |v|: 1.9e-6 m at nb 14 (16,384 rows).
#pragma once

#include <cuda_runtime.h>

namespace {

// The CTA's sub-histogram: per cell five u32 words, side by side (one
// address register serves all five atomics): the hi and lo int32 words of
// g and of h in fixed point and the count, each added with one native
// shared-memory integer atomic. A run whose g (h) holds a non-finite value
// adds that stat straight to the f64 sums instead (gx, hx), so that NaN
// and Inf reach its cells as they reach an f64 sum.
constexpr int kCellWords = 5;
constexpr int kGHi = 0, kGLo = 1, kHHi = 2, kHLo = 3, kN = 4;

struct Cells {
  unsigned* w;                           // [cells, kCellWords]
  double* sums;                          // the run's slot: [cells, 2] f64
  bool gx, hx;
  __device__ void add(int cell, unsigned gh, unsigned gl, unsigned hh,
                      unsigned hl) const {
    unsigned* p = w + kCellWords * cell;
    if (gx) {
      atomicAdd(sums + 2 * cell, static_cast<double>(__uint_as_float(gh)));
    } else {
      atomicAdd(p + kGHi, gh);
      atomicAdd(p + kGLo, gl);
    }
    if (hx) {
      atomicAdd(sums + 2 * cell + 1,
                static_cast<double>(__uint_as_float(hh)));
    } else {
      atomicAdd(p + kHHi, hh);
      atomicAdd(p + kHLo, hl);
    }
    atomicAdd(p + kN, 1u);
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

// The scratch of a one-launch histogram call in device memory, zero
// before and after the call: f64 sums of g and h [cells, 2], u32 counts
// [cells] and tickets. The CTAs that add to a range of cells each take its
// ticket, and the last of them rounds the range to the output and zeroes
// it and the ticket for the next call on the stream.
struct Scratch {
  double* sums;
  unsigned* cnt;
  unsigned* tickets;
};

// Adds to the scratch that return nothing (PTX red): written as atomicAdd,
// the flush adds compile to ATOMG, which wait for the old value
__device__ __forceinline__ void red_add(double* p, double v) {
  asm volatile("red.relaxed.gpu.global.add.f64 [%0], %1;"
               :: "l"(p), "d"(v) : "memory");
}
__device__ __forceinline__ void red_add(unsigned* p, unsigned v) {
  asm volatile("red.relaxed.gpu.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Whether this CTA is the last of `expected` to take `ticket`, taken once
// its adds to the scratch are visible (the barrier, then one thread's
// fence, as a grid sync arrives). Every thread of the CTA calls it.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket,
                                               unsigned expected) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == expected - 1u;
  }
  __syncthreads();
  return last;
}

// The last CTA's part: cells [0, cells) of the scratch's sums and cnt
// into dst [cells, 3] = (g, h, count), each rounded once, then the cells
// and the ticket zeroed.
template <typename Out>
__device__ void finalize(double* sums, unsigned* cnt, unsigned* ticket,
                         int cells, Out* dst) {
  __threadfence();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    dst[3 * i] = static_cast<Out>(__ldcg(sums + 2 * i));
    dst[3 * i + 1] = static_cast<Out>(__ldcg(sums + 2 * i + 1));
    dst[3 * i + 2] = static_cast<Out>(__ldcg(cnt + i));
    sums[2 * i] = 0.0;
    sums[2 * i + 1] = 0.0;
    cnt[i] = 0u;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace
