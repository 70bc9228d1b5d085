// Fixed-point shared-memory histogram cells that the port's histogram
// kernels share (aligned.cu's slot histogram, B2/B4; histogram.cu's leaf
// histogram, B1).
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

}  // namespace
