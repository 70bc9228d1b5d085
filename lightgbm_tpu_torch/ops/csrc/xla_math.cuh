// The f32 arithmetic of XLA's CPU backend that the port's kernels share
// (lightgbm_tpu_torch/utils/xla_math.py is its PyTorch twin).
#pragma once

#include <cuda_runtime.h>

// XLA's f32 exp (lightgbm_tpu_torch/utils/xla_math.py::exp_f32): n =
// floor(x log2 e + 1/2), a = x - n ln 2 in two fused steps, e^a by a
// degree-7 polynomial with true fused multiply-adds, times 2^n; results
// below the smallest normal flush to 0
__device__ __forceinline__ float exp_xla(float x) {
  x = fminf(fmaxf(x, -87.8f), 88.8f);
  float n = floorf(__fmaf_rn(x, 1.44269504088896341f, 0.5f));
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  float a = __fmaf_rn(n, -0.693359375f, x);
  a = __fmaf_rn(n, 2.12194440e-4f, a);
  float z = __fmaf_rn(a, 1.9875691500e-4f, 1.3981999507e-3f);
  z = __fmaf_rn(z, a, 8.3334519073e-3f);
  z = __fmaf_rn(z, a, 4.1665795894e-2f);
  z = __fmaf_rn(z, a, 1.6666665459e-1f);
  z = __fmaf_rn(z, a, 5.0000001201e-1f);
  z = __fadd_rn(1.0f, __fmaf_rn(z, __fmul_rn(a, a), a));
  const float two_n = __int_as_float((static_cast<int>(n) + 127) << 23);
  const float y = __fmul_rn(z, two_n);
  return y < 1.17549435e-38f ? 0.0f : y;
}
