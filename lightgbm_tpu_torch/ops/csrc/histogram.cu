// Per-leaf gradient / hessian / count histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py::pallas_histogram
// (_hist_kernel, pallas_call at :205, and the sub-binned
// _subbin_rows_kernel, pallas_call at :188), and the f64 einsum of
// lightgbm_tpu/ops/histogram.py:39-49 for tpu_use_f64_hist:
//
//   hist[f, b, :] = sum over the leaf's rows r with bins[r, f] == b
//                   of (g_r, h_r, 1)
//
// The TPU has no fast scatter, so the Pallas kernel turns the scatter
// into one-hot MXU contractions with a bf16 hi/lo payload split. Hopper
// has fast shared-memory atomics, so this kernel takes the pattern of the
// OpenCL reference (ocl/histogram256.cl): each block owns a sub-histogram
// of a tile of features in shared memory, adds its rows into it with
// atomicAdd, and writes it out once; a second small kernel folds the
// per-block sub-histograms in a fixed block order.
//
// The gather of the leaf's rows is fused: the kernel reads the leaf's
// slice of the partition, indices[begin, begin + count), and the rows of
// bins [N, F] (uint8) and gh [N, 2] (f32) it names, or the contiguous rows
// [begin, begin + count) when indices is null (the identity root
// partition). No gathered [P, F] copy is written.
//
// What bounds it on an H100: bytes. One call must read count * (F + 8)
// bytes of bins rows and gh, plus 4 * count bytes of indices for a
// gathered leaf, and write F * B * 3 accumulators; the 3 * F * count adds
// are two orders of magnitude below the card's f32 rate. The design keeps
// every add in shared memory (no global atomics), reads each row once,
// and launches only as many blocks as the card holds at once (two per SM
// at the default shared-memory budget), so the fold pass reads at most
// a few hundred sub-histograms.
//
// Acc = float is the default path. Acc = double is the exact mode: f64
// sums of f32 payloads are exact at realistic leaf sizes, so the result
// does not depend on the order of the atomics, and the fold runs in a
// fixed order.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStats = 3;

template <typename Acc>
__global__ void hist_block_kernel(const uint8_t* __restrict__ bins,
                                  int num_features,
                                  const float* __restrict__ gh,
                                  const int32_t* __restrict__ indices,
                                  long long begin, long long count,
                                  int num_bins, int feat_per_block,
                                  long long rows_per_block,
                                  Acc* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* sh = reinterpret_cast<Acc*>(smem_raw);
  const int f0 = blockIdx.y * feat_per_block;
  const int nf = min(feat_per_block, num_features - f0);
  const int cells = nf * num_bins * kStats;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = Acc(0);
  __syncthreads();

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(count, r0 + rows_per_block);
  const float2* gh2 = reinterpret_cast<const float2*>(gh);
  for (long long p = r0 + threadIdx.x; p < r1; p += blockDim.x) {
    const long long row = indices != nullptr
        ? static_cast<long long>(indices[begin + p]) : begin + p;
    const float2 v = gh2[row];
    const Acc g = static_cast<Acc>(v.x);
    const Acc h = static_cast<Acc>(v.y);
    const uint8_t* brow = bins + row * num_features + f0;
    for (int f = 0; f < nf; ++f) {
      const int b = brow[f];
      if (b < num_bins) {
        Acc* cell = sh + (f * num_bins + b) * kStats;
        atomicAdd(cell, g);
        atomicAdd(cell + 1, h);
        atomicAdd(cell + 2, Acc(1));
      }
    }
  }
  __syncthreads();

  // this block's sub-histogram of features [f0, f0 + nf) lands in its own
  // [F, B, 3] slab: out is [gridDim.x, F, B, 3]
  Acc* dst = out + (static_cast<long long>(blockIdx.x) * num_features + f0)
      * num_bins * kStats;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = sh[i];
}

template <typename Acc>
__global__ void hist_fold_kernel(const Acc* __restrict__ partial,
                                 int num_partials, long long cells,
                                 Acc* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  Acc s = Acc(0);
  for (int k = 0; k < num_partials; ++k) s += partial[k * cells + i];
  out[i] = s;
}

template <typename Acc>
int launch(const void* bins, int num_features, const void* gh,
           const void* indices, long long begin, long long count,
           int num_bins, int feat_per_block, int num_blocks, int threads,
           void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fpb = feat_per_block;
  const int grid_y = (num_features + fpb - 1) / fpb;
  const size_t smem = static_cast<size_t>(fpb) * num_bins * kStats
      * sizeof(Acc);
  cudaError_t err = cudaFuncSetAttribute(
      hist_block_kernel<Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_per_block = (count + num_blocks - 1) / num_blocks;
  // one block slab straight into out when a single block covers the rows
  Acc* block_out = static_cast<Acc*>(num_blocks == 1 ? out : partial);
  hist_block_kernel<Acc><<<dim3(num_blocks, grid_y), threads, smem, s>>>(
      static_cast<const uint8_t*>(bins), num_features,
      static_cast<const float*>(gh), static_cast<const int32_t*>(indices),
      begin, count, num_bins, fpb, rows_per_block, block_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || num_blocks == 1) return static_cast<int>(err);
  const long long cells =
      static_cast<long long>(num_features) * num_bins * kStats;
  const int fold_threads = 256;
  const long long fold_blocks = (cells + fold_threads - 1) / fold_threads;
  hist_fold_kernel<Acc><<<static_cast<unsigned>(fold_blocks), fold_threads,
                          0, s>>>(static_cast<const Acc*>(partial),
                                  num_blocks, cells, static_cast<Acc*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out: [F, num_bins, 3]; partial: [num_blocks, F, num_bins, 3] scratch
// (unused when num_blocks == 1). Returns the CUDA error code (0 = ok).
int lgbt_hist_f32(const void* bins, int num_features, const void* gh,
                  const void* indices, long long begin, long long count,
                  int num_bins, int feat_per_block, int num_blocks,
                  int threads, void* partial, void* out, void* stream) {
  return launch<float>(bins, num_features, gh, indices, begin, count,
                       num_bins, feat_per_block, num_blocks, threads,
                       partial, out, stream);
}

int lgbt_hist_f64(const void* bins, int num_features, const void* gh,
                  const void* indices, long long begin, long long count,
                  int num_bins, int feat_per_block, int num_blocks,
                  int threads, void* partial, void* out, void* stream) {
  return launch<double>(bins, num_features, gh, indices, begin, count,
                        num_bins, feat_per_block, num_blocks, threads,
                        partial, out, stream);
}

// Largest dynamic shared memory a block may opt in to on `device`.
int lgbt_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

}  // extern "C"
