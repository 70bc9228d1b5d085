// Gradient / hessian / count histograms over packed bin words, for the
// level builder, on Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_hist.py::
// pallas_histogram_words, both of its branches: _hist_words_kernel
// (pallas_call at :293, up to 128 bins) and _subbin_words_kernel
// (pallas_call at :276, 16 x 16 sub-bin tiles for more than 128 bins):
//
//   hist[s, f, b, :] = sum over the rows r of segment s with
//                      bin(r, f) == b of (g_r, h_r, 1)
//
// The level builder keeps its rows word-major: words [wcnt, n] int32, the
// bins of features 4w..4w+3 in bits 0-7, 8-15, 16-23, 24-31 of word w,
// and g, h [n] f32 in the same (permuted) row order. A segment is a
// contiguous row range [seg_begin, seg_begin + seg_cnt): the root is one
// segment, and a round's smaller children are one segment each, all in
// one launch.
//
// The TPU builds a bf16 one-hot per feature and contracts it on the MXU
// against a hi/lo split of the payload; more than 128 bins need the
// sub-bin tiles because the one-hot's sublane axis is 128 wide. Hopper
// has shared-memory atomics, so one kernel serves every bin count up to
// 256: each CTA keeps a sub-histogram of one tile of features in shared
// memory (g and h as f64, the count as u32: 20 bytes a cell, features
// tiled over blockIdx.y to fit), walks a contiguous range of the
// segments' concatenated rows, and flushes its sub-histogram with global
// f64/u32 atomics whenever its range leaves a segment. A finalize pass
// rounds each cell to f32 once. The f64 sums of f32 payloads make the
// result independent of the atomics' order in practice (an f32
// accumulator drifted by ~1e-5 of the slot's sum of |g| on 10.5M equal
// first-tree gradients; PERF.md, on B4), so the kernel is bit-equal to
// its plain twin, and tpu_use_f64_hist gets the single rounding of the
// JAX package's f64 path.
//
// Rows are split evenly over the CTAs from the segment table in device
// memory (seg_off, the exclusive prefix of the counts, ends with the
// total), so the host needs no count to launch: the grid size is only a
// hint.
//
// What bounds it on an H100: bytes. A call reads count * (4 * wcnt + 8)
// bytes of words and payload and writes S * F * B * 3 f32 cells; the
// 3 * F adds per row are far below the card's rate. Reads are coalesced
// (thread t reads row r + t of a word array); the adds stay in shared
// memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStats = 3;

// Index of the segment holding virtual row v: the last s with
// seg_off[s] <= v (seg_off is non-decreasing; empty segments are skipped).
__device__ int find_segment(const long long* seg_off, int nseg,
                            long long v) {
  int lo = 0, hi = nseg;            // answer in [lo, hi)
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg_off[mid] <= v) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void words_hist_kernel(const int32_t* __restrict__ words,
                                  long long n, const float* __restrict__ g,
                                  const float* __restrict__ h,
                                  const int32_t* __restrict__ seg_begin,
                                  const long long* __restrict__ seg_off,
                                  int nseg, int num_features, int num_bins,
                                  int feat_per_block,
                                  double* __restrict__ gh_out,
                                  unsigned* __restrict__ cnt_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int f0 = blockIdx.y * feat_per_block;
  const int nf = min(feat_per_block, num_features - f0);
  const int cells = nf * num_bins;
  double* sh = reinterpret_cast<double*>(smem_raw);             // [cells, 2]
  unsigned* sc = reinterpret_cast<unsigned*>(sh + 2 * cells);   // [cells]
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    sh[2 * i] = 0.0;
    sh[2 * i + 1] = 0.0;
    sc[i] = 0u;
  }
  __syncthreads();

  const long long total = seg_off[nseg];
  const long long per = (total + gridDim.x - 1) / gridDim.x;
  const long long v0 = static_cast<long long>(blockIdx.x) * per;
  const long long v1 = min(total, v0 + per);
  if (v0 >= v1) return;
  const int w_first = f0 >> 2;
  const int w_last = (f0 + nf - 1) >> 2;

  for (int s = find_segment(seg_off, nseg, v0);
       s < nseg && seg_off[s] < v1; ++s) {
    const long long lo = max(v0, seg_off[s]);
    const long long hi = min(v1, seg_off[s + 1]);
    if (lo >= hi) continue;
    const long long base_row = seg_begin[s] - seg_off[s];
    for (long long v = lo + threadIdx.x; v < hi; v += blockDim.x) {
      const long long row = base_row + v;
      const double gv = static_cast<double>(g[row]);
      const double hv = static_cast<double>(h[row]);
      for (int w = w_first; w <= w_last; ++w) {
        const int word = words[static_cast<long long>(w) * n + row];
        const int fa = max(f0, 4 * w), fb = min(f0 + nf, 4 * w + 4);
        for (int ff = fa; ff < fb; ++ff) {
          const int b = (word >> ((ff & 3) * 8)) & 255;
          if (b < num_bins) {
            const int cell = (ff - f0) * num_bins + b;
            atomicAdd(sh + 2 * cell, gv);
            atomicAdd(sh + 2 * cell + 1, hv);
            atomicAdd(sc + cell, 1u);
          }
        }
      }
    }
    // flush this segment's part and clear the sub-histogram
    __syncthreads();
    const long long out0 =
        (static_cast<long long>(s) * num_features + f0) * num_bins;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      if (sc[i] != 0u) {
        atomicAdd(gh_out + 2 * (out0 + i), sh[2 * i]);
        atomicAdd(gh_out + 2 * (out0 + i) + 1, sh[2 * i + 1]);
        atomicAdd(cnt_out + out0 + i, sc[i]);
      }
      sh[2 * i] = 0.0;
      sh[2 * i + 1] = 0.0;
      sc[i] = 0u;
    }
    __syncthreads();
  }
}

// out [cells, 3] f32 = (g, h, count), each rounded once
__global__ void words_finalize_kernel(const double* __restrict__ gh,
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

}  // namespace

extern "C" {

// out [nseg, F, B, 3] f32; gh ([nseg, F, B, 2] f64) and cnt ([nseg, F, B]
// u32) are accumulators zeroed by the caller; seg_off [nseg + 1] int64 is
// the exclusive prefix of the segment counts. Returns the CUDA error code
// (0 = ok).
int lgbt_words_hist(const void* words, long long n, const void* g,
                    const void* h, const void* seg_begin,
                    const void* seg_off, int nseg, int num_features,
                    int num_bins, int feat_per_block, int blocks_x,
                    int threads, void* gh, void* cnt, void* out,
                    void* stream) {
  if (nseg == 0 || num_features == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(feat_per_block) * num_bins
      * (2 * sizeof(double) + sizeof(unsigned));
  cudaError_t e = cudaFuncSetAttribute(
      words_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid_y = (num_features + feat_per_block - 1) / feat_per_block;
  words_hist_kernel<<<dim3(blocks_x, grid_y), threads, smem, s>>>(
      static_cast<const int32_t*>(words), n, static_cast<const float*>(g),
      static_cast<const float*>(h), static_cast<const int32_t*>(seg_begin),
      static_cast<const long long*>(seg_off), nseg, num_features, num_bins,
      feat_per_block, static_cast<double*>(gh), static_cast<unsigned*>(cnt));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long cells =
      static_cast<long long>(nseg) * num_features * num_bins;
  const int fin_threads = 256;
  words_finalize_kernel<<<static_cast<unsigned>((cells + fin_threads - 1)
                                                / fin_threads),
                          fin_threads, 0, s>>>(
      static_cast<const double*>(gh), static_cast<const unsigned*>(cnt),
      cells, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Largest dynamic shared memory a block may opt in to on `device`.
int lgbt_words_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

}  // extern "C"
