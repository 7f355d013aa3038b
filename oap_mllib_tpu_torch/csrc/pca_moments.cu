// PCA moments for Hopper (sm_90a): masked column sums and row count (the
// mean pass) and the centered Gram (the Gram pass) of one table.
//
// Replaces the TPU kernel oap_mllib_tpu/ops/pallas/pca_kernel.py
// `_tile_moments` (reached through `_pallas_moments` and
// `_pallas_moments_dbuf`; entries `pca_moments_pallas` and
// `covariance_pallas`).  Same function:
//   colsum[c] = sum_r mask[r] x[r, c],   count = sum_r mask[r]   (f32)
//   gram      = ((x - mean) * mask)^T ((x - mean) * mask)        (tier)
// The covariance runs it twice, as the TPU kernel's caller does: the
// mean pass (sums only), then the Gram pass with mean = colsum / n.
// Centering is f32 and happens before any bf16 rounding; the tiers
// (0 highest, 1 high, 2 default) apply to the Gram only.
//
// What bounds it on an H100 SXM (data sheet: 67 TFLOP/s FP32, 989
// TFLOP/s bf16 dense, 3.35 TB/s).  The mean pass reads x once: at
// n = 2^20, d = 128 that is 537 MB, ~0.16 ms.  The Gram pass needs the
// symmetric Gram's n d (d + 1) operations (its distinct entries): 17.3
// GFLOP at d = 128, ~0.26 ms on FP32 at highest, far less on the tensor
// cores, where the one read of x (0.16 ms) bounds it; 275 GFLOP at
// n = 2^18, d = 1024, ~4.1 ms on FP32, ~0.28 ms per bf16 product.  Both
// passes on the TPU accumulated into one resident block across a
// sequential grid; here blocks run in parallel and in no order, so both
// are split into fixed row slices whose partials a second kernel sums
// in slice order.  No float atomics anywhere: two launches give the
// same bits.
//
// Design against that bound.  Mean pass: one thread per column per row
// slice, each warp reading consecutive columns of a row; Kahan sums per
// slice and across slices, so large-mean data keeps f32 accuracy.  Gram
// pass, two routes chosen by the wrapper from (tier, d), both computing
// only the output tiles on and above the diagonal, mirrored into a
// bit-symmetric result, with the masked, centered operand formed in
// shared memory and never written to device memory:
//   - gram_wgmma.cuh, the default and high tiers at d >= 64: bf16
//     operands on the tensor cores (wgmma, f32 accumulators), raw rows
//     staged with cp.async three stages ahead;
//   - gram_simt.cuh, the highest tier (f32 products on the FP32 pipe,
//     as the plain version computes them) and the bf16 tiers below
//     d = 64: register tiles, upper triangle only inside diagonal
//     tiles, cp.async double-buffered staging.
// Both routes take their tile order, and this kernel its slice sum,
// from gram_tile.cuh.
//
// Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (oap_mllib_tpu_torch/ops/cuda/_build.py).  Every
// launch goes on the caller's stream; no synchronisation, no allocation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_simt.cuh"
#include "gram_tile.cuh"
#include "gram_wgmma.cuh"

namespace {

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = __fsub_rn(v, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// grid (ceil(d / blockDim), slices): thread = one column of one slice.
// Block column 0, thread 0 also sums the slice's mask (the row count).
__global__ void colsum_kernel(const float* __restrict__ x,
                              const float* __restrict__ mask, int n, int d,
                              int slice_rows, float* __restrict__ psum,
                              float* __restrict__ pcount) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  const int lo = s * slice_rows;
  const int hi = min(n, lo + slice_rows);
  if (col < d) {
    float sum = 0.f, comp = 0.f;
#pragma unroll 4
    for (int row = lo; row < hi; ++row) {
      float v = x[(size_t)row * d + col];
      if (mask != nullptr) v = __fmul_rn(v, mask[row]);
      kahan_add(sum, comp, v);
    }
    psum[(size_t)s * d + col] = sum;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float sum = 0.f, comp = 0.f;
    for (int row = lo; row < hi; ++row)
      kahan_add(sum, comp, mask != nullptr ? mask[row] : 1.f);
    pcount[s] = sum;
  }
}

// colsum[c] = slice partials summed in slice order; count likewise.
__global__ void colsum_finish_kernel(const float* __restrict__ psum,
                                     const float* __restrict__ pcount,
                                     int d, int slices,
                                     float* __restrict__ colsum,
                                     float* __restrict__ count) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col < d) {
    float sum = 0.f, comp = 0.f;
    for (int s = 0; s < slices; ++s)
      kahan_add(sum, comp, psum[(size_t)s * d + col]);
    colsum[col] = sum;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float sum = 0.f, comp = 0.f;
    for (int s = 0; s < slices; ++s) kahan_add(sum, comp, pcount[s]);
    count[0] = sum;
  }
}

}  // namespace

extern "C" {

// One moments pass over x (n, d) f32, contiguous on device `dev` (made
// current here: this library's runtime keeps its own current device).
//   mask: (n) row weights, or null for all ones.
//   need_sums: colsum (d) and count (1) from `sum_slices` slices of
//     `sum_slice_rows` rows; scratch psum (sum_slices * d), pcount
//     (sum_slices).
//   need_gram: gram (d, d) of (x - mean) * mask, mean (d); `route` 0
//     (SIMT: `tm` in {1, 2, 4, 8} sets the 16 * tm output tile) or 1
//     (wgmma, 128-wide tiles, bf16 tiers only), `m` tiles per side,
//     `gram_slices` slices of `gram_slice_rows` rows; scratch gram_part
//     (gram_slices * d * d).
// Returns a cudaError_t: cudaGetLastError() after the launches, or the
// refusal of a route, tile and tier that do not go together.
int pca_moments(int dev, const float* x, const float* mask,
                const float* mean, int n, int d, int mode, int need_sums,
                int need_gram,
                int sum_slices, int sum_slice_rows, float* psum,
                float* pcount, float* colsum, float* count, int route,
                int tm, int m, int gram_slices, int gram_slice_rows,
                float* gram_part, float* gram, void* stream) {
  const cudaError_t set = cudaSetDevice(dev);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (need_sums) {
    const int threads = d < 256 ? ((d + 31) / 32) * 32 : 256;
    const dim3 grid((d + threads - 1) / threads, sum_slices);
    colsum_kernel<<<grid, threads, 0, st>>>(x, mask, n, d, sum_slice_rows,
                                            psum, pcount);
    colsum_finish_kernel<<<(d + 255) / 256, 256, 0, st>>>(
        psum, pcount, d, sum_slices, colsum, count);
  }
  if (need_gram) {
    const int err =
        route == 1
            ? gram_wg::launch(x, mask, mean, n, d, mode, m, gram_slices,
                              gram_slice_rows, gram_part, st)
            : gram_simt::launch(x, mask, mean, n, d, mode, tm, m,
                                gram_slices, gram_slice_rows, gram_part, st);
    if (err != 0) return err;
    const long long elems = (long long)d * d;
    gram::sum_slices_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(
        gram_part, gram_slices, elems, gram);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
