// Helpers shared by the port's hand-written Gram routines: the PCA
// moments kernel's two routes (pca_moments.cu with gram_simt.cuh and
// gram_wgmma.cuh, K2) and the ALS factor Gram (als_factor_gram.cu, K4).
//
// - bf16_round: an f32 value rounded to bf16 (nearest even) and back,
//   the operand rounding of the `high` and `default` tiers;
// - tile_of: the upper-triangle tile order.  A Gram is cut into square
//   tiles (or micro-tiles), and only those on and above the diagonal
//   are computed, numbered row by row;
// - sum_slices_kernel: K2's second launch, which adds the row slices'
//   (d, d) partials in slice order.  No float atomics, so two launches
//   give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gram {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Upper-triangle tile number t -> (ti, tj), ti <= tj, m tiles per side,
// in row-major order.
__device__ __forceinline__ void tile_of(int t, int m, int& ti, int& tj) {
  int i = 0;
  while (t >= m - i) {
    t -= m - i;
    ++i;
  }
  ti = i;
  tj = i + t;
}

// out[e] = sum over slices of part[slice][e], in slice order.
__global__ void sum_slices_kernel(const float* __restrict__ part, int slices,
                                  long long elems, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= elems) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s = __fadd_rn(s, part[k * elems + e]);
  out[e] = s;
}

}  // namespace gram
