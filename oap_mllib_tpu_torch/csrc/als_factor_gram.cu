// ALS factor Gram for Hopper (sm_90a): G = F^T F of an (n, r) factor
// table, the implicit-feedback term of every ALS half-update.
//
// Replaces the TPU kernel oap_mllib_tpu/ops/pallas/als_kernel.py
// `_make_gram_kernel` (reached through `_pallas_factor_gram` and
// `_pallas_factor_gram_dbuf`; entries `factor_gram_traced` and
// `factor_gram_pallas`): F^T F streamed over 512-row tiles at a tier of
// `_tiers.tiered_dot`.  Same function and tiers (0 highest, 1 high,
// 2 default); the fit calls it at highest, as the JAX package does.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32): one read
// of F.  At the ML-25M user table (n = 162,541, r = 10) that is 6.5 MB,
// ~0.002 ms, and 2 n r^2 = 33 MFLOP, ~0.0005 ms: far below what two
// kernel launches cost, so launch overhead is what this kernel's time
// shows at the fit's shapes.
//
// Design.  The TPU kernel accumulated into one resident (r, r) block
// over a sequential grid.  Here gram_tile.cuh does it (the routine K2
// uses, without centering): blocks over fixed row slices keep their
// (r, r) tile in registers, write it to their slice's partial, and a
// second kernel sums the partials in slice order.  No atomics, same
// bits on every launch, bit-symmetric result.
//
// Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (oap_mllib_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>

#include "gram_tile.cuh"

extern "C" {

// gram (r, r) = F^T F for F (n, r) f32 contiguous on the device.  `tm`
// in {1, 2, 4, 8} sets the 16 * tm output tile, `m` tiles per side,
// `slices` row slices of `slice_rows` rows; scratch part (slices * r * r).
// Returns cudaGetLastError() after the launches.
int als_factor_gram(const float* f, int n, int r, int mode, int tm, int m,
                    int slices, int slice_rows, float* part, float* gram,
                    void* stream) {
  return gram::launch<false>(f, nullptr, nullptr, n, r, mode, tm, m, slices,
                             slice_rows, part, gram,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
