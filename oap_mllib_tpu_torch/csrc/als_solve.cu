// Batched ALS normal-equation assembly and solve for Hopper (sm_90a),
// rank r <= 32.
//
// Replaces the TPU kernel oap_mllib_tpu/ops/pallas/als_kernel.py
// `_solve_tile` (reached through `_pallas_solve` and `_pallas_solve_dbuf`;
// entries `solve_traced` and `solve_normal_eq_pallas`).  Same function,
// per system s:
//   A = gram + (moments + reg * n_reg * I)   lower triangle; reg first,
//                                            the Gram second (the
//                                            addition order of
//                                            als_ops.regularized_solve)
//   L = Cholesky(A) by right-looking rank-1 downdates, with
//       L[i][j] = A[i][j] / sqrt(A[j][j]) (diagonal included), then
//       forward (L z = b) and back (L^T w = z) substitution: the
//       operation sequence of `_chol_solve_unrolled`, lower triangle only
//   out = n_reg > 0 ? nan_to_num(w) : 0   (NaN -> 0, +-inf -> +-FLT_MAX)
// f32 at every tier, with IEEE sqrt and division and no contraction of a
// product into an FMA (explicit _rn intrinsics), so the kernel and the
// plain PyTorch version run the same rounded operations.
//
// Layout.  The TPU kernel reads a lane-major (r^2 + r + 1, B) sheet, a
// TPU layout.  This kernel reads A, b and n_reg where the port's moment
// builders leave them, through element strides: the grouped path's
// (n, r+1, r+2) moment matrices (A = M[:, :r, :r], b = M[:, :r, r],
// n_reg = M[:, r, r+1]) and the COO path's separate (n, r, r), (n, r)
// and (n) arrays alike, with no repacking copy.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32): the bytes.
// Counting the whole system as the TPU sheet holds it (r^2 + r + 1
// floats in, r out), 162,541 systems at r = 10 move 79 MB, ~0.024 ms;
// the r^3 / 3 + 2 r^2 operations per system are ~100x less.
//
// Design.  One thread per system, the packed lower triangle (r (r+1) / 2
// floats) and the right-hand side in thread-local arrays (local memory,
// cached in L1; interleaved across threads, so a warp's accesses to one
// index coalesce).  Systems are independent, so there is no reduction
// and nothing to order.  Simple first: no shared-memory staging of the
// moments and no warp-cooperative factorisation yet.
//
// Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (oap_mllib_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_RANK = 32;
constexpr int TRI = MAX_RANK * (MAX_RANK + 1) / 2;
constexpr int THREADS = 128;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.f;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}

__global__ void __launch_bounds__(THREADS)
solve_kernel(const float* __restrict__ a, long long sa_n, long long sa_i,
             long long sa_j, const float* __restrict__ b, long long sb_n,
             long long sb_j, const float* __restrict__ nreg, long long sn,
             const float* __restrict__ gram, float reg, int n, int r,
             float* __restrict__ out) {
  const int sys = blockIdx.x * blockDim.x + threadIdx.x;
  if (sys >= n) return;
  float L[TRI];
  float v[MAX_RANK];
  const float nr = nreg[(long long)sys * sn];
  const float* as = a + (long long)sys * sa_n;
  const float* bs = b + (long long)sys * sb_n;
  const float reg_n = __fmul_rn(reg, nr);

  // assemble the lower triangle: moments + reg * n_reg on the diagonal,
  // then the Gram
  for (int i = 0; i < r; ++i) {
    for (int j = 0; j <= i; ++j) {
      float aij = as[i * sa_i + j * sa_j];
      if (i == j) aij = __fadd_rn(aij, reg_n);
      if (gram != nullptr) aij = __fadd_rn(gram[i * r + j], aij);
      L[tri(i, j)] = aij;
    }
    v[i] = bs[i * sb_j];
  }

  // Cholesky by rank-1 Schur downdates, column by column
  for (int j = 0; j < r; ++j) {
    const float dj = __fsqrt_rn(L[tri(j, j)]);
    for (int i = j; i < r; ++i) L[tri(i, j)] = __fdiv_rn(L[tri(i, j)], dj);
    for (int i1 = j + 1; i1 < r; ++i1) {
      const float c1 = L[tri(i1, j)];
      for (int i2 = j + 1; i2 <= i1; ++i2)
        L[tri(i1, i2)] =
            __fsub_rn(L[tri(i1, i2)], __fmul_rn(c1, L[tri(i2, j)]));
    }
  }

  // forward: L z = b (v holds rhs, then z)
  for (int j = 0; j < r; ++j) {
    v[j] = __fdiv_rn(v[j], L[tri(j, j)]);
    for (int i = j + 1; i < r; ++i)
      v[i] = __fsub_rn(v[i], __fmul_rn(L[tri(i, j)], v[j]));
  }
  // back: L^T w = z (v[k] holds w[k] for k > j)
  for (int j = r - 1; j >= 0; --j) {
    float acc = v[j];
    for (int k = j + 1; k < r; ++k)
      acc = __fsub_rn(acc, __fmul_rn(L[tri(k, j)], v[k]));
    v[j] = __fdiv_rn(acc, L[tri(j, j)]);
  }

  float* o = out + (long long)sys * r;
  for (int j = 0; j < r; ++j) o[j] = nr > 0.f ? nan_to_num(v[j]) : 0.f;
}

}  // namespace

extern "C" {

int als_solve_max_rank(void) { return MAX_RANK; }

// Solve n systems of rank r <= 32.  a: A[s][i][j] at a + s*sa_n +
// i*sa_i + j*sa_j (lower triangle read); b: b[s][j] at b + s*sb_n +
// j*sb_j; nreg: n_reg[s] at nreg + s*sn; gram: (r, r) contiguous or
// null; out: (n, r) contiguous.  All f32 on the device; strides in
// elements.  Returns cudaGetLastError() after the launch.
int als_solve(const float* a, long long sa_n, long long sa_i, long long sa_j,
              const float* b, long long sb_n, long long sb_j,
              const float* nreg, long long sn, const float* gram, float reg,
              int n, int r, float* out, void* stream) {
  if (r < 1 || r > MAX_RANK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  solve_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      a, sa_n, sa_i, sa_j, b, sb_n, sb_j, nreg, sn, gram, reg, n, r, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
