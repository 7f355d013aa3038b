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
// plain PyTorch version run the same rounded operations: every element
// sees the same operations in the same order, and the result is
// bit-equal to the plain version.
//
// Layout.  The TPU kernel reads a lane-major (r^2 + r + 1, B) sheet, a
// TPU layout.  This kernel reads A, b and n_reg where the port's moment
// builders leave them, through element strides: the grouped path's
// (n, r+1, r+2) moment matrices (A = M[:, :r, :r], b = M[:, :r, r],
// n_reg = M[:, r, r+1]) and the COO path's separate (n, r, r), (n, r)
// and (n) arrays alike, with no repacking copy.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32): the bytes,
// counting the lower triangle of A, b, n_reg and the factors once:
// ~0.015 ms for 162,541 systems at r = 10, ~0.115 ms at r = 32.  The
// r^3 / 3 + 2 r^2 operations per system take ~0.001 and ~0.03 ms on the
// FP32 pipe.  What an SM can issue bounds it in practice: a
// factorisation is a chain of dependent steps, each division and square
// root a multi-instruction IEEE sequence, and the triangle has to stay
// in registers.
//
// Design.  A group of G lanes per system: G the smallest power of two
// >= r (32 / G systems to a warp), except for the fit's rank, r = 10 on
// G = 10 lanes (three systems to a warp, two lanes idle).  r = G and
// r = 10 run instantiations with their loops bounded at compile time;
// other ranks take G's instantiation with r a runtime bound.  Lane i
// holds row i of the triangle and the i-th entry of the right-hand side
// in registers: `row[G]` is indexed only by unrolled loop counters, so
// nothing goes to local memory.
//   - Loads: at G = 32 (one system a warp) the warp stages its lower
//     triangle through shared memory (lane c reads column c of each row,
//     so a row is one coalesced load; row stride G + 1 keeps the lanes'
//     reads of their rows on distinct banks).  Narrower groups read their
//     short rows straight into registers.  Every load is issued before
//     the first is used.  Each lane then adds reg * n_reg to its diagonal
//     and the Gram's row, which the block stages once in shared memory.
//   - Cholesky, column j: lane j's diagonal goes to the group by
//     __shfl_sync; every lane divides its L[i][j] by the root; the
//     downdate L[i1][i2] -= L[i1][j] * L[i2][j] takes L[i2][j] from lane
//     i2 by shuffle.  Lanes whose entry lies above the diagonal compute
//     it too, unpredicated, and a runtime r stops the downdate only at
//     multiples of 4 columns: no live result ever reads such entries.
//   - Forward: lane j forms z_j and broadcasts it; lanes i > j subtract.
//   - Back: lane k > j forms L[k][j] * w_k; every lane receives the
//     products by shuffle and subtracts them in increasing k, the order
//     of `acc_j = z_j - sum_{k>j} L[k][j] w_k`; lane j divides.
// Lanes past r and systems past n run on zeros and store nothing; no
// live lane reads them.  Systems are independent: no reduction and
// nothing to order.
//
// Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (oap_mllib_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_RANK = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.f;
  if (isinf(v)) return v > 0.f ? FLT_MAX : -FLT_MAX;
  return v;
}

// v of lane j of this lane's group of G: a segment shuffle for a power of
// two, else a whole-warp shuffle from lane_of[j], the group's lane j
template <int G>
__device__ __forceinline__ float from_lane(float v, int j, const int* lane_of) {
  if constexpr ((G & (G - 1)) == 0)
    return __shfl_sync(FULL, v, j, G);
  else
    return __shfl_sync(FULL, v, lane_of[j]);
}

// G lanes per system, 32 / G systems a warp (lanes past that idle); R > 0
// fixes r at compile time, else r_arg is used
template <int G, int R>
__global__ void __launch_bounds__(THREADS)
solve_kernel(const float* __restrict__ a, long long sa_n, long long sa_i,
             long long sa_j, const float* __restrict__ b, long long sb_n,
             long long sb_j, const float* __restrict__ nreg, long long sn,
             const float* __restrict__ gram, float reg, int n, int r_arg,
             float* __restrict__ out) {
  constexpr int SPW = 32 / G;      // systems per warp
  constexpr int ROWS = SPW * G;    // lanes in use
  constexpr int STRIDE = G + 1;    // odd for G >= 2: lanes hit distinct banks
  // one system a warp (G = 32) stages its rows through shared memory;
  // narrower groups read their rows straight into registers, as their
  // rows are short and a warp's loads span a few cache lines
  constexpr bool STAGED = G == 32;
  __shared__ float stage[STAGED ? WARPS : 1][STAGED ? 32 * STRIDE : 1];
  __shared__ float gram_s[G * STRIDE];  // the Gram's lower triangle
  const int r = R > 0 ? R : r_arg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane % G;          // this lane's row of its system
  const long long sys0 = ((long long)blockIdx.x * WARPS + warp) * SPW;
  const long long sys = sys0 + lane / G;
  const bool live = lane < ROWS && sys < n;
  int lane_of[G];
#pragma unroll
  for (int j = 0; j < G; ++j) lane_of[j] = lane - gl + j;

  if (gram != nullptr) {
    for (int e = threadIdx.x; e < G * G; e += THREADS) {
      const int i = e / G, c = e % G;
      gram_s[i * STRIDE + c] = (i < r && c <= i) ? gram[i * r + c] : 0.f;
    }
  }
  float rhs = (live && gl < r) ? b[sys * sb_n + gl * sb_j] : 0.f;
  const float nr = live ? nreg[sys * sn] : 0.f;
  // row gl of the lower triangle, zeros elsewhere; every load is issued
  // before the first is used
  float row[G];
  if constexpr (STAGED) {
    // element e = lane + 32 t of the warp's system is row t, column lane
    const float* as = a + sys0 * sa_n + lane * sa_j;
#pragma unroll
    for (int t = 0; t < G; ++t)
      row[t] = (sys0 < n && t < r && lane <= t) ? as[t * sa_i] : 0.f;
    float* sm = stage[warp];
#pragma unroll
    for (int t = 0; t < G; ++t) sm[t * STRIDE + lane] = row[t];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < G; ++c) row[c] = sm[lane * STRIDE + c];
  } else {
    const float* ar = a + sys * sa_n + gl * sa_i;
#pragma unroll
    for (int c = 0; c < G; ++c)
      row[c] = (live && gl < r && c <= gl) ? ar[c * sa_j] : 0.f;
  }
  __syncthreads();  // gram_s

  // assemble row gl: + reg * n_reg on the diagonal, then the Gram.
  // Entries above the diagonal are never read by a live result, so they
  // are updated without a predicate throughout.
  const float reg_n = __fmul_rn(reg, nr);
#pragma unroll
  for (int c = 0; c < G; ++c)
    if (c == gl) row[c] = __fadd_rn(row[c], reg_n);
  if (gram != nullptr) {
#pragma unroll
    for (int c = 0; c < G; ++c) row[c] = __fadd_rn(gram_s[gl * STRIDE + c], row[c]);
  }

  // Cholesky by rank-1 Schur downdates, column by column
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= r) break;
    const float dj = __fsqrt_rn(from_lane<G>(row[j], j, lane_of));
    row[j] = __fdiv_rn(row[j], dj);
#pragma unroll
    for (int i2 = j + 1; i2 < G; ++i2) {
      if ((i2 & 3) == 0 && i2 >= r) break;  // columns past r: harmless
      const float c2 = from_lane<G>(row[j], i2, lane_of);  // L[i2][j]
      row[i2] = __fsub_rn(row[i2], __fmul_rn(row[j], c2));
    }
  }

  // forward: L z = b (rhs holds b_i, then z_i)
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j >= r) break;
    const float q = __fdiv_rn(rhs, row[j]);
    if (gl == j) rhs = q;
    const float zj = from_lane<G>(rhs, j, lane_of);
    if (gl > j) rhs = __fsub_rn(rhs, __fmul_rn(row[j], zj));
  }
  // back: L^T w = z (rhs holds w_k on lanes k > j)
#pragma unroll
  for (int j = G - 1; j >= 0; --j) {
    if (j >= r) continue;
    const float p = __fmul_rn(row[j], rhs);  // lane k: L[k][j] * w_k
    float acc = from_lane<G>(rhs, j, lane_of);
#pragma unroll
    for (int k = j + 1; k < G; ++k) {
      if (k >= r) break;
      acc = __fsub_rn(acc, from_lane<G>(p, k, lane_of));
    }
    const float wj = __fdiv_rn(acc, row[j]);
    if (gl == j) rhs = wj;
  }

  if (live && gl < r)
    out[sys * r + gl] = nr > 0.f ? nan_to_num(rhs) : 0.f;
}

template <int G, int R>
void launch(const float* a, long long sa_n, long long sa_i, long long sa_j,
            const float* b, long long sb_n, long long sb_j, const float* nreg,
            long long sn, const float* gram, float reg, int n, int r,
            float* out, cudaStream_t st) {
  constexpr long long per_block = (long long)WARPS * (32 / G);
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  solve_kernel<G, R><<<blocks, THREADS, 0, st>>>(
      a, sa_n, sa_i, sa_j, b, sb_n, sb_j, nreg, sn, gram, reg, n, r, out);
}

}  // namespace

extern "C" {

int als_solve_max_rank(void) { return MAX_RANK; }

// Solve n systems of rank r <= 32 with g lanes per system (g from
// als_kernel.solve_group: 10 at r = 10, else the smallest power of two
// >= r).  a: A[s][i][j] at a + s*sa_n + i*sa_i + j*sa_j (lower triangle
// read); b: b[s][j] at b + s*sb_n + j*sb_j; nreg: n_reg[s] at nreg +
// s*sn; gram: (r, r) contiguous or null; out: (n, r) contiguous.  All
// f32 on device `dev` (made current here: this library's runtime keeps
// its own current device); strides in elements.  Returns
// cudaGetLastError() after the launch, the error of cudaSetDevice, or
// cudaErrorInvalidValue for an r or g the kernel does not take.
int als_solve(int dev, const float* a, long long sa_n, long long sa_i,
              long long sa_j, const float* b, long long sb_n, long long sb_j,
              const float* nreg, long long sn, const float* gram, float reg,
              int n, int r, int g, float* out, void* stream) {
  const bool pow2 = g >= r && g <= MAX_RANK && (g & (g - 1)) == 0;
  if (r < 1 || r > MAX_RANK || !((r == 10 && g == 10) || pow2))
    return (int)cudaErrorInvalidValue;
  if (n < 1) return (int)cudaSuccess;
  const cudaError_t set = cudaSetDevice(dev);
  if (set != cudaSuccess) return (int)set;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ALS_SOLVE_ARGS a, sa_n, sa_i, sa_j, b, sb_n, sb_j, nreg, sn, gram, reg, n, r, out, st
  // r == g: loops bounded at compile time
  switch (g) {
    case 1: launch<1, 1>(ALS_SOLVE_ARGS); break;
    case 2: launch<2, 2>(ALS_SOLVE_ARGS); break;
    case 4:
      r == 4 ? launch<4, 4>(ALS_SOLVE_ARGS) : launch<4, 0>(ALS_SOLVE_ARGS);
      break;
    case 8:
      r == 8 ? launch<8, 8>(ALS_SOLVE_ARGS) : launch<8, 0>(ALS_SOLVE_ARGS);
      break;
    case 10: launch<10, 10>(ALS_SOLVE_ARGS); break;
    case 16:
      r == 16 ? launch<16, 16>(ALS_SOLVE_ARGS) : launch<16, 0>(ALS_SOLVE_ARGS);
      break;
    default:
      r == 32 ? launch<32, 32>(ALS_SOLVE_ARGS) : launch<32, 0>(ALS_SOLVE_ARGS);
  }
#undef ALS_SOLVE_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
