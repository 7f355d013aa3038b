// The float64 form of K2's Gram for Hopper (sm_90a): G = Xc^T Xc of
// double rows on the FP64 tensor cores (DMMA `mma.sync`, dmma_f64.cuh),
// fed by cp.async stages.  pca_moments.cu's `pca_moments_f64` launches it.
//
// Xc is the (n, d) input centered and masked in double, xc = (x -
// mean[col]) * mask[row] (the plain version's rounding: one subtract,
// one multiply); rows past the slice and columns past d count as zeros.
//
// What bounds it on an H100 SXM: the symmetric Gram's n d (d + 1)
// operations at 67 TFLOP/s on the FP64 tensor cores, or the one 8-byte
// read of x at 3.35 TB/s, whichever is longer: at n = 2^20, d = 128,
// 17.3 GFLOP (0.26 ms) against 1.07 GB (0.32 ms); at 2^18 x 1024, 275
// GFLOP (4.1 ms) against 2.1 GB.  Design against that bound:
//   - The (d, d) output is cut into T = 128-wide tiles; only tiles on and
//     above the diagonal are computed, each block one tile over one fixed
//     slice of rows (gram_tile.cuh's tile order).  At d <= 128 the one
//     tile is the whole upper triangle, so every row of the slice is read
//     from device memory exactly once.
//   - Rows go into shared memory by cp.async, BK = 16 rows a stage,
//     STAGES deep, 16 bytes a copy when d is even (else 8), zero-filled
//     past the slice and past d; each thread owns fixed columns of every
//     stage, keeps their means in registers, and centers and masks its
//     own elements in place one stage ahead of the products; the copies
//     and the centering go in parts between the depth steps, so the
//     tensor cores are not left idle while every warp stages.  A staged
//     row of 128 doubles sits in a 132-double slot, so the fragment loads
//     (depth t, columns g) hit 16 distinct bank pairs a half warp.
//   - Sixteen warps, four on each of the SM's tensor-core partitions.  A
//     diagonal tile is a 4 x 4 grid of 32 x 32 blocks, of which the 10 on
//     and above the diagonal are computed: warps 0-11 take half (16
//     columns) of one of the 6 off-diagonal blocks each (4 products of
//     16 x 8 a depth step), warps 12-15 one diagonal block each, whose
//     products below the diagonal are skipped (6 of 8) and whose B
//     fragments are their A fragments; every partition gets 18 products a
//     step.  An off-diagonal tile (d > 128) has 16 warps of 32 x 32.
// Each entry a <= b is computed once and mirrored, so the partial is
// bit-symmetric; gram::sum_slices_kernel<double> adds the slices in
// slice order.  No atomics: two launches give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma_f64.cuh"
#include "gram_tile.cuh"

namespace gram_dmma {

constexpr int T = 128;        // tile edge
constexpr int BK = 16;        // rows a stage
constexpr int LD = T + 4;     // a staged row's slot, in doubles
constexpr int STAGES = 4;
constexpr int THREADS = 512;
constexpr int KU = dmma::KU;  // depth a product
static_assert(BK % KU == 0, "stage depth");

// Dynamic shared memory of a launch: one or two staged column strips and
// the stage's mask values, STAGES deep.
__host__ __device__ constexpr int smem_bytes(bool two) {
  return STAGES * ((two ? 2 : 1) * BK * LD + BK) * (int)sizeof(double);
}

// A diagonal tile's warp: its 32 x 32 block (side 0 the row block, 1
// the column block, in units of 32) and side 2 its part, 0 or 1 the left
// or right 16 columns of an off-diagonal block (warps 0-5 and 6-11, each
// over (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)), 2 a whole diagonal
// block (warps 12-15, blocks 0-3).
__host__ __device__ constexpr int diag_job(int warp, int side) {
  if (warp >= 12) return side == 2 ? 2 : warp - 12;
  if (side == 2) return warp / 6;
  const int o = warp % 6;
  return side == 0 ? (o < 3 ? 0 : o < 5 ? 1 : 2) : (o < 3 ? o + 1 : o < 5 ? o - 1 : 3);
}

// A fragment of a k-major stage: the element (row m0 + g, depth r0 + t)
// of the product operand, that is staged row r0 + t at column m0 + g
// (`s` already points at row t, column g).
__device__ __forceinline__ double frag(const double* s, int m0, int r0) {
  return s[r0 * LD + m0];
}

// Part `part` of `parts` of one stage's copies: rows [r0, r0 + BK) of the
// strips at columns ca (and cb when `two`), and their mask values, zeros
// past the slice and past d.
constexpr int PARTS = BK / KU;  // one part after each depth step
template <int VEC>
__device__ __forceinline__ void stage(double* sa, double* sb, double* sm,
                                      const double* __restrict__ x,
                                      const double* __restrict__ mask, int d, int ca, int cb,
                                      bool two, int r0, int row_hi, int part = 0,
                                      int parts = 1) {
  constexpr int PER_ROW = T / VEC, COPIES = BK * PER_ROW / THREADS;
  static_assert(BK * PER_ROW % THREADS == 0 && THREADS % PER_ROW == 0, "copies");
#pragma unroll
  for (int i = part * COPIES / parts; i < (part + 1) * COPIES / parts; ++i) {
    const int q = threadIdx.x + i * THREADS;
    const int r = q / PER_ROW, cc = (q % PER_ROW) * VEC;
    const int row = r0 + r;
    const bool ok_a = row < row_hi && ca + cc < d;
    dmma::copy_async<VEC>(sa + r * LD + cc, ok_a ? x + (size_t)row * d + ca + cc : x, ok_a);
    if (two) {
      const bool ok_b = row < row_hi && cb + cc < d;
      dmma::copy_async<VEC>(sb + r * LD + cc, ok_b ? x + (size_t)row * d + cb + cc : x, ok_b);
    }
  }
  if (part == 0 && mask != nullptr && threadIdx.x < BK) {
    const int row = r0 + threadIdx.x;
    const bool ok = row < row_hi;
    dmma::copy_async<1>(sm + threadIdx.x, ok ? mask + row : mask, ok);
  }
}

// Part `part` of `parts` of this thread's own elements of a landed
// stage, centered and masked in place: (x - mean) * mask, zeros past the
// slice and past d.
template <int VEC>
__device__ __forceinline__ void center(double* s, const double* sm, const double (&mean)[VEC],
                                       bool has_mask, int d, int c0, int r0, int row_hi,
                                       int part = 0, int parts = 1) {
  constexpr int PER_ROW = T / VEC, COPIES = BK * PER_ROW / THREADS;
#pragma unroll
  for (int i = part * COPIES / parts; i < (part + 1) * COPIES / parts; ++i) {
    const int q = threadIdx.x + i * THREADS;
    const int r = q / PER_ROW, cc = (q % PER_ROW) * VEC;
    const bool row_ok = r0 + r < row_hi;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      double& e = s[r * LD + cc + v];
      double val = 0.0;
      if (row_ok && c0 + cc + v < d) {
        val = __dsub_rn(e, mean[v]);
        if (has_mask) val = __dmul_rn(val, sm[r]);
      }
      e = val;
    }
  }
}

template <bool WIDE, int VEC>
__global__ void __launch_bounds__(THREADS, 1)
gram_dmma_kernel(const double* __restrict__ x, const double* __restrict__ mask,
                 const double* __restrict__ mean, int n, int d, int m, int slice_rows,
                 double* __restrict__ part) {
  extern __shared__ __align__(16) double smem[];
  int ti, tj;
  gram::tile_of(blockIdx.x, m, ti, tj);
  const bool two = WIDE && ti != tj;
  const int ca = ti * T, cb = tj * T;
  const int row_lo = blockIdx.y * slice_rows;
  const int row_hi = min(n, row_lo + slice_rows);
  const int steps = row_hi > row_lo ? (row_hi - row_lo + BK - 1) / BK : 0;
  const bool has_mask = mask != nullptr;
  constexpr int STRIPS = WIDE ? 2 : 1;
  auto sa_of = [&](int s) { return smem + s * (STRIPS * BK * LD + BK); };
  auto sb_of = [&](int s) { return smem + s * (STRIPS * BK * LD + BK) + BK * LD; };
  auto sm_of = [&](int s) { return smem + s * (STRIPS * BK * LD + BK) + STRIPS * BK * LD; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's staged columns and their means
  const int my_col = (tid % (T / VEC)) * VEC;
  double mean_a[VEC], mean_b[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    mean_a[v] = ca + my_col + v < d ? mean[ca + my_col + v] : 0.0;
    mean_b[v] = two && cb + my_col + v < d ? mean[cb + my_col + v] : 0.0;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      stage<VEC>(sa_of(s), sb_of(s), sm_of(s), x, mask, d, ca, cb, two, row_lo + s * BK,
                 row_hi);
    dmma::copy_commit();
  }
  dmma::copy_wait<STAGES - 2>();
  __syncthreads();
  if (steps > 0) {
    center<VEC>(sa_of(0), sm_of(0), mean_a, has_mask, d, ca, row_lo, row_hi);
    if (two) center<VEC>(sb_of(0), sm_of(0), mean_b, has_mask, d, cb, row_lo, row_hi);
  }

  // accumulators: the 16 x 8 products [mi][nj] of a 32 x 32 block
  double acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0;
  // this warp's block: rows a0.., columns b0.. of the Gram
  const int job = two ? 0 : diag_job(warp, 2);
  const int a0 = two ? ca + 32 * (warp / 4) : ca + 32 * diag_job(warp, 0);
  const int b0 = two ? cb + 32 * (warp % 4) : ca + 32 * diag_job(warp, 1) + 16 * (job == 1);
  // the same block's columns in its stage strip, and whether any lies
  // inside d
  const int ra = a0 - ca, rb = b0 - (two ? cb : ca);
  const bool busy = b0 < d;

  for (int it = 0; it < steps; ++it) {
    dmma::copy_wait<STAGES - 3>();
    // stage it + 1 landed for all (its mask too), stage it centered by
    // all, stage it - 1 read by all
    __syncthreads();
    // between this stage's depth steps: a part of the copies of stage it
    // + STAGES - 1 (into the buffer of stage it - 1), and a part of the
    // centering of stage it + 1
    const int nxt = it + STAGES - 1, nxt_s = nxt % STAGES, nxt_r0 = row_lo + nxt * BK;
    const int cen_s = (it + 1) % STAGES, cen_r0 = row_lo + (it + 1) * BK;
    auto between = [&](int p) {
      if (nxt < steps)
        stage<VEC>(sa_of(nxt_s), sb_of(nxt_s), sm_of(nxt_s), x, mask, d, ca, cb, two, nxt_r0,
                   row_hi, p, PARTS);
      if (it + 1 < steps) {
        center<VEC>(sa_of(cen_s), sm_of(cen_s), mean_a, has_mask, d, ca, cen_r0, row_hi, p,
                    PARTS);
        if (two)
          center<VEC>(sb_of(cen_s), sm_of(cen_s), mean_b, has_mask, d, cb, cen_r0, row_hi, p,
                      PARTS);
      }
    };

    const double* sa = sa_of(it % STAGES) + t * LD + g;
    const double* sb = two ? sb_of(it % STAGES) + t * LD + g : sa;
    if (busy) {
#pragma unroll
      for (int u = 0; u < BK; u += KU) {
        double a[2][KU / 2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int s = 0; s < KU / 4; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) a[mi][2 * s + h] = frag(sa, ra + 16 * mi + 8 * h, u + 4 * s);
        if (job == 2) {
          // a diagonal block: products on and above the diagonal, B's
          // fragments are A's
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int nj = 2 * mi; nj < 4; ++nj) {
              double b[KU / 4];
#pragma unroll
              for (int s = 0; s < KU / 4; ++s) b[s] = a[nj / 2][2 * s + nj % 2];
              dmma::mma16x8(acc[mi][nj], a[mi], b);
            }
        } else {
          // 32 columns off the diagonal (two), or 16 (a half block)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            if (!two && nj >= 2) break;
            double b[KU / 4];
#pragma unroll
            for (int s = 0; s < KU / 4; ++s) b[s] = frag(sb, rb + 8 * nj, u + 4 * s);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) dmma::mma16x8(acc[mi][nj], a[mi], b);
          }
        }
        between(u / KU);
      }
    } else {
#pragma unroll
      for (int p = 0; p < PARTS; ++p) between(p);
    }
    dmma::copy_commit();
  }
  dmma::copy_wait<0>();

  // each entry a <= b once, and its mirror
  double* out = part + (size_t)blockIdx.y * d * d;
  auto put = [&](int a, int b, double v) {
    if (a <= b && b < d) {
      out[(size_t)a * d + b] = v;
      out[(size_t)b * d + a] = v;
    }
  };
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((job == 2 && nj >= 2 * mi) || (job != 2 && (two || nj < 2)))
          put(a0 + 16 * mi + 8 * (e / 2) + g, b0 + 8 * nj + 2 * t + e % 2, acc[mi][nj][e]);
}

template <bool WIDE, int VEC>
inline int launch_one(dim3 grid, cudaStream_t st, const double* x, const double* mask,
                      const double* mean, int n, int d, int m, int slice_rows, double* part) {
  constexpr int bytes = smem_bytes(WIDE);
  // the shared-memory limit is a per-device attribute of the kernel: set
  // it once per device
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(done >> dev & 1ull)) {
    err = cudaFuncSetAttribute(gram_dmma_kernel<WIDE, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) done |= 1ull << dev;
  }
  gram_dmma_kernel<WIDE, VEC><<<grid, THREADS, bytes, st>>>(x, mask, mean, n, d, m,
                                                           slice_rows, part);
  return 0;
}

// The tile kernel over (tiles, slices) into `part` (slices, d, d): `m`
// 128-wide tiles per side, slice_rows a multiple of BK; the caller sums
// the slices.  Returns a cudaError_t.
inline int launch(const double* x, const double* mask, const double* mean, int n, int d,
                  int m, int slices, int slice_rows, double* part, cudaStream_t st) {
  const dim3 grid(m * (m + 1) / 2, slices);
  const bool vec = d % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (m == 1)
    return vec ? launch_one<false, 2>(grid, st, x, mask, mean, n, d, m, slice_rows, part)
               : launch_one<false, 1>(grid, st, x, mask, mean, n, d, m, slice_rows, part);
  return vec ? launch_one<true, 2>(grid, st, x, mask, mean, n, d, m, slice_rows, part)
             : launch_one<true, 1>(grid, st, x, mask, mean, n, d, m, slice_rows, part);
}

}  // namespace gram_dmma
