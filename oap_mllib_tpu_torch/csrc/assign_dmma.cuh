// The float64 form's Lloyd assignment for Hopper (sm_90a): the nearest of
// k centers of every row in double, its cross term x.c on the FP64
// tensor cores (DMMA `mma.sync`, dmma_f64.cuh), fed by cp.async stages.
// The assignment pass of kmeans_accumulate.cu's `kmeans_accumulate_f64`.
//
// Scores as the plain version forms them: cost mode d2 = max((|x|^2 +
// |c|^2) - 2 x.c, 0), ranked by the least; loop mode x.c - |c|^2 / 2,
// ranked by the greatest; ties to the lowest index.
//
// What bounds it on an H100 SXM: 2 n k d operations at 67 TFLOP/s on the
// FP64 tensor cores (8.0 ms at n = 2^20, d = 256, k = 1000) against 8 n d
// bytes of rows (0.64 ms).  Design against that bound:
//   - A block owns BM = 128 rows and walks the k centers in tiles of
//     BN = 128; for each tile it walks the depth in stages of BK = 32.
//     Eight warps, 4 (rows) x 2 (centers), each hold a 32 x 64 tile of
//     x.c in registers (64 doubles a thread): a depth step of 4 reads 12
//     m8 fragments from shared memory for 16 m16n8k4 products, 0.375
//     bytes of shared memory per FMA against the 4 of the SIMT tile this
//     replaced (shared bandwidth, not the FP64 units, set its pace).
//   - Rows and centers are staged with cp.async, 16 bytes a copy when d is
//     even (else 8), zero-filled past n, k and d, STAGES deep over the
//     flattened (center tile, depth stage) sequence, so the copies of the
//     next tile fly during this tile's last products and its scores; a
//     stage's copies are issued in parts between the depth steps.  A
//     stage keeps each row of 32 doubles in a 36-double slot: the m8
//     fragment loads (rows g, depth t) hit 16 distinct bank pairs a half
//     warp.  Dynamic shared memory, 216 KB, one block an SM (on an H100
//     against 16-deep stages four deep: 0.66 ms less a loop
//     pass at 2^20 x 256, k = 1000; and against 16 warps of 32 x 32,
//     whose 128-register cap spills).
//   - Scores fold into a running (best, lowest index) per row and thread
//     across the center tiles, in rising column order; the 4 lanes and 2
//     warps that share a row then reduce in a fixed order.  No atomics.
//   - Cost mode's |x|^2 comes from the first center tile's stages, no
//     read of its own: each stage, one warp a row, a lane an element of
//     the stage's 32 of depth, a fixed xor-shuffle tree, added to the
//     row's running sum in stage order.
// Every depth takes this tile; there is no route by depth.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "dmma_f64.cuh"

namespace assign_dmma {

constexpr int BM = 128;            // rows a block
constexpr int BN = 128;            // centers a tile
constexpr int BK = 32;             // depth a stage
constexpr int LD = BK + 4;         // a staged row's slot, in doubles
constexpr int STAGES = 3;
constexpr int THREADS = 256;       // 8 warps: 4 along rows, 2 along centers
constexpr int WM = 32, WN = 64;    // a warp's tile
constexpr int MI = WM / 16;        // 16-row products a warp
constexpr int NJ = WN / 8;         // 8-column products a warp
constexpr int KU = dmma::KU;       // depth a product
constexpr int SMEM_BYTES = STAGES * (BM + BN) * LD * (int)sizeof(double);
static_assert(BK % KU == 0 && (BM / WM) * (BN / WN) * 32 == THREADS, "tile shape");

__device__ __forceinline__ bool better(double s, int i, double bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// Copy part `part` of PARTS of one stage: rows [row0, row0 + BM) and
// centers [n0, n0 + BN) at depth [k0, k0 + BK), zeros past n, k and d.
constexpr int PARTS = BK / KU;  // one part after each depth step
template <int VEC>
__device__ __forceinline__ void stage(double* xs, double* cs, const double* __restrict__ x,
                                      const double* __restrict__ c, int n, int d, int k,
                                      int row0, int n0, int k0, int part = 0, int parts = 1) {
  constexpr int PER_ROW = BK / VEC, COPIES = BM * PER_ROW / THREADS;
  static_assert(BM == BN && BM * PER_ROW % THREADS == 0, "copies");
#pragma unroll
  for (int i = part * COPIES / parts; i < (part + 1) * COPIES / parts; ++i) {
    const int q = threadIdx.x + i * THREADS;
    const int r = q / PER_ROW, cc = (q % PER_ROW) * VEC;
    const int row = row0 + r, col = k0 + cc;
    const bool ok = row < n && col < d;
    dmma::copy_async<VEC>(xs + r * LD + cc, ok ? x + (size_t)row * d + col : x, ok);
  }
#pragma unroll
  for (int i = part * COPIES / parts; i < (part + 1) * COPIES / parts; ++i) {
    const int q = threadIdx.x + i * THREADS;
    const int r = q / PER_ROW, cc = (q % PER_ROW) * VEC;
    const int cen = n0 + r, col = k0 + cc;
    const bool ok = cen < k && col < d;
    dmma::copy_async<VEC>(cs + r * LD + cc, ok ? c + (size_t)cen * d + col : c, ok);
  }
}

template <bool NEED_COST, int VEC>
__global__ void __launch_bounds__(THREADS, 1)
assign_dmma_kernel(const double* __restrict__ x, const double* __restrict__ w,
              const double* __restrict__ c, const double* __restrict__ csq, int n, int d,
              int k, int* __restrict__ labels, double* __restrict__ cost_part) {
  extern __shared__ __align__(16) double smem[];
  __shared__ double xsq_s[BM];
  __shared__ double red_s[BN / WN][BM];
  __shared__ int redi_s[BN / WN][BM];
  __shared__ double rowcost_s[BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int row0 = blockIdx.x * BM;
  const int nk = (d + BK - 1) / BK, tiles = (k + BN - 1) / BN, steps = nk * tiles;
  auto xs_of = [&](int s) { return smem + s * (BM + BN) * LD; };
  auto cs_of = [&](int s) { return smem + s * (BM + BN) * LD + BM * LD; };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage<VEC>(xs_of(s), cs_of(s), x, c, n, d, k, row0, (s / nk) * BN,
                              (s % nk) * BK);
    dmma::copy_commit();
  }

  // cost mode: |x|^2 of the rows this thread's accumulators hold (wm WM +
  // 16 mi + 8 h + g), and of row warp * RPW + lane for lane < RPW, summed
  // from the first center tile's stages
  constexpr int RPW = BM / (THREADS / 32);  // rows a warp sums
  static_assert(BK == 32 && RPW <= 32, "one lane an element of a stage's depth");
  double xsq[MI * 2], xacc = 0.0;

  double best[MI * 2];
  int bidx[MI * 2];
#pragma unroll
  for (int i = 0; i < MI * 2; ++i) {
    best[i] = -CUDART_INF;
    bidx[i] = 0;
  }
  double acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0;

  for (int it = 0; it < steps; ++it) {
    dmma::copy_wait<STAGES - 2>();
    __syncthreads();  // stage `it` landed for all; stage it - 1 is free
    // stage it + STAGES - 1 goes into the buffer of stage it - 1, its
    // copies issued in parts between this stage's depth steps
    const int nxt = it + STAGES - 1, nxt_s = nxt % STAGES;
    const int nxt_n0 = (nxt / nk) * BN, nxt_k0 = (nxt % nk) * BK;

    const double* xs = xs_of(it % STAGES) + (wm * WM + g) * LD + t;
    const double* cs = cs_of(it % STAGES) + (wn * WN + g) * LD + t;
#pragma unroll
    for (int u = 0; u < BK; u += KU) {
      double a[MI][KU / 2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int s = 0; s < KU / 4; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) a[mi][2 * s + h] = xs[(16 * mi + 8 * h) * LD + u + 4 * s];
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        double b[KU / 4];
#pragma unroll
        for (int s = 0; s < KU / 4; ++s) b[s] = cs[8 * nj * LD + u + 4 * s];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) dmma::mma16x8(acc[mi][nj], a[mi], b);
      }
      if (nxt < steps)
        stage<VEC>(xs_of(nxt_s), cs_of(nxt_s), x, c, n, d, k, row0, nxt_n0, nxt_k0, u / KU,
                   PARTS);
    }
    dmma::copy_commit();

    if (NEED_COST && it < nk) {
      // |x|^2 from this stage of the first center tile: one warp a row, a
      // lane an element of the stage's depth, a fixed xor tree, added to
      // the row's sum (held by lane r) in stage order
      const double* xr = xs_of(it % STAGES) + warp * RPW * LD + lane;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        double p = __dmul_rn(xr[r * LD], xr[r * LD]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p = __dadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
        if (lane == r) xacc = __dadd_rn(xacc, p);
      }
      if (it == nk - 1) {
        if (lane < RPW) xsq_s[warp * RPW + lane] = xacc;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < MI * 2; ++i) xsq[i] = xsq_s[wm * WM + 8 * i + g];
      }
    }

    if (it % nk == nk - 1) {
      // this center tile's scores, in rising column order per row
      const int n0 = (it / nk) * BN + wn * WN;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * nj + 2 * t + e;
          if (col >= k) continue;
          const double cq = csq[col];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 2 * mi + h;
              const double v = acc[mi][nj][2 * h + e];
              double s;
              if (NEED_COST) {
                const double d2 = __dsub_rn(__dadd_rn(xsq[i], cq), __dmul_rn(2.0, v));
                s = -fmax(d2, 0.0);
              } else {
                s = __dsub_rn(v, __dmul_rn(0.5, cq));
              }
              if (s > best[i]) {
                best[i] = s;
                bidx[i] = col;
              }
            }
        }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0;
    }
  }
  dmma::copy_wait<0>();

  // the 4 lanes of a row, then the warps along the centers, in order
#pragma unroll
  for (int i = 0; i < MI * 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const double os = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (better(os, oi, best[i], bidx[i])) {
        best[i] = os;
        bidx[i] = oi;
      }
    }
    if (t == 0) {
      red_s[wn][wm * WM + 8 * i + g] = best[i];
      redi_s[wn][wm * WM + 8 * i + g] = bidx[i];
    }
  }
  __syncthreads();
  if (tid < BM) {
    double bs = red_s[0][tid];
    int bi = redi_s[0][tid];
#pragma unroll
    for (int j = 1; j < BN / WN; ++j)
      if (better(red_s[j][tid], redi_s[j][tid], bs, bi)) {
        bs = red_s[j][tid];
        bi = redi_s[j][tid];
      }
    const int row = row0 + tid;
    if (row < n) labels[row] = bi;
    if (NEED_COST) rowcost_s[tid] = row < n ? __dmul_rn(-bs, w[row]) : 0.0;
  }
  if (NEED_COST) {
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int r = 0; r < BM; ++r) s = __dadd_rn(s, rowcost_s[r]);
      cost_part[blockIdx.x] = s;
    }
  }
}

template <bool NEED_COST, int VEC>
inline cudaError_t launch_one(int dev, cudaStream_t st, const double* x, const double* w,
                              const double* c, const double* csq, int n, int d, int k,
                              int* labels, double* cost_part) {
  // the shared-memory limit is a per-device attribute of the kernel: set
  // it once per device
  static unsigned long long done = 0;
  if (dev >= 64 || !(done >> dev & 1ull)) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_dmma_kernel<NEED_COST, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (dev < 64) done |= 1ull << dev;
  }
  assign_dmma_kernel<NEED_COST, VEC><<<(n + BM - 1) / BM, THREADS, SMEM_BYTES, st>>>(
      x, w, c, csq, n, d, k, labels, cost_part);
  return cudaSuccess;
}

// Labels of every row and, in cost mode, one cost partial per block of
// BM rows (`cost_part` holds ceil(n / BM)); csq holds |c|^2 of the k
// centers.
inline cudaError_t launch(int dev, cudaStream_t st, bool need_cost, const double* x,
                          const double* w, const double* c, const double* csq, int n, int d,
                          int k, int* labels, double* cost_part) {
  const bool vec = d % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (need_cost)
    return vec ? launch_one<true, 2>(dev, st, x, w, c, csq, n, d, k, labels, cost_part)
               : launch_one<true, 1>(dev, st, x, w, c, csq, n, d, k, labels, cost_part);
  return vec ? launch_one<false, 2>(dev, st, x, w, c, csq, n, d, k, labels, cost_part)
             : launch_one<false, 1>(dev, st, x, w, c, csq, n, d, k, labels, cost_part);
}

}  // namespace assign_dmma
