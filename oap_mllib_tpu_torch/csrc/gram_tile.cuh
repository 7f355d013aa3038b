// Deterministic tiled Gram  G = Xc^T Xc  for Hopper (sm_90a), shared by
// pca_moments.cu (K2, the centered PCA Gram) and als_factor_gram.cu (K4,
// the ALS factor Gram F^T F).  Each of those keeps its own entry point.
//
// Xc is the (n, d) input, centered and masked in f32 when CENTER is set
// (xc = (x - mean[col]) * mask[row], as `_tile_moments` computes it)
// and taken as it is otherwise.  Rows past n read as zero, so ragged row
// counts need no padding, and columns past d likewise.
//
// Work split.  The (d, d) output is cut into T x T tiles (T = 16 * TM);
// only the tiles on and above the diagonal are computed, and each block
// owns one such tile over one fixed slice of `slice_rows` rows.  A block
// stages BK rows of its two column tiles in shared memory per step and
// runs a TM x TM register tile per thread (256 threads, 16 x 16), the
// thread's rows and columns interleaved at stride 16 so shared-memory
// reads are broadcasts or consecutive words.  It writes its tile, and
// the tile's mirror image, into its slice's (d, d) partial; a second
// kernel sums the slice partials in slice order.  No float atomics: two
// launches give the same bits.  The result is bit-symmetric: a mirrored
// tile is the same value, and inside a diagonal tile the computation of
// (a, b) and (b, a) is the same sequence of symmetric operations.
//
// Tiers (MODE): 0 highest = FP32 FMA on f32 operands; 2 default = FP32
// FMA on bf16-rounded operands (a product of two bf16 values is exact
// in f32, so this is a bf16 product with f32 accumulation); 1 high =
// operands split into bf16 hi + lo, acc += hi_a hi_b + (hi_a lo_b +
// lo_a hi_b), the cross pair summed by one FMA of two exact products,
// which keeps it symmetric in (a, b).  Everything runs on the FP32 pipe
// (SIMT); tensor cores (wgmma) and TMA are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gram {

constexpr int SIDE = 16;       // threads per block edge
constexpr int THREADS = SIDE * SIDE;
constexpr int BK = 16;         // rows per shared-memory stage

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

template <int TM, int MODE, bool CENTER>
__device__ __forceinline__ void stage(const float* __restrict__ x,
                                      const float* __restrict__ mask,
                                      const float* __restrict__ mean, int d,
                                      int r0, int row_hi, int c0,
                                      float (*hi)[SIDE * TM],
                                      float (*lo)[SIDE * TM]) {
  constexpr int T = SIDE * TM;
  for (int e = threadIdx.x; e < BK * T; e += THREADS) {
    const int rr = e / T, cc = e % T;
    const int row = r0 + rr, col = c0 + cc;
    float v = 0.f;
    if (row < row_hi && col < d) {
      v = x[(size_t)row * d + col];
      if (CENTER) {
        v = __fsub_rn(v, mean[col]);
        if (mask != nullptr) v = __fmul_rn(v, mask[row]);
      }
    }
    if (MODE == 0) {
      hi[rr][cc] = v;
    } else if (MODE == 2) {
      hi[rr][cc] = bf16_round(v);
    } else {
      const float h = bf16_round(v);
      hi[rr][cc] = h;
      lo[rr][cc] = bf16_round(__fsub_rn(v, h));
    }
  }
}

template <int TM, int MODE, bool CENTER>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const float* __restrict__ x, const float* __restrict__ mask,
            const float* __restrict__ mean, int n, int d, int m,
            int slice_rows, float* __restrict__ part) {
  constexpr int T = SIDE * TM;
  __shared__ float Ah[BK][T], Al[BK][T], Bh[BK][T], Bl[BK][T];

  int ti, tj;
  tile_of(blockIdx.x, m, ti, tj);
  const bool diag = ti == tj;
  const int s = blockIdx.y;
  const int row_lo = s * slice_rows;
  const int row_hi = min(n, row_lo + slice_rows);
  const int tx = threadIdx.x % SIDE, ty = threadIdx.x / SIDE;
  const float(*bh)[T] = diag ? Ah : Bh;
  const float(*bl)[T] = diag ? Al : Bl;

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  for (int r0 = row_lo; r0 < row_hi; r0 += BK) {
    stage<TM, MODE, CENTER>(x, mask, mean, d, r0, row_hi, ti * T, Ah, Al);
    if (!diag)
      stage<TM, MODE, CENTER>(x, mask, mean, d, r0, row_hi, tj * T, Bh, Bl);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ah[TM], bhv[TM], al[TM], blv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ah[i] = Ah[kk][ty + SIDE * i];
        bhv[i] = bh[kk][tx + SIDE * i];
        if (MODE == 1) {
          al[i] = Al[kk][ty + SIDE * i];
          blv[i] = bl[kk][tx + SIDE * i];
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          if (MODE == 1) {
            const float cross =
                fmaf(ah[i], blv[j], __fmul_rn(al[i], bhv[j]));
            acc[i][j] = __fadd_rn(fmaf(ah[i], bhv[j], acc[i][j]), cross);
          } else {
            acc[i][j] = fmaf(ah[i], bhv[j], acc[i][j]);
          }
        }
    }
    __syncthreads();
  }

  float* out = part + (size_t)s * d * d;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int a = ti * T + ty + SIDE * i;
    if (a >= d) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int b = tj * T + tx + SIDE * j;
      if (b >= d) continue;
      out[(size_t)a * d + b] = acc[i][j];
      if (!diag) out[(size_t)b * d + a] = acc[i][j];
    }
  }
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

template <int TM, bool CENTER>
inline void launch_mode(int mode, dim3 grid, cudaStream_t st, const float* x,
                        const float* mask, const float* mean, int n, int d,
                        int m, int slice_rows, float* part) {
  if (mode == 0)
    gram_kernel<TM, 0, CENTER><<<grid, THREADS, 0, st>>>(x, mask, mean, n, d,
                                                         m, slice_rows, part);
  else if (mode == 1)
    gram_kernel<TM, 1, CENTER><<<grid, THREADS, 0, st>>>(x, mask, mean, n, d,
                                                         m, slice_rows, part);
  else
    gram_kernel<TM, 2, CENTER><<<grid, THREADS, 0, st>>>(x, mask, mean, n, d,
                                                         m, slice_rows, part);
}

// The whole Gram: the tile kernel over (tiles, slices), then the slice
// sum into `gram` (d, d).  `tm` is 1, 2, 4 or 8; `m` tiles per side.
// Returns cudaGetLastError() after the launches.
template <bool CENTER>
inline int launch(const float* x, const float* mask, const float* mean,
                  int n, int d, int mode, int tm, int m, int slices,
                  int slice_rows, float* part, float* gram,
                  cudaStream_t st) {
  const dim3 grid(m * (m + 1) / 2, slices);
  switch (tm) {
    case 1:
      launch_mode<1, CENTER>(mode, grid, st, x, mask, mean, n, d, m,
                             slice_rows, part);
      break;
    case 2:
      launch_mode<2, CENTER>(mode, grid, st, x, mask, mean, n, d, m,
                             slice_rows, part);
      break;
    case 4:
      launch_mode<4, CENTER>(mode, grid, st, x, mask, mean, n, d, m,
                             slice_rows, part);
      break;
    default:
      launch_mode<8, CENTER>(mode, grid, st, x, mask, mean, n, d, m,
                             slice_rows, part);
  }
  const long long elems = (long long)d * d;
  sum_slices_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(
      part, slices, elems, gram);
  return (int)cudaGetLastError();
}

}  // namespace gram
