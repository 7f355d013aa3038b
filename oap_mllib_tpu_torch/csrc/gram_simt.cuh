// Deterministic SIMT Gram  G = Xc^T Xc  for Hopper (sm_90a): the route of
// pca_moments.cu (K2) at every tier below the width (d = 64) where
// gram_wgmma.cuh takes over.
//
// Xc is the (n, d) input, centered and masked in f32 (xc = (x -
// mean[col]) * mask[row], as `_tile_moments` computes it).  Rows past
// the slice and columns past d are staged as zeros, so ragged shapes
// need no padding in device memory.
//
// Work split (gram_tile.cuh's tile order and slice sum).  The (d, d)
// output is cut into T x T tiles (T = 16 * TM); only tiles on and above
// the diagonal are computed, and each block owns one tile over one fixed
// slice of rows, with a TM x TM register tile per thread (256 threads,
// 16 x 16, so shared-memory reads are broadcasts or consecutive
// words).  It writes
// its tile and the tile's mirror image into its slice's (d, d) partial;
// gram::sum_slices_kernel sums the partials in slice order.  No float
// atomics: two launches give the same bits, and every entry is computed
// once and mirrored, so the result is bit-symmetric.
//
// What it adds to a plain tiled Gram.  (1) A diagonal tile skips
// the register pairs that hold only entries below its diagonal, and
// writes each entry a <= b once, with its mirror: the thread (ty, tx)
// holds rows ty + 16 i and columns tx + 16 j, and keeps the pairs j >= i
// (10 of 16 products at TM = 4).  (2) The raw f32
// rows (and their mask values) are staged with cp.async into two
// shared-memory stages, 16 bytes a copy where d is a multiple of 4 (else
// 4), zero-filled past the edges; the next stage's copies fly while the
// current one is formed and computed.
// Each thread owns fixed columns of the stage, so it keeps their means
// in registers and forms the operand in place after the copy lands (no
// division per element).
//
// Tiers (MODE): 0 highest = FP32 FMA on f32 operands; 2 default = FP32
// FMA on bf16-rounded operands (exact products, f32 sums); 1 high =
// operands split into bf16 hi + lo, acc += hi_a hi_b + (hi_a lo_b +
// lo_a hi_b), the cross pair summed by one FMA of two exact products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_tile.cuh"

namespace gram_simt {

constexpr int SIDE = 16;
constexpr int THREADS = SIDE * SIDE;
constexpr int BK = 16;  // rows per stage

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VEC floats from src to shared dst, or zeros when !valid.
template <int VEC>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const int bytes = valid ? 4 * VEC : 0;
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int TM, int VEC>
struct Stager {
  static constexpr int T = SIDE * TM;
  static constexpr int CPR = T / VEC;  // copies per staged row
  static constexpr int PASSES = (BK * CPR + THREADS - 1) / THREADS;
  static constexpr int RSTEP = THREADS / CPR;  // rows between passes
  int cc;       // this thread's copy column: floats [cc * VEC, +VEC)
  int rr0;      // its first staged row
  float mean_v[VEC];
  bool col_ok;

  __device__ void init(const float* mean, int d, int c0) {
    cc = threadIdx.x % CPR;
    rr0 = threadIdx.x / CPR;
    const int col = c0 + cc * VEC;
    col_ok = col < d;  // VEC == 4 only when d % 4 == 0
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      mean_v[v] = col + v < d ? mean[col + v] : 0.f;
  }

  __device__ void load(float (*s)[T], const float* x, int d, int c0, int r0,
                       int row_hi) const {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int rr = rr0 + p * RSTEP;
      if (rr < BK) {
        const int row = r0 + rr;
        const bool ok = col_ok && row < row_hi;
        const float* src = ok ? x + (size_t)row * d + c0 + cc * VEC : x;
        copy_async<VEC>(&s[rr][cc * VEC], src, ok);
      }
    }
  }

  // center, mask (the rows' values at sm, or null for ones) and round the
  // landed stage in place (lo parts at MODE 1)
  template <int MODE>
  __device__ void form(float (*s)[T], float (*lo)[T], const float* sm,
                       int r0, int row_hi) const {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int rr = rr0 + p * RSTEP;
      if (rr < BK) {
        const int row = r0 + rr;
        const bool ok = col_ok && row < row_hi;
        const float m = sm != nullptr ? sm[rr] : 1.f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float val = 0.f;
          if (ok) {
            val = __fsub_rn(s[rr][cc * VEC + v], mean_v[v]);
            if (sm != nullptr) val = __fmul_rn(val, m);
          }
          if (MODE == 0) {
            s[rr][cc * VEC + v] = val;
          } else if (MODE == 2) {
            s[rr][cc * VEC + v] = gram::bf16_round(val);
          } else {
            const float h = gram::bf16_round(val);
            s[rr][cc * VEC + v] = h;
            lo[rr][cc * VEC + v] = gram::bf16_round(__fsub_rn(val, h));
          }
        }
      }
    }
  }
};

// Row (or column) of a thread's register i in a 16 * TM tile:
// interleaved at stride 16.
__device__ __forceinline__ int reg_line(int t, int i) { return t + SIDE * i; }

// Whether register pair (i, j) of a diagonal tile can hold an entry on
// or above the diagonal: the pairs below it never do.
__device__ __forceinline__ constexpr bool upper_pair(int i, int j) { return j >= i; }

template <int TM, int MODE, bool DIAG>
__device__ __forceinline__ void compute_stage(const float (*ah)[SIDE * TM],
                                              const float (*al)[SIDE * TM],
                                              const float (*bh)[SIDE * TM],
                                              const float (*bl)[SIDE * TM],
                                              int tx, int ty,
                                              float (&acc)[TM][TM]) {
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], b[TM], alo[TM], blo[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      a[i] = ah[kk][ty + SIDE * i];
      b[i] = bh[kk][tx + SIDE * i];
      if (MODE == 1) {
        alo[i] = al[kk][ty + SIDE * i];
        blo[i] = bl[kk][tx + SIDE * i];
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        if (DIAG && !upper_pair(i, j)) continue;
        if (MODE == 1) {
          const float cross = fmaf(a[i], blo[j], __fmul_rn(alo[i], b[j]));
          acc[i][j] = __fadd_rn(fmaf(a[i], b[j], acc[i][j]), cross);
        } else {
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
  }
}

template <int TM, int MODE, int VEC, bool DIAG>
__device__ __forceinline__ void tile_body(
    const float* __restrict__ x, const float* __restrict__ mask,
    const float* __restrict__ mean, int d, int ti, int tj, int row_lo,
    int row_hi, float* __restrict__ out, float (*sa)[BK][SIDE * TM],
    float (*sb)[BK][SIDE * TM], float (*la)[SIDE * TM],
    float (*lb)[SIDE * TM], float (*sm)[BK]) {
  constexpr int T = SIDE * TM;
  const int tx = threadIdx.x % SIDE, ty = threadIdx.x / SIDE;
  Stager<TM, VEC> ga, gb;
  ga.init(mean, d, ti * T);
  if (!DIAG) gb.init(mean, d, tj * T);

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  const int steps = (row_hi - row_lo + BK - 1) / BK;
  auto load = [&](int t) {
    const int buf = t & 1, r0 = row_lo + t * BK;
    ga.load(sa[buf], x, d, ti * T, r0, row_hi);
    if (!DIAG) gb.load(sb[buf], x, d, tj * T, r0, row_hi);
    if (mask != nullptr && threadIdx.x < BK) {
      const int row = r0 + threadIdx.x;
      copy_async<1>(&sm[buf][threadIdx.x], row < row_hi ? mask + row : mask,
                    row < row_hi);
    }
    copy_commit();
  };
  load(0);
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1, r0 = row_lo + t * BK;
    copy_wait_all();
    __syncthreads();  // stage t landed; stage t - 1's reads are done
    if (t + 1 < steps) load(t + 1);  // flies during this stage's work
    const float* m = mask != nullptr ? sm[buf] : nullptr;
    ga.template form<MODE>(sa[buf], la, m, r0, row_hi);
    if (!DIAG) gb.template form<MODE>(sb[buf], lb, m, r0, row_hi);
    __syncthreads();
    if (DIAG)
      compute_stage<TM, MODE, true>(sa[buf], la, sa[buf], la, tx, ty, acc);
    else
      compute_stage<TM, MODE, false>(sa[buf], la, sb[buf], lb, tx, ty, acc);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int a = ti * T + reg_line(ty, i);
    if (a >= d) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int b = tj * T + reg_line(tx, j);
      if (DIAG && (!upper_pair(i, j) || a > b)) continue;
      if (b >= d) continue;
      out[(size_t)a * d + b] = acc[i][j];
      out[(size_t)b * d + a] = acc[i][j];
    }
  }
}

template <int TM, int MODE, int VEC>
__global__ void __launch_bounds__(THREADS)
gram_simt_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                 const float* __restrict__ mean, int n, int d, int m,
                 int slice_rows, float* __restrict__ part) {
  constexpr int T = SIDE * TM;
  constexpr int LO = MODE == 1 ? BK : 1;  // lo parts, high tier only
  __shared__ __align__(16) float sa[2][BK][T];
  __shared__ __align__(16) float sb[2][BK][T];
  __shared__ __align__(16) float la[LO][T];
  __shared__ __align__(16) float lb[LO][T];
  __shared__ __align__(16) float sm[2][BK];  // the rows' mask values
  int ti, tj;
  gram::tile_of(blockIdx.x, m, ti, tj);
  const int row_lo = blockIdx.y * slice_rows;
  const int row_hi = min(n, row_lo + slice_rows);
  float* out = part + (size_t)blockIdx.y * d * d;
  if (ti == tj)
    tile_body<TM, MODE, VEC, true>(x, mask, mean, d, ti, tj, row_lo, row_hi,
                                   out, sa, sb, la, lb, sm);
  else
    tile_body<TM, MODE, VEC, false>(x, mask, mean, d, ti, tj, row_lo, row_hi,
                                    out, sa, sb, la, lb, sm);
}

template <int TM, int VEC>
inline void launch_mode(int mode, dim3 grid, cudaStream_t st, const float* x,
                        const float* mask, const float* mean, int n, int d,
                        int m, int slice_rows, float* part) {
  if (mode == 0) {
    gram_simt_kernel<TM, 0, VEC><<<grid, THREADS, 0, st>>>(
        x, mask, mean, n, d, m, slice_rows, part);
  } else if (mode == 1) {
    gram_simt_kernel<TM, 1, VEC><<<grid, THREADS, 0, st>>>(
        x, mask, mean, n, d, m, slice_rows, part);
  } else {
    gram_simt_kernel<TM, 2, VEC><<<grid, THREADS, 0, st>>>(
        x, mask, mean, n, d, m, slice_rows, part);
  }
}

template <int TM>
inline void launch_tm(int mode, bool vec, dim3 grid, cudaStream_t st,
                      const float* x, const float* mask, const float* mean,
                      int n, int d, int m, int slice_rows, float* part) {
  if (vec)
    launch_mode<TM, 4>(mode, grid, st, x, mask, mean, n, d, m, slice_rows,
                       part);
  else
    launch_mode<TM, 1>(mode, grid, st, x, mask, mean, n, d, m, slice_rows,
                       part);
}

// The tile kernel over (tiles, slices) into `part` (slices, d, d); the
// caller sums the slices.  `tm` is 1, 2 or 4 (wider tables go to
// gram_wgmma.cuh), `m` tiles per side.  Returns cudaErrorInvalidValue
// for another tm.
inline int launch(const float* x, const float* mask, const float* mean,
                  int n, int d, int mode, int tm, int m, int slices,
                  int slice_rows, float* part, cudaStream_t st) {
  const dim3 grid(m * (m + 1) / 2, slices);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (tm) {
    case 1:
      launch_tm<1>(mode, vec, grid, st, x, mask, mean, n, d, m, slice_rows,
                   part);
      break;
    case 2:
      launch_tm<2>(mode, vec, grid, st, x, mask, mean, n, d, m, slice_rows,
                   part);
      break;
    case 4:
      launch_tm<4>(mode, vec, grid, st, x, mask, mean, n, d, m, slice_rows,
                   part);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace gram_simt
