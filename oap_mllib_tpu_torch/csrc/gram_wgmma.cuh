// Deterministic tensor-core Gram  G = Xc^T Xc  for Hopper (sm_90a): the
// route of pca_moments.cu (K2) at every tier for d >= 64.
//
// Xc is the (n, d) input, centered and masked in f32 (xc = (x -
// mean[col]) * mask[row]) before any bf16 rounding, as `_tile_moments`
// computes it.  Every tier splits each formed f32 value v into bf16
// parts, each the rounding of what the parts before it leave (every
// subtraction exact), and sums products of parts; a product of two bf16
// values is exact, the tensor core sums them in f32:
//   default (MODE 2): v0 alone, one product;
//   high (MODE 1):    v0 + v1; v0 v0, v0 v1 and v1 v0 in one accumulator;
//   highest (MODE 0): v = v0 + v1 + v2 exactly (v0 by truncation where
//                     rounding would pass bf16's largest finite value),
//                     and the six products whose parts sum to at most 2
//                     (a0 b0, a0 b1, a1 b0, a0 b2, a1 b1, a2 b0): the
//                     TPU's own HIGHEST scheme, as K1's highest
//                     (assign_wgmma.cuh).  The dropped products are
//                     ~2^-24 of the result.  The tensor core's f32
//                     accumulation errs at the scale of what it holds, so
//                     a0 b0 and the five small products (~2^-8 of it) go
//                     to two accumulators.
// Both operands are the same table, so one split serves A and B.
//
// Work split.  The (d, d) output is cut into 128 x 128 tiles, only
// tiles on and above the diagonal are computed (in gram_tile.cuh's
// tile_of order), and each block owns one tile over one fixed slice of
// rows; its tile (and the mirror image) goes into the slice's (d, d)
// partial, and gram::sum_slices_kernel sums the partials in slice
// order.  No float atomics: two launches give the same bits.  Inside a
// diagonal tile the tensor core's sums for (a, b) and (b, a) need not
// agree, so only the entries a <= b are written, each with its mirror:
// the result is bit-symmetric.
//
// A block is two warpgroups (256 threads); warpgroup w owns output rows
// [64 w, 64 w + 64) of the tile and issues wgmma.mma_async m64n128k16
// with the f32 accumulators in registers (64 a thread each).  The Gram
// sums over rows of x, so both operands are staged as rows x columns:
// A = Xc^T and B = Xc are MN-major, which bf16 wgmma takes through its
// transpose flags.  Per stage of BK = 32 rows:
//   1. cp.async brings the raw f32 rows of the tile's two column blocks
//      (one at a diagonal tile) and the rows' mask values into a ring of
//      four shared-memory stages, 16 bytes a copy where d is a multiple
//      of 4 (else 4), zero-filled past the slice and past d; the copies
//      run three stages ahead of the products.
//   2. Every thread forms 8 consecutive columns of the landed stage
//      (center, mask, split into the tier's parts) and stores them as
//      bf16 into the wgmma layout: per part and 64-column atom, BK rows
//      of 128 bytes with the 128-byte swizzle (16-byte chunk c of row r
//      at chunk c ^ (r % 8)), double-buffered so the products of one
//      stage run while the next one is formed.
//   3. fence.proxy.async, a block barrier, then each warpgroup issues
//      its products for the stage and lets them run while the block goes
//      on to the next stage (wgmma.wait_group 1).  The tensor core's f32
//      accumulation drifts with the number of products it folds: at the
//      high tier over 2^18 rows it passed the tier's 1e-4 (1.5e-4 on the
//      card), so at high and highest the accumulators restart every
//      PROMOTE stages and are added into a register total with IEEE f32
//      adds (at highest the small sum into the large one, then that into
//      the total).
// Descriptors (MN-major, 128-byte swizzle): start address >> 4; the
// leading byte offset is the stride between 64-column atoms (BK * 128
// bytes), the stride byte offset the stride between groups of 8 rows
// (1024 bytes); a k-step of 16 rows advances the start by 2048 bytes.
// Every atom starts on a 1024-byte boundary, so the base offset is 0.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s).
// At n = 2^20, d = 128 one read of x, 0.16 ms; the tensor work of the
// one 128 x 128 tile is below it at every tier (six products at highest,
// 0.10 ms at the peak).  At n = 2^18, d = 1024 the 36 tiles read x's
// column blocks 64 times over (8.6 GB, mostly from L2) against 0.28 ms
// of tensor work a product at the peak (1.67 ms at highest): the L2
// traffic of f32 operands staged per tile, and at highest the forming of
// three parts per element, are what the design leaves as its limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_simt.cuh"
#include "gram_tile.cuh"

namespace gram_wg {

constexpr int T = 128;        // output tile edge
constexpr int BK = 32;        // rows per stage
constexpr int STAGES = 4;     // f32 stages in flight
constexpr int PROMOTE = 4;    // high, highest: stages per tensor-core partial sum
constexpr int THREADS = 256;  // two warpgroups
constexpr int F32_OP = BK * T * 4;     // bytes of one operand's f32 stage
constexpr int ATOM = BK * 128;         // bytes of one 64-column bf16 atom
constexpr int BF_OP = 2 * ATOM;        // bytes of one bf16 operand
constexpr int KSTEP = 16 * 128;        // bytes of 16 rows of an atom

template <int MODE>
__host__ __device__ constexpr int parts() {  // bf16 parts of a formed value
  return MODE == 0 ? 3 : MODE == 1 ? 2 : 1;
}

template <int MODE>
__host__ __device__ constexpr int bf_ops() {  // A, B of part 0, then of part 1, ...
  return 2 * parts<MODE>();
}

template <int MODE>
__host__ __device__ constexpr int smem_bytes() {  // + 1024 to align the base by hand
  return 1024 + STAGES * (2 * F32_OP + 4 * BK) + 2 * bf_ops<MODE>() * BF_OP;
}
static_assert(smem_bytes<0>() <= 232448, "a block has at most 227 KB of shared memory");

__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(ATOM >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = A (64 x 16, bf16, MN-major) B (16 x 128, bf16,
// MN-major) + (add ? d : 0), both operands from shared memory.
__device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db,
                                    int add = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(add));
}

// The rows' mask values [r0, r0 + BK) into `sm` (zeros past row_hi).
__device__ __forceinline__ void load_mask(float* sm, const float* mask,
                                          int r0, int row_hi) {
  if (threadIdx.x < BK) {
    const int row = r0 + threadIdx.x;
    gram_simt::copy_async<1>(sm + threadIdx.x, row < row_hi ? mask + row : mask,
                             row < row_hi);
  }
}

// Raw f32 rows [r0, r0 + BK) of the column block at c0 into the stage at
// `s` ([BK][T] floats), zeros past row_hi and past d.
template <int VEC>
__device__ __forceinline__ void load_stage(float* s, const float* x, int d,
                                           int c0, int r0, int row_hi) {
  constexpr int CPR = T / VEC;
  constexpr int PASSES = BK * CPR / THREADS;
  const int cc = threadIdx.x % CPR;
  const int col = c0 + cc * VEC;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int rr = threadIdx.x / CPR + p * (THREADS / CPR);
    const int row = r0 + rr;
    const bool ok = col < d && row < row_hi;
    gram_simt::copy_async<VEC>(s + rr * T + cc * VEC,
                               ok ? x + (size_t)row * d + col : x, ok);
  }
}

// The leading bf16 parts of (a, b) at highest: each value's rounding,
// or its truncation (the top 16 bits, exact) where rounding would pass
// bf16's largest finite value, so the three parts hold every finite f32.
__device__ __forceinline__ __nv_bfloat162 lead_pair(float a, float b) {
  const float most = __uint_as_float(0x7F7F0000u);  // bf16's largest finite
  const float ta = __uint_as_float(__float_as_uint(a) & 0xFFFF0000u);
  const float tb = __uint_as_float(__float_as_uint(b) & 0xFFFF0000u);
  return __floats2bfloat162_rn(fabsf(a) <= most ? a : ta, fabsf(b) <= most ? b : tb);
}

// The landed stage `s` (rows' mask values at `sm`, or null for ones)
// formed into the bf16 operand at `dst`, part p at dst + 2 p BF_OP:
// this thread's 8 columns [8 cc, 8 cc + 8) of its BK / 16 rows.  Columns
// past d are staged as zeros and their means are 0, so they form zeros.
template <int MODE>
__device__ __forceinline__ void form_stage(const float* s, uint8_t* dst,
                                           const float (&mean)[8],
                                           const float* sm, int r0,
                                           int row_hi) {
  constexpr int PARTS = parts<MODE>();
  const int cc = threadIdx.x % 16;
  const int atom = cc >> 3, chunk = cc & 7;
#pragma unroll
  for (int p = 0; p < BK / 16; ++p) {
    const int rr = threadIdx.x / 16 + 16 * p;
    const int row = r0 + rr;
    const bool row_ok = row < row_hi;
    const float m = sm != nullptr ? sm[rr] : 1.f;
    const float4 v0 = *reinterpret_cast<const float4*>(s + rr * T + 8 * cc);
    const float4 v1 =
        *reinterpret_cast<const float4*>(s + rr * T + 8 * cc + 4);
    const float raw[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = 0.f;
      if (row_ok) {
        v[c] = __fsub_rn(raw[c], mean[c]);
        if (sm != nullptr) v[c] = __fmul_rn(v[c], m);
      }
    }
    // part q of the pair: the rounding of what parts 0..q-1 left
    uint32_t h[PARTS][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float a = v[2 * c], b = v[2 * c + 1];
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        const __nv_bfloat162 bq =
            MODE == 0 && q == 0 ? lead_pair(a, b) : __floats2bfloat162_rn(a, b);
        h[q][c] = *reinterpret_cast<const uint32_t*>(&bq);
        if (q + 1 < PARTS) {
          a = __fsub_rn(a, __low2float(bq));
          b = __fsub_rn(b, __high2float(bq));
        }
      }
    }
    const int off = atom * ATOM + rr * 128 + ((chunk ^ (rr & 7)) << 4);
#pragma unroll
    for (int q = 0; q < PARTS; ++q)
      *reinterpret_cast<uint4*>(dst + 2 * q * BF_OP + off) =
          make_uint4(h[q][0], h[q][1], h[q][2], h[q][3]);
  }
}

template <int MODE, int VEC>
__global__ void __launch_bounds__(THREADS, 1)
gram_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                  const float* __restrict__ mean, int n, int d, int m,
                  int slice_rows, float* __restrict__ part) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle works on shared-memory address bits: atoms start on 1024
  uint8_t* smem = smem_raw + ((1024 - (gram_simt::smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int BF_BUF = bf_ops<MODE>() * BF_OP;
  float* f32 = reinterpret_cast<float*>(smem);  // [STAGES][A, B][BK][T]
  uint8_t* bf = smem + STAGES * 2 * F32_OP;     // [2][part][A, B]
  float* msk = reinterpret_cast<float*>(bf + 2 * BF_BUF);  // [STAGES][BK]

  int ti, tj;
  gram::tile_of(blockIdx.x, m, ti, tj);
  const bool diag = ti == tj;
  const int row_lo = blockIdx.y * slice_rows;
  const int row_hi = min(n, row_lo + slice_rows);
  const int steps = (row_hi - row_lo + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  float mean_a[8], mean_b[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ca = ti * T + 8 * (threadIdx.x % 16) + c;
    const int cb = tj * T + 8 * (threadIdx.x % 16) + c;
    mean_a[c] = ca < d ? mean[ca] : 0.f;
    mean_b[c] = cb < d ? mean[cb] : 0.f;
  }

  // acc: the tensor core's running sum (at highest of a0 b0 alone; lo
  // sums the five small products).  At high and highest they restart
  // every PROMOTE stages and are added into tot with IEEE f32 adds: the
  // tensor core's own f32 accumulation drifts with the number of
  // products it folds (past the tier's 1e-4 over 2^18 rows), tot does not.
  constexpr int NLO = MODE == 0 ? 64 : 1, NTOT = MODE == 2 ? 1 : 64;
  float acc[64], lo[NLO], tot[NTOT];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NLO; ++i) lo[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NTOT; ++i) tot[i] = 0.f;

  auto load = [&](int t) {
    float* s = f32 + (t % STAGES) * 2 * (F32_OP / 4);
    const int r0 = row_lo + t * BK;
    load_stage<VEC>(s, x, d, ti * T, r0, row_hi);
    if (!diag) load_stage<VEC>(s + F32_OP / 4, x, d, tj * T, r0, row_hi);
    if (mask != nullptr) load_mask(msk + (t % STAGES) * BK, mask, r0, row_hi);
  };
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < steps) load(t);
    gram_simt::copy_commit();
  }

  for (int t = 0; t < steps; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // stage t landed; stage t - 1 formed; products t - 2 done
    if (t + STAGES - 1 < steps) load(t + STAGES - 1);
    gram_simt::copy_commit();

    const float* s = f32 + (t % STAGES) * 2 * (F32_OP / 4);
    const float* sm = mask != nullptr ? msk + (t % STAGES) * BK : nullptr;
    uint8_t* buf = bf + (t & 1) * BF_BUF;
    const int r0 = row_lo + t * BK;
    form_stage<MODE>(s, buf, mean_a, sm, r0, row_hi);
    if (!diag) form_stage<MODE>(s + F32_OP / 4, buf + BF_OP, mean_b, sm, r0, row_hi);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // part p of A at a0 + p PART, of B at b0 + p PART
    constexpr uint32_t PART = 2 * BF_OP;
    const uint32_t a0 = gram_simt::smem_addr(buf) + wg * ATOM;
    const uint32_t b0 = gram_simt::smem_addr(buf + (diag ? 0 : BF_OP));
    // high, highest: the first product into each accumulator of every
    // PROMOTE-th stage restarts it
    const int add = MODE != 2 ? (t % PROMOTE != 0) : 1;
    fence_acc(acc);
    if constexpr (MODE == 0) fence_acc(lo);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t k = ks * KSTEP;
      const uint64_t da = make_desc(a0 + k);
      const uint64_t db = make_desc(b0 + k);
      const int first = ks == 0 ? add : 1;
      mma(acc, da, db, first);
      if constexpr (MODE == 1) {
        mma(acc, da, make_desc(b0 + PART + k));
        mma(acc, make_desc(a0 + PART + k), db);
      } else if constexpr (MODE == 0) {
        const uint64_t da1 = make_desc(a0 + PART + k);
        const uint64_t db1 = make_desc(b0 + PART + k);
        mma(lo, da, db1, first);
        mma(lo, da1, db);
        mma(lo, da, make_desc(b0 + 2 * PART + k));
        mma(lo, da1, db1);
        mma(lo, make_desc(a0 + 2 * PART + k), db);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (MODE != 2 && (t % PROMOTE == PROMOTE - 1 || t == steps - 1)) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if constexpr (MODE == 0) {
        fence_acc(lo);
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] = __fadd_rn(tot[i], __fadd_rn(acc[i], lo[i]));
      } else if constexpr (MODE == 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
      }
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    }
    fence_acc(acc);
    if constexpr (MODE == 0) fence_acc(lo);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  if constexpr (MODE == 0) fence_acc(lo);

  // accumulator i of lane l in warp w: row 16 w + l / 4 + 8 ((i / 2) % 2),
  // column 8 (i / 4) + 2 (l % 4) + i % 2 of the warpgroup's 64 x 128
  float* out = part + (size_t)blockIdx.y * d * d;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int a = ti * T + 64 * wg + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
    const int b = tj * T + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const float v = MODE == 2 ? acc[i] : tot[i % NTOT];
    if (a < d && b < d && (!diag || a <= b)) {
      out[(size_t)a * d + b] = v;
      out[(size_t)b * d + a] = v;
    }
  }
}

template <int MODE, int VEC>
inline int launch_one(dim3 grid, cudaStream_t st, const float* x,
                      const float* mask, const float* mean, int n, int d,
                      int m, int slice_rows, float* part) {
  constexpr int bytes = smem_bytes<MODE>();
  // the shared-memory limit is a per-device attribute of the kernel: set
  // it once per device (the call costs far more than a launch)
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(done >> dev & 1ull)) {
    err = cudaFuncSetAttribute(gram_wgmma_kernel<MODE, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) done |= 1ull << dev;
  }
  gram_wgmma_kernel<MODE, VEC><<<grid, THREADS, bytes, st>>>(
      x, mask, mean, n, d, m, slice_rows, part);
  return 0;
}

// The tile kernel over (tiles, slices) into `part` (slices, d, d) at a
// tier (mode 0 highest, 1 high, 2 default); the caller sums the slices.
// `m` 128-wide tiles per side; slice_rows a multiple of BK.  Returns a
// cudaError_t (invalid value for another mode).
inline int launch(const float* x, const float* mask, const float* mean,
                  int n, int d, int mode, int m, int slices, int slice_rows,
                  float* part, cudaStream_t st) {
  const dim3 grid(m * (m + 1) / 2, slices);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (mode == 0)
    return vec ? launch_one<0, 4>(grid, st, x, mask, mean, n, d, m,
                                  slice_rows, part)
               : launch_one<0, 1>(grid, st, x, mask, mean, n, d, m,
                                  slice_rows, part);
  if (mode == 1)
    return vec ? launch_one<1, 4>(grid, st, x, mask, mean, n, d, m,
                                  slice_rows, part)
               : launch_one<1, 1>(grid, st, x, mask, mean, n, d, m,
                                  slice_rows, part);
  if (mode == 2)
    return vec ? launch_one<2, 4>(grid, st, x, mask, mean, n, d, m,
                                  slice_rows, part)
               : launch_one<2, 1>(grid, st, x, mask, mean, n, d, m,
                                  slice_rows, part);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gram_wg
