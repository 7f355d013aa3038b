// K1's assignment for rows wider than 256 features on Hopper's tensor
// cores (sm_90a): the nearest center of every row of x, for
// kmeans_accumulate.cu at d > 256, every tier.
//
// The same function as assign_wgmma.cuh (the d <= 256 route) and the
// plain version `_assign_plain`: loop mode ranks s_j = x.c_j - |c_j|^2 / 2
// (larger first), cost mode s_j = -max(|x|^2 + |c_j|^2 - 2 x.c_j, 0), ties
// to the lowest j, |c|^2 = +inf past k.  The cross term runs on wgmma:
//   high, default: x and c rounded to bf16, one product, f32 sums;
//   highest:       the exact three-part bf16 splits (x by truncation, c
//                  by rounding in assign_wg::prep_kernel) and the six
//                  products whose parts sum to at most 2, x0 c0 in an
//                  accumulator of its own and the five small products
//                  in a second, added once a score with an IEEE add
//                  (assign_wgmma.cuh says why: one accumulator broke the
//                  sharded loop's 1e-5 cost gate).
//
// Why another route.  The d <= 256 route forms each row's operand parts
// once a pass and keeps them for the whole pass (registers and shared
// memory), which bounds its depth.  This route streams the depth: an
// item is a block of BM = 128 rows and a group of center tiles; for
// each center tile it runs the depth in 64-deep chunks with the
// accumulators held across the whole depth, then scores the tile and
// folds it into the rows' running best.
//
// A stage (one 64-deep chunk of one center tile) is, per block:
//   1. cp.async copies of the rows' raw f32 values (16 bytes a copy where
//      d is a multiple of 4, else 4; zeros past n and d) and of the
//      prepared centers' chunk (assign_wg::prep_kernel's swizzled layout
//      in tiles of BN, one contiguous run), D stages ahead;
//   2. all 256 threads form the rows' bf16 parts from the raw values
//      into the A operand's layout (K-major, 128-byte rows, 16-byte chunk
//      c of row r at c ^ (r % 8)), as gram_wgmma.cuh forms K2's operands,
//      and in cost mode sum the rows' |x|^2 (first center tile of an item
//      only; a fixed order: a thread's 8 values a stage, stage after stage
//      in a register, then at the tile's last stage an xor tree over the
//      8 threads of a row);
//   3. fence.proxy.async and a block barrier, then each warpgroup (64 of
//      the 128 rows) issues wgmma.mma_async m64nBNk16 with both operands
//      from shared memory and lets them run while the block forms the
//      next stage (two formed buffers at the bf16 tiers; one at highest,
//      whose three parts of x and of the centers leave no room for two).
//
// Sharing x.  Every center tile reads a row block's x again.  At k = 1000
// and d = 960 the block's rows are 491 KB of f32: a block that walked all
// the tiles itself would find its rows gone from the 50 MB L2 by the
// next tile (132 SMs hold 65 MB of rows), and read x from device memory
// once a tile.  So the center tiles are cut into at most MAX_GROUPS
// groups and an item is (row block, group): the items of one row block
// are consecutive and run side by side on neighbouring blocks, so x
// comes from device memory once and from L2 for the other groups.  The
// blocks are persistent (one an SM, a grid a multiple of the groups), so
// the pipeline runs on across items without refilling.  Each item writes
// its rows' (best score, index) to a (groups, n) scratch; merge_kernel
// reduces the groups in order by (score desc, index asc) and writes the
// labels and, in cost mode, one cost partial per 128 rows.  No atomics:
// two launches give the same bits.
//
// What bounds it (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s, 50 MB L2).
// At n = 2^20, d = 960, k = 1000 the cross term is 2nkd = 2.01 TFLOP a
// product: 2.04 ms at the bf16 tiers, 12.2 ms at highest (six).  x is
// read once from device memory (4.03 GB, 1.20 ms); through L2 each item
// reads its rows' f32 values and its tiles' prepared centers: at the
// bf16 tiers (BN = 256, four groups) 16 GB of rows and 15.7 GB of
// centers, at highest (BN = 128, eight groups) 32 GB and 47 GB.  A stage
// at the bf16 tiers asks 64 KB of L2 for 0.56 us of tensor work at the
// SM's share of the peak: the L2, not the tensor cores, is what the
// design leaves as the limit there; highest asks 80 KB for 1.7 us.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

#include "assign_wgmma.cuh"

namespace assign_wide {

using assign_wg::better;
using assign_wg::fence_regs;
using assign_wg::make_desc;
using assign_wg::pack;
using assign_wg::pack_exact;
using assign_wg::smem_addr;
using assign_wg::trunc_bf16;

constexpr int BM = 128;          // rows an item: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int CHUNK = 64;        // depth a stage: one 128-byte bf16 row
constexpr int MAX_GROUPS = 8;    // center-tile groups: the items of a row block
constexpr int MIN_D = assign_wg::MAX_D + 1;

template <int PARTS>
struct Cfg {
  static constexpr int BN = PARTS == 3 ? 128 : 256;  // centers a tile
  static constexpr int D = PARTS == 3 ? 1 : 2;       // stages loaded ahead
  static constexpr int NA = PARTS == 3 ? 1 : 2;      // formed-row buffers
  static constexpr int SC = D + NA;                  // center stages
  static constexpr int SX = D;                       // raw-row stages
  static constexpr int X_BYTES = BM * CHUNK * 4;
  static constexpr int C_BYTES = PARTS * BN * 128;
  static constexpr int A_BYTES = PARTS * BM * 128;
  static constexpr int ACC = BN / 2;  // f32 accumulators a thread
};

// Dynamic shared memory of a block: alignment slack, the center stages,
// the formed rows, the raw rows and the rows' |x|^2.
template <int PARTS>
__host__ __device__ constexpr int smem_bytes() {
  using C = Cfg<PARTS>;
  return 1024 + C::SC * C::C_BYTES + C::NA * C::A_BYTES + C::SX * C::X_BYTES + BM * 4;
}

// Center tiles of a group: the tiles cut into at most MAX_GROUPS groups
// of equal size (the last one shorter).
__host__ __device__ constexpr int tiles_per_group(int tiles) {
  return (tiles + MAX_GROUPS - 1) / MAX_GROUPS;
}
__host__ __device__ constexpr int groups_of(int tiles) {
  return (tiles + tiles_per_group(tiles) - 1) / tiles_per_group(tiles);
}

// d (64 x 128, f32) += A (64 x 16) B (128 x 16), both bf16, K-major with the
// 128-byte swizzle in shared memory; `add` 0 overwrites d instead.
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int add) {
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
      "}, %64, %65, p, 1, 1, 0, 0;\n"
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

// d (64 x 256, f32) += A (64 x 16) B (256 x 16), both bf16, K-major with the
// 128-byte swizzle in shared memory; `add` 0 overwrites d instead.
__device__ __forceinline__ void mma_ss_n256(float (&d)[128], uint64_t da, uint64_t db, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(add));
}

__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da, uint64_t db, int add) {
  mma_ss_n128(d, da, db, add);
}
__device__ __forceinline__ void mma_ss(float (&d)[128], uint64_t da, uint64_t db, int add) {
  mma_ss_n256(d, da, db, add);
}

template <int VEC>
__device__ __forceinline__ void copy_f32(float* dst, const float* src, bool valid) {
  const int bytes = valid ? 4 * VEC : 0;
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Where a block is in its walk: item (row block, group), center tile,
// depth chunk.  Items go blockIdx.x, + gridDim.x, ...; an item walks its
// group's tiles, a tile its chunks.
struct Cursor {
  int item, tile, q;
};

struct Walk {
  int items, groups, per_group, tiles, nq;
  __device__ int first_tile(int item) const { return (item % groups) * per_group; }
  __device__ int end_tile(int item) const { return min(tiles, first_tile(item) + per_group); }
  __device__ Cursor start() const {
    return Cursor{(int)blockIdx.x, first_tile(blockIdx.x), 0};
  }
  __device__ bool valid(const Cursor& c) const { return c.item < items; }
  __device__ void next_tile(Cursor& c) const {
    c.q = 0;
    if (++c.tile < end_tile(c.item)) return;
    c.item += gridDim.x;
    c.tile = first_tile(c.item);
  }
  __device__ void advance(Cursor& c) const {
    if (++c.q < nq) return;
    next_tile(c);
  }
};

template <int PARTS, bool NEED_COST, int VEC>
__global__ void __launch_bounds__(THREADS, 1)
assign_wide_kernel(const float* __restrict__ x, const uint8_t* __restrict__ prep,
                   const float* __restrict__ csq, int n, int d, Walk walk,
                   float* __restrict__ part_s, int* __restrict__ part_i) {
  using C = Cfg<PARTS>;
  constexpr int BN = C::BN, ACC = C::ACC, D = C::D, NA = C::NA, SC = C::SC, SX = C::SX;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle works on shared-memory address bits: operands start on 1024
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* cring = smem;                        // [SC] prepared center chunks
  uint8_t* abuf = cring + SC * C::C_BYTES;      // [NA][PARTS][BM rows][128 B]
  float* xring = reinterpret_cast<float*>(abuf + NA * C::A_BYTES);  // [SX][BM][CHUNK]
  float* xsq_s = xring + SX * BM * CHUNK;       // [BM]

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r_lo = 64 * wg + 16 * warp + g;  // this thread's rows: r_lo, r_lo + 8

  // a stage's copies: the rows of the cursor's item at its chunk, and
  // the chunk of its center tile, into stage buffer s
  auto load = [&](const Cursor& cu, int s) {
    const int row0 = (cu.item / walk.groups) * BM, k0 = cu.q * CHUNK;
    float* xs = xring + (s % SX) * BM * CHUNK;
    constexpr int PER_ROW = CHUNK / VEC;
#pragma unroll
    for (int e = tid; e < BM * PER_ROW; e += THREADS) {
      const int r = e / PER_ROW, cc = (e % PER_ROW) * VEC;
      const int row = row0 + r, col = k0 + cc;
      const bool ok = row < n && col < d;
      copy_f32<VEC>(xs + r * CHUNK + cc, ok ? x + (size_t)row * d + col : x, ok);
    }
    const uint8_t* src = prep + ((long long)cu.tile * walk.nq + cu.q) * C::C_BYTES;
    uint8_t* dst = cring + (s % SC) * C::C_BYTES;
#pragma unroll
    for (int e = tid; e < C::C_BYTES / 16; e += THREADS) copy_16(dst + 16 * e, src + 16 * e);
  };

  Cursor ld = walk.start(), cm = walk.start();
#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (walk.valid(ld)) {
      load(ld, s);
      walk.advance(ld);
    }
    copy_commit();
  }

  float best[2] = {-CUDART_INF_F, -CUDART_INF_F};
  int bidx[2] = {0, 0};
  // highest keeps x0 c0 in acc and the five smaller products in lo
  float acc[ACC], lo[PARTS == 3 ? ACC : 1];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (PARTS == 3 ? ACC : 1); ++i) lo[i] = 0.f;

  // stage t = the block's running stage count; a tile's chunks run in
  // the inner loop, its scores after it (nothing reads the accumulators
  // while products are in flight)
  int t = 0;
  for (; walk.valid(cm); walk.next_tile(cm)) {
    const bool first_tile = cm.tile == walk.first_tile(cm.item);
    // cost mode, first tile: this thread's running sums of squares of its
    // units' values, chunk after chunk (its units are the same rows and
    // 16-byte chunks at every stage)
    float sq[BM * 8 / THREADS] = {};
    for (int q = 0; q < walk.nq; ++q, ++t) {
      // stage t's copies landed (D - 1 later stages may still fly) and,
      // in every thread, the products of stage t - NA are done
      asm volatile("cp.async.wait_group %0;\n" ::"n"(D - 1) : "memory");
      __syncthreads();

      // form stage t's rows into A buffer t % NA: thread unit u is row
      // u / 8, 16-byte chunk u % 8 (8 values) of the stage
      const float* xs = xring + (t % SX) * BM * CHUNK;
      uint8_t* a = abuf + (t % NA) * C::A_BYTES;
#pragma unroll
      for (int i = 0; i < BM * 8 / THREADS; ++i) {
        const int u = tid + i * THREADS, r = u >> 3, ch = u & 7;
        const float4 v0 = *reinterpret_cast<const float4*>(xs + r * CHUNK + 8 * ch);
        const float4 v1 = *reinterpret_cast<const float4*>(xs + r * CHUNK + 8 * ch + 4);
        const float f[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        if (NEED_COST && first_tile) {
#pragma unroll
          for (int e = 0; e < 8; ++e) sq[i] = fmaf(f[e], f[e], sq[i]);
          if (q == walk.nq - 1) {
            // the row's |x|^2: an xor tree over its 8 threads, once a tile
            float v = __fadd_rn(sq[i], __shfl_xor_sync(0xffffffffu, sq[i], 1));
            v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
            v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
            if (ch == 0) xsq_s[r] = v;
          }
        }
        const int off = r * 128 + ((ch ^ (r & 7)) << 4);
        if constexpr (PARTS == 1) {
          *reinterpret_cast<uint4*>(a + off) = make_uint4(
              pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]), pack(f[6], f[7]));
        } else {
          uint32_t h[3][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p0[2], p1[2], p2[2];
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              p0[v] = trunc_bf16(f[2 * e + v]);
              const float rest = __fsub_rn(f[2 * e + v], p0[v]);
              p1[v] = trunc_bf16(rest);
              p2[v] = __fsub_rn(rest, p1[v]);
            }
            h[0][e] = pack_exact(p0[0], p0[1]);
            h[1][e] = pack_exact(p1[0], p1[1]);
            h[2][e] = pack_exact(p2[0], p2[1]);
          }
#pragma unroll
          for (int p = 0; p < 3; ++p)
            *reinterpret_cast<uint4*>(a + p * BM * 128 + off) =
                make_uint4(h[p][0], h[p][1], h[p][2], h[p][3]);
        }
      }
      // the formed rows and the copied centers, written through the
      // generic proxy, are read by wgmma through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();

      // stage t + D into the buffers of stages t (raw rows: formed) and
      // t + D - SC = t - NA (centers: its products are done)
      if (walk.valid(ld)) {
        load(ld, t + D);
        walk.advance(ld);
      }
      copy_commit();

      // the products of stage t: acc (and lo) restart at a tile's first
      // chunk
      const uint32_t a0 = smem_addr(a) + wg * 64 * 128;
      const uint32_t b0 = smem_addr(cring + (t % SC) * C::C_BYTES);
      const int keep = q != 0;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t ak = a0 + 32 * ks, bk = b0 + 32 * ks;
        if constexpr (PARTS == 3) {
          constexpr int AP = BM * 128, BP = BN * 128;  // bytes of a part
          // the six products whose parts sum to at most 2
          mma_ss(acc, make_desc(ak), make_desc(bk), ks == 0 ? keep : 1);
          mma_ss(lo, make_desc(ak), make_desc(bk + BP), ks == 0 ? keep : 1);
          mma_ss(lo, make_desc(ak + AP), make_desc(bk), 1);
          mma_ss(lo, make_desc(ak), make_desc(bk + 2 * BP), 1);
          mma_ss(lo, make_desc(ak + AP), make_desc(bk + BP), 1);
          mma_ss(lo, make_desc(ak + 2 * AP), make_desc(bk), 1);
        } else {
          mma_ss(acc, make_desc(ak), make_desc(bk), ks == 0 ? keep : 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the products run on while the block forms the next stage
      if constexpr (NA == 2)
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      else
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    fence_regs(lo);

    // the tile's scores.  Accumulator i: row r_lo + 8 ((i / 2) % 2),
    // column 8 (i / 4) + 2 tq + i % 2 of the tile; a thread's columns
    // rise with i, so a strict > keeps the tile's lowest index, and the
    // tile's best merges into the running best by (score desc, index
    // asc).  Centers past k have |c|^2 = +inf: they score -inf and never
    // win.
    float xsq[2] = {0.f, 0.f};
    if (NEED_COST) {
      xsq[0] = xsq_s[r_lo];
      xsq[1] = xsq_s[r_lo + 8];
    }
    float tb[2] = {-CUDART_INF_F, -CUDART_INF_F};
    int tbi[2] = {INT_MAX, INT_MAX};
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int col = cm.tile * BN + 8 * (i >> 2) + 2 * tq + (i & 1);
      const int h = (i >> 1) & 1;
      const float cs = __ldg(csq + col);
      const float v = PARTS == 3 ? __fadd_rn(acc[i], lo[i % (PARTS == 3 ? ACC : 1)]) : acc[i];
      float sc;
      if (NEED_COST) {
        const float d2 = __fsub_rn(__fadd_rn(xsq[h], cs), __fmul_rn(2.f, v));
        sc = -fmaxf(d2, 0.f);
      } else {
        sc = __fsub_rn(v, __fmul_rn(0.5f, cs));
      }
      if (sc > tb[h]) {
        tb[h] = sc;
        tbi[h] = col;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (better(tb[h], tbi[h], best[h], bidx[h])) {
        best[h] = tb[h];
        bidx[h] = tbi[h];
      }

    if (cm.tile == walk.end_tile(cm.item) - 1) {
      // the item's end: the four threads of a row reduce by (score desc,
      // index asc), and the row's best of this group goes to the scratch
      const int row0 = (cm.item / walk.groups) * BM, grp = cm.item % walk.groups;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float os = __shfl_xor_sync(0xffffffffu, best[h], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bidx[h], off);
          if (better(os, oi, best[h], bidx[h])) {
            best[h] = os;
            bidx[h] = oi;
          }
        }
        const int row = row0 + r_lo + 8 * h;
        if (tq == 0 && row < n) {
          part_s[(size_t)grp * n + row] = best[h];
          part_i[(size_t)grp * n + row] = bidx[h];
        }
        best[h] = -CUDART_INF_F;
        bidx[h] = 0;
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The groups' bests of every row reduced in group order by (score desc,
// index asc): the label, and in cost mode w * min d2 summed over each
// block of BM rows in row order, one partial a block.
__global__ void __launch_bounds__(BM)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i, int groups,
             int n, const float* __restrict__ w, int need_cost, int* __restrict__ labels,
             float* __restrict__ cost_part) {
  __shared__ float rowcost_s[BM];
  const int row = blockIdx.x * BM + threadIdx.x;
  float bs = -CUDART_INF_F;
  int bi = 0;
  if (row < n) {
    for (int g = 0; g < groups; ++g) {
      const float s = part_s[(size_t)g * n + row];
      const int i = part_i[(size_t)g * n + row];
      if (better(s, i, bs, bi)) {
        bs = s;
        bi = i;
      }
    }
    labels[row] = bi;
  }
  if (!need_cost) return;
  rowcost_s[threadIdx.x] = row < n ? __fmul_rn(-bs, w[row]) : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s = __fadd_rn(s, rowcost_s[r]);
    cost_part[blockIdx.x] = s;
  }
}

// Bytes of the route's scratch at a tier: the prepared centers in tiles
// of BN, then the (groups, n) best scores and indices.
template <int PARTS>
inline long long prep_bytes(int k, int d) {
  const int dpad = (d + CHUNK - 1) / CHUNK * CHUNK;
  return assign_wg::prep_bytes<PARTS, Cfg<PARTS>::BN>(k, dpad);
}

template <int PARTS>
inline int groups(int k) {
  return groups_of((k + Cfg<PARTS>::BN - 1) / Cfg<PARTS>::BN);
}

// Streaming multiprocessors of a device (cached: the query costs more
// than a launch).
inline int sm_count(int dev) {
  static int counts[64] = {0};
  if (dev >= 0 && dev < 64 && counts[dev] > 0) return counts[dev];
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || v < 1)
    v = 1;
  if (dev >= 0 && dev < 64) counts[dev] = v;
  return v;
}

template <int PARTS, bool NEED_COST, int VEC>
inline cudaError_t launch_one(int dev, int grid, cudaStream_t st, const float* x,
                              const uint8_t* prep, const float* csq, int n, int d,
                              const Walk& walk, float* part_s, int* part_i) {
  // the shared-memory limit is a per-device attribute of the kernel: set
  // it once per device
  static unsigned long long done = 0;
  if (dev >= 64 || !(done >> dev & 1ull)) {
    const cudaError_t err =
        cudaFuncSetAttribute(assign_wide_kernel<PARTS, NEED_COST, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<PARTS>());
    if (err != cudaSuccess) return err;
    if (dev < 64) done |= 1ull << dev;
  }
  assign_wide_kernel<PARTS, NEED_COST, VEC><<<grid, THREADS, smem_bytes<PARTS>(), st>>>(
      x, prep, csq, n, d, walk, part_s, part_i);
  return cudaSuccess;
}

template <int PARTS>
inline cudaError_t run(int dev, cudaStream_t st, bool need_cost, const float* x,
                       const float* w, const float* c, const float* csq, int n, int d, int k,
                       uint8_t* scratch, int* labels, float* cost_part) {
  constexpr int BN = Cfg<PARTS>::BN;
  const int dpad = (d + CHUNK - 1) / CHUNK * CHUNK;
  const int tiles = (k + BN - 1) / BN;
  const long long chunks = (long long)tiles * BN * (dpad / 8);
  assign_wg::prep_kernel<PARTS, BN>
      <<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(c, k, d, dpad, scratch);
  float* part_s = reinterpret_cast<float*>(scratch + prep_bytes<PARTS>(k, d));
  Walk walk;
  walk.tiles = tiles;
  walk.per_group = tiles_per_group(tiles);
  walk.groups = groups_of(tiles);
  walk.nq = dpad / CHUNK;
  int* part_i = reinterpret_cast<int*>(part_s + (size_t)walk.groups * n);
  const int row_blocks = (n + BM - 1) / BM;
  walk.items = row_blocks * walk.groups;
  // one persistent block an SM, a multiple of the groups so that the
  // items of a row block run side by side
  const int sms = sm_count(dev);
  int grid = sms >= walk.groups ? sms / walk.groups * walk.groups : sms;
  grid = grid < walk.items ? grid : walk.items;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err;
  if (need_cost)
    err = vec ? launch_one<PARTS, true, 4>(dev, grid, st, x, scratch, csq, n, d, walk, part_s, part_i)
              : launch_one<PARTS, true, 1>(dev, grid, st, x, scratch, csq, n, d, walk, part_s, part_i);
  else
    err = vec ? launch_one<PARTS, false, 4>(dev, grid, st, x, scratch, csq, n, d, walk, part_s, part_i)
              : launch_one<PARTS, false, 1>(dev, grid, st, x, scratch, csq, n, d, walk, part_s, part_i);
  if (err != cudaSuccess) return err;
  merge_kernel<<<row_blocks, BM, 0, st>>>(part_s, part_i, walk.groups, n, w, need_cost ? 1 : 0,
                                          labels, cost_part);
  return cudaSuccess;
}

// Prepare the centers and assign every row at a tier (mode 0 highest:
// three parts; 1, 2: one); `scratch` holds scratch_bytes(mode, n, d, k)
// and `cost_part` one float per BM rows.  Refuses d <= 256 (the wgmma
// route's) with an invalid value.
inline cudaError_t launch(int dev, cudaStream_t st, int mode, bool need_cost, const float* x,
                          const float* w, const float* c, const float* csq, int n, int d,
                          int k, uint8_t* scratch, int* labels, float* cost_part) {
  if (d < MIN_D) return cudaErrorInvalidValue;
  if (mode == 0)
    return run<3>(dev, st, need_cost, x, w, c, csq, n, d, k, scratch, labels, cost_part);
  return run<1>(dev, st, need_cost, x, w, c, csq, n, d, k, scratch, labels, cost_part);
}

// Bytes of `scratch` at a tier, or -1 where the route does not take d.
inline long long scratch_bytes(int mode, int n, int d, int k) {
  if (d < MIN_D) return -1;
  if (mode == 0) return prep_bytes<3>(k, d) + (long long)groups<3>(k) * n * 8;
  return prep_bytes<1>(k, d) + (long long)groups<1>(k) * n * 8;
}

}  // namespace assign_wide
