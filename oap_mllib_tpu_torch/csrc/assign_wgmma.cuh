// The Lloyd assignment on Hopper's tensor cores (sm_90a): the nearest
// center of every row of x, for kmeans_accumulate.cu (K1) at d <= 256.
//
// Per row, loop mode ranks s_j = x.c_j - |c_j|^2 / 2 (larger first),
// cost mode s_j = -max(|x|^2 + |c_j|^2 - 2 x.c_j, 0); ties go to the
// lowest j.  The cross term x.c runs on wgmma at every tier:
//   high, default: x and c rounded to bf16, one product, f32 sums
//                  (exactly the tiers' arithmetic: a product of two bf16
//                  values is exact in f32);
//   highest:       x = x0 + x1 + x2 and c = c0 + c1 + c2, each part bf16
//                  and the split exact (x by truncation: x0 = the top 16
//                  bits of x, x1 those of x - x0, x2 = x - x0 - x1; c by
//                  rounding in prep_kernel), and the six products whose
//                  parts sum to at most 2 (x0c0, x0c1, x1c0, x0c2, x1c1,
//                  x2c0): the TPU's own HIGHEST scheme.  The dropped
//                  products are ~2^-24 of x.c.  The tensor core's f32
//                  accumulation errs at the scale of what it holds, so
//                  x0c0 (d / 16 products) and the five small products
//                  (~2^-8 of it) go to two accumulators, added once per
//                  score with an IEEE add: folding all six into one put
//                  the fit's cost 2.65e-5 from the cuBLAS loop's (the
//                  sharded loop's 1e-5 gate).
// Why bf16 x 3 and not 3xTF32 (big = tf32(a), small = tf32(a - big), three
// products): both cost 3.25 ms at the main shape at the data-sheet peaks
// (6 x 2nkd / 989e12, 3 x 2nkd / 495e12), but the bf16 split keeps all 24
// bits of each operand against ~22, and it runs the bf16 tiers' operand
// path and instruction, so one kernel serves every tier.
//
// Work split.  A block owns BM = 128 rows: two consumer warpgroups, each
// 64 rows, run wgmma.mma_async m64nBNk16 with A (its x rows) from
// registers and B (a center tile) from shared memory; one producer warp
// streams the center tiles.
//   - Each consumer thread forms its A fragments once for the whole pass
//     (rows g and g + 8 of its warp's 16, columns 2t, 2t + 1, 2t + 8,
//     2t + 9 of every k-step, straight from device memory): the first
//     part stays in registers (64 at d = 256), highest's x1 and x2 go to
//     shared memory in fragment order (16 bytes a thread and k-step, one
//     128-bit load each, no bank conflict).  Forming them per center tile
//     from an f32 tile in shared memory cost more than the products.
//   - The centers are prepared once a pass by prep_kernel: split into
//     PARTS bf16 parts, zero-padded to whole tiles (BN centers, 64-deep
//     chunks), each 128-byte row swizzled (16-byte chunk c of row r at c
//     ^ (r % 8)) and laid out stage by stage ([tile][chunk][part][row]),
//     so a stage is one contiguous TMA bulk copy.  The producer fills a
//     ring of STAGES buffers; a `full` mbarrier per buffer says a stage
//     landed, an `empty` one that both warpgroups' products that read it
//     are done (each warpgroup keeps one stage's products in flight).  No
//     block-wide barrier in the loop: the warpgroups run apart.
//   - Descriptors (K-major, 128-byte swizzle): start address >> 4, the
//     stride byte offset 1024 (eight 128-byte rows), a k-step of 16
//     values advances the start by 32 bytes; every part starts on 1024.
//   - After a tile's last chunk the epilogue turns the accumulators into
//     scores with the __f*_rn forms of the SIMT route.  A thread's
//     columns rise with the register index, so a strict > keeps the
//     tile's lowest index; tiles merge by (score desc, index asc), so they
//     may come in any order: block b starts at tile b % tiles, spreading
//     the SMs' reads over the centers.  |c|^2 is +inf past k, so padded
//     centers never win.  At the end the four threads of a row reduce by
//     the same order.
//
// What bounds it (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s, 50 MB L2).
// At n = 2^20, d = 256, k = 1000 the tensor work is 2nkd = 0.54 TFLOP a
// product: 0.54 ms at the bf16 tiers, 3.25 ms at highest (six).  Every
// block reads every prepared center from L2: k d 2 PARTS bytes (0.5 MB,
// 1.5 MB at highest) for BM = 128 rows, so 4.2 GB (12.6 GB) a pass.  x is
// read once (1 GB, 0.32 ms of HBM), but a block's fragments are formed
// before its first product and not overlapped with another block's
// products (one block per SM).  BM = 128 is what highest's x1 and x2
// (128 KB at d = 256) leave room for beside its four 24 KB stages.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

namespace assign_wg {

constexpr int BM = 128;         // rows per block
constexpr int CONSUMERS = 256;  // two warpgroups: the products and scores
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp: the copies
constexpr int CHUNK = 64;     // depth per stage: one 128-byte bf16 row
constexpr int MAX_D = 256;    // the fragments' depth bound (registers, shared memory)
constexpr int MAX_KS = MAX_D / 16;  // k-steps of the deepest row
constexpr int MAX_DQ = MAX_D / CHUNK;

template <int PARTS>
struct Cfg {
  static constexpr int BN = PARTS == 3 ? 64 : 128;  // centers per tile
  static constexpr int STAGES = PARTS == 3 ? 4 : 8;
  static constexpr int PART_BYTES = BN * 128;
  static constexpr int STAGE_BYTES = PARTS * PART_BYTES;
  static constexpr int ACC = BN / 2;  // f32 accumulators a thread
};

// Dynamic shared memory of one block at depth dpad (a multiple of 64):
// alignment slack, the stage ring, the x parts past the first (bf16, in
// fragment order) and the row costs.
template <int PARTS>
__host__ __device__ constexpr int smem_bytes(int dpad) {
  return 1024 + Cfg<PARTS>::STAGES * Cfg<PARTS>::STAGE_BYTES + (PARTS - 1) * BM * dpad * 2 +
         BM * 4 + 2 * Cfg<PARTS>::STAGES * 8;
}

// Bytes of the prepared centers: whole tiles, whole chunks, PARTS parts.
template <int PARTS>
__host__ __device__ constexpr long long prep_bytes(int k, int dpad) {
  return (long long)((k + Cfg<PARTS>::BN - 1) / Cfg<PARTS>::BN) *
         (dpad / CHUNK) * Cfg<PARTS>::STAGE_BYTES;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// One arrival that also expects `bytes` of bulk copies in this phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// `bytes` from global `src` to shared `dst` by the TMA unit, completing
// on the barrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// K-major, 128-byte swizzle: start >> 4, leading offset 1 (unused),
// stride offset 1024 >> 4, layout type 1 (128B) in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) += A (64 x 16, bf16, registers) B (64 x 16, bf16,
// K-major in shared memory); `add` 0 overwrites d instead.
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t db, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

// d (64 x 128, f32) += A (64 x 16, bf16, registers) B (128 x 16, bf16,
// K-major in shared memory); `add` 0 overwrites d instead.
__device__ __forceinline__ void mma_n128(float (&d)[64], const uint32_t (&a)[4],
                                        uint64_t db, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                    int add) {
  mma_n64(d, a, db, add);
}

__device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                    int add) {
  mma_n128(d, a, db, add);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two bf16-exact f32 values (low 16 bits zero) as one bf16x2 register.
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// v's leading bf16 part by truncation (the top 16 bits), exact to take
// away: three such parts hold all 24 bits of an f32 value, so x = x0 +
// x1 + x2 exactly.
__device__ __forceinline__ float trunc_bf16(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

// v into PARTS bf16 parts (as f32 values): p0 = bf16(v), p1 = bf16(v -
// p0), p2 = bf16(v - p0 - p1); each subtraction is exact.
template <int PARTS>
__device__ __forceinline__ void split(float v, float (&p)[PARTS]) {
  float r = v;
#pragma unroll
  for (int i = 0; i < PARTS; ++i) {
    p[i] = __bfloat162float(__float2bfloat16_rn(r));
    r = __fsub_rn(r, p[i]);
  }
}

// (score, index) order: larger score first, then the lower index.
__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// The centers (k, d) into their operand form at `prep` (prep_bytes) and
// nothing else: one thread per 16-byte chunk (8 values) of a padded
// center row and part.  Rows past k and columns past d are zeros.
template <int PARTS>
__global__ void prep_kernel(const float* __restrict__ c, int k, int d, int dpad,
                            uint8_t* __restrict__ prep) {
  using C = Cfg<PARTS>;
  const int per_row = dpad / 8;
  const long long rows = (long long)((k + C::BN - 1) / C::BN) * C::BN;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * per_row) return;
  const int j = (int)(i / per_row), c8 = (int)(i % per_row);
  const int q = c8 / 8, ch = c8 % 8;
  const int tile = j / C::BN, r = j % C::BN;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int col = 8 * c8 + e;
    v[e] = j < k && col < d ? c[(size_t)j * d + col] : 0.f;
  }
  uint32_t h[PARTS][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float a[PARTS], b[PARTS];
    split<PARTS>(v[2 * e], a);
    split<PARTS>(v[2 * e + 1], b);
#pragma unroll
    for (int p = 0; p < PARTS; ++p) h[p][e] = pack(a[p], b[p]);
  }
  const long long stage = (long long)tile * (dpad / CHUNK) + q;
#pragma unroll
  for (int p = 0; p < PARTS; ++p) {
    uint8_t* dst = prep + stage * C::STAGE_BYTES + p * C::PART_BYTES + r * 128 +
                   ((ch ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(dst) = make_uint4(h[p][0], h[p][1], h[p][2], h[p][3]);
  }
}

template <int PARTS, bool NEED_COST>
__global__ void __launch_bounds__(THREADS, 1)
assign_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const uint8_t* __restrict__ prep, const float* __restrict__ csq,
                    int n, int d, int k, int dpad, int vec, int* __restrict__ labels,
                    float* __restrict__ cost_part) {
  using C = Cfg<PARTS>;
  constexpr int BN = C::BN, ACC = C::ACC, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle works on shared-memory address bits: stages start on 1024
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  const int ks_total = dpad / 16;
  // x1 and x2 (highest): [part][warp of the block][k-step][lane] 16 bytes
  uint8_t* xpart = smem + STAGES * C::STAGE_BYTES;
  float* rowcost_s = reinterpret_cast<float*>(xpart + (PARTS - 1) * BM * dpad * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(rowcost_s + BM);  // a stage landed
  uint64_t* empty = full + STAGES;  // both warpgroups' products read it

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.x * BM;
  const int r_lo = 64 * wg + 16 * warp + g;  // this thread's rows: r_lo, r_lo + 8
  const int dq = dpad / CHUNK;
  const int tiles = (k + BN - 1) / BN;
  const int steps = tiles * dq;
  // every block reads every center tile; blocks start at different
  // tiles so that the SMs do not all read the same lines of L2 at once
  const int first = blockIdx.x % tiles;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer: stage s into buffer s % STAGES once both warpgroups
    // are done with the stage that held it
    if (tid == CONSUMERS) {
      for (int s = 0; s < steps; ++s) {
        const int b = s % STAGES;
        if (s >= STAGES) mbar_wait(&empty[b], (s / STAGES - 1) & 1);
        const int tile = (first + s / dq) % tiles;
        mbar_expect(&full[b], C::STAGE_BYTES);
        bulk_copy(ring + b * C::STAGE_BYTES,
                  prep + ((long long)tile * dq + s % dq) * C::STAGE_BYTES, C::STAGE_BYTES,
                  &full[b]);
      }
    }
    return;
  }

  // This thread's A fragments, formed once for the whole pass: rows r_lo
  // (registers 0, 2) and r_lo + 8 (1, 3), columns 2 tq, 2 tq + 1 (0, 1)
  // and 2 tq + 8, 2 tq + 9 (2, 3) of every k-step.  The first part stays
  // in registers; highest's x1 and x2 go to shared memory, each thread's
  // 16 bytes of a k-step beside its lane's.
  uint32_t a0[MAX_KS][4];
  float xsq[2] = {0.f, 0.f};
  const int rows[2] = {row0 + r_lo, row0 + r_lo + 8};
  uint8_t* xmine = xpart + ((wg * 4 + warp) * ks_total * 32 + lane) * 16;
#pragma unroll
  for (int kk = 0; kk < MAX_KS; ++kk) {
    if (kk < ks_total) {
      float f[8];  // (row, column) pairs in register order
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e & 1], col = 16 * kk + 2 * tq + 8 * (e >> 1);
        const bool ok = row < n;
        const float* src = x + (size_t)row * d + col;
        if (vec && ok && col + 1 < d) {
          const float2 v = *reinterpret_cast<const float2*>(src);
          f[2 * e] = v.x;
          f[2 * e + 1] = v.y;
        } else {
          f[2 * e] = ok && col < d ? src[0] : 0.f;
          f[2 * e + 1] = ok && col + 1 < d ? src[1] : 0.f;
        }
        if (NEED_COST) {
          xsq[e & 1] = fmaf(f[2 * e], f[2 * e], xsq[e & 1]);
          xsq[e & 1] = fmaf(f[2 * e + 1], f[2 * e + 1], xsq[e & 1]);
        }
      }
      if constexpr (PARTS == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a0[kk][e] = pack(f[2 * e], f[2 * e + 1]);
      } else {
        uint32_t a1[4], a2[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p0[2], p1[2], p2[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            p0[u] = trunc_bf16(f[2 * e + u]);
            const float r = __fsub_rn(f[2 * e + u], p0[u]);
            p1[u] = trunc_bf16(r);
            p2[u] = __fsub_rn(r, p1[u]);
          }
          a0[kk][e] = pack_exact(p0[0], p0[1]);
          a1[e] = pack_exact(p1[0], p1[1]);
          a2[e] = pack_exact(p2[0], p2[1]);
        }
        *reinterpret_cast<uint4*>(xmine + kk * 512) = make_uint4(a1[0], a1[1], a1[2], a1[3]);
        *reinterpret_cast<uint4*>(xmine + (BM * dpad * 2) + kk * 512) =
            make_uint4(a2[0], a2[1], a2[2], a2[3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) a0[kk][e] = 0u;
    }
  }
  if (NEED_COST) {
    // |x|^2 of the two rows: the four threads of a row, in a fixed order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xsq[h] += __shfl_xor_sync(0xffffffffu, xsq[h], 1);
      xsq[h] += __shfl_xor_sync(0xffffffffu, xsq[h], 2);
    }
  }

  // hand every stage up to `upto` back to the producer (one arrival per
  // warpgroup, after the warpgroup's products that read it are done)
  int released = 0;
  auto release = [&](int upto) {
    for (; released <= upto; ++released)
      if (tid % 128 == 0) mbar_arrive(&empty[released % STAGES]);
  };

  float best[2] = {-CUDART_INF_F, -CUDART_INF_F};
  int bidx[2] = {0, 0};
  // highest keeps x0 c0 in acc and the five smaller products in lo, so
  // that the tensor core's f32 accumulation of the small terms errs at
  // their own scale, not at that of the whole cross term
  float acc[ACC], lo[PARTS == 3 ? ACC : 1];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (PARTS == 3 ? ACC : 1); ++i) lo[i] = 0.f;

  for (int ti = 0; ti < tiles; ++ti) {
    const int tile = (first + ti) % tiles;
#pragma unroll
    for (int q = 0; q < MAX_DQ; ++q) {
      if (q >= dq) break;
      const int s = ti * dq + q;
      mbar_wait(&full[s % STAGES], (s / STAGES) & 1);

      uint32_t a1[4][4], a2[4][4];
      if constexpr (PARTS == 3) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint4 u1 = *reinterpret_cast<const uint4*>(xmine + (4 * q + ks) * 512);
          const uint4 u2 =
              *reinterpret_cast<const uint4*>(xmine + (BM * dpad * 2) + (4 * q + ks) * 512);
          a1[ks][0] = u1.x, a1[ks][1] = u1.y, a1[ks][2] = u1.z, a1[ks][3] = u1.w;
          a2[ks][0] = u2.x, a2[ks][1] = u2.y, a2[ks][2] = u2.z, a2[ks][3] = u2.w;
        }
      }
      const uint32_t b0 = smem_addr(ring + (s % STAGES) * C::STAGE_BYTES);
      // acc restarts at every tile
      const int keep = q != 0;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t bk = b0 + 32 * ks;
        const uint32_t(&f0)[4] = a0[4 * q + ks];
        if constexpr (PARTS == 3) {
          // the six products whose parts sum to at most 2
          mma(acc, f0, make_desc(bk), ks == 0 ? keep : 1);
          mma(lo, f0, make_desc(bk + C::PART_BYTES), ks == 0 ? keep : 1);
          mma(lo, a1[ks], make_desc(bk), 1);
          mma(lo, f0, make_desc(bk + 2 * C::PART_BYTES), 1);
          mma(lo, a1[ks], make_desc(bk + C::PART_BYTES), 1);
          mma(lo, a2[ks], make_desc(bk), 1);
        } else {
          mma(acc, f0, make_desc(bk), ks == 0 ? keep : 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (q != dq - 1) {
        // the products run on into the next stage: nothing reads acc
        // until the tile's last chunk; stage s - 1's products are done
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        release(s - 1);
        continue;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      release(s);
      fence_regs(acc);
      fence_regs(lo);

      // accumulator i: row r_lo + 8 ((i / 2) % 2), column
      // 8 (i / 4) + 2 tq + i % 2 of the tile.  A thread's columns rise with
      // i, so a strict > keeps the tile's lowest index; the tile's best
      // then merges by (score desc, index asc).  Centers past k have
      // |c|^2 = +inf, so they score -inf and never win.
      float tb[2] = {-CUDART_INF_F, -CUDART_INF_F};
      int tbi[2] = {INT_MAX, INT_MAX};
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int col = tile * BN + 8 * (i >> 2) + 2 * tq + (i & 1);
        const int h = (i >> 1) & 1;
        const float cs = csq[col];
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
      for (int h = 0; h < 2; ++h) {
        if (better(tb[h], tbi[h], best[h], bidx[h])) {
          best[h] = tb[h];
          bidx[h] = tbi[h];
        }
      }
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // the four threads of a row: (score desc, index asc)
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
    const int r = r_lo + 8 * h, row = row0 + r;
    if (tq == 0) {
      if (row < n) labels[row] = bidx[h];
      if (NEED_COST) rowcost_s[r] = row < n ? __fmul_rn(-best[h], w[row]) : 0.f;
    }
  }
  if (NEED_COST) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");  // the consumers only
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s = __fadd_rn(s, rowcost_s[r]);
      cost_part[blockIdx.x] = s;
    }
  }
}

template <int PARTS, bool NEED_COST>
inline cudaError_t launch_one(int dev, int blocks, cudaStream_t st, const float* x,
                              const float* w, const uint8_t* prep, const float* csq, int n,
                              int d, int k, int dpad, int vec, int* labels,
                              float* cost_part) {
  const int bytes = smem_bytes<PARTS>(dpad);
  // the shared-memory limit is a per-device attribute of the kernel: set
  // it once per device, at the largest size the route takes
  static unsigned long long done = 0;
  if (dev >= 64 || !(done >> dev & 1ull)) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_wgmma_kernel<PARTS, NEED_COST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<PARTS>(MAX_D));
    if (err != cudaSuccess) return err;
    if (dev < 64) done |= 1ull << dev;
  }
  assign_wgmma_kernel<PARTS, NEED_COST><<<blocks, THREADS, bytes, st>>>(
      x, w, prep, csq, n, d, k, dpad, vec, labels, cost_part);
  return cudaSuccess;
}

template <int PARTS>
inline cudaError_t run(int dev, cudaStream_t st, bool need_cost, const float* x,
                       const float* w, const float* c, const float* csq, int n, int d, int k,
                       int dpad, int vec, uint8_t* prep, int* labels, float* cost_part) {
  constexpr int BN = Cfg<PARTS>::BN;
  const long long chunks = (long long)((k + BN - 1) / BN) * BN * (dpad / 8);
  prep_kernel<PARTS><<<(unsigned)((chunks + 255) / 256), 256, 0, st>>>(c, k, d, dpad, prep);
  const int blocks = (n + BM - 1) / BM;
  return need_cost ? launch_one<PARTS, true>(dev, blocks, st, x, w, prep, csq, n, d, k,
                                             dpad, vec, labels, cost_part)
                   : launch_one<PARTS, false>(dev, blocks, st, x, w, prep, csq, n, d, k,
                                              dpad, vec, labels, cost_part);
}

// Prepare the centers and assign every row at a tier (mode 0 highest:
// three parts; 1, 2: one); `prep` holds prep_bytes<PARTS>(k, dpad) and
// `cost_part` one float per block of BM rows.
inline cudaError_t launch(int dev, cudaStream_t st, int mode, bool need_cost,
                          const float* x, const float* w, const float* c, const float* csq,
                          int n, int d, int k, uint8_t* prep, int* labels,
                          float* cost_part) {
  if (d < 1 || d > MAX_D) return cudaErrorInvalidValue;
  const int dpad = (d + CHUNK - 1) / CHUNK * CHUNK;
  const int vec = d % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  if (mode == 0)
    return run<3>(dev, st, need_cost, x, w, c, csq, n, d, k, dpad, vec, prep, labels,
                  cost_part);
  return run<1>(dev, st, need_cost, x, w, c, csq, n, d, k, dpad, vec, prep, labels,
                cost_part);
}

}  // namespace assign_wg
