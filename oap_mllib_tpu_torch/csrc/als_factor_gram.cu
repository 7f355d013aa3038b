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
// of F.  At the ML-25M user table (n = 162,541) that is 6.5 MB at
// r = 10 (~0.002 ms) and 20.8 MB at r = 32 (~0.006 ms); the symmetric
// Gram's n r (r + 1) operations take less.  At these sizes a launch
// and a serial tail cost as much as the read, so the design spends one
// launch and keeps the tail short.
//
// Design: one launch, no float atomics.
//   - Grid: two blocks per SM (264), each over a contiguous range of
//     `block_rows` rows, which is one contiguous run of F.  A block
//     copies it in stages of `stage_rows` rows (~16 KB) with 16-byte
//     cp.async into a ring of four buffers: three stages fly while one
//     computes.  The bf16 tiers round the landed stage in place.
//   - Work split: the outputs are cut into 4 x 4 micro-tiles, and only
//     those on and above the diagonal are tasks (gram::tile_of order).
//     Thread tid takes task tid % U over the rows q, q + Q, ... of each
//     stage (q = tid / U, Q = 256 / U), accumulating in registers at the
//     tier.  Lanes of a warp share a row, so the shared-memory reads are
//     broadcasts (one float4 a chunk where r is a multiple of 4).  Past
//     256 tasks (r > 88) the block runs the tasks in passes of 256,
//     restaging its rows for each.
//   - Block sum: each entry a <= b adds its Q thread partials in q order
//     (shared memory); the block writes its partial, the T = r (r + 1) / 2
//     entries a <= b packed row by row.
//   - Grid sum in the same launch, in two fixed orders: blocks form
//     groups of ~sqrt(blocks) consecutive blocks.  Each block draws an
//     atomic ticket of its group (acquire-release at gpu scope, after the
//     block's writes); the group's last block copies the group's
//     partials into shared memory at once, adds them in block order,
//     resets the ticket and draws the top ticket; the last group adds
//     the group sums in group order and writes each entry to (a, b) and
//     (b, a).  No order depends on which block finishes first, so two
//     launches give the same bits, and the result is bit-symmetric.
//   - The tickets live in a small zeroed array that the wrapper keeps
//     per device and stream (calls on one stream are ordered; the last
//     blocks leave them zeroed for the next call).
//
// Tiers (MODE): 0 highest = FP32 FMA on f32 operands; 2 default = FP32
// FMA on bf16-rounded operands (exact products, f32 sums); 1 high =
// operands split into bf16 hi + lo, acc += hi_a hi_b + (hi_a lo_b +
// lo_a hi_b), the cross pair summed by one FMA of two exact products.
//
// Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (oap_mllib_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NSTAGE = 4;               // stage buffers: NSTAGE - 1 in flight
constexpr int W = 4;                    // micro-tile edge
constexpr int RED = THREADS * W * W;    // floats of the block-sum buffer
constexpr int MAX_GROUP = 32;           // blocks per group, and groups
constexpr int TICKETS = MAX_GROUP + 1;  // one per group, then the top
constexpr int SMEM_DYNAMIC = 232448 - 1024;  // dynamic bytes opted into

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the floats [0, cnt) of src into shared dst: 16-byte copies (VEC 4, the
// tail zero-filled) or 4-byte ones
template <int VEC>
__device__ __forceinline__ void stage_copy(float* dst, const float* src,
                                           long long cnt) {
  if (VEC == 4) {
    for (long long v = threadIdx.x; 4 * v < cnt; v += THREADS) {
      const long long left = cnt - 4 * v;
      const int bytes = left >= 4 ? 16 : 4 * (int)left;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + 4 * v)),
                   "l"(src + 4 * v), "r"(bytes));
    }
  } else {
    for (long long v = threadIdx.x; v < cnt; v += THREADS)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(dst + v)),
                   "l"(src + v));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// ticket += 1 at gpu scope, acquire and release: thread 0 draws it after
// a __syncthreads(), so the block's earlier writes are visible to the
// block that draws the last ticket, and that block's reads after the
// next __syncthreads() see every writer's partial
__device__ __forceinline__ unsigned draw_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

// every copy group but the newest NSTAGE - 1 has landed
__device__ __forceinline__ void wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 1) : "memory");
}

// For each packed entry t = (a, b), a <= b (t_n of them; rows of src tp
// floats apart, tp a multiple of 4): the sum over k in [0, count) of
// src[k * tp + t], added in k order, written to out[t], or to G[a][b]
// and G[b][a] of the (r, r) `out` when `mirror`.  The block copies a
// chunk of entries of all `count` rows into shared memory `buf` (cap
// floats) at once, so every load of the chunk flies together, then each
// thread adds its entries' column of the chunk.
__device__ __forceinline__ void ordered_sums(const float* src, int count,
                                             int t_n, int tp, int r,
                                             float* buf, int cap, float* out,
                                             bool mirror) {
  const int chunk = min(tp, cap / count / 4 * 4);
  for (int t0 = 0; t0 < t_n; t0 += chunk) {
    const int m = min(chunk, tp - t0);  // a multiple of 4
    for (int k = 0; k < count; ++k)
      for (int e = 4 * threadIdx.x; e < m; e += 4 * THREADS)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(buf + k * chunk + e)),
                     "l"(src + (long long)k * tp + t0 + e));
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int e = threadIdx.x; e < m && t0 + e < t_n; e += THREADS) {
      float s = 0.f;
      for (int k = 0; k < count; ++k) s = __fadd_rn(s, buf[k * chunk + e]);
      if (mirror) {
        int a, b;
        gram::tile_of(t0 + e, r, a, b);
        out[a * r + b] = s;
        out[b * r + a] = s;
      } else {
        out[t0 + e] = s;
      }
    }
    __syncthreads();
  }
}

// acc += the stage's rows q, q + qn, ... (x: hi parts, xl: lo parts at
// MODE 1) for micro-tile (ca, cb); V4 reads each 4-column chunk as one
// float4 (r a multiple of 4, so every chunk is 16-byte aligned).
// Columns past r read the next row or the stage's padding: they feed
// only entries past r, which are never written.
template <int MODE, bool V4>
__device__ __forceinline__ void accumulate(const float* x, const float* xl,
                                           int r, int rows, int q, int qn,
                                           int ca, int cb,
                                           float (&acc)[W][W]) {
  for (int k = q; k < rows; k += qn) {
    const int o = k * r;
    float av[W], bv[W], al[W], bl[W];
    if constexpr (V4) {
      *reinterpret_cast<float4*>(av) = *reinterpret_cast<const float4*>(x + o + ca * W);
      *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(x + o + cb * W);
      if (MODE == 1) {
        *reinterpret_cast<float4*>(al) = *reinterpret_cast<const float4*>(xl + o + ca * W);
        *reinterpret_cast<float4*>(bl) = *reinterpret_cast<const float4*>(xl + o + cb * W);
      }
    } else {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        av[i] = x[o + ca * W + i];
        bv[i] = x[o + cb * W + i];
        if (MODE == 1) {
          al[i] = xl[o + ca * W + i];
          bl[i] = xl[o + cb * W + i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (MODE == 1) {
          const float cross = fmaf(av[i], bl[j], __fmul_rn(al[i], bv[j]));
          acc[i][j] = __fadd_rn(fmaf(av[i], bv[j], acc[i][j]), cross);
        } else {
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
  }
}

template <int MODE, int VEC>
__global__ void __launch_bounds__(THREADS)
factor_gram_kernel(const float* __restrict__ f, int n, int r, int block_rows,
                   int stage_rows, int stage_alloc, int smem_floats, int tp,
                   int group_size, int groups, float* __restrict__ part,
                   float* __restrict__ gpart, unsigned* __restrict__ tickets,
                   float* __restrict__ gram) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  // stage k % NSTAGE: hi part at smem + (k % NSTAGE) * stage_alloc, lo part
  // (MODE 1) NSTAGE buffers further on.  The block sum reuses the space
  // once a pass's stages are done (no copy is in flight then).
  float* const red = smem;

  const int tid = threadIdx.x;
  const int row_lo = blockIdx.x * block_rows;
  const int row_hi = min(n, row_lo + block_rows);
  const int mt = (r + W - 1) / W, tasks = mt * (mt + 1) / 2;
  const int t_n = r * (r + 1) / 2;  // packed entries a <= b
  float* const my_part = part + (long long)blockIdx.x * tp;
  // copy stage k of the block's rows (an empty copy group past its end)
  auto issue = [&](int k) {
    const int k0 = row_lo + k * stage_rows;
    stage_copy<VEC>(smem + (k % NSTAGE) * stage_alloc, f + (long long)k0 * r,
                    k0 < row_hi ? (long long)(min(row_hi, k0 + stage_rows) - k0) * r
                                : 0);
  };

  for (int u0 = 0; u0 < tasks; u0 += THREADS) {
    const int up = min(tasks - u0, THREADS);  // tasks in this pass
    const int qn = THREADS / up;              // row groups
    const int u = tid % up, q = tid / up;
    int ca, cb;
    gram::tile_of(u0 + u, mt, ca, cb);
    float acc[W][W];
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[i][j] = 0.f;

    for (int k = 0; k < NSTAGE - 1; ++k) issue(k);
    for (int s0 = row_lo, st = 0; s0 < row_hi; s0 += stage_rows, ++st) {
      float* const x = smem + (st % NSTAGE) * stage_alloc;
      float* const xl = x + NSTAGE * stage_alloc;
      issue(st + NSTAGE - 1);  // into the buffer computed one stage ago
      wait_stage();
      __syncthreads();
      const int rows = min(stage_rows, row_hi - s0);
      if (MODE != 0) {
        for (int e = tid; e < rows * r; e += THREADS) {
          const float v = x[e];
          const float h = gram::bf16_round(v);
          x[e] = h;
          if (MODE == 1) xl[e] = gram::bf16_round(__fsub_rn(v, h));
        }
        __syncthreads();
      }
      if (q < qn) {
        if ((r & 3) == 0)
          accumulate<MODE, true>(x, xl, r, rows, q, qn, ca, cb, acc);
        else
          accumulate<MODE, false>(x, xl, r, rows, q, qn, ca, cb, acc);
      }
      __syncthreads();  // the buffer is refilled in the next iteration
    }

    // block sum: each entry a <= b of this pass's tasks, its thread
    // partials in q order
    if (q < qn) {
#pragma unroll
      for (int i = 0; i < W; ++i)
#pragma unroll
        for (int j = 0; j < W; ++j) red[(q * up + u) * W * W + i * W + j] = acc[i][j];
    }
    __syncthreads();
    for (int o = tid; o < up * W * W; o += THREADS) {
      const int uu = o / (W * W), comp = o % (W * W);
      int ta, tb;
      gram::tile_of(u0 + uu, mt, ta, tb);
      const int ea = ta * W + comp / W, eb = tb * W + comp % W;
      if (ea <= eb && eb < r) {
        float s = 0.f;
        for (int qq = 0; qq < qn; ++qq)
          s = __fadd_rn(s, red[(qq * up + uu) * W * W + comp]);
        my_part[ea * r - ea * (ea - 1) / 2 + eb - ea] = s;  // packed (ea, eb)
      }
    }
    __syncthreads();  // red is rewritten by the next pass
  }

  // grid sum in two levels: the last block of each group of consecutive
  // blocks adds the group's partials in block order, and the last group
  // adds the group sums in group order
  const int top = TICKETS - 1;
  __syncthreads();
  const int g = blockIdx.x / group_size;
  const int g_lo = g * group_size;
  const int g_n = min((int)gridDim.x, g_lo + group_size) - g_lo;
  if (tid == 0) last = draw_ticket(&tickets[g]) == (unsigned)(g_n - 1);
  __syncthreads();
  if (!last) return;
  ordered_sums(part + (long long)g_lo * tp, g_n, t_n, tp, r, smem, smem_floats,
               gpart + (long long)g * tp, false);
  if (tid == 0) tickets[g] = 0u;
  __syncthreads();
  if (tid == 0) last = draw_ticket(&tickets[top]) == (unsigned)(groups - 1);
  __syncthreads();
  if (!last) return;
  ordered_sums(gpart, groups, t_n, tp, r, smem, smem_floats, gram, true);
  if (tid == 0) tickets[top] = 0u;
}

// the largest stage: the geometry keeps stage_rows * r <= 4096
constexpr int MAX_STAGE_ALLOC = 4096 + 4;

// dynamic shared memory of a block: the largest of its stage buffers, the
// block-sum buffer and the grid sum's partials (`tail` floats), these no
// more than a full-size stage ring, so small tables sum in one chunk
// without costing occupancy
int smem_floats_of(int mode, int stage_alloc, int tail) {
  const int stages = (mode == 1 ? 2 : 1) * NSTAGE * stage_alloc;
  const int sums = tail < NSTAGE * MAX_STAGE_ALLOC ? tail : NSTAGE * MAX_STAGE_ALLOC;
  const int most = stages > RED ? stages : RED;
  return most > sums ? most : sums;
}

// the shared-memory opt-in is a per-device attribute of the kernel: set
// it once per device (the call costs far more than a launch)
template <int MODE, int VEC>
int opt_in(int dev) {
  static unsigned long long done = 0;
  if (dev < 64 && (done >> dev & 1ull)) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(factor_gram_kernel<MODE, VEC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_DYNAMIC);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) done |= 1ull << dev;
  return 0;
}

template <int MODE, int VEC>
int launch_one(int dev, int blocks, int smem_floats, cudaStream_t st,
               const float* f, int n, int r, int block_rows, int stage_rows,
               int stage_alloc, int tp, int group_size, int groups,
               float* part, float* gpart, unsigned* tickets, float* gram) {
  const int err = opt_in<MODE, VEC>(dev);
  if (err != 0) return err;
  factor_gram_kernel<MODE, VEC><<<blocks, THREADS, 4 * smem_floats, st>>>(
      f, n, r, block_rows, stage_rows, stage_alloc, smem_floats, tp,
      group_size, groups, part, gpart, tickets, gram);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tickets the wrapper keeps zeroed per device and stream.
int als_factor_gram_tickets(void) { return TICKETS; }

// gram (r, r) = F^T F for F (n, r) f32 contiguous on device `dev` (made
// current here: this library's runtime keeps its own current device), on
// `stream`, in one launch.  Geometry from als_kernel.factor_gram_geometry:
// `blocks` blocks of `block_rows` rows (a multiple of 4), stages of
// `stage_rows` rows (a multiple of 4), groups of `group_size` blocks.
// scratch: (blocks + groups) * tp floats, tp = r (r + 1) / 2 rounded up
// to a multiple of 4; tickets: TICKETS zeros, left zero.  Returns a
// cudaError_t: cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a geometry the kernel does not take.
int als_factor_gram(int dev, const float* f, int n, int r, int mode,
                    int blocks, int block_rows, int stage_rows,
                    int group_size, int groups, float* scratch,
                    unsigned* tickets, float* gram, void* stream) {
  const int stage_alloc = ((stage_rows * r + 4) + 3) / 4 * 4;
  const int tp = (r * (r + 1) / 2 + 3) / 4 * 4;
  const int smem_floats = smem_floats_of(
      mode, stage_alloc, (group_size > groups ? group_size : groups) * tp);
  if (n < 1 || r < 1 || blocks < 1 || block_rows % 4 != 0 ||
      stage_rows % 4 != 0 || stage_rows < 4 || stage_alloc > MAX_STAGE_ALLOC ||
      group_size < 1 || group_size > MAX_GROUP || groups < 1 ||
      groups > MAX_GROUP || groups != (blocks + group_size - 1) / group_size ||
      (long long)blocks * block_rows < n || mode < 0 || mode > 2 ||
      4LL * smem_floats > SMEM_DYNAMIC || smem_floats < 4 * MAX_GROUP)
    return (int)cudaErrorInvalidValue;
  int cur = -1;
  if (cudaGetDevice(&cur) != cudaSuccess || cur != dev) {
    const cudaError_t set = cudaSetDevice(dev);
    if (set != cudaSuccess) return (int)set;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = scratch;
  float* gpart = scratch + (long long)blocks * tp;
  const bool vec = reinterpret_cast<uintptr_t>(f) % 16 == 0;
#define ALS_GRAM_ARGS                                                      \
  dev, blocks, smem_floats, st, f, n, r, block_rows, stage_rows,           \
      stage_alloc, tp, group_size, groups, part, gpart, tickets, gram
  int err;
  if (mode == 0)
    err = vec ? launch_one<0, 4>(ALS_GRAM_ARGS) : launch_one<0, 1>(ALS_GRAM_ARGS);
  else if (mode == 1)
    err = vec ? launch_one<1, 4>(ALS_GRAM_ARGS) : launch_one<1, 1>(ALS_GRAM_ARGS);
  else
    err = vec ? launch_one<2, 4>(ALS_GRAM_ARGS) : launch_one<2, 1>(ALS_GRAM_ARGS);
#undef ALS_GRAM_ARGS
  return err;
}

}  // extern "C"
