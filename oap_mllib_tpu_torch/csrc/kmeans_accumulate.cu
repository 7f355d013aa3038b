// Fused Lloyd accumulate for Hopper (sm_90a): assignment, cluster sums,
// counts and cost of one K-Means pass.
//
// Replaces the TPU kernel oap_mllib_tpu/ops/pallas/kmeans_kernel.py
// `_tile_update` (reached through `_pallas_accumulate` and
// `_pallas_accumulate_dbuf`).  Same function, for the three precision
// tiers and both modes:
//   loop mode  (need_cost = 0): label = argmax_j (x.c_j - |c_j|^2 / 2)
//   cost mode  (need_cost = 1): d2 = max(|x|^2 + |c|^2 - 2 x.c, 0),
//                               label = argmin d2, cost += w * min d2
//   sums[label] += w * x (one-hot stays 0/1), counts[label] += w
// Ties go to the lowest center index, as jnp.argmax / jnp.argmin do.
//
// Tiers (`mode`): 0 highest = f32 operands; 1 high = cross term on
// bf16-rounded operands with FP32 accumulation, sums as sum(bf16_hi(w x))
// + sum(bf16_lo(w x)), counts likewise on w; 2 default = the same cross
// term, sums as sum(bf16(w x)), counts split like "high".
//
// What bounds it on an H100 SXM (data sheet: 989 TFLOP/s bf16 dense,
// 3.35 TB/s): per pass 2 n k d + 2 n d operations and
// n d 4 + n 4 + 2 k d 4 bytes.  At n = 2^20, d = 256, k = 1000 that is
// ~537 GFLOP against ~1.08 GB, so the pass is bound by operations:
// ~0.55 ms at the bf16 tensor-core peak for the bf16 tiers, and ~3.26 ms
// for highest, whose f32-accurate cross term is six bf16 products on the
// tensor cores (8.0 ms if it ran on the FP32 pipe).  At d = 960 the
// same pass is 2.04 ms (bf16 tiers) and 12.2 ms (highest).
//
// Design.  The TPU kernel adds into one resident (k, d) accumulator
// across a sequential grid; Hopper blocks run in parallel and in no
// order, so the pass is split:
//   1. csq      |c|^2 per center (sequential IEEE adds).
//   2. assign   the nearest center of every row, carrying a running
//               (best score, lowest index) per row; writes labels and,
//               in cost mode, one cost partial per 128 rows.  Both
//               routes prepare the centers in operand form and run the
//               cross term on wgmma at every tier (one bf16 product for
//               high and default, a three-part bf16 split at highest).
//               By depth: d <= 256 runs assign_wgmma.cuh, which forms
//               each row's operand parts once a pass and keeps them for
//               the whole pass; wider rows run assign_wide.cuh, which
//               streams the depth in 64-deep chunks, the rows' parts
//               formed per stage in shared memory.
//   3. rank     a stable counting sort of the rows by label: one warp per
//               row range counts labels (integers, so order-free) and
//               gives each row its rank among equal labels in row order.
//   4. scan     exclusive prefix over the (cluster, range) counts, spread
//               over the card: per-block totals, then each block adds
//               the totals before it and scans its own tile.
//   5. scatter  perm[offset] = row: rows grouped by cluster, in row order.
//   6. segsum   per (cluster, part): w x summed over the part's rows in
//               fixed order; each cluster is cut into `parts` equal parts
//               so that a large cluster does not serialise on one block.
//   7. finalize parts summed in fixed order into sums and counts.
//   8. cost     cost partials summed by one block in a fixed tree.
// No float atomics anywhere: two launches on the same inputs give the
// same bits.
//
// The float64 form (`kmeans_accumulate_f64`, the x64 parity lane,
// Config.enable_x64): the same function at the highest tier on double
// operands, passes 1-8 as above with every float a double.  Its
// assignment is assign_dmma.cuh: the cross term on the FP64 tensor
// cores (DMMA mma.sync, 128 rows by 128 centers a block, cp.async
// stages), ranked on the plain version's rounding order ((|x|^2 +
// |c|^2) - 2 x.c); the sort, scan and scatter passes are the f32 form's,
// and sums, counts and cost add in f64 in the same fixed orders, so two
// launches give the same bits here too.  Its bound on an H100 SXM: the
// same 2 n k d operations at 67 TFLOP/s on the FP64 tensor cores; at
// n = 2^20, d = 256, k = 1000 that is 8.0 ms against 0.64 ms of bytes.
//
// Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (oap_mllib_tpu_torch/ops/cuda/_build.py).  Every
// launch goes on the caller's stream; no synchronisation, no allocation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "assign_dmma.cuh"
#include "assign_wgmma.cuh"
#include "assign_wide.cuh"

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Round-to-nearest adds and products of either scalar type: the f32
// passes' intrinsics, and their f64 counterparts for the float64 form.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T inf_of() {
  if constexpr (sizeof(T) == 8) return CUDART_INF; else return CUDART_INF_F;
}

// |c|^2 of centers [0, k), +inf for the padding [k, kpad) of the wgmma
// route's last center tile.
template <typename T>
__global__ void csq_kernel(const T* __restrict__ c, int k, int kpad, int d,
                           T* __restrict__ csq) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= kpad) return;
  if (j >= k) {
    csq[j] = inf_of<T>();
    return;
  }
  const T* cj = c + (size_t)j * d;
  T s = 0;
  for (int t = 0; t < d; ++t) s = add_rn(s, mul_rn(cj[t], cj[t]));
  csq[j] = s;
}

// One warp per range of `range_rows` rows: counts[label][range] and each
// row's rank among the range's rows of the same label, in row order.
__global__ void rank_kernel(const int* __restrict__ labels, int n,
                            int range_rows, int ranges,
                            int* __restrict__ counts,
                            int* __restrict__ rank) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int lo = b * range_rows;
  const int hi = min(n, lo + range_rows);
  for (int base = lo; base < hi; base += 32) {
    const int row = base + lane;
    const bool valid = row < hi;
    const unsigned active = __ballot_sync(0xffffffffu, valid);
    if (valid) {
      const int l = labels[row];
      const unsigned peers = __match_any_sync(active, l);
      const int before = __popc(peers & ((1u << lane) - 1u));
      volatile int* slot = counts + (size_t)l * ranges + b;
      const int have = *slot;
      rank[row] = have + before;
      __syncwarp(active);
      if (lane == 31 - __clz(peers)) *slot = have + __popc(peers);
    }
    __syncwarp();
  }
}

// Exclusive prefix sum of m integers over the card: block b owns the
// tile [b SCAN_TILE, (b + 1) SCAN_TILE), SCAN_PER consecutive integers a
// thread.  scan_sums_kernel writes each tile's total; scan_apply_kernel
// adds the totals of the tiles before its own and scans its tile.
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_PER = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_PER;

// The block's sum of one value a thread (every thread gets it).
__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  int t = threadIdx.x < SCAN_THREADS / 32 ? red[threadIdx.x] : 0;
  if (threadIdx.x < 32)
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  if (threadIdx.x == 0) red[0] = t;
  __syncthreads();
  const int total = red[0];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_sums_kernel(const int* __restrict__ a, int m, int* __restrict__ tile_sum) {
  __shared__ int red[SCAN_THREADS / 32];
  const int base = blockIdx.x * SCAN_TILE + SCAN_PER * threadIdx.x;
  int v = 0;
#pragma unroll
  for (int j = 0; j < SCAN_PER; ++j) v += base + j < m ? a[base + j] : 0;
  v = block_sum(v, red);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = v;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_apply_kernel(int* __restrict__ a, int m, const int* __restrict__ tile_sum) {
  __shared__ int red[SCAN_THREADS / 32];
  __shared__ int warp_pre[SCAN_THREADS / 32];
  int before = 0;
  for (int b = threadIdx.x; b < blockIdx.x; b += SCAN_THREADS) before += tile_sum[b];
  const int offset = block_sum(before, red);

  const int base = blockIdx.x * SCAN_TILE + SCAN_PER * threadIdx.x;
  int v[SCAN_PER], mine = 0;
#pragma unroll
  for (int j = 0; j < SCAN_PER; ++j) {
    v[j] = base + j < m ? a[base + j] : 0;
    mine += v[j];
  }
  // inclusive scan of the threads' sums: in the warp, then the warps'
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += u;
  }
  if (lane == 31) warp_pre[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int t = warp_pre[lane], tinc = t;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, tinc, off);
      if (lane >= off) tinc += u;
    }
    warp_pre[lane] = tinc - t;  // exclusive over the warps
  }
  __syncthreads();
  int run = offset + warp_pre[warp] + inc - mine;
#pragma unroll
  for (int j = 0; j < SCAN_PER; ++j) {
    if (base + j < m) a[base + j] = run;
    run += v[j];
  }
}

__global__ void scatter_kernel(const int* __restrict__ labels,
                               const int* __restrict__ offsets,
                               const int* __restrict__ rank, int n,
                               int range_rows, int ranges,
                               int* __restrict__ perm) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int l = labels[row];
  perm[offsets[(size_t)l * ranges + row / range_rows] + rank[row]] = row;
}

template <int MODE, typename T>
__global__ void segsum_kernel(const T* __restrict__ x,
                              const T* __restrict__ w,
                              const int* __restrict__ perm,
                              const int* __restrict__ offsets, int n, int d,
                              int k, int ranges, int parts,
                              T* __restrict__ psums,
                              T* __restrict__ pcounts) {
  const int cl = blockIdx.x, j = blockIdx.y;
  const int start = offsets[(size_t)cl * ranges];
  const int end = cl + 1 < k ? offsets[(size_t)(cl + 1) * ranges] : n;
  const long long size = end - start;
  const int lo = start + (int)(size * j / parts);
  const int hi = start + (int)(size * (j + 1) / parts);
  T* out = psums + ((size_t)cl * parts + j) * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    T a0 = 0, a1 = 0;
#pragma unroll 4
    for (int t = lo; t < hi; ++t) {
      const int row = perm[t];
      const T wx = mul_rn(w[row], x[(size_t)row * d + col]);
      if constexpr (MODE == 0) {
        a0 = add_rn(a0, wx);
      } else if constexpr (MODE == 2) {
        a0 = __fadd_rn(a0, bf16_round(wx));
      } else {
        const float h = bf16_round(wx);
        a0 = __fadd_rn(a0, h);
        a1 = __fadd_rn(a1, bf16_round(__fsub_rn(wx, h)));
      }
    }
    out[col] = MODE == 1 ? add_rn(a0, a1) : a0;
  }
  if (threadIdx.x == 0) {
    T a0 = 0, a1 = 0;
    for (int t = lo; t < hi; ++t) {
      const T wv = w[perm[t]];
      if constexpr (MODE == 0) {
        a0 = add_rn(a0, wv);
      } else {
        const float h = bf16_round(wv);
        a0 = __fadd_rn(a0, h);
        a1 = __fadd_rn(a1, bf16_round(__fsub_rn(wv, h)));
      }
    }
    pcounts[(size_t)cl * parts + j] = MODE == 0 ? a0 : add_rn(a0, a1);
  }
}

template <typename T>
__global__ void finalize_kernel(const T* __restrict__ psums,
                                const T* __restrict__ pcounts, int d,
                                int parts, T* __restrict__ sums,
                                T* __restrict__ counts) {
  const int cl = blockIdx.x;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    T s = 0;
    for (int j = 0; j < parts; ++j)
      s = add_rn(s, psums[((size_t)cl * parts + j) * d + col]);
    sums[(size_t)cl * d + col] = s;
  }
  if (threadIdx.x == 0) {
    T s = 0;
    for (int j = 0; j < parts; ++j)
      s = add_rn(s, pcounts[(size_t)cl * parts + j]);
    counts[cl] = s;
  }
}

// Sum of m partials by one block of 1024 threads in a fixed tree.
template <typename T>
__global__ void cost_kernel(const T* __restrict__ part, int m,
                            T* __restrict__ cost) {
  __shared__ T s[1024];
  const int tid = threadIdx.x;
  T a = 0;
  for (int i = tid; i < m; i += 1024) a = add_rn(a, part[i]);
  s[tid] = a;
  __syncthreads();
  for (int off = 512; off > 0; off >>= 1) {
    if (tid < off) s[tid] = add_rn(s[tid], s[tid + off]);
    __syncthreads();
  }
  if (tid == 0) cost[0] = s[0];
}

// Passes 3-8 (rank, scan, scatter, segsum, finalize, cost) of either
// form, after the assignment wrote `labels` (and `cost_part`).
template <int MODE, typename T>
void launch_sums(cudaStream_t st, const T* x, const T* w, const int* labels, int n, int d,
                 int k, int range_rows, int ranges, int parts, int need_cost,
                 int cost_parts, const T* cost_part, int* counts_i, int* scan_part,
                 int* rank, int* perm, T* psums, T* pcounts, T* sums, T* counts,
                 T* cost) {
  rank_kernel<<<ranges, 32, 0, st>>>(labels, n, range_rows, ranges, counts_i,
                                     rank);
  const int m = k * ranges, tiles = (m + SCAN_TILE - 1) / SCAN_TILE;
  scan_sums_kernel<<<tiles, SCAN_THREADS, 0, st>>>(counts_i, m, scan_part);
  scan_apply_kernel<<<tiles, SCAN_THREADS, 0, st>>>(counts_i, m, scan_part);
  scatter_kernel<<<(n + 255) / 256, 256, 0, st>>>(labels, counts_i, rank, n,
                                                  range_rows, ranges, perm);
  const int cols = d < 256 ? ((d + 31) / 32) * 32 : 256;
  const dim3 grid(k, parts);
  segsum_kernel<MODE, T><<<grid, cols, 0, st>>>(x, w, perm, counts_i, n, d, k,
                                                ranges, parts, psums, pcounts);
  finalize_kernel<T><<<k, cols, 0, st>>>(psums, pcounts, d, parts, sums, counts);
  if (need_cost) cost_kernel<T><<<1, 1024, 0, st>>>(cost_part, cost_parts, cost);
}

}  // namespace

extern "C" {

// Rows per cost partial of a route (1 wgmma, 2 the float64 form's DMMA
// tile, 3 the wide rows' wgmma): the size of `cost_part` is
// ceil(n / this); 0 for no route.
int kmeans_assign_rows(int route) {
  return route == 1 ? assign_wg::BM : route == 2 ? assign_dmma::BM
                                    : route == 3 ? assign_wide::BM : 0;
}

// The float64 form's DMMA tile: centers a tile, its dynamic shared
// memory in bytes.
int kmeans_f64_center_tile() { return assign_dmma::BN; }
int kmeans_f64_smem_bytes() { return assign_dmma::SMEM_BYTES; }
// A warp's tile: rows (side 0) and centers (side 1).
int kmeans_f64_warp_tile(int side) { return side == 0 ? assign_dmma::WM : assign_dmma::WN; }

// Bytes of the f32 form's `prep` scratch at a tier: the wgmma route's
// prepared centers (d <= 256), or the wide route's prepared centers and
// (groups, n) bests (d > 256); -1 for d < 1.
long long kmeans_prep_bytes(int mode, int n, int d, int k) {
  if (d < 1) return -1;
  if (d > assign_wg::MAX_D) return assign_wide::scratch_bytes(mode, n, d, k);
  const int dpad = (d + assign_wg::CHUNK - 1) / assign_wg::CHUNK * assign_wg::CHUNK;
  return mode == 0 ? assign_wg::prep_bytes<3>(k, dpad) : assign_wg::prep_bytes<1>(k, dpad);
}

// The wide route at a tier: centers a tile (side 0), groups of center
// tiles (side 1) at k centers, and its shared memory in bytes (side 2).
int kmeans_wide_figure(int mode, int side, int k) {
  if (side == 0) return mode == 0 ? assign_wide::Cfg<3>::BN : assign_wide::Cfg<1>::BN;
  if (side == 1) return mode == 0 ? assign_wide::groups<3>(k) : assign_wide::groups<1>(k);
  return mode == 0 ? assign_wide::smem_bytes<3>() : assign_wide::smem_bytes<1>();
}

// Floats of `csq`: k rounded up to whole tiles of the widest center tile
// (the wide route's 256 at the bf16 tiers).
int kmeans_csq_size(int k) { return (k + 255) / 256 * 256; }

// Integers of the scan's tile totals for m counts.
int kmeans_scan_tiles(int m) { return (m + SCAN_TILE - 1) / SCAN_TILE; }

// One fused accumulate pass on device `dev`.  Inputs: x (n, d), w (n),
// c (k, d), all f32 contiguous on the device.  `route` 1 assigns on the
// tensor cores with the d <= 256 route, 3 with the wide rows' route (d >
// 256).  Scratch (sizes in elements): csq kmeans_csq_size(k), prep
// kmeans_prep_bytes bytes, labels
// n, cost_part ceil(n / kmeans_assign_rows(route)), counts_i k * ranges,
// scan_part kmeans_scan_tiles(k * ranges), rank n, perm n, psums
// k * parts * d, pcounts k * parts.  Outputs: sums (k, d), counts (k),
// cost (1; written only when need_cost).  `range_rows` * `ranges` must
// cover n.  Returns a cudaError_t: cudaGetLastError() after the
// launches, or the refusal of a route that does not take d.
int kmeans_accumulate(int dev, const float* x, const float* w, const float* c, int n,
                      int d, int k, int mode, int need_cost, int route, int range_rows,
                      int ranges, int parts, float* csq, uint8_t* prep, int* labels,
                      float* cost_part, int* counts_i, int* scan_part, int* rank,
                      int* perm, float* psums, float* pcounts, float* sums,
                      float* counts, float* cost, void* stream) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counts_i, 0, sizeof(int) * (size_t)k * (size_t)ranges, st);
  if (err != cudaSuccess) return (int)err;

  const int kpad = kmeans_csq_size(k);
  csq_kernel<<<(kpad + 255) / 256, 256, 0, st>>>(c, k, kpad, d, csq);

  if (route == 1)
    err = assign_wg::launch(dev, st, mode, need_cost != 0, x, w, c, csq, n, d, k, prep,
                            labels, cost_part);
  else if (route == 3)
    err = assign_wide::launch(dev, st, mode, need_cost != 0, x, w, c, csq, n, d, k, prep,
                              labels, cost_part);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;

  const int cost_parts = (n + kmeans_assign_rows(route) - 1) / kmeans_assign_rows(route);
  if (mode == 0)
    launch_sums<0, float>(st, x, w, labels, n, d, k, range_rows, ranges, parts, need_cost,
                          cost_parts, cost_part, counts_i, scan_part, rank, perm, psums,
                          pcounts, sums, counts, cost);
  else if (mode == 1)
    launch_sums<1, float>(st, x, w, labels, n, d, k, range_rows, ranges, parts, need_cost,
                          cost_parts, cost_part, counts_i, scan_part, rank, perm, psums,
                          pcounts, sums, counts, cost);
  else
    launch_sums<2, float>(st, x, w, labels, n, d, k, range_rows, ranges, parts, need_cost,
                          cost_parts, cost_part, counts_i, scan_part, rank, perm, psums,
                          pcounts, sums, counts, cost);
  return (int)cudaGetLastError();
}

// The float64 form: one fused pass at the highest tier on double
// operands x (n, d), w (n), c (k, d), contiguous on device `dev`.
// Scratch as kmeans_accumulate's (no prep), each float a double: csq
// kmeans_csq_size(k), labels n, cost_part ceil(n / kmeans_assign_rows(2)),
// counts_i k * ranges, scan_part kmeans_scan_tiles(k * ranges), rank n,
// perm n, psums k * parts * d, pcounts k * parts.  Outputs sums (k, d),
// counts (k), cost (1; written only when need_cost).  Returns a
// cudaError_t.
int kmeans_accumulate_f64(int dev, const double* x, const double* w, const double* c,
                          int n, int d, int k, int need_cost, int range_rows, int ranges,
                          int parts, double* csq, int* labels, double* cost_part,
                          int* counts_i, int* scan_part, int* rank, int* perm,
                          double* psums, double* pcounts, double* sums, double* counts,
                          double* cost, void* stream) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counts_i, 0, sizeof(int) * (size_t)k * (size_t)ranges, st);
  if (err != cudaSuccess) return (int)err;
  const int kpad = kmeans_csq_size(k);
  csq_kernel<<<(kpad + 255) / 256, 256, 0, st>>>(c, k, kpad, d, csq);
  err = assign_dmma::launch(dev, st, need_cost != 0, x, w, c, csq, n, d, k, labels, cost_part);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + assign_dmma::BM - 1) / assign_dmma::BM;
  launch_sums<0, double>(st, x, w, labels, n, d, k, range_rows, ranges, parts, need_cost,
                         blocks, cost_part, counts_i, scan_part, rank, perm, psums, pcounts,
                         sums, counts, cost);
  return (int)cudaGetLastError();
}

}  // extern "C"
