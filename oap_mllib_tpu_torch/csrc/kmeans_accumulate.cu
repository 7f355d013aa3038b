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
// What bounds it on an H100 SXM (data sheet: 67 TFLOP/s FP32, 989 TFLOP/s
// bf16 dense, 3.35 TB/s): per pass 2 n k d + 2 n d operations and
// n d 4 + n 4 + 2 k d 4 bytes.  At n = 2^20, d = 256, k = 1000 that is
// ~537 GFLOP against ~1.08 GB, so the pass is bound by operations:
// ~0.55 ms at the bf16 tensor-core peak for the bf16 tiers, and ~3.26 ms
// for highest, whose f32-accurate cross term is six bf16 products on the
// tensor cores (8.0 ms if it ran on the FP32 pipe).
//
// Design.  The TPU kernel adds into one resident (k, d) accumulator
// across a sequential grid; Hopper blocks run in parallel and in no
// order, so the pass is split:
//   1. csq      |c|^2 per center (sequential IEEE adds).
//   2. assign   the nearest center of every row, carrying a running
//               (best score, lowest index) per row; writes labels and,
//               in cost mode, one cost partial per block.  Route by
//               depth: d <= 256 runs assign_wgmma.cuh (a prep kernel
//               puts the centers in operand form, then wgmma on the
//               tensor cores at every tier: one bf16 product for high
//               and default, a three-part bf16 split at highest); wider
//               rows run assign_kernel below (a 64x64 SIMT register tile
//               on the FP32 pipe): the wgmma route keeps each row's
//               operand parts in registers and shared memory for the
//               whole pass, which bounds its depth.
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
// Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (oap_mllib_tpu_torch/ops/cuda/_build.py).  Every
// launch goes on the caller's stream; no synchronisation, no allocation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "assign_wgmma.cuh"

namespace {

constexpr int BM = 64;        // rows per assign block
constexpr int BN = 64;        // centers per tile
constexpr int BK = 16;        // feature depth per shared-memory stage
constexpr int TM = 4;         // rows per thread
constexpr int TN = 4;         // centers per thread
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)
constexpr int PAD = 4;        // keeps float4 alignment, breaks bank stride

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

using assign_wg::better;

// |c|^2 of centers [0, k), +inf for the padding [k, kpad) of the wgmma
// route's last center tile.
__global__ void csq_kernel(const float* __restrict__ c, int k, int kpad, int d,
                           float* __restrict__ csq) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= kpad) return;
  if (j >= k) {
    csq[j] = CUDART_INF_F;
    return;
  }
  const float* cj = c + (size_t)j * d;
  float s = 0.f;
  for (int t = 0; t < d; ++t) s = __fadd_rn(s, __fmul_rn(cj[t], cj[t]));
  csq[j] = s;
}

template <bool BF16, bool NEED_COST>
__global__ void __launch_bounds__(THREADS)
assign_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ c, const float* __restrict__ csq,
              int n, int d, int k, int* __restrict__ labels,
              float* __restrict__ cost_part) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];
  __shared__ float xsq_s[BM];
  __shared__ float red_s[BM][THREADS / (BM / TM)];
  __shared__ int redi_s[BM][THREADS / (BM / TM)];
  __shared__ float rowcost_s[BM];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // center group
  const int ty = tid / (BN / TN);  // row group
  const int row0 = blockIdx.x * BM;

  if (NEED_COST) {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int row = row0 + r;
      float s = 0.f;
      if (row < n) {
        const float* xr = x + (size_t)row * d;
        for (int t = lane; t < d; t += 32) s = fmaf(xr[t], xr[t], s);
      }
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) xsq_s[r] = s;
    }
    __syncthreads();
  }

  float best[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = -CUDART_INF_F;
    bidx[i] = 0;
  }

  for (int n0 = 0; n0 < k; n0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int e0 = 0; e0 < BM * BK; e0 += THREADS) {
        const int e = e0 + tid;
        const int r = e / BK, cc = e % BK;
        const int row = row0 + r, col = k0 + cc;
        float v = (row < n && col < d) ? x[(size_t)row * d + col] : 0.f;
        As[cc][r] = BF16 ? bf16_round(v) : v;
      }
#pragma unroll
      for (int e0 = 0; e0 < BN * BK; e0 += THREADS) {
        const int e = e0 + tid;
        const int r = e / BK, cc = e % BK;
        const int cen = n0 + r, col = k0 + cc;
        float v = (cen < k && col < d) ? c[(size_t)cen * d + col] : 0.f;
        Bs[cc][r] = BF16 ? bf16_round(v) : v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // this thread's columns rise with n0 and j, so a strict > keeps the
    // lowest index among its own ties
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col >= k) continue;
      const float cs = csq[col];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float s;
        if (NEED_COST) {
          const float d2 = __fsub_rn(__fadd_rn(xsq_s[ty * TM + i], cs),
                                     __fmul_rn(2.f, acc[i][j]));
          s = -fmaxf(d2, 0.f);
        } else {
          s = __fsub_rn(acc[i][j], __fmul_rn(0.5f, cs));
        }
        if (s > best[i]) {
          best[i] = s;
          bidx[i] = col;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    red_s[ty * TM + i][tx] = best[i];
    redi_s[ty * TM + i][tx] = bidx[i];
  }
  __syncthreads();
  if (tid < BM) {
    float bs = red_s[tid][0];
    int bi = redi_s[tid][0];
    for (int t = 1; t < BN / TN; ++t) {
      if (better(red_s[tid][t], redi_s[tid][t], bs, bi)) {
        bs = red_s[tid][t];
        bi = redi_s[tid][t];
      }
    }
    const int row = row0 + tid;
    if (row < n) labels[row] = bi;
    if (NEED_COST) rowcost_s[tid] = row < n ? __fmul_rn(-bs, w[row]) : 0.f;
  }
  if (NEED_COST) {
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s = __fadd_rn(s, rowcost_s[r]);
      cost_part[blockIdx.x] = s;
    }
  }
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

template <int MODE>
__global__ void segsum_kernel(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const int* __restrict__ perm,
                              const int* __restrict__ offsets, int n, int d,
                              int k, int ranges, int parts,
                              float* __restrict__ psums,
                              float* __restrict__ pcounts) {
  const int cl = blockIdx.x, j = blockIdx.y;
  const int start = offsets[(size_t)cl * ranges];
  const int end = cl + 1 < k ? offsets[(size_t)(cl + 1) * ranges] : n;
  const long long size = end - start;
  const int lo = start + (int)(size * j / parts);
  const int hi = start + (int)(size * (j + 1) / parts);
  float* out = psums + ((size_t)cl * parts + j) * d;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int t = lo; t < hi; ++t) {
      const int row = perm[t];
      const float wx = __fmul_rn(w[row], x[(size_t)row * d + col]);
      if (MODE == 0) {
        a0 = __fadd_rn(a0, wx);
      } else if (MODE == 2) {
        a0 = __fadd_rn(a0, bf16_round(wx));
      } else {
        const float h = bf16_round(wx);
        a0 = __fadd_rn(a0, h);
        a1 = __fadd_rn(a1, bf16_round(__fsub_rn(wx, h)));
      }
    }
    out[col] = MODE == 1 ? __fadd_rn(a0, a1) : a0;
  }
  if (threadIdx.x == 0) {
    float a0 = 0.f, a1 = 0.f;
    for (int t = lo; t < hi; ++t) {
      const float wv = w[perm[t]];
      if (MODE == 0) {
        a0 = __fadd_rn(a0, wv);
      } else {
        const float h = bf16_round(wv);
        a0 = __fadd_rn(a0, h);
        a1 = __fadd_rn(a1, bf16_round(__fsub_rn(wv, h)));
      }
    }
    pcounts[(size_t)cl * parts + j] = MODE == 0 ? a0 : __fadd_rn(a0, a1);
  }
}

__global__ void finalize_kernel(const float* __restrict__ psums,
                                const float* __restrict__ pcounts, int d,
                                int parts, float* __restrict__ sums,
                                float* __restrict__ counts) {
  const int cl = blockIdx.x;
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < parts; ++j)
      s = __fadd_rn(s, psums[((size_t)cl * parts + j) * d + col]);
    sums[(size_t)cl * d + col] = s;
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int j = 0; j < parts; ++j)
      s = __fadd_rn(s, pcounts[(size_t)cl * parts + j]);
    counts[cl] = s;
  }
}

// Sum of m partials by one block of 1024 threads in a fixed tree.
__global__ void cost_kernel(const float* __restrict__ part, int m,
                            float* __restrict__ cost) {
  __shared__ float s[1024];
  const int tid = threadIdx.x;
  float a = 0.f;
  for (int i = tid; i < m; i += 1024) a = __fadd_rn(a, part[i]);
  s[tid] = a;
  __syncthreads();
  for (int off = 512; off > 0; off >>= 1) {
    if (tid < off) s[tid] = __fadd_rn(s[tid], s[tid + off]);
    __syncthreads();
  }
  if (tid == 0) cost[0] = s[0];
}

template <bool BF16, bool NEED_COST>
void launch_assign(int blocks, cudaStream_t st, const float* x,
                   const float* w, const float* c, const float* csq, int n,
                   int d, int k, int* labels, float* cost_part) {
  assign_kernel<BF16, NEED_COST><<<blocks, THREADS, 0, st>>>(
      x, w, c, csq, n, d, k, labels, cost_part);
}

}  // namespace

extern "C" {

// Rows per assign block of a route (0 SIMT, 1 wgmma): the size of
// `cost_part` is ceil(n / this).
int kmeans_assign_rows(int route) { return route == 1 ? assign_wg::BM : BM; }

// Bytes of the wgmma route's prepared centers at a tier, or -1 where
// the route does not take d.
long long kmeans_prep_bytes(int mode, int d, int k) {
  if (d < 1 || d > assign_wg::MAX_D) return -1;
  const int dpad = (d + assign_wg::CHUNK - 1) / assign_wg::CHUNK * assign_wg::CHUNK;
  return mode == 0 ? assign_wg::prep_bytes<3>(k, dpad) : assign_wg::prep_bytes<1>(k, dpad);
}

// Floats of `csq`: k rounded up to whole tiles of the widest wgmma tile.
int kmeans_csq_size(int k) { return (k + 127) / 128 * 128; }

// Integers of the scan's tile totals for m counts.
int kmeans_scan_tiles(int m) { return (m + SCAN_TILE - 1) / SCAN_TILE; }

// One fused accumulate pass on device `dev`.  Inputs: x (n, d), w (n),
// c (k, d), all f32 contiguous on the device.  `route` 1 assigns on the
// tensor cores (d <= 256), 0 on the FP32 pipe.  Scratch (sizes in
// elements): csq kmeans_csq_size(k), prep kmeans_prep_bytes bytes (route 1 only), labels
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

  if (route == 1) {
    err = assign_wg::launch(dev, st, mode, need_cost != 0, x, w, c, csq, n, d, k, prep,
                            labels, cost_part);
    if (err != cudaSuccess) return (int)err;
  } else {
    const int blocks = (n + BM - 1) / BM;
    const bool bf16 = mode != 0;
    if (bf16 && need_cost)
      launch_assign<true, true>(blocks, st, x, w, c, csq, n, d, k, labels, cost_part);
    else if (bf16)
      launch_assign<true, false>(blocks, st, x, w, c, csq, n, d, k, labels, cost_part);
    else if (need_cost)
      launch_assign<false, true>(blocks, st, x, w, c, csq, n, d, k, labels, cost_part);
    else
      launch_assign<false, false>(blocks, st, x, w, c, csq, n, d, k, labels, cost_part);
  }

  rank_kernel<<<ranges, 32, 0, st>>>(labels, n, range_rows, ranges, counts_i,
                                     rank);
  const int m = k * ranges, tiles = kmeans_scan_tiles(m);
  scan_sums_kernel<<<tiles, SCAN_THREADS, 0, st>>>(counts_i, m, scan_part);
  scan_apply_kernel<<<tiles, SCAN_THREADS, 0, st>>>(counts_i, m, scan_part);
  scatter_kernel<<<(n + 255) / 256, 256, 0, st>>>(labels, counts_i, rank, n,
                                                  range_rows, ranges, perm);

  const int cols = d < 256 ? ((d + 31) / 32) * 32 : 256;
  const dim3 grid(k, parts);
  if (mode == 0)
    segsum_kernel<0><<<grid, cols, 0, st>>>(x, w, perm, counts_i, n, d, k,
                                            ranges, parts, psums, pcounts);
  else if (mode == 1)
    segsum_kernel<1><<<grid, cols, 0, st>>>(x, w, perm, counts_i, n, d, k,
                                            ranges, parts, psums, pcounts);
  else
    segsum_kernel<2><<<grid, cols, 0, st>>>(x, w, perm, counts_i, n, d, k,
                                            ranges, parts, psums, pcounts);
  finalize_kernel<<<k, cols, 0, st>>>(psums, pcounts, d, parts, sums, counts);
  if (need_cost)
    cost_kernel<<<1, 1024, 0, st>>>(cost_part, (n + kmeans_assign_rows(route) - 1) /
                                                   kmeans_assign_rows(route), cost);
  return (int)cudaGetLastError();
}

}  // extern "C"
