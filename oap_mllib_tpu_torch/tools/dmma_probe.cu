// Probe of the f64 `mma.sync` shapes of csrc/dmma_f64.cuh on the card:
// for each shape (0 = m8n8k4 twice, 4 = m16n8k4, 8 = m16n8k8, 16 =
// m16n8k16) one warp's 16 x 8 tile against a double loop on the host
// (small integers, so the sums are exact and must match bit for bit),
// then each shape's rate in TFLOP/s on a grid that fills the card.
// Built and run by tools/dmma_probe.py; prints one line per check.

#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

#include "../csrc/dmma_f64.cuh"

template <int S>
__host__ __device__ constexpr int depth() { return S == 0 ? 4 : S; }

// A (16 x K) and B (K x 8) row-major, C (16 x 8) in and out.
template <int S>
__global__ void tile_kernel(const double* A, const double* B, double* C) {
  constexpr int K = depth<S>();
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double a[2 * K / 4], b[K / 4];
#pragma unroll
  for (int s = 0; s < K / 4; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) a[2 * s + h] = A[(8 * h + g) * K + 4 * s + t];
    b[s] = B[(4 * s + t) * 8 + g];
  }
  double c[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1], C[(8 + g) * 8 + 2 * t],
                 C[(8 + g) * 8 + 2 * t + 1]};
  dmma::mma16x8<S>(c, a, b);
  C[g * 8 + 2 * t] = c[0];
  C[g * 8 + 2 * t + 1] = c[1];
  C[(8 + g) * 8 + 2 * t] = c[2];
  C[(8 + g) * 8 + 2 * t + 1] = c[3];
}

// 8 independent 16 x 8 accumulators a warp, `iters` rounds of products.
template <int S>
__global__ void __launch_bounds__(256) rate_kernel(double* out, int iters) {
  constexpr int K = depth<S>();
  double a[2 * K / 4], b[K / 4];
#pragma unroll
  for (int i = 0; i < 2 * K / 4; ++i) a[i] = 1e-3 * (threadIdx.x + i);
#pragma unroll
  for (int i = 0; i < K / 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  double c[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) dmma::mma16x8<S>(c[j], a, b);
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int S>
static bool check_tile() {
  constexpr int K = depth<S>();
  double hA[16 * K], hB[K * 8], hC[16 * 8], want[16 * 8];
  srand(S + 1);
  for (int i = 0; i < 16 * K; ++i) hA[i] = (double)(rand() % 17 - 8);
  for (int i = 0; i < K * 8; ++i) hB[i] = (double)(rand() % 17 - 8);
  for (int i = 0; i < 16 * 8; ++i) hC[i] = (double)(rand() % 9 - 4);
  for (int r = 0; r < 16; ++r)
    for (int n = 0; n < 8; ++n) {
      double s = hC[r * 8 + n];
      for (int k = 0; k < K; ++k) s += hA[r * K + k] * hB[k * 8 + n];
      want[r * 8 + n] = s;
    }
  double *A, *B, *C;
  cudaMalloc(&A, sizeof hA);
  cudaMalloc(&B, sizeof hB);
  cudaMalloc(&C, sizeof hC);
  cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
  cudaMemcpy(C, hC, sizeof hC, cudaMemcpyHostToDevice);
  tile_kernel<S><<<1, 32>>>(A, B, C);
  cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpy(hC, C, sizeof hC, cudaMemcpyDeviceToHost);
  int bad = 0;
  for (int i = 0; i < 16 * 8; ++i) bad += hC[i] != want[i];
  printf("DMMA_TILE shape=%d ok=%d mismatches=%d err=%s\n", S, bad == 0 && err == cudaSuccess,
         bad, cudaGetErrorString(err));
  cudaFree(A);
  cudaFree(B);
  cudaFree(C);
  return bad == 0 && err == cudaSuccess;
}

template <int S>
static void rate(int blocks) {
  constexpr int K = depth<S>();
  const int iters = 4096;
  double* out;
  cudaMalloc(&out, sizeof(double) * blocks * 256);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  rate_kernel<S><<<blocks, 256>>>(out, iters);
  float best = 1e30f;
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(e0);
    rate_kernel<S><<<blocks, 256>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    best = ms < best ? ms : best;
  }
  const double flops = 2.0 * 16 * 8 * K * 8.0 * iters * (blocks * 8.0);
  printf("DMMA_RATE shape=%d blocks=%d ms=%.4f tflops=%.2f err=%s\n", S, blocks, best,
         flops / (best * 1e-3) / 1e12, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  cudaDeviceProp p;
  cudaGetDeviceProperties(&p, 0);
  printf("DMMA_PROBE device=%s sms=%d\n", p.name, p.multiProcessorCount);
  const bool ok = check_tile<0>() & check_tile<4>() & check_tile<8>() & check_tile<16>();
  const int blocks = p.multiProcessorCount * 8;
  rate<0>(blocks);
  rate<4>(blocks);
  rate<8>(blocks);
  rate<16>(blocks);
  return ok ? 0 : 1;
}
