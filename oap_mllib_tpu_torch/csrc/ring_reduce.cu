// Ring allreduce step for Hopper (sm_90a): one rank's share of one step
// of a bidirectional ring reduce-scatter / all-gather, pulling from its
// neighbours' buffers through peer pointers.
//
// Replaces the TPU kernel oap_mllib_tpu/ops/pallas/ring_reduce.py
// `_make_ring_kernel` (reached through `_ring_pallas`; entries
// `ring_allreduce` and `stacked_ring_fn`).  Same function and schedule:
// every rank's (rows, cols) f32 buffer, padded to world * seg rows and
// an even multiple of 128 columns, splits into `world` row segments;
// the columns [0, half) travel clockwise (rank r receives from r - 1)
// and [half, cols) counter-clockwise (from r + 1).  World - 1
// reduce-scatter steps add the arriving segment into the running copy
// (`cur + recv`), world - 1 all-gather steps copy the reduced segments
// around; every segment's additions happen in a fixed ring order, so
// the result is the same on every rank and the same bits as the plain
// version (oap_mllib_tpu_torch/ops/cuda/ring_kernel.py) and as the JAX
// package's ppermute schedule.
//
// Design.  The TPU kernel pushed segments with remote DMAs from VMEM
// staging buffers under DMA semaphores and a neighbour barrier.  Here a
// step is one launch per rank on that rank's device and stream: the
// kernel reads the left neighbour's segment of the clockwise half and
// the right neighbour's segment of the other half directly through
// their device pointers (over NVLink when the neighbour is another
// card; peer access is enabled by `ring_enable_peer`), and adds into or
// overwrites its own buffer in place.  A rank writes a different
// segment from the one its neighbours read in the same step, so a step
// needs no lock; between steps the host orders each rank after both
// neighbours' previous step with CUDA events (the neighbour barrier of
// the TPU kernel), and never synchronises.  16-byte loads and stores, a
// grid-stride loop over the two half segments, no shared memory.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, NVLink 450 GB/s each
// way per card).  Ranks on one card: HBM bytes.  The function must read
// every rank's buffer once and write every rank's result once (2 W B
// bytes for W ranks of B bytes); the schedule moves more, 5 (W - 1) B
// (a reduce-scatter step reads two segments and writes one, an
// all-gather step reads one and writes one).  Ranks on distinct cards:
// NVLink, the 2 (W - 1) / W B that any allreduce must bring into each
// card, half from each neighbour, against 2 B of HBM traffic per card.
//
// Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (oap_mllib_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

// own[seg rows at row_cw, cols [0, half)]   (+)= left[same]
// own[seg rows at row_ccw, cols [half, cols)] (+)= right[same]
__global__ void ring_step_kernel(float* own, const float* left,
                                 const float* right, long long row_cw,
                                 long long row_ccw, int seg, int cols,
                                 int add) {
  const int half = cols / 2;
  const long long q = half / 4;  // float4s in one half row
  const long long per_half = static_cast<long long>(seg) * q;
  const long long total = 2 * per_half;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const bool ccw = t >= per_half;
    const long long u = ccw ? t - per_half : t;
    const long long row = (ccw ? row_ccw : row_cw) + u / q;
    const long long off = row * cols + (ccw ? half : 0) + (u % q) * 4;
    const float4 recv =
        *reinterpret_cast<const float4*>((ccw ? right : left) + off);
    float4* dst = reinterpret_cast<float4*>(own + off);
    if (add) {
      float4 cur = *dst;
      cur.x = cur.x + recv.x;
      cur.y = cur.y + recv.y;
      cur.z = cur.z + recv.z;
      cur.w = cur.w + recv.w;
      *dst = cur;
    } else {
      *dst = recv;
    }
  }
}

}  // namespace

extern "C" {

// Let `dev` read `peer`'s memory; an access already enabled is success.
// Returns a cudaError_t.
int ring_enable_peer(int dev, int peer) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: not a failure
    return cudaSuccess;
  }
  return err;
}

// One ring step of one rank on device `dev` and `stream`: `own`, `left`
// and `right` are (rows, cols) f32 row-major buffers of this rank and
// its neighbours, `cols` a multiple of 8 and every buffer 16-byte
// aligned; the clockwise half of `seg` rows starting at row `row_cw`
// pulls from `left`, the other half at `row_ccw` from `right`; `add`
// selects reduce-scatter (add) or all-gather (copy).  Returns
// cudaGetLastError() after the launch.
int ring_step(int dev, float* own, const float* left, const float* right,
              long long row_cw, long long row_ccw, int seg, int cols,
              int add, void* stream) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  const long long work = 2LL * seg * (cols / 8);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  ring_step_kernel<<<static_cast<int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      own, left, right, row_cw, row_ccw, seg, cols, add);
  return cudaGetLastError();
}

}  // extern "C"
