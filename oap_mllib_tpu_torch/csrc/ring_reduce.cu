// Ring allreduce for Hopper (sm_90a): the sum of one (rows, cols) f32
// buffer per rank, folded in the ring schedule's order, in one launch
// per card.
//
// Replaces the TPU kernel oap_mllib_tpu/ops/pallas/ring_reduce.py
// `_make_ring_kernel` (reached through `_ring_pallas`; entries
// `ring_allreduce` and `stacked_ring_fn`).  Same function and bits:
// every rank's buffer, padded to world * seg rows and an even multiple
// of 128 columns, splits into `world` row segments (per segment group);
// the columns [0, half) travel clockwise and [half, cols)
// counter-clockwise.  Each element's additions happen in an order the
// schedule fixes: an element of segment j in the clockwise half ends as
// x[j+W-1] + (... + (x[j+1] + x[j])) in rank indices mod W, the
// counter-clockwise half mirrors it, and every rank receives a copy.
// The host derives that order from the written schedule
// (ring_kernel.fold_order) and passes it as `order[dir][segment]`.
//
// Design.  The TPU kernel pushed segments around the ring with remote
// DMAs, 2 (W - 1) steps.  Here no step is needed: a thread reads every
// rank's value of its element, through device pointers (peer loads over
// NVLink when a rank lives on another card), folds them with __fadd_rn
// in the schedule's order, and stores the sum into every rank's output.
// So the result is the plain ring's, bit for bit, with no padded copy,
// no barrier and no intermediate write.  When the ranks share one card
// the single launch covers every element; across C cards each card's
// launch takes a contiguous 1/C share of the elements and writes its
// sums into every rank's output, its own and the peers' (remote stores
// over NVLink).  The host orders the launches with CUDA events: each
// card starts after every card's inputs are ready and its outputs
// allocated, and every card's stream waits for every launch to end, so
// no input is reused while a peer still reads it.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, NVLink 450 GB/s each
// way per card).  Ranks on one card: HBM bytes, every input read once
// and every output written once, 2 W B for W ranks of B bytes, which is
// exactly what this kernel moves.  Ranks on distinct cards: NVLink, the
// 2 (W - 1) / W B that any allreduce must bring into each card (here
// half as peer loads of the inputs, half as the peers' stores of their
// shares).  16-byte loads and stores in a grid-stride loop; a 4-element
// chunk whose elements fold in different orders (it straddles a row,
// half or segment edge) folds element by element.
//
// Built by nvcc into a shared library with a plain C interface and
// loaded with ctypes (oap_mllib_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxWorld = 16;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

struct RingArgs {
  const float* in[kMaxWorld];
  float* out[kMaxWorld];
  // order[dir][j][t]: the rank whose value the t-th fold of an element of
  // segment j adds (dir 0 clockwise, 1 counter-clockwise)
  unsigned char order[2][kMaxWorld][kMaxWorld];
  int world, cols, half, seg_rows, seg;
  int lo, hi;  // this launch's share of the flat elements, [lo, hi)
};

// dir * kMaxWorld + segment of the element at (row, col)
__device__ __forceinline__ int fold_class(int row, int col, const RingArgs& a) {
  return (col >= a.half) * kMaxWorld + (row % a.seg_rows) / a.seg;
}

__device__ __forceinline__ int fold_class(int e, const RingArgs& a) {
  const int row = e / a.cols;
  return fold_class(row, e - row * a.cols, a);
}

__device__ __forceinline__ float fold_one(int e, const RingArgs& a) {
  const unsigned char* o = &a.order[0][0][0] + fold_class(e, a) * kMaxWorld;
  float acc = a.in[o[0]][e];
  for (int t = 1; t < a.world; ++t) acc = __fadd_rn(a.in[o[t]][e], acc);
  return acc;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
ring_fold_kernel(const __grid_constant__ RingArgs a) {
  const int W = a.world;
  const int stride = gridDim.x * blockDim.x * 4;
  for (int e = a.lo + 4 * (blockIdx.x * blockDim.x + threadIdx.x); e < a.hi;
       e += stride) {
    const int row = e / a.cols;
    const int col = e - row * a.cols;
    if (VEC && e + 3 < a.hi && col + 3 < a.cols &&
        (col >= a.half || col + 3 < a.half)) {
      // one row and one half, so one segment: one fold order for all four
      const unsigned char* o =
          &a.order[0][0][0] + fold_class(row, col, a) * kMaxWorld;
      float4 v[kMaxWorld];
#pragma unroll
      for (int t = 0; t < kMaxWorld; ++t)
        if (t < W) v[t] = *reinterpret_cast<const float4*>(a.in[o[t]] + e);
      float4 acc = v[0];
#pragma unroll
      for (int t = 1; t < kMaxWorld; ++t) {
        if (t < W) {
          acc.x = __fadd_rn(v[t].x, acc.x);
          acc.y = __fadd_rn(v[t].y, acc.y);
          acc.z = __fadd_rn(v[t].z, acc.z);
          acc.w = __fadd_rn(v[t].w, acc.w);
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxWorld; ++r)
        if (r < W) *reinterpret_cast<float4*>(a.out[r] + e) = acc;
    } else {
      const int end = min(e + 4, a.hi);
      for (int f = e; f < end; ++f) {
        const float s = fold_one(f, a);
        for (int r = 0; r < W; ++r) a.out[r][f] = s;
      }
    }
  }
}

// The events that order one card's launch against the other cards'
// (before: inputs ready, outputs allocated; after: all folds stored),
// made once per device.  A wait takes the event's state when it is
// enqueued, so one event per device serves every ring.
cudaError_t card_events(int dev, cudaEvent_t** ev) {
  static cudaEvent_t events[64][2];
  static bool made[64];
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!made[dev]) {
    for (int k = 0; k < 2; ++k) {
      const cudaError_t err =
          cudaEventCreateWithFlags(&events[dev][k], cudaEventDisableTiming);
      if (err != cudaSuccess) return err;
    }
    made[dev] = true;
  }
  *ev = events[dev];
  return cudaSuccess;
}

// Every stream waits on every other card's event `k`, recorded now.
cudaError_t cross_wait(int cards, const int* devs, void* const* streams,
                       int k) {
  cudaEvent_t* ev[16];
  for (int c = 0; c < cards; ++c) {
    cudaError_t err = cudaSetDevice(devs[c]);
    if (err == cudaSuccess) err = card_events(devs[c], &ev[c]);
    if (err == cudaSuccess)
      err = cudaEventRecord(ev[c][k], static_cast<cudaStream_t>(streams[c]));
    if (err != cudaSuccess) return err;
  }
  for (int c = 0; c < cards; ++c) {
    cudaError_t err = cudaSetDevice(devs[c]);
    for (int o = 0; o < cards && err == cudaSuccess; ++o)
      if (o != c)
        err = cudaStreamWaitEvent(static_cast<cudaStream_t>(streams[c]),
                                  ev[o][k], 0);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Let `dev` read and write `peer`'s memory; an access already enabled is
// success.  Returns a cudaError_t.
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

// One ring of `world` (rows, cols) f32 row-major buffers: one launch on
// each of `cards` cards, card c (device devs[c], stream streams[c])
// folding the flat elements [los[c], his[c]).  `ptrs` holds the ranks'
// input pointers, then their output pointers (any card, peer access
// enabled), `order` the 2 * world * world bytes order[dir][segment][t];
// `cols`, `half` (first counter-clockwise column of the padded buffer),
// `seg_rows` (rows of a segment group) and `seg` (rows of a segment)
// place an element in its fold order.  `vec` allows 16-byte accesses
// (every pointer 16-byte aligned, every los[c] a multiple of 4).  With
// more than one card, every card's launch waits for every card's stream
// as it stands, and afterwards every card's stream waits for every
// launch.  Returns a cudaError_t (invalid value for a world or a card
// count out of range).
int ring_fold(int cards, const int* devs, void* const* streams,
              const int* los, const int* his, float* const* ptrs,
              const unsigned char* order, int world, int cols, int half,
              int seg_rows, int seg, int vec) {
  if (world < 1 || world > kMaxWorld || cards < 1 || cards > kMaxWorld)
    return cudaErrorInvalidValue;
  RingArgs a = {};
  for (int r = 0; r < world; ++r) {
    a.in[r] = ptrs[r];
    a.out[r] = ptrs[world + r];
  }
  for (int dir = 0; dir < 2; ++dir)
    for (int j = 0; j < world; ++j)
      for (int t = 0; t < world; ++t)
        a.order[dir][j][t] = order[(dir * world + j) * world + t];
  a.world = world;
  a.cols = cols;
  a.half = half;
  a.seg_rows = seg_rows;
  a.seg = seg;
  cudaError_t err = cudaSuccess;
  if (cards > 1 && (err = cross_wait(cards, devs, streams, 0)) != cudaSuccess)
    return err;
  for (int c = 0; c < cards; ++c) {
    if ((err = cudaSetDevice(devs[c])) != cudaSuccess) return err;
    a.lo = los[c];
    a.hi = his[c];
    const long long chunks = (static_cast<long long>(a.hi - a.lo) + 3) / 4;
    long long blocks = (chunks + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    if (blocks < 1) blocks = 1;
    cudaStream_t st = static_cast<cudaStream_t>(streams[c]);
    if (vec)
      ring_fold_kernel<true><<<static_cast<int>(blocks), kThreads, 0, st>>>(a);
    else
      ring_fold_kernel<false><<<static_cast<int>(blocks), kThreads, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (cards > 1) err = cross_wait(cards, devs, streams, 1);
  return err;
}

}  // extern "C"
