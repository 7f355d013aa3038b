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
// (ring_kernel.fold_order) and passes it, with the ranks' pointers, in a
// small device table that it fills before the launch:
//   table[r]                      input of rank r
//   table[W + r]                  output of rank r
//   table[2 W + (dir W + j) W + t] rank of the t-th fold of segment j
// so the world is bounded by nothing in the kernel.
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

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kMaxCards = 64;

struct RingArgs {
  const long long* table;  // pointers and fold order, laid out as above
  int world, cols, half, seg_rows, seg;
  int lo, hi;  // this launch's share of the flat elements, [lo, hi)
};

__device__ __forceinline__ const float* in_ptr(const RingArgs& a, int r) {
  return reinterpret_cast<const float*>(__ldg(a.table + r));
}

__device__ __forceinline__ float* out_ptr(const RingArgs& a, int r) {
  return reinterpret_cast<float*>(__ldg(a.table + a.world + r));
}

// The fold order of the element at (row, col): its row of the table.
__device__ __forceinline__ const long long* fold_row(int row, int col,
                                                    const RingArgs& a) {
  const int cls = (col >= a.half) * a.world + (row % a.seg_rows) / a.seg;
  return a.table + 2 * a.world + (size_t)cls * a.world;
}

__device__ __forceinline__ float fold_one(int e, const RingArgs& a) {
  const int row = e / a.cols;
  const long long* o = fold_row(row, e - row * a.cols, a);
  float acc = in_ptr(a, (int)__ldg(o))[e];
  for (int t = 1; t < a.world; ++t)
    acc = __fadd_rn(in_ptr(a, (int)__ldg(o + t))[e], acc);
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
      // one row and one half, so one segment: one fold order for all four;
      // the loop runs `world` times, its loads independent of the adds
      const long long* o = fold_row(row, col, a);
      float4 acc = *reinterpret_cast<const float4*>(in_ptr(a, (int)__ldg(o)) + e);
#pragma unroll 4
      for (int t = 1; t < W; ++t) {
        const float4 v =
            *reinterpret_cast<const float4*>(in_ptr(a, (int)__ldg(o + t)) + e);
        acc.x = __fadd_rn(v.x, acc.x);
        acc.y = __fadd_rn(v.y, acc.y);
        acc.z = __fadd_rn(v.z, acc.z);
        acc.w = __fadd_rn(v.w, acc.w);
      }
      for (int r = 0; r < W; ++r)
        *reinterpret_cast<float4*>(out_ptr(a, r) + e) = acc;
    } else {
      const int end = min(e + 4, a.hi);
      for (int f = e; f < end; ++f) {
        const float s = fold_one(f, a);
        for (int r = 0; r < W; ++r) out_ptr(a, r)[f] = s;
      }
    }
  }
}

// The events that order one card's launch against the other cards'
// (before: inputs ready, outputs allocated; after: all folds stored),
// made once per device.  A wait takes the event's state when it is
// enqueued, so one event per device serves every ring.
cudaError_t card_events(int dev, cudaEvent_t** ev) {
  static cudaEvent_t events[kMaxCards][2];
  static bool made[kMaxCards];
  if (dev < 0 || dev >= kMaxCards) return cudaErrorInvalidDevice;
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
  cudaEvent_t* ev[kMaxCards];
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
// folding the flat elements [los[c], his[c]).  `tables[c]` is card c's
// copy of the table (inputs, outputs, fold order; see the top of this
// file), in that card's memory and filled on its stream; the pointers in
// it may be on any card, with peer access enabled.  `cols`, `half`
// (first counter-clockwise column of the padded buffer), `seg_rows`
// (rows of a segment group) and `seg` (rows of a segment) place an
// element in its fold order.  `vec` allows 16-byte accesses (every
// pointer 16-byte aligned, every los[c] a multiple of 4).  With more
// than one card, every card's launch waits for every card's stream as it
// stands, and afterwards every card's stream waits for every launch.
// Returns a cudaError_t (invalid value for an empty world or a card
// count out of range).
int ring_fold(int cards, const int* devs, void* const* streams,
              const int* los, const int* his, const long long* const* tables,
              int world, int cols, int half, int seg_rows, int seg, int vec) {
  if (world < 1 || cards < 1 || cards > kMaxCards) return cudaErrorInvalidValue;
  RingArgs a = {};
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
    a.table = tables[c];
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
