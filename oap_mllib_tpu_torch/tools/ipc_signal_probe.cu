// Probe of the signals that order two processes around K5 across
// processes: a ping-pong of `rounds` rounds between two processes, each
// holding the other's word through CUDA IPC, by one of four mechanisms:
//   0  stream memory operations: cuStreamWriteValue32 to the peer's
//      word, cuStreamWaitValue32 on one's own (csrc/stream_memops.cuh);
//   1  one kernel for every round: st.release.sys to the peer, a bounded
//      spin of ld.acquire.sys on one's own word;
//   2  as 1, one launch a round;
//   3  a one-thread kernel's st.release.sys to the peer, then
//      cuStreamWaitValue32 on one's own word.
// Process 0 signals first and waits; process 1 waits, then answers.
// Every run starts from zeroed words; round i writes base + i.  A spin gives up
// after `limit_ns` (and counts a timeout); the host gives up on a run
// after `deadline_s`, then writes its own word past every value so its
// stream drains.  Built into a shared library and driven by
// tools/ipc_signal_probe.py.

#include <cuda_runtime.h>

#include <chrono>
#include <cstring>

#include "../csrc/stream_memops.cuh"

namespace {

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Rounds [first, last] of the ping-pong in one thread; gives up (and
// counts a timeout) when a wait passes limit_ns, and does nothing once a
// timeout was counted.
__global__ void pingpong_kernel(unsigned* peer, const unsigned* own, int role, unsigned first,
                                unsigned last, long long limit_ns, int* timeouts) {
  if (*(volatile int*)timeouts) return;
  for (unsigned v = first; v <= last; ++v) {
    if (role == 0) store_release(peer, v);
    const unsigned long long t0 = now_ns();
    while (load_acquire(own) < v) {
      if ((long long)(now_ns() - t0) > limit_ns) {
        atomicAdd(timeouts, 1);
        return;
      }
    }
    if (role == 1) store_release(peer, v);
  }
}

__global__ void signal_kernel(unsigned* peer, unsigned v) { store_release(peer, v); }

int enqueue(cudaStream_t st, int mech, int role, int rounds, unsigned base, unsigned* peer,
            unsigned* own, long long limit_ns, int* timeouts) {
  if (mech == 1) {
    pingpong_kernel<<<1, 1, 0, st>>>(peer, own, role, base + 1, base + rounds, limit_ns,
                                     timeouts);
    return cudaGetLastError();
  }
  for (int i = 1; i <= rounds; ++i) {
    const unsigned v = base + i;
    const unsigned long long p = reinterpret_cast<unsigned long long>(peer);
    const unsigned long long o = reinterpret_cast<unsigned long long>(own);
    int err = 0;
    if (mech == 2) {
      pingpong_kernel<<<1, 1, 0, st>>>(peer, own, role, v, v, limit_ns, timeouts);
      err = cudaGetLastError();
    } else if (mech == 0) {
      if (role == 0) err = memops::write_all(st, 1, &p, v);
      if (!err) err = memops::wait_all(st, 1, &o, v);
      if (!err && role == 1) err = memops::write_all(st, 1, &p, v);
    } else if (mech == 3) {
      if (role == 0) {
        signal_kernel<<<1, 1, 0, st>>>(peer, v);
        err = cudaGetLastError();
      }
      if (!err) err = memops::wait_all(st, 1, &o, v);
      if (!err && role == 1) {
        signal_kernel<<<1, 1, 0, st>>>(peer, v);
        err = cudaGetLastError();
      }
    } else {
      return cudaErrorInvalidValue;
    }
    if (err) return err;
  }
  return 0;
}

}  // namespace

extern "C" {

// A zeroed buffer of `bytes` on `dev` for the peer to map, and its handle.
int probe_alloc(int dev, long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaSetDevice(dev);
  if (!err) err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (!err) err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (!err) err = cudaDeviceSynchronize();
  if (!err) err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return err;
}

int probe_open(int dev, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(dev);
  if (err) return err;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// Zero this process's word (no run is in flight).
int probe_zero(int dev, void* word) {
  cudaError_t err = cudaSetDevice(dev);
  if (!err) err = cudaMemset(word, 0, sizeof(unsigned));
  if (!err) err = cudaDeviceSynchronize();
  return err;
}

// The card's stream-memory-operation and preemption attributes:
// out[0] 64-bit stream memory operations, out[1] wait NOR, out[2] flush
// of remote writes, out[3] compute preemption; -1 where unread.
int probe_attrs(int dev, int* out) {
  typedef CUresult (*AttrFn)(int*, CUdevice_attribute, CUdevice);
  AttrFn attr = nullptr;
  const cudaError_t err = memops::entry("cuDeviceGetAttribute", reinterpret_cast<void**>(&attr));
  const CUdevice_attribute which[4] = {CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS,
                                       CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_WAIT_VALUE_NOR,
                                       CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES,
                                       CU_DEVICE_ATTRIBUTE_COMPUTE_PREEMPTION_SUPPORTED};
  for (int i = 0; i < 4; ++i) {
    out[i] = -1;
    if (!err && attr(&out[i], which[i], dev) != CUDA_SUCCESS) out[i] = -1;
  }
  return err;
}

// One run of the ping-pong on a stream of its own: `*ms` the stream's
// time from before the first round to after the last, `*timeouts` the
// spins that gave up, `*stalled` 1 when the host gave up after
// `deadline_s`.  Returns a cudaError_t or CUresult.
int probe_run(int dev, int mech, int role, int rounds, unsigned base, void* peer, void* own,
              long long limit_ns, double deadline_s, float* ms, int* timeouts, int* stalled) {
  cudaError_t err = cudaSetDevice(dev);
  if (err) return err;
  cudaStream_t st, side;
  cudaEvent_t t0, t1;
  int* count = nullptr;
  *stalled = 0;
  *timeouts = 0;
  if ((err = cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking))) return err;
  if ((err = cudaStreamCreateWithFlags(&side, cudaStreamNonBlocking))) return err;
  if ((err = cudaEventCreate(&t0)) || (err = cudaEventCreate(&t1))) return err;
  if ((err = cudaMalloc(&count, sizeof(int)))) return err;
  if ((err = cudaMemset(count, 0, sizeof(int))) || (err = cudaDeviceSynchronize())) return err;
  cudaEventRecord(t0, st);
  int rc = enqueue(st, mech, role, rounds, base, static_cast<unsigned*>(peer),
                   static_cast<unsigned*>(own), limit_ns, count);
  cudaEventRecord(t1, st);
  const auto start = std::chrono::steady_clock::now();
  while ((err = cudaEventQuery(t1)) == cudaErrorNotReady) {
    const double waited =
        std::chrono::duration<double>(std::chrono::steady_clock::now() - start).count();
    if (waited > deadline_s && !*stalled) {
      // release this process's waits: its own word past every value
      *stalled = 1;
      const unsigned past = 0xFFFFFFF0u;
      cudaMemcpyAsync(own, &past, sizeof(past), cudaMemcpyHostToDevice, side);
      cudaStreamSynchronize(side);
    }
  }
  if (!rc) rc = err;
  if (!rc) rc = cudaEventElapsedTime(ms, t0, t1);
  if (!rc) rc = cudaMemcpy(timeouts, count, sizeof(int), cudaMemcpyDeviceToHost);
  cudaFree(count);
  cudaEventDestroy(t0);
  cudaEventDestroy(t1);
  cudaStreamDestroy(st);
  cudaStreamDestroy(side);
  return rc;
}

}  // extern "C"
