// Stream memory operations for libraries that link cudart statically:
// cuStreamWriteValue32 and cuStreamWaitValue32, taken from the driver
// through the runtime's entry-point query (the .so files do not link
// libcuda), resolved once per process.
//
// A write is an operation of the stream: it runs when the work queued
// before it has ended, and with the default flags it is preceded by a
// memory barrier (the stream's earlier writes are visible before the
// word is).  A wait holds the stream's later work until the word is at
// least the value; it is not a kernel, so it holds no SM while it waits,
// and a context that waits does not keep another context that shares the
// card from running.  Used by ring_reduce.cu (K5 across processes) and
// tools/ipc_signal_probe.cu.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace memops {

typedef CUresult (*ValueFn)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);

struct Fns {
  ValueFn write = nullptr;
  ValueFn wait = nullptr;
  cudaError_t err = cudaSuccess;  // why the functions are missing, if they are
};

inline cudaError_t entry(const char* name, void** fn) {
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(name, fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &found);
#endif
  if (err == cudaSuccess && (found != cudaDriverEntryPointSuccess || *fn == nullptr))
    err = cudaErrorSymbolNotFound;
  if (err != cudaSuccess) cudaGetLastError();  // not left as the runtime's last error
  return err;
}

inline Fns load() {
  Fns f;
  f.err = entry("cuStreamWriteValue32", reinterpret_cast<void**>(&f.write));
  if (f.err == cudaSuccess)
    f.err = entry("cuStreamWaitValue32", reinterpret_cast<void**>(&f.wait));
  return f;
}

// The resolved functions (f.err says why they are missing).
inline const Fns& fns() {
  static const Fns f = load();
  return f;
}

// `value` to each of the `n` words at addrs[i] on `stream`, each write
// after a memory barrier.  Returns 0, a CUresult, or a cudaError_t when
// the functions are missing.
inline int write_all(cudaStream_t stream, int n, const unsigned long long* addrs,
                     unsigned value) {
  const Fns& f = fns();
  if (f.err != cudaSuccess) return f.err;
  for (int i = 0; i < n; ++i) {
    const CUresult r = f.write(reinterpret_cast<CUstream>(stream), addrs[i], value,
                               CU_STREAM_WRITE_VALUE_DEFAULT);
    if (r != CUDA_SUCCESS) return r;
  }
  return 0;
}

// Hold `stream` until each of the `n` words at addrs[i] is >= `least`
// (unsigned).  Returns as write_all.
inline int wait_all(cudaStream_t stream, int n, const unsigned long long* addrs,
                    unsigned least) {
  const Fns& f = fns();
  if (f.err != cudaSuccess) return f.err;
  for (int i = 0; i < n; ++i) {
    const CUresult r = f.wait(reinterpret_cast<CUstream>(stream), addrs[i], least,
                              CU_STREAM_WAIT_VALUE_GEQ);
    if (r != CUDA_SUCCESS) return r;
  }
  return 0;
}

}  // namespace memops
