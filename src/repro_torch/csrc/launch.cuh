// Host-side launch facts shared by the port's kernels (fused_ffn.cu,
// flash_attention.cu, mla_decode.cu), computed once per device and kernel
// instead of once per launch: the dynamic shared-memory attribute a kernel
// needs above 48 KB (cudaFuncSetAttribute holds in the device's context),
// the blocks of it an SM holds at once, and the device's SM count.  The
// table is guarded by a mutex, so threads that launch at once (the plan
// server's search workers) set each attribute once.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

struct KernelFacts {
  int sms;     // SMs of the current device
  int per_sm;  // blocks of the kernel an SM holds at `smem` bytes
};

// The facts of `kernel` launched with `threads` threads and `smem` bytes of
// dynamic shared memory on the calling thread's current device; the
// attribute is set the first time.  Returns a cudaError_t.
static inline int kernel_facts(const void* kernel, int threads, size_t smem,
                               KernelFacts* out) {
  struct Entry {
    const void* kernel;
    int device, threads;
    size_t smem;
    KernelFacts facts;
  };
  static std::mutex mu;
  static std::vector<Entry> table;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& en : table)
    if (en.kernel == kernel && en.device == dev && en.threads == threads &&
        en.smem == smem) {
      *out = en.facts;
      return 0;
    }
  Entry en{kernel, dev, threads, smem, {0, 0}};
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&en.facts.sms,
                                  cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &en.facts.per_sm, kernel, threads, smem)) != cudaSuccess)
    return (int)e;
  if (en.facts.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  table.push_back(en);
  *out = en.facts;
  return 0;
}
