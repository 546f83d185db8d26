// Batched finish_cost arithmetic: one elementwise pass over a GA
// generation's distinct (structure, hardware point) queries.
//
// Replaces the TPU kernel src/repro/kernels/finish_batch.py:
// _stream_blocks_kernel (launched by _finish_pallas).  That kernel computed
// only the streaming-block lanes (n_blocks, wr * n_blocks, min(fp, glb));
// the mask algebra (_finish_masks) and the NoC lane (_noc_bytes) were
// separate jnp ops around it.  On the GPU each of those would be a launch
// of its own, so this kernel computes all nine outputs in one pass.
//
// Layout: `in` is a contiguous [7, n] int64 array whose rows are
// fp, w_total, single, glb, wbuf, shared, share (the two masks as 0/1);
// `out` is a contiguous [9, n] int64 array whose rows are wr, n_blocks,
// ema_w, fp_out, noc, infeasible_buf, w_overflow, stream, feasible.
//
// Bound: the function must move 86 bytes per lane (42 in: five int64 and
// two one-byte masks; 44 out: five int64 and four masks) and does a few
// integer operations and one float64 division per lane, so it is bound by
// bytes: about 26 ns at 3.35 TB/s for a generation of 1,024 lanes.  At the
// planner's batch sizes (~10^2 lanes) it is bound by the launch itself,
// and what surrounds it sets the pace: the lanes start and end in host
// memory.  The design is a simple grid-stride loop, one thread per lane,
// 256 threads per block; no shared memory, wgmma or TMA applies to this
// work.
//
// Zero copy: `in` and `out` may be pinned host memory, passed as the
// device pointers that finish_batch_device_ptr returns for them (the H100
// reads and writes host memory through unified addressing), so a batch is
// one launch and one finish_batch_sync, with no copy and no device
// allocation.  The same kernel runs on device buffers (finish_lanes on
// CUDA tensors).
//
// Bit-exactness with the scalar Python kernel (math.ceil(fp / glb)):
// the engine's guards (needs_scalar_fallback) keep fp < 2**31 and
// glb < 2**53, so both convert to double exactly; __ddiv_rn is the
// correctly rounded IEEE division Python performs, whatever the compiler
// flags, and ceil of a double is exact.  w_total / share is C truncation,
// which equals Python's floor division because both are non-negative.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 16;

__global__ void finish_batch_kernel(const int64_t* __restrict__ in,
                                    int64_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t fp = in[i];
    const int64_t w_total = in[n + i];
    const bool single = in[2 * n + i] != 0;
    const int64_t glb = in[3 * n + i];
    const int64_t wbuf = in[4 * n + i];
    const bool shared = in[5 * n + i] != 0;
    const int64_t share = in[6 * n + i];

    const int64_t wr = w_total / share;
    const double q = __ddiv_rn(__ll2double_rn(fp),
                               __ll2double_rn(glb > 1 ? glb : 1));
    int64_t n_blocks = __double2ll_rz(ceil(q));
    if (n_blocks < 1) n_blocks = 1;

    const int64_t wbuf_cap = shared ? glb : wbuf;
    const bool overflow = shared ? (fp + wr > glb) : (fp > glb);
    const bool infeasible_buf = overflow && !single;
    const bool stream = overflow && single;
    const int64_t ema_w = stream ? wr * n_blocks : w_total;
    const int64_t fp_out = stream ? (fp < glb ? fp : glb) : fp;
    const bool w_overflow =
        !shared && !single && !infeasible_buf && (wr > wbuf_cap);
    const bool feasible = !(infeasible_buf || w_overflow);

    out[i] = wr;
    out[n + i] = n_blocks;
    out[2 * n + i] = ema_w;
    out[3 * n + i] = fp_out;
    out[4 * n + i] = (share - 1) * ema_w;
    out[5 * n + i] = infeasible_buf;
    out[6 * n + i] = w_overflow;
    out[7 * n + i] = stream;
    out[8 * n + i] = feasible;
  }
}

}  // namespace

// Launch on `stream`, on the calling thread's current device (the caller
// makes it the device that holds `in` and `out`); returns the launch's
// cudaError_t (0 on success).  n == 0 launches nothing.
extern "C" int finish_batch_launch(const void* in, void* out, long long n,
                                   void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  finish_batch_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int64_t*)in, (int64_t*)out, (int64_t)n);
  return (int)cudaGetLastError();
}

// The device pointer through which kernels on the current device reach the
// host allocation at `host` (pinned memory is mapped under unified
// addressing); cudaErrorInvalidValue if `host` is not mapped host memory.
// cudaFree(nullptr) first makes the current device's primary context
// current on the calling thread: a thread that has made no CUDA call yet
// (its pinned buffers came from torch's cache) has none, and without one
// cudaPointerGetAttributes gives no device pointer.
extern "C" int finish_batch_device_ptr(const void* host, void** dev) {
  cudaError_t err = cudaFree(nullptr);
  if (err != cudaSuccess) return (int)err;
  cudaPointerAttributes attr;
  err = cudaPointerGetAttributes(&attr, host);
  if (err != cudaSuccess) return (int)err;
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return (int)cudaErrorInvalidValue;
  *dev = attr.devicePointer;
  return 0;
}

// Wait for `stream`; returns its cudaError_t (a fault in the kernel shows
// here).
extern "C" int finish_batch_sync(void* stream) {
  return (int)cudaStreamSynchronize((cudaStream_t)stream);
}
