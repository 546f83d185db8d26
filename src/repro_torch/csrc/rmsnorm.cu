// Fused RMSNorm: out = x * rsqrt(mean(x^2) + eps) * scale per row of an
// [M, d] array, statistics in fp32, result in the input's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py: _rms_kernel
// (launched by fused_rmsnorm), which normalised blocks of 256 rows held in
// VMEM and needed M % 256 == 0.  Here one block of 256 threads owns one
// row: each thread sums the squares of its strided elements in fp32, a warp
// shuffle and a 8-slot shared-memory pass reduce them, and a second sweep
// over the row (hitting L1/L2, the row is 4 KB at d = 2048 in bf16) writes
// the output.  Any M is taken (one block a row, no ragged edge to mask) and
// any d.
//
// Bound: bytes.  The function reads x and scale once and writes the output
// once, a few operations per element: [4096, 2048] bf16 moves 33.6 MB, about
// 10 us at 3.35 TB/s.  One block a row gives thousands of blocks at prefill
// and a handful at decode (M = batch), where the launch itself sets the
// pace.
//
// dtypes: x (and out) and scale are each fp32 or bf16 (DT_F32 / DT_BF16);
// the model's scale is cast to its compute dtype, a test's may be fp32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename S>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const S* __restrict__ scale,
                               T* __restrict__ out, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  const T* row = x + (int64_t)blockIdx.x * d;
  T* orow = out + (int64_t)blockIdx.x * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float v = to_f32(row[c]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += partial[w];
  const float r = rsqrtf(total / (float)d + eps);
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const float y = to_f32(row[c]) * r;
    orow[c] = from_f32<T>(y * to_f32(scale[c]));
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long m, int d,
           float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, S><<<(unsigned)m, kThreads, 0, stream>>>(
      (const T*)x, (const S*)scale, (T*)out, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: contiguous [m, d]; scale: contiguous [d].  Launches on `stream`
// on the calling thread's current device; returns the launch's cudaError_t
// (0 on success).  m == 0 launches nothing.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              long long m, int d, float eps, int x_dtype,
                              int s_dtype, void* stream) {
  if (m <= 0) return 0;
  if (m > 0x7fffffffLL || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == DT_F32 && s_dtype == DT_F32)
    return launch<float, float>(x, scale, out, m, d, eps, s);
  if (x_dtype == DT_F32 && s_dtype == DT_BF16)
    return launch<float, __nv_bfloat16>(x, scale, out, m, d, eps, s);
  if (x_dtype == DT_BF16 && s_dtype == DT_F32)
    return launch<__nv_bfloat16, float>(x, scale, out, m, d, eps, s);
  if (x_dtype == DT_BF16 && s_dtype == DT_BF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, m, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
