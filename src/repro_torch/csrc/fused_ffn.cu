// Fused SwiGLU FFN: out[M, d] = (silu(x @ Wg) * (x @ Wi)) @ Wo, with the
// [M, f] hidden activation never written to device memory.
//
// Replaces the TPU kernel src/repro/kernels/fused_ffn.py: _ffn_kernel
// (launched by fused_swiglu).  On the TPU the grid (M/256, f/512) ran its f
// axis in order on one core and carried a [256, d] fp32 accumulator in VMEM
// (2 MB at d = 2048).  A Hopper block has at most 227 KB of shared memory,
// and blocks run in parallel in no order, so that carry cannot exist here.
//
// Design: a grid over (M tiles of 64 rows, f tiles of 128 columns), so even
// decode (M = batch <= 8) has f / 128 = 44 blocks at tinyllama's width
// instead of one.  Each block
//   1. computes G = x[64, d] @ Wg[d, 128] and U = x @ Wi[d, 128] in
//      32-deep k steps through shared memory (fp32 accumulators in
//      registers, 8 warps of 32 x 32 each),
//   2. forms the hidden tile H = silu(G) * U in fp32 and keeps it in shared
//      memory (as the compute dtype: the tensor cores take bf16 operands),
//   3. multiplies H by Wo[128 rows of this f tile, d] in 128-column chunks
//      and writes its fp32 partial [64, d] to a workspace slice of its own.
// A second kernel sums the f / 128 partials of each output element in a
// fixed order and casts, so the result is deterministic (no atomics).
//
// Bound: operations at prefill, bytes at decode.  At M = 4096, d = 2048,
// f = 5632 the three products are 283 GFLOP, 0.29 ms at 989 TFLOP/s bf16;
// at M = 8 the 69 MB of bf16 weights take 21 us at 3.35 TB/s.  This first
// version is far from both: warp-level mma.sync (tile_mma.cuh) fed by plain
// loads, no cp.async/TMA pipelining, and the fp32 partials cost 2 * (f/128)
// * M * d * 4 bytes of traffic (1.5 GB each way at M = 4096).  The fp32
// route (scalar FMAs) exists for checking against fp32 references.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int BM = 64, BF = 128, BK = 32, BN = 128, PAD = 8;
constexpr int kThreads = 256;
constexpr int LDX = BK + PAD, LDW = BF + PAD, LDH = BF + PAD, LDO = BN + PAD;
constexpr int kX = BM * LDX, kW = BK * LDW, kH = BM * LDH, kO = BF * LDO;

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)(kX + 2 * kW + kH + kO) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ffn_kernel(const T* __restrict__ x, const T* __restrict__ wg,
               const T* __restrict__ wi, const T* __restrict__ wo,
               float* __restrict__ partial, int M, int d, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);
  T* Gs = Xs + kX;
  T* Us = Gs + kW;
  T* Hs = Us + kW;
  T* Os = Hs + kH;
  const T zero = from_f32<T>(0.f);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  const int m0 = blockIdx.x * BM, f0 = blockIdx.y * BF;

  // 1. G and U over the whole depth d
  float ag[2][4][4], au[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) ag[i][j][c] = au[i][j][c] = 0.f;
  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK, m = m0 + r, k = k0 + c;
      Xs[r * LDX + c] = (m < M && k < d) ? x[(int64_t)m * d + k] : zero;
    }
    for (int e = tid; e < BK * BF; e += kThreads) {
      const int r = e / BF, c = e % BF, k = k0 + r, f = f0 + c;
      const bool ok = k < d && f < F;
      const int64_t off = (int64_t)k * F + f;
      Gs[r * LDW + c] = ok ? wg[off] : zero;
      Us[r * LDW + c] = ok ? wi[off] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* a = Xs + (32 * wm + 16 * i) * LDX + kk;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 32 * wn + 8 * j;
          mma_tile<T>(ag[i][j], a, LDX, Gs + kk * LDW + col, LDW, 1);
          mma_tile<T>(au[i][j], a, LDX, Us + kk * LDW + col, LDW, 1);
        }
      }
    __syncthreads();
  }

  // 2. the hidden tile, kept on chip
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float g = ag[i][j][c];
        const float h = g / (1.f + expf(-g)) * au[i][j][c];
        const int r = 32 * wm + 16 * i + frag_row(c);
        const int col = 32 * wn + 8 * j + frag_col(c);
        Hs[r * LDH + col] = from_f32<T>(h);
      }
  __syncthreads();

  // 3. this f tile's share of the output, chunk by chunk of d
  float* pout = partial + (int64_t)blockIdx.y * M * d;
  for (int n0 = 0; n0 < d; n0 += BN) {
    for (int e = tid; e < BF * BN; e += kThreads) {
      const int r = e / BN, c = e % BN, f = f0 + r, n = n0 + c;
      Os[r * LDO + c] = (f < F && n < d) ? wo[(int64_t)f * d + n] : zero;
    }
    __syncthreads();
    float ao[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) ao[i][j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BF; kk += 16)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* a = Hs + (32 * wm + 16 * i) * LDH + kk;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tile<T>(ao[i][j], a, LDH, Os + kk * LDO + 32 * wn + 8 * j, LDO,
                      1);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int m = m0 + 32 * wm + 16 * i + frag_row(c);
          const int n = n0 + 32 * wn + 8 * j + frag_col(c);
          if (m < M && n < d) pout[(int64_t)m * d + n] = ao[i][j][c];
        }
    __syncthreads();
  }
}

// out[i] = sum over the splits of partial[s][i], in split order
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ partial,
                                  T* __restrict__ out, int64_t n,
                                  int splits) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[(int64_t)p * n + i];
    out[i] = from_f32<T>(s);
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wi, const void* wo,
           void* out, void* partial, long long m, int d, int f,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int splits = (f + BF - 1) / BF;
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)splits);
  ffn_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)x, (const T*)wg, (const T*)wi, (const T*)wo, (float*)partial,
      (int)m, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)m * d;
  long long blocks = (n + 255) / 256;
  if (blocks > (1LL << 16)) blocks = 1LL << 16;
  ffn_reduce_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      (const float*)partial, (T*)out, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Slices of the fp32 workspace a launch needs for d_ff = f: the caller
// allocates fused_ffn_splits(f) * m * d floats and passes them as
// `partial`.
extern "C" int fused_ffn_splits(int f) { return (f + BF - 1) / BF; }

// x: contiguous [m, d]; wg, wi: contiguous [d, f]; wo: contiguous [f, d];
// out: contiguous [m, d]; all of one dtype (DT_F32 or DT_BF16).  Two
// launches on `stream` (the fused kernel, then the fixed-order sum) on the
// calling thread's current device; returns the first non-zero cudaError_t,
// else 0.  m == 0 launches nothing.
extern "C" int fused_ffn_launch(const void* x, const void* wg, const void* wi,
                                const void* wo, void* out, void* partial,
                                long long m, int d, int f, int dtype,
                                void* stream) {
  if (m <= 0) return 0;
  if (m > 0x7fffffffLL || d <= 0 || f <= 0 || (f + BF - 1) / BF > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(x, wg, wi, wo, out, partial, m, d, f, s);
  if (dtype == DT_F32)
    return launch<float>(x, wg, wi, wo, out, partial, m, d, f, s);
  return (int)cudaErrorInvalidValue;
}
