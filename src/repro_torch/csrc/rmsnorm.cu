// Fused RMSNorm: out = x * rsqrt(mean(x^2) + eps) * scale per row of an
// [M, d] array, statistics in fp32, result in the input's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py: _rms_kernel
// (launched by fused_rmsnorm), which normalised blocks of 256 rows held in
// VMEM and needed M % 256 == 0.  Any M and any d are taken here.
//
// Bound: bytes.  The function reads x and scale once and writes the output
// once, a few operations per element: [4096, 2048] bf16 moves 33.6 MB, about
// 10 us at 3.35 TB/s.  At decode (M = batch, a few rows) the launch itself
// sets the pace.
//
// Design.  One pass over device memory: a row is loaded into registers,
// reduced, and written from those registers, never read again.  A row
// takes `tpr` threads (a power of two, at most kMaxRowThreads), each
// holding NV units of the row at columns lane, lane + tpr, ...: the
// fewest threads that hold the row in one unit each, so a row of d 2048
// in bf16 is one 16-byte unit a thread of a 256-thread block and qk-norm's
// rows of 64-256 share a warp between several rows.  Where a row is at
// most two units a thread and M >= kRowsMinM, each thread holds
// kRowsPerThread rows at once (all loaded before any is reduced), so that
// enough bytes are in flight to keep device memory busy; at decode (a few
// rows) a thread holds one row, to spread them over the SMs.  A block
// takes one row group (a persistent grid looping over groups did not win
// in scripts/kernel_variants.py).  Each thread loads the scale of its
// columns once, in the scale's own dtype (registers are what limit the
// blocks an SM holds), and uses it for all its rows.  The sums of squares
// are reduced by warp shuffles within the row's lanes and, when a row
// spans warps, through shared memory, in a fixed order.
//
// Routes, chosen by the caller from the inputs before the launch: the
// vector route (vec = 1) moves 16-byte units (8 bf16 or 4 fp32 of x) and
// needs x, out and scale 16-byte aligned and d * sizeof(x) % 16 == 0; the
// scalar route (vec = 0) moves one element a unit and takes any alignment.
// A row longer than kMaxNV units a thread at kMaxRowThreads threads is not
// held in registers: it is read twice (NV = 0, the sum, then the output).
//
// dtypes: x (and out) and scale are each fp32 or bf16 (DT_F32 / DT_BF16);
// the model's scale is cast to its compute dtype, a test's may be fp32.
// The variants that chose these constants, and probes of the design, are
// in scripts/kernel_variants.py (timings in PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowThreads = 256;
constexpr int kRowsPerThread = 2;
constexpr long long kRowsMinM = 1024;
constexpr int kMaxNV = 8;

// VT elements of T that are loaded and stored as one unit (16 bytes on
// the vector route; a 32-byte unit of fp32 scale is two 16-byte loads)
template <typename T, int VT>
struct alignas(VT * sizeof(T) >= 16 ? 16 : VT * sizeof(T)) Unit {
  T e[VT];
};

template <typename T, int VT>
__device__ __forceinline__ Unit<T, VT> load_unit(const T* p) {
  return *reinterpret_cast<const Unit<T, VT>*>(p);
}

// the sums v[0..R) over the tpr lanes of each row (tpr a power of two, the
// same for the whole block); part: R x kThreads / 32 floats of shared
// memory
template <int R>
__device__ __forceinline__ void row_sums(float (&v)[R], int tpr,
                                         float (*part)[kThreads / 32]) {
  for (int off = (tpr < 32 ? tpr : 32) >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] += __shfl_xor_sync(0xffffffffu, v[r], off);
  }
  if (tpr <= 32) return;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) part[r][threadIdx.x >> 5] = v[r];
  }
  __syncthreads();
  const int warps = tpr >> 5;
  const int first = (threadIdx.x / tpr) * warps;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += part[r][first + w];
    v[r] = t;
  }
}

// The units of a row group at `base` that this thread holds: rows
// base + grp + r * rows for r < R, columns lane + i * tpr for i < NV.
template <typename T, int VT, int NV, int R>
__device__ __forceinline__ void load_rows(const T* __restrict__ x,
                                          long long base, long long m, int d,
                                          int rows, int grp, int lane,
                                          int tpr, Unit<T, VT> (&v)[R][NV]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = base + grp + (long long)r * rows;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + i * tpr;
      if (row < m && c < d / VT) v[r][i] = load_unit<T, VT>(x + row * d + c * VT);
    }
  }
}

// A block normalises one row group of rows * R rows: group g (tpr
// threads) holds rows base + g + r * rows for r < R, all loaded before any
// is reduced, so that R 16-byte loads a thread are in flight at once.
// NV = 0: rows too long for registers, read twice (the sum, then the
// output), R = 1.
template <typename T, typename S, int VT, int NV, int R>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, long long m, int d, int tpr, float eps) {
  __shared__ float part[R][kThreads / 32];
  const int units = d / VT;
  const int rows = kThreads / tpr;
  const int lane = threadIdx.x & (tpr - 1);
  const int grp = threadIdx.x / tpr;

  // every thread of the block runs to the end (rows past m are masked), so
  // the shuffles and the barrier of row_sums see the whole block
  if constexpr (NV > 0) {
    // the scale of this thread's columns, in its own dtype, for all R rows
    Unit<S, VT> sc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + i * tpr;
      if (c < units) sc[i] = load_unit<S, VT>(scale + c * VT);
    }
    const long long base = (long long)blockIdx.x * rows * R;
    Unit<T, VT> v[R][NV];
    load_rows<T, VT, NV, R>(x, base, m, d, rows, grp, lane, tpr, v);
    float ss[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + grp + (long long)r * rows;
      ss[r] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (row < m && lane + i * tpr < units) {
#pragma unroll
          for (int j = 0; j < VT; ++j) {
            const float f = to_f32(v[r][i].e[j]);
            ss[r] = fmaf(f, f, ss[r]);
          }
        }
      }
    }
    row_sums<R>(ss, tpr, part);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + grp + (long long)r * rows;
      const float rs = rsqrtf(ss[r] / (float)d + eps);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + i * tpr;
        if (row < m && c < units) {
          Unit<T, VT> o;
#pragma unroll
          for (int j = 0; j < VT; ++j)
            o.e[j] = from_f32<T>(to_f32(v[r][i].e[j]) * rs *
                                 to_f32(sc[i].e[j]));
          *reinterpret_cast<Unit<T, VT>*>(out + row * d + c * VT) = o;
        }
      }
    }
  } else {
    const long long row = (long long)blockIdx.x * rows + grp;
    const bool active = row < m;
    const T* xr = x + row * d;
    float ss[1] = {0.f};
    for (int c = lane; active && c < units; c += tpr) {
      const Unit<T, VT> v = load_unit<T, VT>(xr + c * VT);
#pragma unroll
      for (int j = 0; j < VT; ++j) {
        const float f = to_f32(v.e[j]);
        ss[0] = fmaf(f, f, ss[0]);
      }
    }
    row_sums<1>(ss, tpr, part);
    const float rs = rsqrtf(ss[0] / (float)d + eps);
    for (int c = lane; active && c < units; c += tpr) {
      const Unit<T, VT> v = load_unit<T, VT>(xr + c * VT);
      const Unit<S, VT> s = load_unit<S, VT>(scale + c * VT);
      Unit<T, VT> o;
#pragma unroll
      for (int j = 0; j < VT; ++j)
        o.e[j] = from_f32<T>(to_f32(v.e[j]) * rs * to_f32(s.e[j]));
      *reinterpret_cast<Unit<T, VT>*>(out + row * d + c * VT) = o;
    }
  }
}

template <typename T, typename S, int VT, int NV, int R>
int launch(const void* x, const void* scale, void* out, long long m, int d,
           int tpr, float eps, cudaStream_t stream) {
  const long long rows = (long long)(kThreads / tpr) * R;
  const long long grid = (m + rows - 1) / rows;
  rmsnorm_kernel<T, S, VT, NV, R><<<(unsigned)grid, kThreads, 0, stream>>>(
      (const T*)x, (const S*)scale, (T*)out, m, d, tpr, eps);
  return (int)cudaGetLastError();
}

// several rows a thread only where rows are short enough to hold R of
// them in registers and M is large enough to fill the card
template <typename T, typename S, int VT, int NV>
int launch_rows(const void* x, const void* scale, void* out, long long m,
                int d, int tpr, float eps, cudaStream_t stream) {
  if (VT > 1 && NV <= 2 && m >= kRowsMinM)
    return launch<T, S, VT, NV, kRowsPerThread>(x, scale, out, m, d, tpr,
                                                eps, stream);
  return launch<T, S, VT, NV, 1>(x, scale, out, m, d, tpr, eps, stream);
}

template <typename T, typename S, int VT>
int launch_units(const void* x, const void* scale, void* out, long long m,
                 int d, float eps, cudaStream_t stream) {
  const int units = d / VT;
  int tpr = 1;
  while (tpr < units && tpr < kMaxRowThreads) tpr <<= 1;
  const int nv = (units + tpr - 1) / tpr;
  if (nv <= 1)
    return launch_rows<T, S, VT, 1>(x, scale, out, m, d, tpr, eps, stream);
  if (nv <= 2)
    return launch_rows<T, S, VT, 2>(x, scale, out, m, d, tpr, eps, stream);
  if (nv <= 4)
    return launch<T, S, VT, 4, 1>(x, scale, out, m, d, tpr, eps, stream);
  if (nv <= kMaxNV)
    return launch<T, S, VT, kMaxNV, 1>(x, scale, out, m, d, tpr, eps,
                                       stream);
  return launch<T, S, VT, 0, 1>(x, scale, out, m, d, tpr, eps, stream);
}

template <typename T, typename S>
int launch_route(const void* x, const void* scale, void* out, long long m,
                 int d, float eps, int vec, cudaStream_t stream) {
  constexpr int VT = 16 / sizeof(T);
  if (!vec) return launch_units<T, S, 1>(x, scale, out, m, d, eps, stream);
  if ((((uintptr_t)x | (uintptr_t)scale | (uintptr_t)out) & 15) ||
      d % VT != 0)
    return (int)cudaErrorInvalidValue;
  return launch_units<T, S, VT>(x, scale, out, m, d, eps, stream);
}

}  // namespace

// x, out: contiguous [m, d]; scale: contiguous [d].  vec = 1 takes the
// 16-byte route (refused with cudaErrorInvalidValue unless x, scale and
// out are 16-byte aligned and d * sizeof(x) % 16 == 0), vec = 0 the
// scalar one.  Launches on `stream` on the calling thread's current
// device; returns the launch's cudaError_t (0 on success).  m == 0
// launches nothing.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              long long m, int d, float eps, int x_dtype,
                              int s_dtype, int vec, void* stream) {
  if (m <= 0) return 0;
  if (m > 0x7fffffffLL || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == DT_F32 && s_dtype == DT_F32)
    return launch_route<float, float>(x, scale, out, m, d, eps, vec, s);
  if (x_dtype == DT_F32 && s_dtype == DT_BF16)
    return launch_route<float, bf16>(x, scale, out, m, d, eps, vec, s);
  if (x_dtype == DT_BF16 && s_dtype == DT_F32)
    return launch_route<bf16, float>(x, scale, out, m, d, eps, vec, s);
  if (x_dtype == DT_BF16 && s_dtype == DT_BF16)
    return launch_route<bf16, bf16>(x, scale, out, m, d, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}
