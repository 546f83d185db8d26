// Flash attention: causal / sliding-window attention with an fp32 online
// softmax, reading GQA keys and values where they lie.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py: _attn_kernel
// (launched by flash_attention).  That kernel ran the grid (B*H, S/128,
// S/128) with the kv axis in order on one core, carrying (acc, m, l) in VMEM
// scratch across kv steps, and needed S % 128 == 0 and q, k, v of one head
// count.  Here one block of 4 warps owns (batch * head, 64 queries) and
// loops over the live 64-key tiles itself, so the carry lives in registers:
// each warp holds 16 query rows, their fp32 output accumulator (16 x d in
// the m16n8 fragment layout) and the running max and sum of its rows.
//
// Per kv tile: K and V are staged in shared memory; S = Q K^T by warp-level
// mma.sync (tile_mma.cuh), scaled, masked (causal, window, and keys past a
// ragged S) to -1e30 as the TPU kernel does; the row max is reduced over
// the 4 lanes that share a row; P = exp(S - m) goes through a per-warp
// shared tile into the P V product.  Tiles wholly above the diagonal or left
// of the window are never loaded.  Output: acc / max(l, 1e-30), cast to
// q's dtype, so a fully masked row gives 0 as the reference's NaN -> 0.
//
// Layout: q, o are [B, H, S, d] and k, v [B, Hkv, S, d] by strides (the last
// dim contiguous), so the model's [B, S, H, d] tensors are read and written
// in place, and query head h reads kv head h / (H / Hkv) (the reference's
// head order h = kv_head * G + g), with no copy of k or v per query head.
//
// Bound: bytes at the serving shapes.  At B = 8, H = 32, Hkv = 4, S = 512,
// d = 64 the function must move 37.7 MB (q, k, v and o once, bf16), 11 us at
// 3.35 TB/s, against 8.6 GFLOP of causal products (8.7 us at 989 TFLOP/s).
// This first version reloads K and V per 64-query tile and feeds the tensor
// cores with plain loads, so it is far from that bound.  The depth loops
// stay rolled (#pragma unroll 1): unrolled, the ten (dtype, d) variants
// took ~100 s to build.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, PAD = 8;
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int LDP = BKV + PAD;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hkv, S, causal, window;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];  // strides of b, h, s (elements)
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)((BQ + 2 * BKV) * (D + PAD) + kWarps * 16 * LDP) *
         sizeof(T);
}

__device__ __forceinline__ bool live(int q, int kv, int S, int causal,
                                     int window) {
  return kv < S && (!causal || kv <= q) && (!window || kv > q - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_kernel(Args a) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BKV * LD;
  const int tid = threadIdx.x, warp = tid >> 5;
  T* Pw = Vs + BKV * LD + warp * 16 * LDP;
  const T zero = from_f32<T>(0.f);
  const int S = a.S;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kh = h / (a.H / a.Hkv);
  const int q0 = blockIdx.y * BQ;
  const T* q = (const T*)a.q + b * a.qs[0] + h * a.qs[1];
  const T* k = (const T*)a.k + b * a.ks[0] + kh * a.ks[1];
  const T* v = (const T*)a.v + b * a.vs[0] + kh * a.vs[1];
  T* o = (T*)a.o + b * a.os[0] + h * a.os[1];

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e % D, s = q0 + r;
    Qs[r * LD + c] = s < S ? q[s * a.qs[2] + c] : zero;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  // live key range of this query tile
  const int kv_end = a.causal ? min(S, q0 + BQ) : S;
  const int kv_begin = a.window ? max(0, q0 - a.window + 1) : 0;
  const int row0 = q0 + 16 * warp;

  for (int kt = kv_begin / BKV; kt * BKV < kv_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // every warp is done with the previous K, V tile
    for (int e = tid; e < BKV * D; e += kThreads) {
      const int r = e / D, c = e % D, s = k0 + r;
      const bool ok = s < S;
      Ks[r * LD + c] = ok ? k[s * a.ks[2] + c] : zero;
      Vs[r * LD + c] = ok ? v[s * a.vs[2] + c] : zero;
    }
    __syncthreads();

    float sc[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < D; kk += 16)
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
        mma_tile<T>(sc[j], Qs + 16 * warp * LD + kk, LD, Ks + 8 * j * LD + kk,
                    1, LD);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kv = k0 + 8 * j + frag_col(c);
        const float s = live(row0 + frag_row(c), kv, S, a.causal, a.window)
                            ? sc[j][c] * a.scale
                            : kNegInf;
        sc[j][c] = s;
        mx[c >> 1] = fmaxf(mx[c >> 1], s);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      m_new[hh] = fmaxf(m_run[hh], mx[hh]);
      alpha[hh] = expf(m_run[hh] - m_new[hh]);
      m_run[hh] = m_new[hh];
      l_run[hh] *= alpha[hh];  // this lane's share of the row sum
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kv = k0 + 8 * j + frag_col(c);
        const float p =
            live(row0 + frag_row(c), kv, S, a.causal, a.window)
                ? expf(sc[j][c] - m_new[c >> 1])
                : 0.f;
        l_run[c >> 1] += p;
        Pw[frag_row(c) * LDP + 8 * j + frag_col(c)] = from_f32<T>(p);
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];
    __syncwarp();
#pragma unroll 1
    for (int kk = 0; kk < BKV; kk += 16)
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_tile<T>(acc[n], Pw + kk, LDP, Vs + kk * LD + 8 * n, LD, 1);
    __syncwarp();
  }

  float l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = l_run[hh] + __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    l[hh] = fmaxf(l[hh], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = row0 + frag_row(c);
      if (r < S)
        o[r * a.os[2] + 8 * n + frag_col(c)] =
            from_f32<T>(acc[n][c] / l[c >> 1]);
    }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * a.H), (unsigned)((a.S + BQ - 1) / BQ));
  attn_kernel<T, D><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int B, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Head dims the kernel is built for (the wrapper refuses others).
extern "C" int flash_attention_supports(int d) {
  return d == 16 || d == 32 || d == 64 || d == 128 || d == 256;
}

// q, o: [B, H, S, d]; k, v: [B, Hkv, S, d] with H % Hkv == 0; each given by
// its b, h, s strides in elements, d contiguous; all of one dtype (DT_F32
// or DT_BF16).  window == 0 means no window.  One launch on `stream` on the
// calling thread's current device; returns its cudaError_t (0 on success).
// S == 0 launches nothing.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int S, int d, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, int causal,
    int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || (S + BQ - 1) / BQ > 65535 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, H, Hkv, S, causal, window, scale,
         {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss}};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16) return launch_d<__nv_bfloat16>(a, B, d, s);
  if (dtype == DT_F32) return launch_d<float>(a, B, d, s);
  return (int)cudaErrorInvalidValue;
}
