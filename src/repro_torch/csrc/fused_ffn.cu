// SwiGLU FFN: out[M, d] = (silu(x @ Wg) * (x @ Wi)) @ Wo, in two launches
// that share one GEMM core:
//   (a) ffn_hidden: H[M, f] = silu(x @ Wg) * (x @ Wi), a dual GEMM that
//       holds the Wg and the Wi tile of the same columns and keeps two fp32
//       accumulators; its epilogue writes H in the compute dtype;
//   (b) ffn_out: out[M, d] = H @ Wo.
// No partial sums and no reduce kernel: each output element is summed by
// one block in a fixed order, so the result is deterministic.
//
// Replaces the TPU kernel src/repro/kernels/fused_ffn.py: _ffn_kernel
// (launched by fused_swiglu).  On the TPU the grid (M/256, f/512) ran its f
// axis in order on one core and carried a [256, d] fp32 accumulator in VMEM
// (2 MB at d = 2048).  A Hopper block has at most 227 KB of shared memory
// and blocks run in no order, so a fused kernel would have to hold more
// than 2d hidden columns per block to beat writing H: at d = 2048 that is a
// 512 KB bf16 tile.  Writing H in bf16 and reading it back costs 2 * M * f
// * 2 bytes (92 MB at M = 4096, ~28 us at 3.35 TB/s; 180 KB at M = 8).
//
// bf16, tiles by M:
//   * large M (prefill), Hopper's own path: 128 x 128 block tiles, 64 deep,
//     in a ring of shared-memory stages that one producer warp fills by TMA
//     (128-byte swizzle, completion on an mbarrier per stage) while two
//     consumer warpgroups run wgmma m64n128k16 on the stages that have
//     landed, A K-major and the weights read MN-major (the transpose bit),
//     and hand each stage back through a second mbarrier.  Bound by
//     operations: 6 * M * d * f, 283 GFLOP at M = 4096, 0.29 ms at 989
//     TFLOP/s.
//   * small M (decode, M <= kSmallMaxM, measured on the card): 16-row
//     tiles and narrow column tiles (32 columns of f for (a), 16 of d for
//     (b)) so that every SM streams a slice of the weights, by 16-byte
//     cp.async stages, ldmatrix fragments (.trans for the k-major weight
//     tiles) and warp-level mma.sync; the block's 4 warps split the depth of
//     each stage and sum their accumulators in a fixed order at the end.
//     Bound by bytes: the 69 MB of weights at tinyllama's width, 21 us.
// Ragged shapes (d or f not a multiple of 8, or pointers not 16-byte
// aligned: TMA and cp.async cannot take them) go through the small-M tiles
// at any M, with element loads into the same tiles.
//
// fp32 route: the same two launches as plain shared-memory tiled GEMMs with
// scalar FMAs in full fp32; it exists for checking against fp32 references
// and for fp32 models, not for speed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace {

// largest M served by the small-M tiles (measured on the card with
// scripts/kernel_variants.py: PERF.md)
constexpr long long kSmallMaxM = 16;

template <int BM_, int BN_, int BK_, int WGM_, int WGN_, int WGK_,
          int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WGM = WGM_, WGN = WGN_,
                       WGK = WGK_, STAGES = STAGES_;
  static constexpr int kThreads = 32 * WGM * WGN * WGK;
  static constexpr int TM = BM / WGM, TN = BN / WGN;  // a warp's tile
  static constexpr int LDA = BK + 8, LDB = BN + 8;    // padded rows
  static_assert(TM % 16 == 0 && TN % 16 == 0 && BK % (16 * WGK) == 0,
                "tile shape");
  template <int NB>
  static constexpr size_t smem_bytes() {
    return (size_t)STAGES * (BM * LDA + NB * BK * LDB) * sizeof(bf16);
  }
};

// (BM, BN, BK, warps along M, N and the depth, stages) of each launch
using SmallHidden = Cfg<16, 32, 128, 1, 1, 4, 4>;
using SmallOut = Cfg<16, 16, 256, 1, 1, 4, 6>;

struct GemmArgs {
  const bf16* a;   // [M, K] row-major
  const bf16* b0;  // [K, N] row-major
  const bf16* b1;  // the second [K, N] of the dual product, else null
  bf16* c;         // [M, N]
  int M, N, K;
  int vec;  // K, N multiples of 8 and 16-byte aligned pointers
};

// one stage: the A tile [BM, BK] and NB B tiles [BK, BN] at (m0, n0, k0),
// zero outside the matrices
template <class C, int NB>
__device__ __forceinline__ void load_stage(bf16* sa, bf16* sb,
                                           const GemmArgs& g, int m0, int n0,
                                           int k0) {
  const int tid = threadIdx.x;
  if (g.vec) {
    constexpr int ACH = C::BM * C::BK / 8, BCH = C::BK * C::BN / 8;
#pragma unroll 4
    for (int i = tid; i < ACH; i += C::kThreads) {
      const int r = i / (C::BK / 8), c = (i % (C::BK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < g.M && k < g.K;
      cp_async16(sa + r * C::LDA + c, ok ? g.a + (int64_t)m * g.K + k : g.a,
                 ok ? 16 : 0);
    }
#pragma unroll 4
    for (int i = tid; i < BCH; i += C::kThreads) {
      const int r = i / (C::BN / 8), c = (i % (C::BN / 8)) * 8;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < g.K && n < g.N;
      const int64_t off = ok ? (int64_t)k * g.N + n : 0;
      cp_async16(sb + r * C::LDB + c, g.b0 + off, ok ? 16 : 0);
      if (NB == 2)
        cp_async16(sb + C::BK * C::LDB + r * C::LDB + c, g.b1 + off,
                   ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = tid; i < C::BM * C::BK; i += C::kThreads) {
      const int r = i / C::BK, c = i % C::BK, m = m0 + r, k = k0 + c;
      sa[r * C::LDA + c] =
          (m < g.M && k < g.K) ? g.a[(int64_t)m * g.K + k] : zero;
    }
    for (int i = tid; i < C::BK * C::BN; i += C::kThreads) {
      const int r = i / C::BN, c = i % C::BN, k = k0 + r, n = n0 + c;
      const bool ok = k < g.K && n < g.N;
      const int64_t off = (int64_t)k * g.N + n;
      sb[r * C::LDB + c] = ok ? g.b0[off] : zero;
      if (NB == 2) sb[(C::BK + r) * C::LDB + c] = ok ? g.b1[off] : zero;
    }
  }
}

// C = A @ B0 (NB = 1) or C = silu(A @ B0) * (A @ B1) (NB = 2), one block
// tile (blockIdx.x over M, blockIdx.y over N)
template <class C, int NB>
__device__ __forceinline__ void gemm_block(const GemmArgs& g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  constexpr int SA = C::BM * C::LDA, SB = C::BK * C::LDB;
  constexpr int STAGE = SA + NB * SB;
  constexpr int MT = C::TM / 16, NT = C::TN / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wk = warp % C::WGK, wmn = warp / C::WGK;
  const int wm = wmn / C::WGN, wn = wmn % C::WGN;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;

  float acc[NB][MT][NT][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[b][i][j][c] = 0.f;

  const int nk = (g.K + C::BK - 1) / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk)
      load_stage<C, NB>(smem + s * STAGE, smem + s * STAGE + SA, g, m0, n0,
                        s * C::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // stage kt has landed
    __syncthreads();                 // ... for every thread; and stage
                                     // kt - 1 is free to refill
    const int nxt = kt + C::STAGES - 1;
    if (nxt < nk) {
      bf16* st = smem + (nxt % C::STAGES) * STAGE;
      load_stage<C, NB>(st, st + SA, g, m0, n0, nxt * C::BK);
    }
    cp_async_commit();
    const bf16* sa = smem + (kt % C::STAGES) * STAGE + wm * C::TM * C::LDA;
    const bf16* sb = smem + (kt % C::STAGES) * STAGE + SA + wn * C::TN;
#pragma unroll
    for (int s = 0; s < C::BK / 16 / C::WGK; ++s) {
      const int ks = (s * C::WGK + wk) * 16;
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        load_a_frag(af[i], sa + 16 * i * C::LDA + ks, C::LDA);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          uint32_t bfr[4];
          load_b_frag_kmajor(bfr, sb + b * SB + ks * C::LDB + 16 * j,
                             C::LDB);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_bf16(acc[b][i][2 * j], af[i], bfr[0], bfr[1]);
            mma_bf16(acc[b][i][2 * j + 1], af[i], bfr[2], bfr[3]);
          }
        }
    }
  }
  cp_async_wait<0>();

  if constexpr (C::WGK > 1) {
    // the warps that split the depth hand their sums to warp wk = 0 of
    // their tile, which adds them in the order wk = 1, 2, ...
    constexpr int NACC = NB * MT * NT * 4;
    float* red = reinterpret_cast<float*>(smem_raw);
    __syncthreads();  // every warp is done with the stages
    if (wk > 0) {
      float* dst = red + ((wmn * (C::WGK - 1) + wk - 1) * NACC) * 32 + lane;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              dst[(((b * MT + i) * NT + j) * 4 + c) * 32] = acc[b][i][j][c];
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 0; w < C::WGK - 1; ++w) {
      const float* src = red + ((wmn * (C::WGK - 1) + w) * NACC) * 32 + lane;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[b][i][j][c] += src[(((b * MT + i) * NT + j) * 4 + c) * 32];
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the tile
        const int m = m0 + wm * C::TM + 16 * i + frag_row(2 * h);
        const int n = n0 + wn * C::TN + 8 * j + frag_col(2 * h);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[0][i][j][2 * h + e];
          v[e] = NB == 2 ? x / (1.f + expf(-x)) * acc[NB - 1][i][j][2 * h + e]
                         : x;
        }
        if (m >= g.M) continue;
        bf16* dst = g.c + (int64_t)m * g.N + n;
        if (g.vec) {
          if (n < g.N)  // n even, N a multiple of 8: n + 1 < N too
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v[0], v[1]);
        } else {
          if (n < g.N) dst[0] = __float2bfloat16_rn(v[0]);
          if (n + 1 < g.N) dst[1] = __float2bfloat16_rn(v[1]);
        }
      }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads) ffn_hidden_kernel(GemmArgs g) {
  gemm_block<C, 2>(g);
}

template <class C>
__global__ void __launch_bounds__(C::kThreads) ffn_out_kernel(GemmArgs g) {
  gemm_block<C, 1>(g);
}

// ---- bf16, large M: TMA + wgmma ---------------------------------------------

constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64, WG_CONSUMERS = 2;
constexpr int WG_THREADS = 128 * (WG_CONSUMERS + 1);
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;  // one 128-row A tile
constexpr int WG_B_BYTES = WG_BK * WG_BN * 2;  // one B tile: 2 x 64 columns
constexpr int WG_CHUNK_BYTES = WG_BK * 128;    // 64 columns x 64 k

template <int NB>
struct WgCfg {
  static constexpr int STAGES = NB == 2 ? 4 : 6;
  static constexpr int STAGE_BYTES = WG_A_BYTES + NB * WG_B_BYTES;
  // the stages from a 1024-byte boundary (the swizzle atom), then the
  // full and empty barriers
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                                 2 * STAGES * sizeof(uint64_t);
};

// C = A @ B0 (NB = 1) or silu(A @ B0) * (A @ B1) (NB = 2) on one 128 x 128
// tile; warpgroups 0 and 1 consume (64 rows each), warpgroup 2 produces
template <int NB>
__device__ __forceinline__ void gemm_wgmma(const CUtensorMap* ta,
                                           const CUtensorMap* tb0,
                                           const CUtensorMap* tb1, bf16* c,
                                           int M, int N, int K) {
  using W = WgCfg<NB>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* base =
      wg_smem + ((1024 - (smem_addr(wg_smem) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(base + W::STAGES * W::STAGE_BYTES);
  uint64_t* empty = full + W::STAGES;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BN;
  const int nk = (K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WG_CONSUMERS) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % W::STAGES;
        if (kt >= W::STAGES) mbar_wait(&empty[s], (kt / W::STAGES - 1) & 1);
        unsigned char* st = base + s * W::STAGE_BYTES;
        // out-of-bounds parts of a box arrive as zeros and count in full
        mbar_expect_tx(&full[s], W::STAGE_BYTES);
        const int k0 = kt * WG_BK;
        tma_load_2d(st, ta, &full[s], k0, m0);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int ch = 0; ch < WG_BN / 64; ++ch)
            tma_load_2d(st + WG_A_BYTES + b * WG_B_BYTES + ch * WG_CHUNK_BYTES,
                        b ? tb1 : tb0, &full[s], n0 + 64 * ch, k0);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[NB][64];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[b][i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % W::STAGES;
      mbar_wait(&full[s], (kt / W::STAGES) & 1);
      const unsigned char* st = base + s * W::STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        // A: this warpgroup's 64 rows, 16 k (32 bytes) into the swizzled
        // rows; B: 16 k rows (two 8-row atoms) down, chunks 8 KB apart
        const uint64_t da = gmma_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          wgmma_ss_m64n128k16<1>(
              acc[b], da,
              gmma_desc(st + WG_A_BYTES + b * WG_B_BYTES + kk * 16 * 128,
                        WG_CHUNK_BYTES, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    }
    // epilogue: warp w of the warpgroup holds rows 16 w .. 16 w + 15
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int row = m0 + 64 * wg + 16 * w + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = row + 8 * hh, n = n0 + 8 * j + 2 * (lane & 3);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[0][4 * j + 2 * hh + e];
          v[e] = NB == 2
                     ? x / (1.f + expf(-x)) * acc[NB - 1][4 * j + 2 * hh + e]
                     : x;
        }
        if (m < M && n < N)  // n even, N a multiple of 8: n + 1 < N too
          *reinterpret_cast<__nv_bfloat162*>(c + (int64_t)m * N + n) =
              __floats2bfloat162_rn(v[0], v[1]);
      }
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
    ffn_hidden_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                            const __grid_constant__ CUtensorMap tb0,
                            const __grid_constant__ CUtensorMap tb1, bf16* c,
                            int M, int N, int K) {
  gemm_wgmma<2>(&ta, &tb0, &tb1, c, M, N, K);
}

__global__ void __launch_bounds__(WG_THREADS, 1)
    ffn_out_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb0, bf16* c,
                         int M, int N, int K) {
  gemm_wgmma<1>(&ta, &tb0, &tb0, c, M, N, K);
}

// a row-major bf16 [rows, cols] matrix read in boxes of 64 columns (128
// bytes, the swizzle span) by box_rows rows
int tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
               int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * sizeof(bf16)};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return tma_map_bf16(map, ptr, 2, dims, strides, box);
}

template <int NB>
int launch_wgmma(const GemmArgs& g, cudaStream_t stream) {
  CUtensorMap ta, tb0, tb1;
  int err = tensor_map(&ta, g.a, g.M, g.K, WG_BM);
  if (err == 0) err = tensor_map(&tb0, g.b0, g.K, g.N, WG_BK);
  if (err == 0 && NB == 2) err = tensor_map(&tb1, g.b1, g.K, g.N, WG_BK);
  if (err != 0) return err;
  constexpr size_t bytes = WgCfg<NB>::SMEM;
  const dim3 grid((unsigned)((g.M + WG_BM - 1) / WG_BM),
                  (unsigned)((g.N + WG_BN - 1) / WG_BN));
  cudaError_t e;
  if constexpr (NB == 2) {
    e = cudaFuncSetAttribute(ffn_hidden_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    ffn_hidden_wgmma_kernel<<<grid, WG_THREADS, bytes, stream>>>(
        ta, tb0, tb1, g.c, g.M, g.N, g.K);
  } else {
    e = cudaFuncSetAttribute(ffn_out_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    ffn_out_wgmma_kernel<<<grid, WG_THREADS, bytes, stream>>>(
        ta, tb0, g.c, g.M, g.N, g.K);
  }
  return (int)cudaGetLastError();
}

// ---- fp32 ------------------------------------------------------------------

constexpr int FT = 64, FK = 16;  // 64 x 64 tiles, 16-deep steps, 256 threads

// C = A @ B0, or silu(A @ B0) * (A @ B1) when DUAL; each thread sums 4 x 4
// outputs (rows ty + 16 i, columns tx + 16 j) in k order
template <bool DUAL>
__device__ __forceinline__ void gemm_f32(const float* __restrict__ a,
                                         const float* __restrict__ b0,
                                         const float* __restrict__ b1,
                                         float* __restrict__ c, int M, int N,
                                         int K) {
  __shared__ float As[FK][FT + 4];
  __shared__ float Bs[DUAL ? 2 : 1][FK][FT + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * FT, n0 = blockIdx.y * FT;
  float acc[DUAL ? 2 : 1][4][4];
#pragma unroll
  for (int b = 0; b < (DUAL ? 2 : 1); ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int e = tid; e < FT * FK; e += 256) {
      const int r = e / FK, kk = e % FK, m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? a[(int64_t)m * K + k] : 0.f;
      const int kb = e / FT, nn = e % FT, kr = k0 + kb, n = n0 + nn;
      const bool ok = kr < K && n < N;
      Bs[0][kb][nn] = ok ? b0[(int64_t)kr * N + n] : 0.f;
      if (DUAL) Bs[DUAL ? 1 : 0][kb][nn] = ok ? b1[(int64_t)kr * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk)
#pragma unroll
      for (int b = 0; b < (DUAL ? 2 : 1); ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[b][i][j] =
                fmaf(As[kk][ty + 16 * i], Bs[b][kk][tx + 16 * j], acc[b][i][j]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m >= M || n >= N) continue;
      const float x = acc[0][i][j];
      c[(int64_t)m * N + n] =
          DUAL ? x / (1.f + expf(-x)) * acc[DUAL ? 1 : 0][i][j] : x;
    }
}

__global__ void __launch_bounds__(256)
    ffn_hidden_f32_kernel(const float* a, const float* b0, const float* b1,
                          float* c, int M, int N, int K) {
  gemm_f32<true>(a, b0, b1, c, M, N, K);
}

__global__ void __launch_bounds__(256)
    ffn_out_f32_kernel(const float* a, const float* b0, float* c, int M,
                       int N, int K) {
  gemm_f32<false>(a, b0, nullptr, c, M, N, K);
}

template <class C, int NB>
int launch_bf16(const GemmArgs& g, cudaStream_t stream) {
  constexpr size_t bytes = C::template smem_bytes<NB>();
  void (*kernel)(GemmArgs);
  if constexpr (NB == 2) kernel = ffn_hidden_kernel<C>;
  else kernel = ffn_out_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((g.M + C::BM - 1) / C::BM),
            (unsigned)((g.N + C::BN - 1) / C::BN));
  kernel<<<grid, C::kThreads, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// x: contiguous [m, d]; wg, wi: contiguous [d, f]; wo: contiguous [f, d];
// h: contiguous [m, f] scratch for the hidden activation; out: contiguous
// [m, d]; all of one dtype (DT_F32 or DT_BF16).  bf16 takes the large-M
// tiles above kSmallMaxM rows where the rows allow TMA, else the small-M
// tiles.  Two
// launches on `stream` on the calling thread's current device; returns the
// first non-zero cudaError_t, else 0.  m == 0 launches nothing.
extern "C" int fused_ffn_launch(const void* x, const void* wg, const void* wi,
                                const void* wo, void* h, void* out,
                                long long m, int d, int f, int dtype,
                                void* stream) {
  if (m <= 0) return 0;
  if (m > 0x7fffffffLL || d <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) {
    if ((d + FT - 1) / FT > 65535 || (f + FT - 1) / FT > 65535)
      return (int)cudaErrorInvalidValue;
    const unsigned mt = (unsigned)((m + FT - 1) / FT);
    ffn_hidden_f32_kernel<<<dim3(mt, (f + FT - 1) / FT), 256, 0, s>>>(
        (const float*)x, (const float*)wg, (const float*)wi, (float*)h,
        (int)m, f, d);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ffn_out_f32_kernel<<<dim3(mt, (d + FT - 1) / FT), 256, 0, s>>>(
        (const float*)h, (const float*)wo, (float*)out, (int)m, d, f);
    return (int)cudaGetLastError();
  }
  if (dtype != DT_BF16) return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 && f % 8 == 0 && aligned16(x) &&
                  aligned16(wg) && aligned16(wi) && aligned16(wo) &&
                  aligned16(h) && aligned16(out);
  const GemmArgs hid{(const bf16*)x, (const bf16*)wg, (const bf16*)wi,
                     (bf16*)h, (int)m, f, d, vec};
  const GemmArgs o{(const bf16*)h, (const bf16*)wo, nullptr, (bf16*)out,
                   (int)m, d, f, vec};
  const bool small = m <= kSmallMaxM || !vec;
  if ((f + 15) / 16 > 65535 || (d + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  int err = small ? launch_bf16<SmallHidden, 2>(hid, s)
                  : launch_wgmma<2>(hid, s);
  if (err != 0) return err;
  return small ? launch_bf16<SmallOut, 1>(o, s) : launch_wgmma<1>(o, s);
}
