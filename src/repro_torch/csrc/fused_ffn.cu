// SwiGLU FFN: out[M, d] = (silu(x @ Wg) * (x @ Wi)) @ Wo, in two launches
// that share one GEMM core:
//   (a) ffn_hidden: H[M, f] = silu(x @ Wg) * (x @ Wi), a dual GEMM that
//       holds the Wg and the Wi tile of the same columns and keeps two fp32
//       accumulators; its epilogue writes H in the compute dtype;
//   (b) ffn_out: out[M, d] = H @ Wo.
// In bf16 each output element is summed by one block in a fixed order; in
// fp32 a product whose blocks would not fill the card is split along K into
// partial sums that a second launch adds in split order.  No atomics: a
// call repeats bit for bit.
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
// fp32 (the fp32 models and the reference's default fp32 cache, which
// promotes a bf16 model's stream): products and sums in full fp32 on the
// CUDA cores (no TF32: it keeps about three digits), bound at large M by
// 67 TFLOP/s of fp32 FMAs (6 * M * d * f, 4.2 ms at M = 4096):
//   * larger M: 128- or 64-row tiles (x 256 columns of the out product,
//     x 128 of each weight of the dual one), 16 x 8 or 8 x 8 outputs a
//     thread, one block an SM, two stages of 32 k (the weights by
//     cp.async, x or H transposed through registers), operands
//     double-buffered in registers; the tile and the splits of K a small
//     cost model (tiled_ns) puts first;
//   * small M (decode, M <= kSmallMaxMF32): the weights streamed once by
//     16-byte loads, x's rows in shared memory, K split across the block's
//     warps and across blocks to fill the card; bound by bytes, 139 MB at
//     tinyllama's width, 41 us;
//   * a product split along K keeps its splits' partial sums in a
//     workspace the caller allocates (fused_ffn_workspace), added in
//     split order by a further launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "launch.cuh"
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
  KernelFacts facts;
  if constexpr (NB == 2) {
    err = kernel_facts((const void*)ffn_hidden_wgmma_kernel, WG_THREADS,
                       bytes, &facts);
    if (err != 0) return err;
    ffn_hidden_wgmma_kernel<<<grid, WG_THREADS, bytes, stream>>>(
        ta, tb0, tb1, g.c, g.M, g.N, g.K);
  } else {
    err = kernel_facts((const void*)ffn_out_wgmma_kernel, WG_THREADS, bytes,
                       &facts);
    if (err != 0) return err;
    ffn_out_wgmma_kernel<<<grid, WG_THREADS, bytes, stream>>>(
        ta, tb0, g.c, g.M, g.N, g.K);
  }
  return (int)cudaGetLastError();
}

// ---- fp32: full fp32 FMAs on the CUDA cores ----------------------------------

// largest M served by the weight-streaming kernels (measured on the card
// with scripts/kernel_variants.py: PERF.md)
constexpr long long kSmallMaxMF32 = 16;
// the least depth of a split of K: a split writes and reads back M x N
// partial sums, against its ks x N of the weights
constexpr int kMinSplitK = 128;

// 4 bytes from global to shared (rows that are not 16-byte aligned);
// src_bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

__device__ __forceinline__ void fma4(float acc[4], float x, const float4& b) {
  acc[0] = fmaf(x, b.x, acc[0]);
  acc[1] = fmaf(x, b.y, acc[1]);
  acc[2] = fmaf(x, b.z, acc[2]);
  acc[3] = fmaf(x, b.w, acc[3]);
}

// columns n .. n + 3 of one row: a 16-byte store where the row allows it
template <bool VEC>
__device__ __forceinline__ void store4(float* row, int n, int N,
                                       const float v[4]) {
  if (VEC) {
    if (n < N)  // N a multiple of 4: n + 3 < N too
      *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N) row[n + e] = v[e];
  }
}

struct F32Args {
  const float* a;   // [M, K] row-major
  const float* b0;  // [K, N] row-major
  const float* b1;  // the dual product's second [K, N], else null
  float* c;         // [M, N], written when the product is not split
  float* part;      // [S][NB][M][N] partial sums of the S splits, or null
  int M, N, K, ks;  // ks: the depth of a split (gridDim of the splits)
};

// A split's partial sums of product b at row m, or the result's row
__device__ __forceinline__ float* part_row(const F32Args& g, int NB, int b,
                                           int z, int m) {
  return g.part + (((int64_t)z * NB + b) * g.M + m) * g.N;
}

// -- larger M: 128- or 64-row tiles, 16 x 8 or 8 x 8 outputs a thread -----
//
// A block of 256 threads owns BM = 8 TM rows and 256 columns of C (NB =
// 1), or BM rows and 128 columns of both products (NB = 2: the two
// weights' tiles share the A tile), one block an SM.  Warps: 2 along M x
// 4 along N; lane = 8 ty + tx; a thread sums TM rows, wm * 4 TM + 16 q +
// 4 ty + e (q < TM / 4, e < 4), and two groups of 4 columns (NB = 1: wn *
// 64 + 4 tx and 32 past it; NB = 2: wn * 32 + 4 tx of each weight), each
// output in k order.  Stages of 32 k, two in shared memory: the weights'
// rows by 16-byte cp.async (4-byte copies where rows are not 16-byte
// aligned), A through registers, stored k-major (transposed), so that
// every operand is read as float4: a thread's rows four at a time, its 8
// columns in 2 loads.  The next stage's loads are in flight while this
// one is multiplied, and the next k's operands are read from shared
// memory while this k's FMAs run (registers double-buffered).  An m-major
// A read as float2 ran at 60 % of the fp32 rate, its loads and FMAs not
// overlapping (PERF.md).  TM = 16 reads 6 float4 for 128 FMAs a k; TM = 8
// (64-row tiles, 6 for 64) is taken where 128-row tiles would not fill
// the card (M up to a few hundred rows), before K is split.
constexpr int SG_BK = 32, SG_THREADS = 256;

template <int TM>
struct Sg {
  static constexpr int BM = 8 * TM;
  static constexpr int LDT = BM + 4;  // a k row of the transposed A tile
  static constexpr int A = SG_BK * LDT, B = SG_BK * 256;  // floats a stage
  static constexpr size_t SMEM = 2 * (A + B) * sizeof(float);
  // the k of a stage's A rows a thread fetches (BM threads a k range)
  static constexpr int KPT = SG_BK * BM / SG_THREADS;
};

// A's rows of one stage into registers: thread t takes row t % BM and
// the KPT k from KPT (t / BM) on, zero outside M and this split's kend
template <int TM, bool VEC>
__device__ __forceinline__ void sg_fetch_a(float (&ra)[Sg<TM>::KPT],
                                           const F32Args& g, int m0, int k0,
                                           int kend) {
  using C = Sg<TM>;
  const int m = m0 + (threadIdx.x % C::BM);
  const int k = k0 + C::KPT * (threadIdx.x / C::BM);
  const float* src = g.a + (int64_t)m * g.K + k;
  if (VEC) {  // K a multiple of 4: a float4 lies wholly inside or outside
#pragma unroll
    for (int c = 0; c < C::KPT / 4; ++c) {
      const bool ok = m < g.M && k + 4 * c < kend;
      const float4 v = ok ? *reinterpret_cast<const float4*>(src + 4 * c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      ra[4 * c] = v.x;
      ra[4 * c + 1] = v.y;
      ra[4 * c + 2] = v.z;
      ra[4 * c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < C::KPT; ++e)
      ra[e] = m < g.M && k + e < kend ? src[e] : 0.f;
  }
}

// ... and from registers into the stage's k-major tile (a warp stores 32
// consecutive rows of one k: no bank conflicts)
template <int TM>
__device__ __forceinline__ void sg_store_a(float* sa,
                                           const float (&ra)[Sg<TM>::KPT]) {
  using C = Sg<TM>;
  const int row = threadIdx.x % C::BM, k = C::KPT * (threadIdx.x / C::BM);
#pragma unroll
  for (int e = 0; e < C::KPT; ++e) sa[(k + e) * C::LDT + row] = ra[e];
}

// the NB weight tiles of one stage, rows k0.., zero outside N and kend
template <int NB, bool VEC>
__device__ __forceinline__ void sg_load_b(float* sb, const F32Args& g,
                                          int n0, int k0, int kend) {
  constexpr int BN = 256 / NB;
  const int tid = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int p = 0; p < NB * SG_BK * BN / 4 / SG_THREADS; ++p) {
      const int i = tid + SG_THREADS * p;
      const int b = i / (SG_BK * BN / 4);
      const int r = (i / (BN / 4)) % SG_BK, c = (i % (BN / 4)) * 4;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < kend && n < g.N;
      const float* src = b ? g.b1 : g.b0;
      cp_async16(sb + (b * SG_BK + r) * BN + c,
                 ok ? src + (int64_t)k * g.N + n : src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < NB * SG_BK * BN; i += SG_THREADS) {
      const int b = i / (SG_BK * BN), r = (i / BN) % SG_BK, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < kend && n < g.N;
      const float* src = b ? g.b1 : g.b0;
      cp_async4(sb + (b * SG_BK + r) * BN + c,
                ok ? src + (int64_t)k * g.N + n : src, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// a thread's operands at one k of a stage: its TM rows of A (TM / 4
// float4) and its two groups of 4 columns
template <int TM, int NB>
__device__ __forceinline__ void sg_frag(float4 (&a)[TM / 4], float4 (&b)[2],
                                        const float* sa, const float* sb,
                                        int k) {
  constexpr int BN = 256 / NB, JOFF = NB == 1 ? 32 : SG_BK * BN;
#pragma unroll
  for (int q = 0; q < TM / 4; ++q)
    a[q] = *reinterpret_cast<const float4*>(sa + k * Sg<TM>::LDT + 16 * q);
  b[0] = *reinterpret_cast<const float4*>(sb + k * BN);
  b[1] = *reinterpret_cast<const float4*>(sb + k * BN + JOFF);
}

__device__ __forceinline__ float f4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// C = A @ B0 (NB = 1) or silu(A @ B0) * (A @ B1) (NB = 2) on one tile
// (blockIdx.x over M, blockIdx.y over N) and one split of K (blockIdx.z)
template <int TM, int NB, bool VEC>
__device__ __forceinline__ void sgemm_block(const F32Args& g) {
  using C = Sg<TM>;
  constexpr int BN = 256 / NB;
  extern __shared__ __align__(16) float sg_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = lane & 7, ty = lane >> 3, wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN;
  const int kz0 = blockIdx.z * g.ks, kend = min(g.K, kz0 + g.ks);
  const int nk = (kend - kz0 + SG_BK - 1) / SG_BK;
  const int arow = wm * 4 * TM + 4 * ty, bcol = wn * (BN / 4) + tx * 4;

  float acc[TM][2][4];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;

  float ra[C::KPT];
  sg_fetch_a<TM, VEC>(ra, g, m0, kz0, kend);
  sg_load_b<NB, VEC>(sg_smem + C::A, g, n0, kz0, kend);
  sg_store_a<TM>(sg_smem, ra);
  cp_async_wait<0>();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const float* sa = sg_smem + (kt & 1) * (C::A + C::B);
    const float* sb = sa + C::A + bcol;
    sa += arow;
    const bool next = kt + 1 < nk;
    float* nst = sg_smem + ((kt + 1) & 1) * (C::A + C::B);
    if (next) {  // the next stage's loads fly while this one is multiplied
      sg_fetch_a<TM, VEC>(ra, g, m0, kz0 + (kt + 1) * SG_BK, kend);
      sg_load_b<NB, VEC>(nst + C::A, g, n0, kz0 + (kt + 1) * SG_BK, kend);
    }
    float4 a[2][TM / 4], b[2][2];
    sg_frag<TM, NB>(a[0], b[0], sa, sb, 0);
#pragma unroll
    for (int k = 0; k < SG_BK; ++k) {
      if (k + 1 < SG_BK)
        sg_frag<TM, NB>(a[(k + 1) & 1], b[(k + 1) & 1], sa, sb, k + 1);
#pragma unroll
      for (int q = 0; q < TM / 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = f4(a[k & 1][q], e);
          fma4(acc[4 * q + e][0], x, b[k & 1][0]);
          fma4(acc[4 * q + e][1], x, b[k & 1][1]);
        }
    }
    if (next) {
      sg_store_a<TM>(nst, ra);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + arow + 16 * (r / 4) + r % 4;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + bcol + (NB == 1 ? 32 * j : 0);
      if (g.part) {
        store4<VEC>(part_row(g, NB, NB == 1 ? 0 : j, blockIdx.z, m), n, g.N,
                    acc[r][j]);
      } else if (NB == 1) {
        store4<VEC>(g.c + (int64_t)m * g.N, n, g.N, acc[r][j]);
      } else if (j == 0) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = silu_mul(acc[r][0][e], acc[r][1][e]);
        store4<VEC>(g.c + (int64_t)m * g.N, n, g.N, v);
      }
    }
  }
}

template <int TM, bool VEC>
__global__ void __launch_bounds__(SG_THREADS, 1)
    ffn_hidden_f32_kernel(F32Args g) {
  sgemm_block<TM, 2, VEC>(g);
}

template <int TM, bool VEC>
__global__ void __launch_bounds__(SG_THREADS, 1)
    ffn_out_f32_kernel(F32Args g) {
  sgemm_block<TM, 1, VEC>(g);
}

// -- small M (decode): the weights streamed once --------------------------------
//
// A block of 256 threads owns 128 columns (4 a lane, read as one 16-byte
// load from a k row: a warp reads 512 contiguous bytes) and one split of
// K, whose rows of x (all MR of them, zero past M) it holds in shared
// memory.  Its 8 warps take the split's quads of k rows in turn (warp w the
// quads w, w + 8, ...), each loading the next quad of every weight while it
// multiplies the current one, then sum their accumulators in a fixed tree
// (warps 4-7 into 0-3, 2-3 into 0-1, 1 into 0).  Bound by bytes: the
// weights once.
constexpr int ST_THREADS = 256, ST_WARPS = 8, ST_COLS = 128;
constexpr int kStreamMaxK = 1024;  // the deepest split (x's rows in smem)

template <int MR>
constexpr size_t stream_smem() {  // x's rows, or the tree's buffer
  return (size_t)MR * kStreamMaxK * sizeof(float);
}

template <int NB, bool VEC>
__device__ __forceinline__ void stream_quad(const F32Args& g, int k, int kend,
                                            int n, float4 (&w)[NB][4]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float* src = b ? g.b1 : g.b0;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const bool ok = k + rr < kend && n < g.N;
      const float* row = src + (int64_t)(k + rr) * g.N + n;
      if (VEC) {
        w[b][rr] = ok ? __ldg(reinterpret_cast<const float4*>(row))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        w[b][rr].x = ok ? __ldg(row) : 0.f;
        w[b][rr].y = ok && n + 1 < g.N ? __ldg(row + 1) : 0.f;
        w[b][rr].z = ok && n + 2 < g.N ? __ldg(row + 2) : 0.f;
        w[b][rr].w = ok && n + 3 < g.N ? __ldg(row + 3) : 0.f;
      }
    }
  }
}

template <int MR, int NB, bool VEC>
__device__ __forceinline__ void stream_block(const F32Args& g) {
  extern __shared__ __align__(16) float st_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.x * ST_COLS + lane * 4;  // this lane's 4 columns
  const int ks = g.ks, kz0 = blockIdx.y * ks, kend = min(g.K, kz0 + ks);
  for (int i = tid; i < MR * ks; i += ST_THREADS) {
    const int m = i / ks, k = kz0 + i % ks;
    st_smem[i] = m < g.M && k < kend ? g.a[(int64_t)m * g.K + k] : 0.f;
  }
  __syncthreads();

  float acc[NB][MR][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][m][e] = 0.f;
  const int nq = (kend - kz0 + 3) / 4;
  float4 cur[NB][4], nxt[NB][4];
  if (warp < nq) stream_quad<NB, VEC>(g, kz0 + 4 * warp, kend, n, cur);
  for (int q = warp; q < nq; q += ST_WARPS) {
    if (q + ST_WARPS < nq)
      stream_quad<NB, VEC>(g, kz0 + 4 * (q + ST_WARPS), kend, n, nxt);
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const float4 xv =
          *reinterpret_cast<const float4*>(st_smem + m * ks + 4 * q);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        fma4(acc[b][m], xv.x, cur[b][0]);
        fma4(acc[b][m], xv.y, cur[b][1]);
        fma4(acc[b][m], xv.z, cur[b][2]);
        fma4(acc[b][m], xv.w, cur[b][3]);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) cur[b][rr] = nxt[b][rr];
  }

  // the warps' sums, in a fixed tree, through the rows' shared memory
  constexpr int NV = NB * MR * 4;
  static_assert(ST_WARPS / 2 * NV * 32 <= MR * kStreamMaxK, "tree buffer");
#pragma unroll
  for (int half = ST_WARPS / 2; half >= 1; half /= 2) {
    __syncthreads();  // the previous reads of the buffer are done
    if (warp >= half && warp < 2 * half) {
      float* dst = st_smem + (warp - half) * NV * 32 + lane;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dst[((b * MR + m) * 4 + e) * 32] = acc[b][m][e];
    }
    __syncthreads();
    if (warp < half) {
      const float* src = st_smem + warp * NV * 32 + lane;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[b][m][e] += src[((b * MR + m) * 4 + e) * 32];
    }
  }
  if (warp != 0) return;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    if (m >= g.M) break;
    if (g.part) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
        store4<VEC>(part_row(g, NB, b, blockIdx.y, m), n, g.N, acc[b][m]);
    } else if (NB == 1) {
      store4<VEC>(g.c + (int64_t)m * g.N, n, g.N, acc[0][m]);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = silu_mul(acc[0][m][e], acc[NB - 1][m][e]);
      store4<VEC>(g.c + (int64_t)m * g.N, n, g.N, v);
    }
  }
}

template <int MR, bool VEC>
__global__ void __launch_bounds__(ST_THREADS, 1)
    ffn_hidden_f32_stream_kernel(F32Args g) {
  stream_block<MR, 2, VEC>(g);
}

template <int MR, bool VEC>
__global__ void __launch_bounds__(ST_THREADS, 1)
    ffn_out_f32_stream_kernel(F32Args g) {
  stream_block<MR, 1, VEC>(g);
}

// -- the splits' sums, in split order ------------------------------------------

template <int NB>
__device__ __forceinline__ void reduce_splits(const F32Args& g, int S) {
  const int64_t mn = (int64_t)g.M * g.N;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < mn;
       i += (int64_t)gridDim.x * blockDim.x) {
    float v[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float s = 0.f;
      for (int z = 0; z < S; ++z) s += g.part[((int64_t)z * NB + b) * mn + i];
      v[b] = s;
    }
    g.c[i] = NB == 2 ? silu_mul(v[0], v[NB - 1]) : v[0];
  }
}

__global__ void __launch_bounds__(256)
    ffn_hidden_f32_reduce_kernel(F32Args g, int S) {
  reduce_splits<2>(g, S);
}

__global__ void __launch_bounds__(256)
    ffn_out_f32_reduce_kernel(F32Args g, int S) {
  reduce_splits<1>(g, S);
}

// -- host: the plan of a call, and its launches ----------------------------------

// How one fp32 call runs: the streaming kernels or the tiled ones, each
// product's rows (the streaming kernels' rows a pass, MR; the tiles'
// rows a thread, TM), its splits of K and their depth, and the workspace
// the partial sums take (bytes; 0 when nothing is split).
struct F32Plan {
  bool stream;
  int rows[2], splits[2], ks[2];  // [0]: the hidden product, [1]: the out
  size_t ws;
};

// one fp32 kernel: its function, threads, dynamic shared memory, and the
// rows and columns of C a block owns (rows 0: every row)
struct F32Kernel {
  void (*fn)(F32Args);
  int threads;
  size_t smem;
  int block_rows, block_cols;
};

template <bool VEC>
F32Kernel f32_kernel(bool stream, int rows, int nb) {
#define REPRO_STREAM(MR)                                                   \
  if (stream && rows == MR)                                                \
    return {nb == 2 ? ffn_hidden_f32_stream_kernel<MR, VEC>                \
                    : ffn_out_f32_stream_kernel<MR, VEC>,                  \
            ST_THREADS, stream_smem<MR>(), 0, ST_COLS};
#define REPRO_TILES(TM)                                                    \
  if (!stream && rows == TM)                                               \
    return {nb == 2 ? ffn_hidden_f32_kernel<TM, VEC>                       \
                    : ffn_out_f32_kernel<TM, VEC>,                         \
            SG_THREADS, Sg<TM>::SMEM, Sg<TM>::BM, 256 / nb};
  REPRO_STREAM(4)
  REPRO_STREAM(8)
  REPRO_STREAM(16)
  REPRO_TILES(8)
  REPRO_TILES(16)
#undef REPRO_STREAM
#undef REPRO_TILES
  return {nullptr, 0, 0, 0, 0};
}

// the blocks of `k` over M x N, and its facts on the current device
int f32_tiles(const F32Kernel& k, long long M, int N, KernelFacts* facts,
              long long* tiles) {
  const long long mt = k.block_rows ? (M + k.block_rows - 1) / k.block_rows
                                    : 1;
  *tiles = mt * ((N + k.block_cols - 1) / k.block_cols);
  return kernel_facts((const void*)k.fn, k.threads, k.smem, facts);
}

// splits of K and their depth (a multiple of `align`, at most `max_ks`)
// for the streaming kernels' `tiles` blocks of `slots`: enough to fill the
// card once where the tiles do not, each split at least kMinSplitK deep
void choose_splits(int K, long long tiles, long long slots, int align,
                   int max_ks, int* splits, int* ks) {
  long long s = 1;
  if (tiles < slots) s = slots / tiles;
  s = std::min<long long>(s, std::max(1, K / kMinSplitK));
  s = std::max<long long>(s, (K + max_ks - 1) / max_ks);
  int depth = (int)((K + s - 1) / s);
  depth = (depth + align - 1) / align * align;
  *ks = depth;
  *splits = (K + depth - 1) / depth;
}

// The estimated time (ns) of a tiled product on blocks of TM rows with K
// in S splits of ks: its waves of blocks times a block's FMAs, plus the
// splits' partial sums written and read back and their launch.  A 128-row
// tile's row of 256 columns over one k at ~330 GFLOP/s an SM (65 % of the
// fp32 rate: the tiles' rate at M 4096), a 64-row tile's rows 1.1x as dear
// (they ran 137 us against 150 at the ~100M trainer's shape, where this
// model without the factor put them 25 us behind), partial sums at ~2.5
// TB/s (mostly in the L2), a launch ~3 us: estimates, which
// scripts/kernel_variants.py checks at M 17 to 4096 (PERF.md).
double tiled_ns(long long M, int N, int nb, int tm, long long tiles,
                long long slots, int S, int ks) {
  const long long waves = (tiles * S + slots - 1) / slots;
  double ns = waves * (8.0 * tm) * (tm == 8 ? 1.1 : 1.0) * ks * 1.55;
  if (S > 1) ns += 8.0 * S * nb * M * N / 2500.0 + 3000.0;
  return ns;
}

// The plan for M rows at (d, f), from the occupancy and SM count of the
// current device (kernel_facts: looked up once a kernel and device): the
// streaming kernels up to kSmallMaxMF32 rows, their K split to fill the
// card once; above, the 128- or 64-row tiles and the splits of K that
// tiled_ns puts first.  Returns a cudaError_t.
int plan_f32(long long M, int d, int f, F32Plan* p) {
  p->stream = M <= kSmallMaxMF32;
  const int N[2] = {f, d}, K[2] = {d, f};
  p->ws = 0;
  for (int i = 0; i < 2; ++i) {
    const int nb = i == 0 ? 2 : 1;
    KernelFacts facts;
    long long tiles;
    if (p->stream) {
      p->rows[i] = M <= 4 ? 4 : M <= 8 ? 8 : 16;
      const int err = f32_tiles(f32_kernel<true>(true, p->rows[i], nb), M,
                                N[i], &facts, &tiles);
      if (err != 0) return err;
      choose_splits(K[i], tiles, (long long)facts.sms * facts.per_sm,
                    4 * ST_WARPS, kStreamMaxK, &p->splits[i], &p->ks[i]);
    } else {
      double best = -1.0;
      for (const int tm : {16, 8}) {
        const int err = f32_tiles(f32_kernel<true>(false, tm, nb), M, N[i],
                                  &facts, &tiles);
        if (err != 0) return err;
        const long long slots = (long long)facts.sms * facts.per_sm;
        for (int S = 1; S <= std::max(1, K[i] / kMinSplitK); ++S) {
          const int ks = ((K[i] + S - 1) / S + SG_BK - 1) / SG_BK * SG_BK;
          if (S > 1 && (K[i] + ks - 1) / ks != S) continue;  // a split empty
          const double ns = tiled_ns(M, N[i], nb, tm, tiles, slots, S, ks);
          if (best < 0 || ns < best) {
            best = ns;
            p->rows[i] = tm;
            p->splits[i] = S;
            p->ks[i] = ks;
          }
        }
      }
    }
    if (p->splits[i] > 1)
      p->ws = std::max<size_t>(
          p->ws, (size_t)p->splits[i] * nb * M * N[i] * sizeof(float));
  }
  return 0;
}

int launch_reduce(const F32Args& g, int nb, int S, cudaStream_t stream) {
  const long long mn = (long long)g.M * g.N;
  const unsigned blocks = (unsigned)std::min<long long>((mn + 255) / 256, 4096);
  if (nb == 2)
    ffn_hidden_f32_reduce_kernel<<<blocks, 256, 0, stream>>>(g, S);
  else
    ffn_out_f32_reduce_kernel<<<blocks, 256, 0, stream>>>(g, S);
  return (int)cudaGetLastError();
}

// one product of the plan (i = 0 the hidden, 1 the out product): its
// kernel, then the splits' sums where K is split
template <bool VEC>
int launch_f32_product(const F32Plan& p, int i, F32Args g,
                       cudaStream_t stream) {
  const int nb = i == 0 ? 2 : 1, S = p.splits[i];
  const F32Kernel k = f32_kernel<VEC>(p.stream, p.rows[i], nb);
  float* c = g.c;
  g.ks = p.ks[i];
  if (S > 1) g.c = nullptr;
  else g.part = nullptr;
  const long long mt =
      k.block_rows ? (g.M + k.block_rows - 1) / k.block_rows : 1;
  const long long nt = (g.N + k.block_cols - 1) / k.block_cols;
  if (k.fn == nullptr || nt > 65535 || S > 65535)
    return (int)cudaErrorInvalidValue;
  KernelFacts facts;
  int err = kernel_facts((const void*)k.fn, k.threads, k.smem, &facts);
  if (err != 0) return err;
  // streaming: blocks over columns, splits on y; tiles: rows on x
  const dim3 grid = k.block_rows
                        ? dim3((unsigned)mt, (unsigned)nt, (unsigned)S)
                        : dim3((unsigned)nt, (unsigned)S);
  void (*fn)(F32Args) = k.fn;
  fn<<<grid, k.threads, k.smem, stream>>>(g);
  err = (int)cudaGetLastError();
  if (err != 0 || S == 1) return err;
  g.c = c;
  return launch_reduce(g, nb, S, stream);
}

template <bool VEC>
int launch_f32(const F32Plan& p, const F32Args& hid, const F32Args& out,
               cudaStream_t stream) {
  int err = launch_f32_product<VEC>(p, 0, hid, stream);
  if (err != 0) return err;
  return launch_f32_product<VEC>(p, 1, out, stream);
}

template <class C, int NB>
int launch_bf16(const GemmArgs& g, cudaStream_t stream) {
  constexpr size_t bytes = C::template smem_bytes<NB>();
  void (*kernel)(GemmArgs);
  if constexpr (NB == 2) kernel = ffn_hidden_kernel<C>;
  else kernel = ffn_out_kernel<C>;
  KernelFacts facts;
  const int err = kernel_facts((const void*)kernel, C::kThreads, bytes, &facts);
  if (err != 0) return err;
  dim3 grid((unsigned)((g.M + C::BM - 1) / C::BM),
            (unsigned)((g.N + C::BN - 1) / C::BN));
  kernel<<<grid, C::kThreads, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Bytes of workspace fused_ffn_launch needs for m rows at (d, f) in dtype
// on the current device (the partial sums of fp32 products whose K is
// split; 0 for bf16 and where nothing is split), or minus a cudaError_t.
extern "C" long long fused_ffn_workspace(long long m, int d, int f,
                                         int dtype) {
  if (dtype != DT_F32 || m <= 0) return 0;
  if (m > 0x7fffffffLL || d <= 0 || f <= 0)
    return -(long long)cudaErrorInvalidValue;
  F32Plan p;
  const int err = plan_f32(m, d, f, &p);
  return err != 0 ? -(long long)err : (long long)p.ws;
}

// x: contiguous [m, d]; wg, wi: contiguous [d, f]; wo: contiguous [f, d];
// h: contiguous [m, f] scratch for the hidden activation; out: contiguous
// [m, d]; all of one dtype (DT_F32 or DT_BF16); ws: ws_bytes of scratch,
// at least fused_ffn_workspace(m, d, f, dtype).  bf16 takes the large-M
// tiles above kSmallMaxM rows where the rows allow TMA, else the small-M
// tiles; fp32 the streaming kernels up to kSmallMaxMF32 rows, else the
// tiled ones, each product split along K where plan_f32 finds it pays.
// Launches on `stream` on the calling thread's current device
// (two, or up to four with the splits' sums); returns the first non-zero
// cudaError_t, else 0.  m == 0 launches nothing.
extern "C" int fused_ffn_launch(const void* x, const void* wg, const void* wi,
                                const void* wo, void* h, void* out, void* ws,
                                long long ws_bytes, long long m, int d, int f,
                                int dtype, void* stream) {
  if (m <= 0) return 0;
  if (m > 0x7fffffffLL || d <= 0 || f <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_F32) {
    F32Plan p;
    int err = plan_f32(m, d, f, &p);
    if (err != 0) return err;
    if (ws_bytes < 0 || (size_t)ws_bytes < p.ws || (p.ws && ws == nullptr))
      return (int)cudaErrorInvalidValue;
    const bool vec = d % 4 == 0 && f % 4 == 0 && aligned16(x) &&
                     aligned16(wg) && aligned16(wi) && aligned16(wo) &&
                     aligned16(h) && aligned16(out);
    const F32Args hid{(const float*)x, (const float*)wg, (const float*)wi,
                      (float*)h, (float*)ws, (int)m, f, d, 0};
    const F32Args o{(const float*)h, (const float*)wo, nullptr, (float*)out,
                    (float*)ws, (int)m, d, f, 0};
    return vec ? launch_f32<true>(p, hid, o, s) : launch_f32<false>(p, hid, o, s);
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
