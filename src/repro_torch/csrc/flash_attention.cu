// Flash attention: causal / sliding-window attention with an fp32 online
// softmax, reading GQA keys and values where they lie.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py: _attn_kernel
// (launched by flash_attention).  That kernel ran the grid (B*H, S/128,
// S/128) with the kv axis in order on one core, carrying (acc, m, l) in VMEM
// scratch across kv steps, and needed S % 128 == 0 and q, k, v of one head
// count.  Here one block (or warpgroup) owns (batch * head, a tile of
// queries) and loops over the live key tiles itself, so the carry lives in
// registers: the fp32 output accumulator of its rows and their running max
// and sum.
//
// Layout: q is [B, H, S, dqk], k [B, Hkv, S, dqk], v [B, Hkv, S, dv] and o
// [B, H, S, dv] by strides (the last dim contiguous), so the model's [B, S,
// H, d] tensors are read and written in place, and query head h reads kv
// head h / (H / Hkv) (the reference's head order h = kv_head * G + g), with
// no copy of k or v per query head.  Widths (dqk, dv): (d, d) for d in 16,
// 32, 64, 128, 256, and MLA's (192, 128) (deepseek-v2: 128 + 64 rope
// columns of q and k, 128 of v), which reads and multiplies no padding.
// Output: acc / max(l, 1e-30), cast to q's dtype, so a fully masked row
// gives 0 as the reference's NaN -> 0.
//
// Routes, by dtype and widths:
// - bf16 (64, 64), (128, 128), (192, 128) and (256, 256), where TMA can
//   read the strides and addresses (flash_attn_wgmma_kernel),
//   FlashAttention-3 style: persistent blocks of one producer warp and one
//   consumer warpgroup of 64 query rows, each walking work items (a head's
//   64 query positions) heaviest first.  The producer keeps TMA loads of Q
//   and of K, V tiles (128-byte swizzled boxes of 64 columns) in flight
//   through a ring of stages with mbarriers; the consumer runs wgmma: S = Q
//   K^T from shared memory (K read K-major), then O += P V with P in
//   registers as the A operand (the accumulator's layout is the A
//   fragment's) and V read MN-major (the transpose bit), and runs the
//   softmax of S_t while P_{t-1} V_{t-1} is on the tensor cores.  d 64:
//   three blocks an SM, three stages of 64 keys.  MLA's (192, 128): Q and K
//   tiles of three boxes, 128-key tiles (m64n128 S), one Q buffer and two
//   stages (185 KB, one block an SM), a head's query tiles walked together
//   so that its K and V (335 MB over deepseek's 1,024 heads of an 8 x 512
//   prefill) are read from device memory about once.  d 256 (gemma3): Q, K
//   and V tiles of four boxes (32 KB each at 64 rows), 64-key tiles, one Q
//   buffer and three stages (224 KB, one block an SM); O is a 64 x 256 fp32
//   accumulator, 128 registers a thread, beside S's 32; P V is two m64n128
//   products a 16-key step.
// - bf16, d 16 and 32, and any width whose strides or addresses TMA cannot
//   read (flash_attn_bf16_kernel): the same online softmax on warp-level
//   mma.sync, 4 warps of 16 query rows, operands by ldmatrix (.trans for
//   V), 16-byte cp.async copies (element loads where rows are not 16-byte
//   aligned) into two stages.
// - fp32, every width (flash_attn_f32_kernel): full fp32 FMAs on the CUDA
//   cores (no TF32), register-blocked: each lane holds a block of S (TM
//   query rows x BKV / 16 keys) and of O (TM rows x dv / 16 columns), reads
//   its operands from shared memory as float4 (conflict-free: rows padded to
//   an odd number of 16-byte units), K and V arrive by 16-byte cp.async
//   into two stages, P goes through a per-warp shared tile laid out so that
//   a lane reads its rows of a key as float4.  64 query rows a block, or 32
//   where 64 would leave the card's block slots empty (the ~100M trainer's
//   microbatch).  No atomics: every call repeats bit for bit.
// All: the softmax runs in base 2 with scale * log2(e) folded into one FMA
// before each exponential; masks are applied only on tiles that cross a
// row's live range (the diagonal, the window's edge, a ragged end); tiles
// dead for a whole block are never loaded; query tiles are issued heaviest
// first (the last causal tile has the most keys).
//
// Bound: at tinyllama's 8 x 512 prefill (B 8, H 32, Hkv 4, S 512, d 64) the
// function must move 37.7 MB in bf16 (q, k, v and o once), 11 us at 3.35
// TB/s, against 8.6 GFLOP of causal products (8.7 us at 989 TFLOP/s); in
// fp32 (the reference's default fp32 cache) 75.5 MB, 23 us, against the
// same 8.6 GFLOP at 67 TFLOP/s outside the tensor cores, 128 us: the fp32
// route is bound by its FMAs.  MLA at deepseek's prefill (B 8, H = Hkv =
// 128, S 512, (192, 128)): 671 MB, 200 us, against 86 GFLOP of live
// products (87 us).  gemma3-4b's prefill (B 4, H 8, Hkv 4, S 2,048, d 256,
// causal): 68.7 GFLOP, 69 us, against 100 MB, 30 us; its local layers'
// 1,024-key window leaves ~3/4 of the pairs (51 us).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hkv, S, causal, window;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];  // strides of b, h, s (elements)
  int vec;  // 16-byte aligned rows: cp.async and vector stores allowed
};

// ---- bf16 on mma.sync (d = 16, 32, 256; any d where TMA cannot read) ------

// 4 warps of 16 query rows a block; keys a tile: 64, two stages.  Q's
// fragments stay in registers where d <= 64; MINB blocks an SM at least.
// DQK: the width of q and k; DV: of v and o.
constexpr int MQ = 64, MKV = 64, MWARPS = 4, MTHREADS = 32 * MWARPS;
template <int DQK, int DV> struct MmaAttnCfg {
  static constexpr bool QREG = DQK <= 64;
  static constexpr int MINB = DQK <= 32 ? 4 : DQK == 64 ? 2 : 1;
};

template <int DQK, int DV>
constexpr size_t smem_bytes_mma() {
  return ((size_t)(MQ + 2 * MKV) * (DQK + 8) + 2 * MKV * (DV + 8)) *
         sizeof(bf16);
}

// rows r0 .. r0 + ROWS - 1 of one head (row s at src + s * ss) into dst
// [ROWS][D + 8], zero past S
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ss, int r0, int S,
                                          int vec) {
  constexpr int LD = D + 8, CH = D / 8;
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * CH; i += MTHREADS) {
      const int r = i / CH, c = (i % CH) * 8, s = r0 + r;
      const bool ok = s < S;
      cp_async16(dst + r * LD + c, ok ? src + s * ss + c : src, ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < ROWS * D; i += MTHREADS) {
      const int r = i / D, c = i % D, s = r0 + r;
      dst[r * LD + c] = s < S ? src[s * ss + c] : zero;
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(MTHREADS, MmaAttnCfg<DQK, DV>::MINB)
    flash_attn_bf16_kernel(Args a) {
  constexpr bool QREG = MmaAttnCfg<DQK, DV>::QREG;
  constexpr int LD = DQK + 8, LDV = DV + 8;
  constexpr uint32_t K_STAGE = MKV * LD * sizeof(bf16);  // bytes
  constexpr uint32_t V_STAGE = MKV * LDV * sizeof(bf16);
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + MQ * LD;       // [2][MKV][LD]
  bf16* Vs = Ks + 2 * MKV * LD;  // [2][MKV][LDV]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = a.S;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kh = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;  // heaviest tiles first
  const bf16* q = (const bf16*)a.q + b * a.qs[0] + h * a.qs[1];
  const bf16* k = (const bf16*)a.k + b * a.ks[0] + kh * a.ks[1];
  const bf16* v = (const bf16*)a.v + b * a.vs[0] + kh * a.vs[1];
  bf16* o = (bf16*)a.o + b * a.os[0] + h * a.os[1];

  const int kv_end = a.causal ? min(S, q0 + MQ) : S;
  const int kv_begin = a.window ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = kv_begin / MKV, t_end = (kv_end + MKV - 1) / MKV;

  load_rows<DQK, MQ>(Qs, q, a.qs[2], q0, S, a.vec);
  cp_async_commit();
  load_rows<DQK, MKV>(Ks, k, a.ks[2], t_begin * MKV, S, a.vec);
  load_rows<DV, MKV>(Vs, v, a.vs[2], t_begin * MKV, S, a.vec);
  cp_async_commit();

  // each lane's fragment addresses: tiles are then reached by constants
  const int row0 = q0 + 16 * warp;  // this warp's rows: row0 .. row0 + 15
  const uint32_t q_lane = smem_addr(Qs + 16 * warp * LD + frag_off_a(LD));
  const uint32_t k_lane = smem_addr(Ks + frag_off_b_nmajor(LD));
  const uint32_t v_lane = smem_addr(Vs + frag_off_a(LDV));
  uint32_t qf[QREG ? DQK / 16 : 1][4];
  if constexpr (QREG) {
    cp_async_wait<1>();  // Q has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      ldmatrix_x4(qf[kk], q_lane + 16 * kk * 2);
  }
  // the live keys of this lane's rows g and g + 8, lo <= key <= hi
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + (lane >> 2) + 8 * hh;
    hi[hh] = a.causal ? min(S - 1, r) : S - 1;
    lo[hh] = a.window ? r - a.window + 1 : 0;
  }

  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m_run[2] = {-kInf, -kInf}, l_run[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_rows<DQK, MKV>(Ks + (st ^ 1) * MKV * LD, k, a.ks[2],
                          (t + 1) * MKV, S, a.vec);
      load_rows<DV, MKV>(Vs + (st ^ 1) * MKV * LDV, v, a.vs[2],
                         (t + 1) * MKV, S, a.vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) have landed
    __syncthreads();
    const int k0 = t * MKV;
    const bool dead = (a.causal && k0 > row0 + 15) ||
                      (a.window && k0 + MKV - 1 <= row0 - a.window);
    if (!dead) {
      const uint32_t kt = k_lane + st * K_STAGE, vt = v_lane + st * V_STAGE;
      float sc[MKV / 8][4];
#pragma unroll
      for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        uint32_t af[4];
        if constexpr (QREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) af[r] = qf[kk][r];
        } else {
          ldmatrix_x4(af, q_lane + 16 * kk * 2);
        }
#pragma unroll
        for (int j = 0; j < MKV / 16; ++j) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, kt + (16 * j * LD + 16 * kk) * 2);
          mma_bf16(sc[2 * j], af, bfr[0], bfr[1]);
          mma_bf16(sc[2 * j + 1], af, bfr[2], bfr[3]);
        }
      }
      // keys outside [lo, hi] of a row, only where the tile crosses bounds
      if (k0 < max(lo[0], lo[1]) || k0 + MKV - 1 > min(hi[0], hi[1])) {
        const int c0 = k0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = c0 + 8 * j + (c & 1);
            if (key < lo[c >> 1] || key > hi[c >> 1]) sc[j][c] = -kInf;
          }
      }
      float mx[2] = {-kInf, -kInf};
#pragma unroll
      for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], sc[j][c]);
      float alpha[2], msl[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m_run[hh], mx[hh]);
        // a row with no live key yet keeps max -inf: use 0 there, so that
        // its terms are 2^-inf = 0 and never inf - inf
        msl[hh] = (m_new == -kInf ? 0.f : m_new) * sl2;
        alpha[hh] = fast_exp2(m_run[hh] * sl2 - msl[hh]);
        m_run[hh] = m_new;
        l_run[hh] *= alpha[hh];  // this lane's share of the row sum
      }
#pragma unroll
      for (int j = 0; j < MKV / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = fast_exp2(fmaf(sc[j][c], sl2, -msl[c >> 1]));
          l_run[c >> 1] += p;
          sc[j][c] = p;
        }
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];
#pragma unroll
      for (int kk = 0; kk < MKV / 16; ++kk) {
        // P's accumulator fragments of keys 16 kk .. 16 kk + 15 are the A
        // fragment of this depth step
        const float* s0 = sc[2 * kk];
        const float* s1 = sc[2 * kk + 1];
        const uint32_t pa[4] = {
            pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
            pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
#pragma unroll
        for (int n = 0; n < DV / 16; ++n) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, vt + (16 * kk * LDV + 16 * n) * 2);
          mma_bf16(acc[2 * n], pa, bfr[0], bfr[1]);
          mma_bf16(acc[2 * n + 1], pa, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }
  cp_async_wait<0>();

  float l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = l_run[hh] + __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    l[hh] = 1.f / fmaxf(l[hh], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + frag_row(2 * hh);
      if (r >= S) continue;
      bf16* dst = o + r * a.os[2] + 8 * n + frag_col(2 * hh);
      const float x0 = acc[n][2 * hh] * l[hh], x1 = acc[n][2 * hh + 1] * l[hh];
      if (a.vec) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        dst[1] = __float2bfloat16_rn(x1);
      }
    }
}

// ---- bf16 on TMA + wgmma ((64, 64), (128, 128), (192, 128), (256, 256)) --

// A block: one producer warp and one consumer warpgroup of 64 query rows,
// persistent over work items (a head's 64 query positions); keys a tile:
// BKV; Q in QS buffers (2: the next item's Q loads while this one runs), K
// and V in KVS stages; MINB blocks an SM at least.  More resident
// warpgroups beat larger tiles and shared ones here (PERF.md): three
// blocks an SM at d = 64.  DQK: the width of q and k; DV: of v and o.
// HEADS_FIRST: items walk a head's query tiles together (heaviest first)
// instead of every head's last tile first, so that the K and V of the
// heads in flight stay in the L2 while their query tiles read them: MLA's
// 128 heads a sequence hold K and V of 335 MB at deepseek's 8 x 512
// prefill (the other instances' fit the 50 MB L2 at their serving
// shapes).  (192, 128)'s choices were measured with
// scripts/kernel_variants.py (PERF.md).
template <int DQK, int DV> struct WgAttnCfg {
  static constexpr int BKV = 64, QS = 2, KVS = 3, MINB = DQK == 64 ? 3 : 2;
  static constexpr bool HEADS_FIRST = false;
};
template <> struct WgAttnCfg<192, 128> {
  static constexpr int BKV = 128, QS = 1, KVS = 2, MINB = 1;
  static constexpr bool HEADS_FIRST = true;
};
// d 256: a 64-key K and V stage is 64 KB, so one Q buffer and three
// stages fill 224 KB (one block an SM; two stages ran 1.3x slower at
// gemma3's prefill, PERF.md); gemma3's K and V (32 MB at B 4, S 2,048)
// stay in the L2 whatever the order
template <> struct WgAttnCfg<256, 256> {
  static constexpr int BKV = 64, QS = 1, KVS = 3, MINB = 1;
  static constexpr bool HEADS_FIRST = false;
};
constexpr int WG_THREADS = 128 + 32;

template <int DQK, int DV>
constexpr size_t smem_bytes_wg() {
  using C = WgAttnCfg<DQK, DV>;
  return 1024 +
         (size_t)(C::QS * 64 * DQK + C::KVS * C::BKV * (DQK + DV)) * 2 +
         (2 * C::KVS + 2 * C::QS) * sizeof(uint64_t);
}

// q, k, v as 4-d tensor maps (d, s, head, batch), boxes of 64 x 64
struct AttnMaps {
  CUtensorMap q, k, v;
};

// Work item i -> batch, head, first query row and live key tiles: the
// last query tiles of every head first, or (heads_first) each head's query
// tiles in turn, its last first
struct AttnItem {
  int b, h, q0, t_begin, t_end;
};

template <int BKV, bool HEADS_FIRST>
__device__ __forceinline__ AttnItem attn_item(const Args& a, int B, int i) {
  const int n_q = (a.S + 63) / 64, bh = B * a.H;
  const int qt = HEADS_FIRST ? i % n_q : i / bh;
  const int hb = HEADS_FIRST ? i / n_q : i % bh;
  AttnItem it;
  it.q0 = (n_q - 1 - qt) * 64;
  it.b = hb / a.H;
  it.h = hb % a.H;
  const int kv_end = a.causal ? min(a.S, it.q0 + 64) : a.S;
  const int kv_begin = a.window ? max(0, it.q0 - a.window + 1) : 0;
  it.t_begin = kv_begin / BKV;
  it.t_end = (kv_end + BKV - 1) / BKV;
  return it;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(WG_THREADS, WgAttnCfg<DQK, DV>::MINB)
    flash_attn_wgmma_kernel(const __grid_constant__ AttnMaps maps, Args a,
                            int B, int n_items) {
  using C = WgAttnCfg<DQK, DV>;
  constexpr int BKV = C::BKV, KVS = C::KVS, QS = C::QS;
  constexpr int NBQ = DQK / 64, NBV = DV / 64;
  constexpr int Q_BYTES = 64 * DQK * 2, K_BYTES = BKV * DQK * 2,
                V_BYTES = BKV * DV * 2;
  // a tile: NBQ (NBV) column blocks of 64 d (one TMA box each), 64 rows
  // (Q) or BKV rows (K, V) of 128 bytes a block
  constexpr int BLK = 64 * 128, BLK_KV = BKV * 128;
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ __align__(1024) unsigned char attn_smem[];
  unsigned char* Qs =  // QS Q tiles: this item's (and the next one's)
      attn_smem + ((1024 - (smem_addr(attn_smem) & 1023)) & 1023);
  unsigned char* Ks = Qs + QS * Q_BYTES;   // KVS stages
  unsigned char* Vs = Ks + KVS * K_BYTES;  // KVS stages
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + KVS * V_BYTES);
  uint64_t* empty = full + KVS;
  uint64_t* q_full = empty + KVS;   // QS
  uint64_t* q_empty = q_full + QS;  // QS
  const int S = a.S, lane = threadIdx.x & 31;
  const int group = a.H / a.Hkv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KVS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    for (int s = 0; s < QS; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Both roles walk the same items and number the K, V tiles they pass
  // (g) and the items (n), which give every barrier's stage and phase.
  if (threadIdx.x >= 128) {  // the producer warp
    if (lane == 0) {
      int g = 0, n = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
        const AttnItem it = attn_item<BKV, C::HEADS_FIRST>(a, B, i);
        const int qb = n % QS, kh = it.h / group;
        if (n >= QS) mbar_wait(&q_empty[qb], (n / QS - 1) & 1);
        mbar_expect_tx(&q_full[qb], Q_BYTES);
#pragma unroll
        for (int c = 0; c < NBQ; ++c)
          tma_load_4d(Qs + qb * Q_BYTES + c * BLK, &maps.q, &q_full[qb],
                      64 * c, it.q0, it.h, it.b);
        for (int t = it.t_begin; t < it.t_end; ++t, ++g) {
          const int s = g % KVS;
          if (g >= KVS) mbar_wait(&empty[s], (g / KVS - 1) & 1);
          mbar_expect_tx(&full[s], K_BYTES + V_BYTES);
#pragma unroll
          for (int c = 0; c < NBQ; ++c)
            tma_load_4d(Ks + s * K_BYTES + c * BLK_KV, &maps.k, &full[s],
                        64 * c, t * BKV, kh, it.b);
#pragma unroll
          for (int c = 0; c < NBV; ++c)
            tma_load_4d(Vs + s * V_BYTES + c * BLK_KV, &maps.v, &full[s],
                        64 * c, t * BKV, kh, it.b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup
  const float sl2 = a.scale * kLog2e;
  int g = 0, n = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
    const AttnItem it = attn_item<BKV, C::HEADS_FIRST>(a, B, i);
    const int qb = n % QS;
    const unsigned char* Qw = Qs + qb * Q_BYTES;
    const int row0 = it.q0 + 16 * (threadIdx.x / 32);  // this warp's rows
    // the live keys of this thread's rows g and g + 8, lo <= key <= hi
    int lo[2], hi[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + (lane >> 2) + 8 * hh;
      hi[hh] = a.causal ? min(S - 1, r) : S - 1;
      lo[hh] = a.window ? r - a.window + 1 : 0;
    }
    float acc[DV / 2];  // O, m64nDV layout: acc[4 n + c], n8 tile n of d
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) acc[j] = 0.f;
    float m_run[2] = {-kInf, -kInf}, l_run[2] = {0.f, 0.f};
    // P of the previous tile (the A fragments of its 16-key steps) and its
    // stage: in flight in O += P V while this tile's softmax runs.  The
    // first product adds 0 * V of the first tile (finite: loaded or zeros).
    uint32_t p_prev[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) p_prev[kk][r] = 0u;
    int st_prev = g % KVS;
    auto issue_pv = [&]() {
      const unsigned char* Vp = Vs + st_prev * V_BYTES;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t dv = gmma_desc(Vp + kk * 16 * 128, BLK_KV, 1024);
        if constexpr (DV == 64) {
          wgmma_rs_m64n64k16<1>(acc, p_prev[kk], dv);
        } else {
          wgmma_rs_m64n128k16<1>(acc, p_prev[kk], dv);
          // d 256: columns 128 .. 255 are the next two 64-column boxes
          if constexpr (DV == 256)
            wgmma_rs_m64n128k16<1>(
                acc + 64, p_prev[kk],
                gmma_desc(Vp + 2 * BLK_KV + kk * 16 * 128, BLK_KV, 1024));
        }
      }
    };
    mbar_wait(&q_full[qb], (n / QS) & 1);

    // Each iteration: S_t = Q K_t and O += P_{t-1} V_{t-1} go to the
    // tensor cores back to back; the softmax of S_t runs while P_{t-1}
    // V_{t-1} is in flight; then O is rescaled and the stage of tile t - 1
    // goes back to the producer.  No product is issued conditionally (the
    // compiler would then wait on each one).
    for (int t = it.t_begin; t < it.t_end; ++t, ++g) {
      const int st = g % KVS;
      mbar_wait(&full[st], (g / KVS) & 1);
      const int k0 = t * BKV;
      float sc[BKV / 2];  // S, m64nBKV layout: sc[4 j + c], n8 tile j
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const int col = (kk % 4) * 32;  // 16 d into the 128-byte rows
        const uint64_t dq = gmma_desc(Qw + (kk / 4) * BLK + col, 16, 1024);
        const uint64_t dk =
            gmma_desc(Ks + st * K_BYTES + (kk / 4) * BLK_KV + col, 16, 1024);
        if constexpr (BKV == 64)
          wgmma_ss_m64n64k16<0>(sc, dq, dk);
        else
          wgmma_ss_m64n128k16<0>(sc, dq, dk);
      }
      wgmma_commit();
      issue_pv();
      wgmma_commit();
      wgmma_wait<1>();  // S_t has landed; P_{t-1} V_{t-1} may be in flight

      // keys outside [lo, hi] of a row (causal, window, ragged end) only
      // where the tile crosses some row's bounds
      if (k0 < max(lo[0], lo[1]) || k0 + BKV - 1 > min(hi[0], hi[1])) {
        const int c0 = k0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = c0 + 8 * j + (c & 1);
            if (key < lo[c >> 1] || key > hi[c >> 1]) sc[4 * j + c] = -kInf;
          }
      }
      float mx[2] = {-kInf, -kInf};
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float alpha[2], msl[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m_run[hh], mx[hh]);
        // a row with no live key yet keeps max -inf: use 0 there, so that
        // its terms are 2^-inf = 0 and never inf - inf
        msl[hh] = (m_new == -kInf ? 0.f : m_new) * sl2;
        alpha[hh] = fast_exp2(m_run[hh] * sl2 - msl[hh]);
        m_run[hh] = m_new;
        l_run[hh] *= alpha[hh];  // this lane's share of the row sum
      }
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) {
        sc[j] = fast_exp2(fmaf(sc[j], sl2, -msl[(j >> 1) & 1]));
        l_run[(j >> 1) & 1] += sc[j];
      }
      wgmma_wait<0>();  // P_{t-1} V_{t-1} has landed in O
      if (t > it.t_begin && threadIdx.x == 0) mbar_arrive(&empty[st_prev]);
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        p_prev[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        p_prev[j / 2][(j % 2) * 2 + 1] =
            pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
      st_prev = st;
    }
    wgmma_fence();
    issue_pv();
    wgmma_commit();
    wgmma_wait<0>();
    if (threadIdx.x == 0) {  // the last tile and Q go back to the producer
      mbar_arrive(&empty[st_prev]);
      mbar_arrive(&q_empty[qb]);
    }

    float l[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = l_run[hh] + __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      l[hh] = 1.f / fmaxf(l[hh], 1e-30f);
    }
    bf16* o = (bf16*)a.o + it.b * a.os[0] + it.h * a.os[1];
#pragma unroll
    for (int nn = 0; nn < DV / 8; ++nn)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + frag_row(2 * hh);
        if (r < S)
          *reinterpret_cast<__nv_bfloat162*>(o + r * a.os[2] + 8 * nn +
                                             frag_col(2 * hh)) =
              __floats2bfloat162_rn(acc[4 * nn + 2 * hh] * l[hh],
                                    acc[4 * nn + 2 * hh + 1] * l[hh]);
      }
  }
}

// the 4-d tensor map (d, s, heads, batch) of q, k or v, by element
// strides, read in boxes of 64 d by `rows` positions
int attn_map(CUtensorMap* map, const void* ptr, int d, int S, int heads,
             int B, const long long* bhs, int rows) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)S, (uint64_t)heads,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)bhs[2] * 2, (uint64_t)bhs[1] * 2,
                               (uint64_t)bhs[0] * 2};
  const uint32_t box[4] = {64, (uint32_t)rows, 1, 1};
  return tma_map_bf16(map, ptr, 4, dims, strides, box);
}

// ---- fp32: register-blocked SIMT tiles ------------------------------------

// 4 warps a block; a warp owns 2 TM query rows, and its lane = 16 rg + kg
// holds rows rg + 2 i (i < TM) of them: their S over keys kg + 16 j (j <
// TN) of a tile, and their O over dv / 16 columns (groups of VW adjacent
// columns, 16 VW apart), so that the 16 lanes of a half warp own whole rows
// and the row max and sum are reduced by 4 shuffles.  Keys a tile: BKV, 32
// where q/k and v together are 256 wide or more (two stages of 64 keys
// would not fit beside Q).  Q, K and V tiles are s-major in shared memory
// (as the model lays them out, so cp.async copies rows unchanged), Q and K
// rows padded to an odd number of 16-byte units: the 8 lanes of a quarter
// warp read 8 different keys' float4 in 8 different banks, and its 8 rows'
// float4 of Q as one broadcast.  P goes through the warp's own tile Ps[key]
// [2 TM + 4], a lane's TM rows of a key adjacent (read as TM / 4 float4).
constexpr int FThreads = 128;
template <int DQK, int DV, int TM> struct F32Cfg {
  static constexpr int BKV = DQK + DV >= 256 ? 32 : 64, BQ = 8 * TM;
  static constexpr int TN = BKV / 16, LDQ = DQK + 4, LDV = DV,
                       LDP = 2 * TM + 4;
  static constexpr int OC = DV / 16, VW = OC >= 4 ? 4 : OC, NG = OC / VW;
};

template <int DQK, int DV, int TM>
constexpr size_t smem_bytes_f32() {
  using C = F32Cfg<DQK, DV, TM>;
  return (size_t)(C::BQ * C::LDQ + 2 * C::BKV * (C::LDQ + C::LDV) +
                  4 * C::BKV * C::LDP) *
         sizeof(float);
}

// rows r0 .. r0 + ROWS - 1 of one head (row s at src + s * ss) into dst
// [ROWS][LD], zero past S: 16-byte cp.async where rows are 16-byte aligned
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ss, int r0, int S,
                                              int vec) {
  if (vec) {
    constexpr int CH = D / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * CH; i += FThreads) {
      const int r = i / CH, c = (i % CH) * 4, s = r0 + r;
      const bool ok = s < S;
      cp_async16(dst + r * LD + c, ok ? src + s * ss + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += FThreads) {
      const int r = i / D, c = i % D, s = r0 + r;
      dst[r * LD + c] = s < S ? src[s * ss + c] : 0.f;
    }
  }
}

// VW adjacent floats at p (VW = 1, 2 or 4)
template <int VW>
__device__ __forceinline__ void load_vw(float (&v)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (VW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int DQK, int DV, int TM>
__global__ void __launch_bounds__(FThreads) flash_attn_f32_kernel(Args a) {
  using C = F32Cfg<DQK, DV, TM>;
  constexpr int BKV = C::BKV, BQ = C::BQ, TN = C::TN, LDQ = C::LDQ,
                LDV = C::LDV, LDP = C::LDP, VW = C::VW, NG = C::NG;
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][LDQ]
  float* Ks = Qs + BQ * LDQ;                       // [2][BKV][LDQ]
  float* Vs = Ks + 2 * BKV * LDQ;                  // [2][BKV][LDV]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 4, kg = lane & 15;
  float* Pw = Vs + 2 * BKV * LDV + warp * BKV * LDP;  // this warp's P
  const int S = a.S;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kh = h / (a.H / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const float* q = (const float*)a.q + b * a.qs[0] + h * a.qs[1];
  const float* k = (const float*)a.k + b * a.ks[0] + kh * a.ks[1];
  const float* v = (const float*)a.v + b * a.vs[0] + kh * a.vs[1];
  float* o = (float*)a.o + b * a.os[0] + h * a.os[1];

  const int kv_end = a.causal ? min(S, q0 + BQ) : S;
  const int kv_begin = a.window ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = kv_begin / BKV, t_end = (kv_end + BKV - 1) / BKV;

  load_rows_f32<DQK, LDQ, BQ>(Qs, q, a.qs[2], q0, S, a.vec);
  load_rows_f32<DQK, LDQ, BKV>(Ks, k, a.ks[2], t_begin * BKV, S, a.vec);
  load_rows_f32<DV, LDV, BKV>(Vs, v, a.vs[2], t_begin * BKV, S, a.vec);
  cp_async_commit();

  // this warp's rows: row0 .. row0 + 2 TM - 1; this lane's: row0 + rg + 2 i
  const int row0 = q0 + 2 * TM * warp;
  const float* Qw = Qs + (2 * TM * warp + rg) * LDQ;  // row i: + 2 i LDQ
  // the live keys of the warp's first and last row bound every row's
  const int hi_min = a.causal ? min(S - 1, row0) : S - 1;
  const int lo_max = a.window ? row0 + 2 * TM - a.window : 0;

  float acc[TM][NG * VW];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < NG * VW; ++c) acc[i][c] = 0.f;
  float m_run[TM], l_run[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) m_run[i] = -kInf, l_run[i] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_rows_f32<DQK, LDQ, BKV>(Ks + (st ^ 1) * BKV * LDQ, k, a.ks[2],
                                   (t + 1) * BKV, S, a.vec);
      load_rows_f32<DV, LDV, BKV>(Vs + (st ^ 1) * BKV * LDV, v, a.vs[2],
                                  (t + 1) * BKV, S, a.vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) have landed
    __syncthreads();
    const int k0 = t * BKV;
    const bool dead = row0 >= S || (a.causal && k0 > row0 + 2 * TM - 1) ||
                      (a.window && k0 + BKV - 1 <= row0 - a.window);
    if (!dead) {
      const float* Kt = Ks + st * BKV * LDQ + kg * LDQ;  // key kg + 16 j
      const float* Vt = Vs + st * BKV * LDV + kg * VW;
      float sc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DQK; d += 4) {
        float4 kv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Kt + 16 * j * LDQ + d);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(Qw + 2 * i * LDQ + d);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            sc[i][j] = fmaf(qv.x, kv[j].x, sc[i][j]);
            sc[i][j] = fmaf(qv.y, kv[j].y, sc[i][j]);
            sc[i][j] = fmaf(qv.z, kv[j].z, sc[i][j]);
            sc[i][j] = fmaf(qv.w, kv[j].w, sc[i][j]);
          }
        }
      }
      // keys outside a row's live range, only where the tile crosses some
      // row's bounds
      if (k0 < lo_max || k0 + BKV - 1 > hi_min) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = row0 + rg + 2 * i;
          const int hi = a.causal ? min(S - 1, r) : S - 1;
          const int lo = a.window ? r - a.window + 1 : 0;
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int key = k0 + kg + 16 * j;
            if (key < lo || key > hi) sc[i][j] = -kInf;
          }
        }
      }
      float alpha[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float mx = sc[i][0];
#pragma unroll
        for (int j = 1; j < TN; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
        for (int x = 1; x < 16; x <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
        const float m_new = fmaxf(m_run[i], mx);
        // a row with no live key yet keeps max -inf: use 0 there, so that
        // its terms are 2^-inf = 0 and never inf - inf
        const float msl = (m_new == -kInf ? 0.f : m_new) * sl2;
        alpha[i] = fast_exp2(m_run[i] * sl2 - msl);
        m_run[i] = m_new;
        l_run[i] *= alpha[i];  // this lane's share of the row sum
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          sc[i][j] = fast_exp2(fmaf(sc[i][j], sl2, -msl));
          l_run[i] += sc[i][j];
        }
      }
      // P[row rg + 2 i][key kg + 16 j] at Pw[(kg + 16 j) LDP + TM rg + i]
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int i = 0; i < TM; i += 4)
          *reinterpret_cast<float4*>(Pw + (kg + 16 * j) * LDP + TM * rg +
                                     i) = make_float4(sc[i][j], sc[i + 1][j],
                                                      sc[i + 2][j],
                                                      sc[i + 3][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < NG * VW; ++c) acc[i][c] *= alpha[i];
      __syncwarp();
#pragma unroll 4
      for (int key = 0; key < BKV; ++key) {
        float p[TM];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(Pw + key * LDP + TM * rg + i);
          p[i] = x.x, p[i + 1] = x.y, p[i + 2] = x.z, p[i + 3] = x.w;
        }
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          float vv[VW];
          load_vw<VW>(vv, Vt + key * LDV + 16 * VW * g);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int c = 0; c < VW; ++c)
              acc[i][g * VW + c] = fmaf(p[i], vv[c], acc[i][g * VW + c]);
        }
      }
      __syncwarp();  // P is read before the next tile overwrites it
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int x = 1; x < 16; x <<= 1)
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], x);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float l = fmaxf(l_run[i], 1e-30f);
    const int r = row0 + rg + 2 * i;
    if (r >= S) continue;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float* dst = o + r * a.os[2] + 16 * VW * g + kg * VW;
      float y[VW];
#pragma unroll
      for (int c = 0; c < VW; ++c) y[c] = acc[i][g * VW + c] / l;
      if constexpr (VW == 4) {
        if (a.vec) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(y[0], y[1], y[2], y[3]);
          continue;
        }
      }
#pragma unroll
      for (int c = 0; c < VW; ++c) dst[c] = y[c];
    }
  }
}

template <int DQK, int DV>
int launch_tma(const Args& a, int B, cudaStream_t stream) {
  constexpr int BKV = WgAttnCfg<DQK, DV>::BKV;
  AttnMaps maps;
  int err = attn_map(&maps.q, a.q, DQK, a.S, a.H, B, a.qs, 64);
  if (err == 0) err = attn_map(&maps.k, a.k, DQK, a.S, a.Hkv, B, a.ks, BKV);
  if (err == 0) err = attn_map(&maps.v, a.v, DV, a.S, a.Hkv, B, a.vs, BKV);
  if (err != 0) return err;
  constexpr size_t bytes = smem_bytes_wg<DQK, DV>();
  constexpr int threads = WG_THREADS;
  auto kernel = flash_attn_wgmma_kernel<DQK, DV>;
  // persistent: as many blocks as the card holds at once, each walking the
  // items i = blockIdx.x, blockIdx.x + gridDim.x, ...
  KernelFacts facts;
  if ((err = kernel_facts((const void*)kernel, threads, bytes, &facts)) != 0)
    return err;
  const long long items = (long long)B * a.H * ((a.S + 63) / 64);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long slots = (long long)facts.sms * facts.per_sm;
  const int grid = (int)(items < slots ? items : slots);
  kernel<<<grid, threads, bytes, stream>>>(maps, a, B, (int)items);
  return (int)cudaGetLastError();
}

template <int DQK, int DV, int TM>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  constexpr int BQ = F32Cfg<DQK, DV, TM>::BQ;
  constexpr size_t bytes = smem_bytes_f32<DQK, DV, TM>();
  auto kernel = flash_attn_f32_kernel<DQK, DV, TM>;
  if ((a.S + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
  KernelFacts facts;
  const int err = kernel_facts((const void*)kernel, FThreads, bytes, &facts);
  if (err != 0) return err;
  dim3 grid((unsigned)(B * a.H), (unsigned)((a.S + BQ - 1) / BQ));
  kernel<<<grid, FThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch(const Args& a, int B, int dtype, cudaStream_t stream) {
  if constexpr ((DQK == 64 || DQK == 128 || DQK == 256) && DV == DQK ||
                (DQK == 192 && DV == 128)) {
    if (dtype == DT_BF16 && a.vec) return launch_tma<DQK, DV>(a, B, stream);
  }
  if (dtype == DT_F32) {
    // 64 query rows a block, or 32 where the 64-row blocks would leave
    // block slots of the card empty: twice the blocks, each warp's key
    // loop over half the rows
    KernelFacts facts;
    const int err =
        kernel_facts((const void*)flash_attn_f32_kernel<DQK, DV, 8>,
                     FThreads, smem_bytes_f32<DQK, DV, 8>(), &facts);
    if (err != 0) return err;
    const long long blocks = (long long)B * a.H * ((a.S + 63) / 64);
    return blocks < (long long)facts.sms * facts.per_sm
               ? launch_f32<DQK, DV, 4>(a, B, stream)
               : launch_f32<DQK, DV, 8>(a, B, stream);
  }
  auto kernel = flash_attn_bf16_kernel<DQK, DV>;
  constexpr size_t bytes = smem_bytes_mma<DQK, DV>();
  if ((a.S + MQ - 1) / MQ > 65535) return (int)cudaErrorInvalidValue;
  KernelFacts facts;
  const int err = kernel_facts((const void*)kernel, MTHREADS, bytes, &facts);
  if (err != 0) return err;
  dim3 grid((unsigned)(B * a.H), (unsigned)((a.S + MQ - 1) / MQ));
  kernel<<<grid, MTHREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// The (q/k, v) head widths the kernel is built for (WIDTH_PAIRS in
// kernels/flash_attention.py): (d, d) for d in 16, 32, 64, 128, 256, and
// MLA's (192, 128).
static bool supports(int dqk, int dv) {
  if (dqk == 192) return dv == 128;
  return dqk == dv &&
         (dqk == 16 || dqk == 32 || dqk == 64 || dqk == 128 || dqk == 256);
}

// q: [B, H, S, dqk]; k: [B, Hkv, S, dqk]; v: [B, Hkv, S, dv]; o: [B, H, S,
// dv], with H % Hkv == 0; each given by its b, h, s strides in elements,
// the last dim contiguous; all of one dtype (DT_F32 or DT_BF16).  window
// == 0 means no window.  One launch on `stream` on the calling thread's
// current device; returns its cudaError_t (0 on success).  S == 0
// launches nothing.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int S, int dqk, int dv, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (H <= 0 || Hkv <= 0 || H % Hkv != 0 || window < 0 ||
      (dtype != DT_BF16 && dtype != DT_F32) || !supports(dqk, dv))
    return (int)cudaErrorInvalidValue;
  const long long strides[12] = {qsb, qsh, qss, ksb, ksh, kss,
                                 vsb, vsh, vss, osb, osh, oss};
  // rows 16-byte aligned: every stride a whole number of 16-byte units
  const int unit = dtype == DT_BF16 ? 8 : 4;
  int vec = aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % unit == 0;
  Args a{q, k, v, o, H, Hkv, S, causal, window, scale,
         {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
         vec};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dqk) {
    case 16: return launch<16, 16>(a, B, dtype, st);
    case 32: return launch<32, 32>(a, B, dtype, st);
    case 64: return launch<64, 64>(a, B, dtype, st);
    case 128: return launch<128, 128>(a, B, dtype, st);
    case 192: return launch<192, 128>(a, B, dtype, st);
    case 256: return launch<256, 256>(a, B, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
