// MLA decode in latent space: one query a row attends over DeepSeek-V2's
// compressed cache as it lies, never expanded.
//
// Replaces no TPU kernel: the JAX package decodes MLA in plain jnp
// (src/repro/models/layers.py mla_apply expands the whole latent cache
// through wukv every step, and so did the port until this kernel).  The
// weight absorption of the DeepSeek-V2 paper moves wukv off the cache and
// onto the query and the output (two batched products outside this
// kernel): a head's score is q_lat . ckv + q_rope . k_rope, with q_lat =
// q_nope W_UK[h]^T, and its output o_lat = softmax . ckv, then o_lat
// W_UV[h].  All 128 heads of a row share one 576-wide key (ckv 512 ||
// k_rope 64) and one 512-wide value (ckv itself): multi-query attention
// with 128 query rows a batch row.
//
// Layout: q_lat [B, H, 512] and q_rope [B, H, 64] by their b and h strides,
// ckv [B, T, 512] and k_rope [B, T, 64] (the cache, read in place) by their
// b and t strides, each last dim contiguous; positions (int64) by its b
// stride; o [B, H, 512] by its b and h strides; all bf16.  Row b attends
// to slots 0 .. min(positions[b], T - 1), the slots the expansion's mask
// leaves live (a row with a negative position has none and gives zeros).
//
// Design: a block owns (batch row, a tile of 64 heads, a split of that
// row's live key tiles).  The 64 x 576 query tile is loaded once and the
// 64-key tiles (576 columns: eight 64-column boxes of ckv and one of
// k_rope, 72 KB) by TMA into two stages, each reloaded by thread 0 as soon
// as both warpgroups are done with it (no producer warp: a ninth warp
// would put three on one of the SM's four register quadrants and cap every
// thread at 168 registers).  Two warpgroups each compute S = Q K^T over
// the 576 columns (wgmma, the same S in both: no exchange between them),
// run the fp32 online softmax in base 2, and multiply P (registers) by
// their 256 columns of V, which are the ckv boxes of the same stage: the
// 64 x 512 fp32 O accumulator is split between the two warpgroups, 128
// registers a thread.  Q and two stages fill 216 KB: one block an SM.
// The key tiles of a row are split so that B x H / 64 x splits blocks fill
// the card in one wave (the wrapper picks splits from the shape and the SM
// count); each split writes its unnormalised O with its row max and sum to
// a workspace, and a combine kernel merges them in split order.  With one
// split the main kernel writes the output itself.  No atomics: every call
// repeats bit for bit.
//
// Bound: at deepseek's decode_long step (B 16, H 128, a 2,184-slot cache)
// a layer must read the live cache once, 16 x 2,184 x 576 x 2 B = 40 MB,
// 12 us at 3.35 TB/s, against 9.4 GFLOP of products (9.5 us at 989
// TFLOP/s): bound by the bytes.  The two head tiles of a row read its keys
// twice; the second read comes from the L2 while both run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "tile_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// the latent widths the kernel is built for (LATENT_WIDTHS in
// kernels/mla_decode.py): deepseek-v2's kv_lora_rank and rope_head_dim
constexpr int KVR = 512, ROPE = 64, DK = KVR + ROPE;
constexpr int HT = 64;      // heads a block: one wgmma M tile
constexpr int BKV = 64;     // keys a tile
constexpr int KVS = 2;      // key stages
constexpr int NB = DK / 64;  // 64-column boxes of a Q or K tile
constexpr int BOX = 64 * 128;     // a box: 64 rows of 128 bytes
constexpr int TILE = NB * BOX;    // a Q tile or a key stage: 72 KB
constexpr int THREADS = 2 * 128;
constexpr size_t SMEM = 1024 + (size_t)(1 + KVS) * TILE +
                        (2 * KVS + 1) * sizeof(uint64_t);

struct Maps {
  CUtensorMap q_lat, q_rope, ckv, k_rope;
};

struct Args {
  void* o;
  float* ws;  // splits > 1: O [B, H, splits, 512], then (m, l) [B, H, splits]
  const long long* pos;
  long long pos_s, os_b, os_h;
  int B, H, T, splits;
  float scale;
};

__global__ void __launch_bounds__(THREADS, 1)
    mla_decode_kernel(const __grid_constant__ Maps maps, Args a) {
  const int split = blockIdx.x, h0 = blockIdx.y * HT, b = blockIdx.z;
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ __align__(1024) unsigned char mla_smem[];
  unsigned char* Qs =
      mla_smem + ((1024 - (smem_addr(mla_smem) & 1023)) & 1023);
  unsigned char* Ks = Qs + TILE;  // KVS stages
  uint64_t* full = reinterpret_cast<uint64_t*>(Ks + KVS * TILE);
  uint64_t* empty = full + KVS;
  uint64_t* q_full = empty + KVS;

  // this row's live slots, and this split's share of their tiles
  const long long qpos = a.pos[b * a.pos_s];
  const int len = qpos < 0 ? 0 : (int)min(qpos + 1, (long long)a.T);
  const int n_tiles = (len + BKV - 1) / BKV;
  const int t_begin = n_tiles * split / a.splits;
  const int n = n_tiles * (split + 1) / a.splits - t_begin;

  // key tile t_begin + g into its stage (thread 0)
  auto load_keys = [&](int g) {
    const int s = g % KVS, k0 = (t_begin + g) * BKV;
    unsigned char* Kt = Ks + s * TILE;
    mbar_expect_tx(&full[s], TILE);
#pragma unroll
    for (int c = 0; c < NB - 1; ++c)
      tma_load_3d(Kt + c * BOX, &maps.ckv, &full[s], 64 * c, k0, b);
    tma_load_3d(Kt + (NB - 1) * BOX, &maps.k_rope, &full[s], 0, k0, b);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < KVS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival from each warpgroup
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n > 0) {
      mbar_expect_tx(q_full, TILE);
#pragma unroll
      for (int c = 0; c < NB - 1; ++c)
        tma_load_3d(Qs + c * BOX, &maps.q_lat, q_full, 64 * c, h0, b);
      tma_load_3d(Qs + (NB - 1) * BOX, &maps.q_rope, q_full, 0, h0, b);
      for (int g = 0; g < KVS && g < n; ++g) load_keys(g);
    }
  }
  __syncthreads();

  // a warpgroup: O's columns 256 wg .. 256 wg + 255
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid & 31;
  const float sl2 = a.scale * kLog2e;
  float acc[128];  // two m64n128 accumulators: acc[4 j + c], n8 tile j
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.f;
  float m_run[2] = {-kInf, -kInf}, l_run[2] = {0.f, 0.f};
  if (n > 0) mbar_wait(q_full, 0);
  for (int g = 0; g < n; ++g) {
    const int st = g % KVS, t = t_begin + g;
    const unsigned char* Kt = Ks + st * TILE;
    mbar_wait(&full[st], (g / KVS) & 1);
    float sc[BKV / 2];  // S, m64n64 layout
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) sc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const int off = (kk / 4) * BOX + (kk % 4) * 32;  // 16 columns
      wgmma_ss_m64n64k16<0>(sc, gmma_desc(Qs + off, 16, 1024),
                            gmma_desc(Kt + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();

    // keys past the row's live slots, only in its last tile
    const int k0 = t * BKV;
    if (k0 + BKV > len) {
      const int c0 = k0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + 8 * j + (c & 1) >= len) sc[4 * j + c] = -kInf;
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
      msl[hh] = m_new * sl2;  // finite: every tile holds a live key
      alpha[hh] = fast_exp2(m_run[hh] * sl2 - msl[hh]);
      m_run[hh] = m_new;
      l_run[hh] *= alpha[hh];  // this lane's share of the row sum
    }
    uint32_t p[BKV / 16][4];  // P as the A fragments of its 16-key steps
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) {
      sc[j] = fast_exp2(fmaf(sc[j], sl2, -msl[(j >> 1) & 1]));
      l_run[(j >> 1) & 1] += sc[j];
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      p[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      p[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
#pragma unroll
    for (int j = 0; j < 128; ++j) acc[j] *= alpha[(j >> 1) & 1];

    // O += P V: V is this warpgroup's four ckv boxes of the stage, read
    // MN-major (the next 64 columns a box further)
    const unsigned char* Vt = Kt + 4 * wg * BOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wgmma_rs_m64n128k16<1>(acc, p[kk],
                             gmma_desc(Vt + kk * 16 * 128, BOX, 1024));
      wgmma_rs_m64n128k16<1>(
          acc + 64, p[kk], gmma_desc(Vt + 2 * BOX + kk * 16 * 128, BOX, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (tid == 0) mbar_arrive(&empty[st]);
    // thread 0 refills the stage once both warpgroups are done with it
    if (threadIdx.x == 0 && g + KVS < n) {
      mbar_wait(&empty[st], (g / KVS) & 1);
      load_keys(g + KVS);
    }
    __syncwarp();
  }

  float l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = l_run[hh] + __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  // this thread's rows (heads) g and g + 8 of its warp's 16, and columns
  const int r0 = h0 + 16 * (tid / 32) + (lane >> 2);
  const int col0 = 256 * wg + 2 * (lane & 3);
  if (a.splits == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      if (r >= a.H) continue;
      const float inv = 1.f / fmaxf(l[hh], 1e-30f);
      bf16* o = (bf16*)a.o + b * a.os_b + r * a.os_h + col0;
#pragma unroll
      for (int nn = 0; nn < 32; ++nn)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * nn) =
            __floats2bfloat162_rn(acc[4 * nn + 2 * hh] * inv,
                                  acc[4 * nn + 2 * hh + 1] * inv);
    }
    return;
  }
  const size_t parts = (size_t)a.B * a.H * a.splits;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= a.H) continue;
    const size_t part = ((size_t)b * a.H + r) * a.splits + split;
    float* o = a.ws + part * KVR + col0;
#pragma unroll
    for (int nn = 0; nn < 32; ++nn)
      *reinterpret_cast<float2*>(o + 8 * nn) =
          make_float2(acc[4 * nn + 2 * hh], acc[4 * nn + 2 * hh + 1]);
    if (wg == 0 && (lane & 3) == 0)
      reinterpret_cast<float2*>(a.ws + parts * KVR)[part] =
          make_float2(m_run[hh], l[hh]);
  }
}

// The splits of row (b, h) merged in split order: each split's O and sum
// weighed by 2^((m_s - m) scale log2 e) against the largest max m; one
// block of 128 threads a (b, h), 4 columns a thread.
__global__ void __launch_bounds__(128) mla_combine_kernel(Args a) {
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int S = a.splits;
  const float kInf = __int_as_float(0x7f800000);
  const float sl2 = a.scale * kLog2e;
  const size_t parts = (size_t)a.B * a.H * S;
  const float2* ml = reinterpret_cast<const float2*>(a.ws + parts * KVR) +
                     (size_t)bh * S;
  float m = -kInf;
  for (int s = 0; s < S; ++s) m = fmaxf(m, ml[s].x);
  float l = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < S; ++s) {
    const float2 p = ml[s];
    if (p.x == -kInf) continue;  // a split with no live key
    const float w = fast_exp2((p.x - m) * sl2);
    const float4 v = reinterpret_cast<const float4*>(
        a.ws + ((size_t)bh * S + s) * KVR)[threadIdx.x];
    l = fmaf(w, p.y, l);
    o.x = fmaf(w, v.x, o.x);
    o.y = fmaf(w, v.y, o.y);
    o.z = fmaf(w, v.z, o.z);
    o.w = fmaf(w, v.w, o.w);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
      (bf16*)a.o + b * a.os_b + h * a.os_h + 4 * threadIdx.x);
  out[0] = __floats2bfloat162_rn(o.x * inv, o.y * inv);
  out[1] = __floats2bfloat162_rn(o.z * inv, o.w * inv);
}

// the 3-d tensor map (d, rows, batch) of a bf16 [B, rows, d] operand by
// element strides, read in boxes of 64 d by 64 rows
int map3(CUtensorMap* map, const void* ptr, int d, int rows, int B,
         long long row_stride, long long b_stride) {
  const uint64_t dims[3] = {(uint64_t)d, (uint64_t)rows, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)row_stride * 2,
                               (uint64_t)b_stride * 2};
  const uint32_t box[3] = {64, 64, 1};
  return tma_map_bf16(map, ptr, 3, dims, strides, box);
}

}  // namespace

// q_lat: [B, H, 512], q_rope: [B, H, 64], ckv: [B, T, 512], k_rope: [B, T,
// 64], each by its b and h (or t) element strides with the last dim
// contiguous, bf16, 16-byte aligned rows; pos: int64, row b at pos[b *
// pos_s]; o: [B, H, 512] bf16 by its b and h strides.  ws: the workspace
// of splits > 1, B * H * splits * (512 + 2) floats.  Two launches on
// `stream` (one with a single split) on the calling thread's current
// device; returns the first nonzero cudaError_t (0 on success).  B == 0
// launches nothing.
extern "C" int mla_decode_launch(
    const void* q_lat, const void* q_rope, const void* ckv,
    const void* k_rope, const long long* pos, void* o, float* ws, int B,
    int H, int T, int kvr, int rope, int splits, long long qsb,
    long long qsh, long long rsb, long long rsh, long long csb,
    long long cst, long long ksb, long long kst, long long pos_s,
    long long osb, long long osh, float scale, void* stream) {
  if (B <= 0) return 0;
  if (kvr != KVR || rope != ROPE || H <= 0 || T <= 0 || splits < 1 ||
      B > 65535 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Maps maps;
  int err = map3(&maps.q_lat, q_lat, KVR, H, B, qsh, qsb);
  if (err == 0) err = map3(&maps.q_rope, q_rope, ROPE, H, B, rsh, rsb);
  if (err == 0) err = map3(&maps.ckv, ckv, KVR, T, B, cst, csb);
  if (err == 0) err = map3(&maps.k_rope, k_rope, ROPE, T, B, kst, ksb);
  if (err != 0) return err;
  KernelFacts facts;
  if ((err = kernel_facts((const void*)mla_decode_kernel, THREADS, SMEM,
                          &facts)) != 0)
    return err;
  Args a{o, ws, pos, pos_s, osb, osh, B, H, T, splits, scale};
  cudaStream_t st = (cudaStream_t)stream;
  mla_decode_kernel<<<dim3(splits, (H + HT - 1) / HT, B), THREADS, SMEM,
                      st>>>(maps, a);
  if ((err = (int)cudaGetLastError()) != 0 || splits == 1) return err;
  mla_combine_kernel<<<B * H, 128, 0, st>>>(a);
  return (int)cudaGetLastError();
}
