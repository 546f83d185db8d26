// Warp-level tile helpers shared by the port's matrix kernels
// (fused_ffn.cu, flash_attention.cu).
//
// bf16 route (tensor cores): 16-byte cp.async copies from device memory
// into shared memory, ldmatrix loads of the m16n8k16 operand fragments
// (.trans for an operand stored k-major, as a row-major weight or V tile),
// and mma.sync with fp32 accumulation.  Fragment layout of the m16n8
// accumulator: with lane = 4 * g + t, c[0], c[1] hold C[g][2t], C[g][2t+1]
// and c[2], c[3] hold C[g + 8][2t], C[g + 8][2t + 1].
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// dtype codes of the C entry points
enum { DT_F32 = 0, DT_BF16 = 1 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// row and column, inside the 16x8 accumulator tile, of element c (0..3)
__device__ __forceinline__ int frag_row(int c) {
  return ((threadIdx.x & 31) >> 2) + (c >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int c) {
  return 2 * (threadIdx.x & 3) + (c & 1);
}

// ---- bf16: cp.async, ldmatrix, mma.sync ------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; src_bytes = 0 writes zeros (the source
// address must still be a valid one)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane i gives the shared address of row i % 8 of
// matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Each lane's element offset, inside a 16 x 16 tile of leading dimension
// ld, of the row it addresses for the fragment loads below; a kernel adds
// it to a tile's shared address once and steps through tiles by constants.
// A fragment (row-major A) and the k-major B fragments of two n8 tiles
// (.trans) share one pattern; the n-major B fragments another.
__device__ __forceinline__ int frag_off_a(int ld) {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int frag_off_b_nmajor(int ld) {
  const int lane = threadIdx.x & 31;
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

// A fragment (16 x 16, row-major at a[r * lda + k]) of rows 0..15, depth
// 0..15 from a pointer at (row 0, k 0)
__device__ __forceinline__ void load_a_frag(uint32_t r[4], const bf16* a,
                                            int lda) {
  ldmatrix_x4(r, smem_addr(a + frag_off_a(lda)));
}

// B fragments of two n8 tiles (n 0..7 and 8..15), depth 0..15, from a
// k-major tile (element (k, n) at b[k * ldb + n], a row-major weight or V):
// r[0], r[1] are tile 0's b0, b1 and r[2], r[3] tile 1's
__device__ __forceinline__ void load_b_frag_kmajor(uint32_t r[4],
                                                   const bf16* b, int ldb) {
  ldmatrix_x4_trans(r, smem_addr(b + frag_off_a(ldb)));
}

// fast 2^x (one MUFU.EX2, flushing denormals; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
