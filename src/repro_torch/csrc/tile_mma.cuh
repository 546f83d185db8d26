// Warp-level 16x8x16 tile product shared by the port's matrix kernels
// (fused_ffn.cu, flash_attention.cu).
//
// mma_tile<T>(acc, a, lda, b, bk, bn) adds A[16 x 16] * B[16 x 8] to the
// warp's fp32 accumulator tile in the m16n8k16 fragment layout: with
// lane = 4 * g + t, acc[0], acc[1] hold C[g][2t], C[g][2t + 1] and acc[2],
// acc[3] hold C[g + 8][2t], C[g + 8][2t + 1].  A is row-major in shared
// memory (element (r, k) at a[r * lda + k], lda even, a 4-byte aligned);
// element (k, n) of B is at b[k * bk + n * bn], so one routine reads a
// row-major weight tile (bk = ld, bn = 1) or a transposed key tile (bk = 1,
// bn = ld).
//
// bf16: one tensor-core mma.sync (fp32 accumulate).  fp32: the same tile
// with scalar FMAs in full fp32, in the same fragment layout, so the
// kernels' epilogues are shared; the fp32 route exists for checking against
// fp32 references, not for speed.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// dtype codes of the C entry points
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo,
                                                  __nv_bfloat16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) |
           ((uint32_t)__bfloat16_as_ushort(hi) << 16);
  }
  static __device__ __forceinline__ void run(float acc[4],
                                             const __nv_bfloat16* a, int lda,
                                             const __nv_bfloat16* b, int bk,
                                             int bn) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    uint32_t a0 = *reinterpret_cast<const uint32_t*>(a + g * lda + 2 * t);
    uint32_t a1 =
        *reinterpret_cast<const uint32_t*>(a + (g + 8) * lda + 2 * t);
    uint32_t a2 = *reinterpret_cast<const uint32_t*>(a + g * lda + 2 * t + 8);
    uint32_t a3 =
        *reinterpret_cast<const uint32_t*>(a + (g + 8) * lda + 2 * t + 8);
    uint32_t b0 = pack(b[(2 * t) * bk + g * bn], b[(2 * t + 1) * bk + g * bn]);
    uint32_t b1 =
        pack(b[(2 * t + 8) * bk + g * bn], b[(2 * t + 9) * bk + g * bn]);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

template <> struct Mma<float> {
  static __device__ __forceinline__ void run(float acc[4], const float* a,
                                             int lda, const float* b, int bk,
                                             int bn) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float x0 = a[g * lda + k], x1 = a[(g + 8) * lda + k];
      const float y0 = b[k * bk + (2 * t) * bn];
      const float y1 = b[k * bk + (2 * t + 1) * bn];
      acc[0] = fmaf(x0, y0, acc[0]);
      acc[1] = fmaf(x0, y1, acc[1]);
      acc[2] = fmaf(x1, y0, acc[2]);
      acc[3] = fmaf(x1, y1, acc[3]);
    }
  }
};

template <typename T>
__device__ __forceinline__ void mma_tile(float acc[4], const T* a, int lda,
                                         const T* b, int bk, int bn) {
  Mma<T>::run(acc, a, lda, b, bk, bn);
}

// row and column, inside the 16x8 tile, of accumulator element c (0..3)
__device__ __forceinline__ int frag_row(int c) {
  return ((threadIdx.x & 31) >> 2) + (c >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int c) {
  return 2 * (threadIdx.x & 3) + (c & 1);
}
