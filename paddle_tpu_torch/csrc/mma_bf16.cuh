// Warp-level bfloat16 tensor-core helpers for sm_80+ (used on sm_90a):
// cp.async copies into shared memory, ldmatrix fragment loads, the
// m16n8k16 bf16 mma with float32 accumulation, and f32 -> bf16x2 packing.
// The copies and ldmatrix addresses serve float32 tiles too (mma_tf32.cuh).
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), for lane = 4 * g + c (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major), four bf16x2 registers:
//     a0 = A[g][2c, 2c+1]      a1 = A[g+8][2c, 2c+1]
//     a2 = A[g][2c+8, 2c+9]    a3 = A[g+8][2c+8, 2c+9]
//   B (16 x 8, k by n), two bf16x2 registers:
//     b0 = B[2c, 2c+1][g]      b1 = B[2c+8, 2c+9][g]
//   C, D (16 x 8, float32), four registers:
//     d0, d1 = C[g][2c, 2c+1]  d2, d3 = C[g+8][2c, 2c+1]
// So the C fragments of two neighbouring n-blocks of a product, packed
// pairwise to bf16x2, are the A fragment of the next product's 16-wide k
// step: a softmax tile goes from one mma to the next in registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; with valid false
// nothing is read and the 16 bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory, zero-filled when valid is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory. Lanes 8i .. 8i+7 give the
// addresses of matrix i's eight 16-byte rows; r[i] receives matrix i with
// lane 4g + c holding its row g, columns 2c and 2c+1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same with each matrix transposed: lane 4g + c receives rows 2c and
// 2c+1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += A B over one 16 x 8 x 16 tile, bf16 operands, float32 accumulation
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special function unit: ex2.approx.ftz, relative error about
// 2^-22, results below 2^-126 flushed to 0 (p and alpha of a softmax)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to nearest bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k step kk of a product whose left operand is the
// 16 x (8 * NB) float32 C tile c[NB][4] of an earlier product: the two
// n-blocks 2kk and 2kk+1, rounded to bf16.
template <int NB>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[NB][4], int kk) {
  a[0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Lane addresses for ldmatrix_x4 over a row-major tile with row stride
// `ld` (elements), at (r0, c0). The tile holds bf16, or float32 read as
// tf32 (mma_tf32.cuh): a 16-byte matrix row is 8 elements or 4 words (E).
//  - a_addr: the A fragment of the 16 x 2E block (rows r0.., cols c0..);
//  - bn_addr: B fragments of two n-blocks (b0, b1 of n-block 0, then of
//    n-block 1) where the tile is stored n by k (rows = n, cols = k), as
//    K is for Q K^T; use plain ldmatrix;
//  - bk_addr (bf16 only): the same where the tile is stored k by n (rows
//    = k, cols = n), as V is for P V; use ldmatrix .trans.
template <typename T>
__device__ __forceinline__ const T* a_addr(const T* tile, int ld, int r0,
                                           int c0, int lane) {
  constexpr int E = 16 / sizeof(T);
  return tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * E;
}
template <typename T>
__device__ __forceinline__ const T* bn_addr(const T* tile, int ld, int n0,
                                            int k0, int lane) {
  constexpr int E = 16 / sizeof(T);
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
         ((lane >> 3) & 1) * E;
}
__device__ __forceinline__ const __nv_bfloat16* bk_addr(
    const __nv_bfloat16* tile, int ld, int k0, int n0, int lane) {
  return tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
         ((lane >> 4) << 3);
}

// Copy rows [r0, r0 + ROWS) of a row-major [t, D] matrix of bf16 or
// float32 into a shared tile whose rows are padded by 16 bytes (stride
// D + 8 or D + 4 elements), 16 bytes a thread per step with NTHREADS
// threads; rows at or past t are zero-filled (their source address is
// clamped to row 0 and not read).
template <int ROWS, int D, int NTHREADS, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src, int r0,
                                                int t) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CHUNKS = D / E;      // chunks per row
  static_assert(ROWS * CHUNKS % NTHREADS == 0, "whole steps only");
#pragma unroll
  for (int j = 0; j < ROWS * CHUNKS / NTHREADS; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    const int r = i / CHUNKS, c = (i % CHUNKS) * E;
    const bool ok = r0 + r < t;
    cp_async_16(dst + r * (D + E) + c,
                src + (ok ? static_cast<size_t>(r0 + r) * D : 0) + c, ok);
  }
}

}  // namespace mma_bf16
