// Warp-level TF32 tensor-core helpers for sm_80+ (used on sm_90a): the
// m16n8k8 tf32 mma with float32 accumulation, round-to-nearest tf32
// conversion, and the 3xTF32 split that carries float32 products through
// the tensor cores. Copies, ldmatrix and its lane addresses come from
// mma_bf16.cuh.
//
// Fragment layouts of mma.m16n8k8 .tf32 (PTX ISA, "Matrix fragments for
// mma.m16n8k8"), for lane = 4 * g + c (g = lane / 4, c = lane % 4):
//   A (16 x 8, row-major), four registers:
//     a0 = A[g][c]    a1 = A[g+8][c]    a2 = A[g][c+4]    a3 = A[g+8][c+4]
//   B (8 x 8, k by n), two registers:
//     b0 = B[c][g]    b1 = B[c+4][g]
//   C, D (16 x 8, float32), four registers:
//     d0, d1 = C[g][2c, 2c+1]  d2, d3 = C[g+8][2c, 2c+1]
// A b16 ldmatrix of float32 rows moves each 16-byte row as four words:
// lane 4g + c receives word c of row g, which is the A and B layout above
// (mma_bf16::a_addr, bn_addr). The C fragment is not the next product's A
// fragment (columns 2c, 2c+1 against c, c+4); a product that takes a C
// tile as its left operand reads its k step in the order 0, 2, 4, 6, 1,
// 3, 5, 7 and must read the right operand's rows in the same order.
//
// 3xTF32: x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a b =
// lo_a hi_b + hi_a lo_b + hi_a hi_b (the lo lo term is below float32's
// rounding). Each product is exact in the tensor core and every sum is
// float32, so only the dropped lo lo term and the float32 sums round; one
// TF32 product (hi hi only) keeps 11 bits of each operand.
//
// c_to_a_tf32 below carries the k order above: it makes the A fragment of
// a C tile (which is also a TF32 wgmma's register A operand, warp by
// warp); the right operand's rows must be read, or written, in that
// order (sm90_tf32.cuh's transposed tiles).
#pragma once

#include <stdint.h>

namespace mma_tf32 {

// x rounded to the nearest tf32 (ties away from zero), low 13 bits zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// the split of four float32 words held as raw bits (an ldmatrix result)
__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// d += A B over one 16 x 8 x 8 tile, tf32 operands, float32 accumulation
__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d0 += A B0 and d1 += A B1 for two n-blocks (b = {b0, b1 of n-block 0,
// b0, b1 of n-block 1}) as 3xTF32: the two small products first, then
// hi hi; the two n-blocks alternate, so no mma depends on the one just
// before it.
__device__ __forceinline__ void mma_1688_x3(
    float (&d0)[4], float (&d1)[4], const uint32_t (&ah)[4],
    const uint32_t (&al)[4], const uint32_t (&bh)[4],
    const uint32_t (&bl)[4]) {
  mma_1688(d0, al, bh[0], bh[1]);
  mma_1688(d1, al, bh[2], bh[3]);
  mma_1688(d0, ah, bl[0], bl[1]);
  mma_1688(d1, ah, bl[2], bl[3]);
  mma_1688(d0, ah, bh[0], bh[1]);
  mma_1688(d1, ah, bh[2], bh[3]);
}

// The A fragment of an 8-wide k step of a product whose left operand is
// the 16 x 8 float32 C tile c of an earlier product, split for 3xTF32:
// columns c and c + 4 of the fragment take the tile's columns 2c and 2c + 1
// (above), so the right operand's rows must be in that order.
__device__ __forceinline__ void c_to_a_tf32(const float (&c)[4],
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  const uint32_t a[4] = {__float_as_uint(c[0]), __float_as_uint(c[2]),
                         __float_as_uint(c[1]), __float_as_uint(c[3])};
  split4(a, hi, lo);
}

}  // namespace mma_tf32
