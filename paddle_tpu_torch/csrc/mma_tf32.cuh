// TF32 helpers of the float32 kernels: round-to-nearest tf32 conversion,
// the 3xTF32 split that carries float32 products through the TF32 tensor
// cores, and the register A operand made from an accumulator.
//
// Fragment layouts of mma.m16n8k8 .tf32 (PTX ISA, "Matrix fragments for
// mma.m16n8k8"), which a TF32 wgmma's register A operand and accumulator
// take warp by warp, for lane = 4 * g + c (g = lane / 4, c = lane % 4):
//   A (16 x 8, row-major), four registers:
//     a0 = A[g][c]    a1 = A[g+8][c]    a2 = A[g][c+4]    a3 = A[g+8][c+4]
//   C, D (16 x 8, float32), four registers:
//     d0, d1 = C[g][2c, 2c+1]  d2, d3 = C[g+8][2c, 2c+1]
// The C fragment is not the next product's A fragment (columns 2c, 2c+1
// against c, c+4); a product that takes a C tile as its left operand reads
// its k step in the order 0, 2, 4, 6, 1, 3, 5, 7 and must read the right
// operand's rows in the same order.
//
// 3xTF32: x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a b =
// lo_a hi_b + hi_a lo_b + hi_a hi_b (the lo lo term is below float32's
// rounding). Each product is exact in the tensor core and every sum is
// float32, so only the dropped lo lo term and the float32 sums round; one
// TF32 product (hi hi only) keeps 11 bits of each operand.
//
// c_to_a_tf32 below carries the k order above: it makes the A fragment of
// a C tile; the right operand's rows must be written in that order
// (sm90_tf32.cuh's transposed tiles).
#pragma once

#include <stdint.h>

namespace mma_tf32 {

// x rounded to the nearest tf32 (ties away from zero), low 13 bits zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both tf32. lo, the finite difference x - hi, is rounded on
// its bits: half a tf32 place added to the magnitude, the low 13 bits
// cleared, which is cvt.rna's result for every finite value in two integer
// operations (split runs on every element a float32 kernel reads)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// The A fragment of an 8-wide k step of a product whose left operand is
// the 16 x 8 float32 C tile c of an earlier product, split for 3xTF32:
// columns c and c + 4 of the fragment take the tile's columns 2c and 2c + 1
// (above), so the right operand's rows must be in that order.
__device__ __forceinline__ void c_to_a_tf32(const float (&c)[4],
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

}  // namespace mma_tf32
