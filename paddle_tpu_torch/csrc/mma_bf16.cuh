// bfloat16 helpers of the Hopper kernels (sm_90a): shared addresses, a
// 4-byte cp.async, the exp2 of the softmax, and the f32 -> bf16x2 packing
// that turns an accumulator into the next product's register A operand.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), which a bf16 wgmma's register A operand and accumulator
// take warp by warp, for lane = 4 * g + c (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major), four bf16x2 registers:
//     a0 = A[g][2c, 2c+1]      a1 = A[g+8][2c, 2c+1]
//     a2 = A[g][2c+8, 2c+9]    a3 = A[g+8][2c+8, 2c+9]
//   C, D (16 x 8, float32), four registers:
//     d0, d1 = C[g][2c, 2c+1]  d2, d3 = C[g+8][2c, 2c+1]
// So the C fragments of two neighbouring n-blocks of a product, packed
// pairwise to bf16x2, are the A fragment of the next product's 16-wide k
// step: a softmax tile goes from one product to the next in registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared memory, zero-filled when valid is false.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
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

}  // namespace mma_bf16
