// Hopper (sm_90a) bfloat16 building blocks: wgmma on shared-memory
// descriptors, mbarriers, TMA tile loads and stores, setmaxnreg, and the
// host-side tensor maps the TMA reads.
//
// Tiles in shared memory. A [rows][D] bf16 tile is kept as TMA writes it
// with a swizzle: rows of ROWB = min(2 D, 128) bytes (64 elements at D 64
// and 128, 32 at D 32), so a tile with D = 128 is two boxes of 64 columns,
// box after box; inside a box the 16-byte chunk j of row r sits at chunk
// j ^ (r % 8) (128-byte swizzle) or j ^ ((r / 2) % 4) (64-byte swizzle, D
// 32). A box starts on a 1024-byte boundary. wgmma reads such a tile
// through a descriptor whose swizzle mode is the tensor map's:
//   K-major (the k index runs along a row: Q and K for Q K^T, K and Q for
//     K Q^T): 8-row groups SBO = 8 ROWB apart; the 16-wide k step kk
//     starts 32 kk bytes into the row, in box kk / (ROWB / 32);
//   MN-major (the n index runs along a row: V for P V, dO and Q for P^T dO
//     and dS^T Q, passed with the trans-b flag): the 16 k rows of a step
//     are two 8-row groups SBO = 8 ROWB apart, and the second box of
//     columns is LBO = (rows of a box) ROWB further on.
//
// Fragments. Within each warp w of a warpgroup (rows 16 w .. 16 w + 15 of
// the 64-row tile) a wgmma accumulator has mma.sync's m16n8 C layout,
// repeated over N / 8 column blocks (float d[N / 8][4]), and a register A
// operand of m64k16 has mma.sync's A layout (mma_bf16.cuh), so c_to_a
// turns a score accumulator into the A operand of the next product.
//
// wgmma is asynchronous: issue with wgmma_fence() first (it orders the
// registers written by ordinary instructions, P and dS fragments and
// rescaled accumulators, before the wgmma reads them), commit the
// group, and touch neither the accumulator nor the register A operand
// before wgmma_wait<N>() has retired the group; fence_regs keeps the
// compiler from moving accesses across those points. ptxas serializes
// every wgmma of a kernel (a wait after each) when one is issued on a
// branch, when ordinary code writes an accumulator inside a pipeline
// stage, or when registers run short; chip_smoke.py's [build] prints its
// notes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace sm90 {

// ----------------------------------------------------------------- tiles

// swizzled tile geometry for head dim D
template <int D>
struct Tile {
  static constexpr int ROWB = D >= 64 ? 128 : 2 * D;  // bytes of a box row
  static constexpr int ELEMS = ROWB / 2;              // columns of a box
  static constexpr int NBOX = D / ELEMS;              // boxes along d
  static constexpr int KSTEPS = ROWB / 32;            // k steps in a box
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : 2;  // desc swizzle
  static_assert(ROWB == 128 || ROWB == 64, "D in {32, 64, 128}");
};

// byte offset of element (r, col) in a swizzled tile whose boxes hold
// `rows` rows each
template <int D>
__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int col) {
  using G = Tile<D>;
  const uint32_t off = r * G::ROWB + (col % G::ELEMS) * 2;
  return (col / G::ELEMS) * rows * G::ROWB +
         (off ^ ((off >> 3) & (G::ROWB == 128 ? 0x70 : 0x30)));
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: rows row0 .. row0 + 63 (A) or N rows (B) of a tile at
// shared address `tile` with `rows` rows a box, at k step 0
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0) {
  using G = Tile<D>;
  return make_desc(tile + row0 * G::ROWB, 16, 8 * G::ROWB, G::LAYOUT);
}

// the same operand at k step kk: the start address (the descriptor's low
// field, in 16-byte units) moves 32 bytes along a row, or to the next
// box of `rows` rows
template <int D>
__device__ __forceinline__ uint64_t kstep(uint64_t desc0, int rows, int kk) {
  using G = Tile<D>;
  return desc0 + (((kk / G::KSTEPS) * rows * G::ROWB +
                   (kk % G::KSTEPS) * 32) >> 4);
}

// A descriptor put together where it is used: held across a long stretch
// of code, a 64-bit descriptor takes two registers, its start field one
// (the high half is a constant)
__device__ __forceinline__ uint64_t desc_at(uint64_t desc) {
  uint64_t d;
  asm volatile("mov.b64 %0, {%1, %2};\n"
               : "=l"(d)
               : "r"(static_cast<uint32_t>(desc)),
                 "r"(static_cast<uint32_t>(desc >> 32)));
  return d;
}

// MN-major B operand (k by n, n = all D columns) of a tile with `rows`
// rows a box, at k row 0; k rows k0 .. k0 + 15 are kstep_mn(desc, k0)
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows) {
  using G = Tile<D>;
  return make_desc(tile, rows * G::ROWB, 8 * G::ROWB, G::LAYOUT);
}
template <int D>
__device__ __forceinline__ uint64_t kstep_mn(uint64_t desc0, int k0) {
  return desc0 + ((k0 * Tile<D>::ROWB) >> 4);
}

// rows r0 + g and r0 + g + 8 of an accumulator of N columns (float
// d[N / 8][4], this lane's C fragments), times s0 and s1, as bf16 into
// columns col0 .. col0 + N - 1 of a swizzled [rows][D] tile at shared
// address `tile` (a 32-bit address: a generic pointer held through the
// main loop would take two registers)
template <int D, int N>
__device__ __forceinline__ void stage_rows(uint32_t tile, int rows, int r0,
                                           int col0,
                                           const float (&d)[N / 8][4],
                                           float s0, float s1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const int col = col0 + n * 8 + 2 * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sc = h ? s1 : s0;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       tile + tile_offset<D>(rows, r0 + g + 8 * h, col)),
                   "r"(mma_bf16::pack_bf16x2(d[n][2 * h] * sc,
                                             d[n][2 * h + 1] * sc))
                   : "memory");
    }
  }
}

// ------------------------------------------------------------ tile order

// Tile i of a launch over `heads` heads of `per_head` tiles each, in the
// order blocks start: heads in chunks of `chunk`, and within a chunk the
// tiles j = 0 of every head, then j = 1, ... . The caller makes j = 0 its
// heaviest tile (causal), and a chunk's tiles (head_chunk) are about two
// waves of blocks, so the K and V (or Q and dO) rows a head's tiles share
// are read while they are still in L2.
__device__ __forceinline__ void tile_order(int i, int heads, int per_head,
                                           int chunk, int& head, int& j) {
  const int c0 = i / (chunk * per_head) * chunk;  // the chunk's first head
  const int hc = min(chunk, heads - c0);          // heads in the chunk
  const int r = i - c0 * per_head;
  j = r / hc;
  head = c0 + r % hc;
}

// heads a chunk: about two waves of `sms` blocks of per_head tiles a head
inline int head_chunk(int sms, int per_head) {
  const int c = 2 * sms / per_head;
  return c > 0 ? c : 1;
}

// streaming multiprocessors of the current device
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// two floats from shared memory at a 32-bit shared address (8-byte
// aligned): a generic pointer would hold two registers
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// ----------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pin registers at this point of the program (no instruction that reads
// or writes them moves across)
template <int NB>
__device__ __forceinline__ void fence_regs(float (&d)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i])::"memory");
}
template <int NB>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[n][i])::"memory");
}

template <int N>
__device__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                         int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                         uint64_t b, int scale_d);
// d = A B (scale_d 0) or d += A B over m64n32k16; A and B K-major in
// shared memory
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[4][4], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// the same with A from registers (mma.sync's A layout per warp) and B,
// k by n, MN-major in shared memory (the trans-b flag set)
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[4][4],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}
// d = A B (scale_d 0) or d += A B over m64n64k16; A and B K-major in
// shared memory
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// the same with A from registers (mma.sync's A layout per warp) and B,
// k by n, MN-major in shared memory (the trans-b flag set)
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}
// d = A B (scale_d 0) or d += A B over m64n128k16; A and B K-major in
// shared memory
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[16][4], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

// the same with A from registers (mma.sync's A layout per warp) and B,
// k by n, MN-major in shared memory (the trans-b flag set)
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// ------------------------------------------------------ mbarriers, TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// make the inits visible to the async proxy (TMA) and the other threads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// arrive on the barrier once this thread's earlier cp.async copies have
// landed (an arrival the init count includes)
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
// arrive and expect `bytes` more of TMA transfer in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// wait until the phase of parity `parity` has completed. A phase that
// never completes (a fault in the ring's bookkeeping) traps after about
// 2^34 clocks (8.7 s at 1.98 GHz): the launch fails instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// one box of a 3D tensor map (d, T, bh) into shared memory; rows past T
// come back zero-filled and still count their bytes
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// one box from shared memory to a 3D tensor map; rows past T are not
// written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// commit the stores issued so far as one group
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until every committed store group has read its shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// order this thread's shared-memory writes before async-proxy reads
// (a TMA store, a wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `threads` threads with id `id` (1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// registers a thread of this warpgroup may hold from here on
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ------------------------------------------------------- host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded (no -lcuda at
// link time), or nullptr
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a [bh, T, D] row-major bf16 tensor as a 3D map (d, T, bh) with boxes of
// Tile<D>::ELEMS columns by `box_rows` rows, swizzled as Tile<D> says:
// the head is a dimension of its own, so a box that runs past T is
// zero-filled instead of reading the next head's rows
template <int D>
cudaError_t rows_map(CUtensorMap* map, const void* base, int bh, int t,
                     int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  using G = Tile<D>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(t) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(G::ELEMS),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             G::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace sm90
