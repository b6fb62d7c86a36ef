// Hopper (sm_90a) float32 building blocks for 3xTF32 on wgmma: the TF32
// wgmma products, the float32 tile geometry and tensor maps, and the stage
// that splits a float32 tile into its tf32 high and low parts (and writes
// the transposed copies the products need) between a TMA load and the
// wgmmas that read it. The mbarriers, TMA, setmaxnreg and tile-order
// helpers are sm90_bf16.cuh's.
//
// What TF32 wgmma takes. The instruction is m64nNk8 .f32.tf32.tf32: a k
// step is 8 elements, 32 bytes, the depth in bytes of bf16's k16.
// Shared-memory operands must be K-major (the transpose flags exist for
// 16-bit types only), so a product whose B operand is stored n-major (K
// for dS K, dO and Q for P^T dO and dS^T Q) reads a transposed copy. A
// register A operand has, in each warp of the warpgroup (rows 16 w .. 16 w
// + 15), mma.m16n8k8's TF32 A layout: a0 = A[g][c], a1 = A[g+8][c], a2 =
// A[g][c+4], a3 = A[g+8][c+4] (lane = 4 g + c). An accumulator holds
// C[g][2c, 2c+1] and C[g+8][2c, 2c+1], so an A operand made from an
// accumulator (mma_tf32::c_to_a_tf32) takes the 8 columns of its k step in
// the order 0, 2, 4, 6, 1, 3, 5, 7, and the B tile it meets must hold its
// k rows in that order too (key_slot): a B tile cannot be reordered when
// wgmma reads it, so the split stage writes it so.
//
// Tiles in shared memory. A float32 tile of COLS columns is kept in boxes
// of 32 columns (128-byte rows, the 128-byte swizzle) or, for a 16-column
// tile, one box of 64-byte rows (the 64-byte swizzle): TMA's layout, the
// geometry of sm90_bf16.cuh's Tile for bf16 rows of the same bytes. A box
// of `rows` rows starts on a 1024-byte boundary; inside it the 16-byte
// chunk j of row r sits at chunk j ^ (r % 8) (128-byte rows) or j ^ ((r /
// 2) % 4) (64-byte rows). wgmma reads such a tile K-major through a
// descriptor with SBO = 8 rows; the 8-wide k step kk starts 32 kk bytes
// into a row, in box kk / (k steps a box).
//
// 3xTF32 (mma_tf32.cuh): x = hi + lo with hi = tf32(x) rounded explicitly
// (cvt.rna) and lo = tf32(x - hi); a b = hi_a hi_b + lo_a hi_b + hi_a lo_b
// with float32 accumulation. An unrounded float32 word is never read as a
// tf32 operand: the split stage writes hi and lo tiles, rounded.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "sm90_bf16.cuh"

namespace sm90_tf32 {

// ------------------------------------------------------------ warp roles

// The float32 kernels launch three warpgroups' worth of threads (ptxas
// then allocates at most 168 registers a thread). Consumer warpgroups of
// 64 rows each: two up to d = 64; one at d = 128, where the hi and lo
// tiles of two consumers' rows would not fit in shared memory beside a
// ring. The producer warpgroup's warp 0 issues the TMA loads and its warps
// 1 .. 3 (SPLIT_THREADS) split each ring stage into tf32 hi and lo.
__host__ __device__ constexpr int consumers(int d) { return d > 64 ? 1 : 2; }
constexpr int SPLIT_THREADS = 96;
// registers a thread of the producer warpgroup (the split warps among
// them) and of a consumer may hold once setmaxnreg has moved them. The
// split loop's speed follows SPLIT_REGS: at 40 (the bf16 kernels'
// producer) the backward kernels read 10-25% slower than at 96 with four
// 16-byte chunks a thread in flight (split_rows; PERF.md §6)
constexpr int SPLIT_REGS = 96, CONSUMER_REGS = 192;
static_assert(128 * (SPLIT_REGS + 2 * CONSUMER_REGS) <= 384 * 168,
              "the consumers take only what the producer gives up");

// ----------------------------------------------------------------- tiles

// swizzled geometry of a float32 tile of COLS columns
template <int COLS>
struct Tile {
  static constexpr int ROWB = COLS >= 32 ? 128 : 4 * COLS;  // box row bytes
  static constexpr int ELEMS = ROWB / 4;                    // box columns
  static constexpr int NBOX = COLS / ELEMS;                 // boxes
  static constexpr int KSTEPS = ROWB / 32;                  // k steps a box
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : 2;   // desc swizzle
  static_assert(COLS == 16 || COLS == 32 || COLS == 64 || COLS == 128,
                "a tile of 16, 32, 64 or 128 float32 columns");
};

// byte offset of element (r, col) of a tile of COLS columns whose boxes
// hold `rows` rows each
template <int COLS>
__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int col) {
  using G = Tile<COLS>;
  const uint32_t off = r * G::ROWB + (col % G::ELEMS) * 4;
  return (col / G::ELEMS) * rows * G::ROWB +
         (off ^ ((off >> 3) & (G::ROWB == 128 ? 0x70 : 0x30)));
}

// K-major operand descriptor of the tile at shared address `tile` (boxes
// of `rows` rows) at k step kk: the rows of an A operand (64) or of a B
// operand (N), put together where it is used (sm90::desc_at)
template <int COLS>
__device__ __forceinline__ uint64_t desc(uint32_t tile, int rows, int kk) {
  using G = Tile<COLS>;
  return sm90::desc_at(sm90::make_desc(
      tile + (kk / G::KSTEPS) * rows * G::ROWB + (kk % G::KSTEPS) * 32, 16,
      8 * G::ROWB, G::LAYOUT));
}

// ----------------------------------------------------------------- wgmma

template <int N>
__device__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                         int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                         uint64_t b, int scale_d);
// d = A B (scale_d 0) or d += A B over m64nNk8, A and B K-major tf32 tiles
// in shared memory (SS), or A from registers (RS; the layout above)
template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[2][4], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[4][4], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[2][4],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[4][4],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
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

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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


// The three products of one 3xTF32 k step, mma(a_lo, b_lo) issuing one:
// hi hi first (it carries the step's scale_d), then the two small ones
template <typename Mma>
__device__ __forceinline__ void x3(Mma mma) {
  mma(0, 0);  // hi_a hi_b
  mma(1, 0);  // lo_a hi_b
  mma(0, 1);  // hi_a lo_b
}

// d (+)= A B over one k step as 3xTF32, A and B in shared memory (hi and lo
// tiles' descriptors at this k step)
template <int N>
__device__ __forceinline__ void wgmma_x3_ss(float (&d)[N / 8][4], uint64_t ah,
                                            uint64_t al, uint64_t bh,
                                            uint64_t bl, int scale_d) {
  x3([&](int la, int lb) {
    wgmma_ss<N>(d, la ? al : ah, lb ? bl : bh, la | lb ? 1 : scale_d);
  });
}

// d (+)= A B over one k step as 3xTF32, A's hi and lo from registers
template <int N>
__device__ __forceinline__ void wgmma_x3_rs(float (&d)[N / 8][4],
                                            const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4],
                                            uint64_t bh, uint64_t bl,
                                            int scale_d = 1) {
  x3([&](int la, int lb) {
    wgmma_rs<N>(d, *(la ? &al : &ah), lb ? bl : bh, la | lb ? 1 : scale_d);
  });
}

// d (+)= A B over one k step as 3xTF32 with A's hi from registers and its
// lo in shared memory: hi_a hi_b and hi_a lo_b by RS, lo_a hi_b by SS (an
// A operand held for a whole tile is read from shared memory once, not by
// every product)
template <int N>
__device__ __forceinline__ void wgmma_x3_rss(float (&d)[N / 8][4],
                                             const uint32_t (&ah)[4],
                                             uint64_t al, uint64_t bh,
                                             uint64_t bl, int scale_d) {
  x3([&](int la, int lb) {
    if (la)
      wgmma_ss<N>(d, al, bh, 1);
    else
      wgmma_rs<N>(d, ah, lb ? bl : bh, lb ? 1 : scale_d);
  });
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(x) : "r"(addr) : "memory");
  return x;
}

// this lane's register A operand of k step kk (mma.m16n8k8's TF32 A
// layout) for rows r0 .. r0 + 15 of a tile of D columns (boxes of `rows`
// rows): a warp's 32 loads land on distinct banks
template <int D>
__device__ __forceinline__ void load_a(uint32_t tile, int rows, int r0,
                                       int kk, uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = lds(tile + tile_offset<D>(rows, r0 + g + 8 * (i & 1),
                                     8 * kk + c + 4 * (i >> 1)));
}

// ------------------------------------------------------------ split stage

// the column of its 8-column k step that a register A operand made from
// an accumulator (c_to_a_tf32) gives key (or query) j of the step: keys
// 0, 2, 4, 6 in columns 0 .. 3, keys 1, 3, 5, 7 in columns 4 .. 7
__device__ __forceinline__ int key_slot(int j) { return (j & 1) * 4 + (j >> 1); }

__device__ __forceinline__ void lds4(uint32_t addr, float (&x)[4]) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void sts4(uint32_t addr, const uint32_t (&x)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3])
               : "memory");
}
__device__ __forceinline__ void sts(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

// Split a float32 tile of R rows by C columns (boxes of R rows) that TMA
// landed raw at `hi`: its tf32 hi in place and its lo at `lo`, the same
// layout. With CT > 0 also write columns c0 .. c0 + CT - 1 transposed, hi
// at hi_t and lo at lo_t, as a [CT][R] tile whose k columns (the tile's
// rows) are in each 8-row group's key_slot order: the K-major B operand of
// a product whose A operand comes from an accumulator. Threads tid of
// nthreads (a multiple of R) share the work 16 bytes at a time; thread tid
// takes row tid % R, so a warp's reads of a column of chunks and its
// transposed stores along a row of the [CT][R] tile land on distinct banks;
// four chunks in flight a thread, where its registers allow. The caller
// makes the stores visible to wgmma (sm90::fence_async_smem) before it lets
// the consumers read the tiles.
template <int R, int C, int CT>
__device__ __forceinline__ void split_rows(uint32_t hi, uint32_t lo,
                                           uint32_t hi_t, uint32_t lo_t,
                                           int c0, int tid, int nthreads) {
#pragma unroll 4
  for (int idx = tid; idx < R * C / 4; idx += nthreads) {
    const int r = idx % R, col = idx / R * 4;
    const uint32_t off = tile_offset<C>(R, r, col);
    float x[4];
    uint32_t h[4], l[4];
    lds4(hi + off, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) mma_tf32::split(x[e], h[e], l[e]);
    sts4(hi + off, h);
    sts4(lo + off, l);
    if (CT > 0 && col >= c0 && col < c0 + CT) {
      const int kc = (r & ~7) | key_slot(r & 7);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t o = tile_offset<R>(CT, col - c0 + e, kc);
        sts(hi_t + o, h[e]);
        sts(lo_t + o, l[e]);
      }
    }
  }
}

// One 16-byte chunk of split_rows' work without the transposed copy: chunk
// idx (row idx % R, columns idx / R * 4 ..) of a tile landed raw at `hi`
// into its hi in place and its lo at `lo`. A warp's 32 consecutive chunks
// are a column of chunks: its reads and writes land on distinct banks.
template <int R, int C>
__device__ __forceinline__ void split_chunk(uint32_t hi, uint32_t lo,
                                            int idx) {
  const uint32_t off = tile_offset<C>(R, idx % R, idx / R * 4);
  float x[4];
  uint32_t h[4], l[4];
  lds4(hi + off, x);
#pragma unroll
  for (int e = 0; e < 4; ++e) mma_tf32::split(x[e], h[e], l[e]);
  sts4(hi + off, h);
  sts4(lo + off, l);
}

// One task of splitting a float32 tile of R rows (keys) by C columns that
// TMA landed raw at `raw` (boxes of R rows) into its transposed hi and lo
// only, at hi_t and lo_t: [C][R] tiles whose k columns (keys) are in each
// 8-key group's key_slot order, as split_rows writes its transposed tiles.
// Keys j, j + 2, j + 4, j + 6 of a group (one parity) take the four slots
// from key_slot(j) on, so task `task` reads those four keys' rows of one
// 16-byte chunk (four columns) and writes each column's four slots as one
// 16-byte store: 4 loads and 8 stores of 16 bytes for 16 elements, tasks
// 0 .. 16 (R / 8) (C / 32) - 1. A warp's 32 consecutive tasks are the 8
// chunks of a box for both parities of two key groups, so its loads cover
// four whole rows and its stores four 128-byte rows' worth: no bank
// conflict beyond the 512 bytes' four wavefronts.
template <int R, int C>
__device__ __forceinline__ void split_transposed_task(uint32_t raw,
                                                      uint32_t hi_t,
                                                      uint32_t lo_t,
                                                      int task) {
  constexpr int NG = R / 8;  // key groups
  const int cc = task % 8, p = task / 8 % 2, g = task / 16 % NG;
  const int col = task / (16 * NG) * 32 + cc * 4;
  float x[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    lds4(raw + tile_offset<C>(R, 8 * g + p + 2 * m, col), x[m]);
  // the first of parity p's four adjacent slots
  const int slot = 8 * g + (key_slot(p) & ~3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) mma_tf32::split(x[m][i], h[m], l[m]);
    const uint32_t o = tile_offset<R>(C, col + i, slot);
    sts4(hi_t + o, h);
    sts4(lo_t + o, l);
  }
}

// the hi and lo of an accumulator of NB 8-column blocks as the A operands
// of NB k steps (mma_tf32::c_to_a_tf32: columns in the order 0, 2, 4, 6,
// 1, 3, 5, 7 of each step)
template <int NB>
__device__ __forceinline__ void c_to_a_x3(const float (&c)[NB][4],
                                          uint32_t (&hi)[NB][4],
                                          uint32_t (&lo)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n) mma_tf32::c_to_a_tf32(c[n], hi[n], lo[n]);
}

// rows r0 + g and r0 + g + 8 of an accumulator of N columns (this lane's C
// fragments) in float32 into columns col0 .. col0 + N - 1 of a float32
// tile of D columns at shared address `tile` (boxes of `rows` rows)
template <int D, int N>
__device__ __forceinline__ void stage_rows(uint32_t tile, int rows, int r0,
                                           int col0,
                                           const float (&d)[N / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                       tile + tile_offset<D>(rows, r0 + g + 8 * h,
                                             col0 + n * 8 + 2 * c)),
                   "f"(d[n][2 * h]), "f"(d[n][2 * h + 1])
                   : "memory");
}

// ------------------------------------------------------- host: tensor maps

// a [bh, T, D] row-major float32 tensor as a 3D map (d, T, bh) with boxes
// of 32 columns (128 bytes, the 128-byte swizzle) by `box_rows` rows: a
// box that runs past T is zero-filled instead of reading the next head
template <int D>
cudaError_t rows_map(CUtensorMap* map, const void* base, int bh, int t,
                     int box_rows) {
  const sm90::EncodeTiled enc = sm90::encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(t) * D * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Tile<D>::ELEMS),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace sm90_tf32
