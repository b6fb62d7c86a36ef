// Flash attention backward for Hopper (sm_90a), plain C entry points.
//
// Replaces the two TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// that `_bwd` launches, the FlashAttention-2 backward:
//   `_bwd_dq_kernel` (:191, launched at :305) -> flash_attention_bwd_dq:
//       dQ = sum over k tiles of  dS K,
//   `_bwd_dkv_kernel` (:234, launched at :340) -> flash_attention_bwd_dkv:
//       dV = sum over q tiles of  P^T dO,   dK = sum over q tiles of dS^T Q,
// where per (q, k) tile, recomputed from the forward's row log-sum-exp,
//   S  = sm_scale * Q K^T (keys >= T and, causal, keys after the query
//        masked),   P = exp(S - LSE),   dP = dO V^T,
//   dS = P * (dP - delta) * sm_scale,   delta = rowsum(dO * O)
// (delta is computed once per row by the caller, as the TPU wrapper does).
// q, k, v, dO, dQ, dK, dV are [bh, T, d] row-major contiguous in one dtype
// (float32 or bfloat16); LSE and delta are [bh, T] float32. As in the TPU
// kernels, dS is rounded to the input dtype before dS K and dS^T Q, and P
// before P^T dO (dS itself is computed from the unrounded float32 P);
// every product accumulates in float32. The two passes stay separate, as
// on the TPU: no atomics, each output element is summed by one thread.
//
// The TPU kernels walk a sequential grid dimension and carry dq (or dk,
// dv) in VMEM scratch between grid steps. Blocks on Hopper run in no
// order, so each block owns its output tile and loops itself:
//   dq:  one block per (bh, 64-row q tile); 64-row K/V tiles stream
//        through; in causal mode the loop stops at the tile holding the
//        diagonal.
//   dkv: one block per (bh, 64-row k tile); 64-row Q/dO tiles stream
//        through; in causal mode the loop starts at the tile holding the
//        diagonal.
// The ragged tail (T not a multiple of 64) is masked in the kernels, so
// the caller need not pad T.
//
// Bound at the training path's shape ([bh=384, T=512, d=64] bf16): the dq
// pass does 6*d operations per (q, k) pair (38.7 GFLOP) and the dk/dv pass
// 8*d (51.5 GFLOP) against 127-153 MB of traffic, so both are bound by
// operations: 0.039 / 0.052 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Kernels, chosen by dtype in the entry points:
//
// dkv_kernel_mma<D> (bfloat16), the FlashAttention-2 design on the tensor
//   cores. 4 warps, 16 key rows each. K and V are staged once in shared
//   memory; Q, dO, LSE and delta tiles of 64 query rows stream through a
//   2-stage cp.async ring. Tiles are bf16 with rows padded to D + 8
//   elements, so ldmatrix reads no bank twice. Each warp computes its
//   score tile transposed, so its rows are its own key rows:
//     S^T = K Q^T,  P^T = exp(sm_scale S^T - LSE[q]),
//     dV += bf16(P^T) dO,  dP^T = V dO^T,
//     dS^T = P^T (dP^T - delta[q]) sm_scale,  dK += bf16(dS^T) Q,
//   all with mma.m16n8k16 (bf16 in, float32 out). P^T and dS^T go from
//   one product's accumulators to the next product's A fragments in
//   registers (mma_bf16.cuh); Q's and dO's B fragments come by ldmatrix,
//   plain for S^T and dP^T, .trans for dV and dK. dK and dV accumulate in
//   float32 registers and leave once, through shared memory, as 16-byte
//   rows. At d = 128 the two accumulators take 128 registers a thread, so
//   the score tiles are computed 32 query columns at a time (64 below),
//   which keeps every instance free of spills.
//
// dq_kernel_mma<D> (bfloat16), the transpose of dkv_kernel_mma: 4 warps,
//   16 query rows each. Q and dO are staged once and kept as A fragments
//   in registers; K and V tiles of 64 key rows stream through a 2-stage
//   cp.async ring (rows past T zero-filled); each lane keeps the LSE and
//   delta of its two rows in registers. Per key tile:
//     S = Q K^T,  P = exp(sm_scale S - LSE),  dP = dO V^T,
//     dS = P (dP - delta) sm_scale,  dQ += bf16(dS) K,
//   K's and V's B fragments by plain ldmatrix for S and dP, K's by
//   ldmatrix.trans for dS K, and dS goes from dP's accumulators to the A
//   fragment in registers. Only the ragged last tile and the diagonal tile
//   are masked (a padded key's row of K is zero, so its dS K term is 0
//   anyway; the mask keeps exp(-LSE) of a padded key from overflowing into
//   inf * 0). dQ accumulates in float32 registers and leaves once, through
//   shared memory, as 16-byte rows. At d = 128 the accumulator and the Q
//   and dO fragments take 128 registers a thread, so the score tiles are
//   computed 32 key columns at a time (64 below).
//
// dq_kernel<D> and dkv_kernel<D> (float32), scalar float32 FMAs: tiles
//   staged as float32, rows padded by one word so the column walks do not
//   collide on a bank; 256 threads, thread (ty, tx) owns tile rows 4*ty ..
//   4*ty+3, score columns tx + 16*j and output columns tx + 16*c; P and dS
//   pass through shared memory; the accumulators live in float32 registers
//   and are stored once. One TF32 product would break the float32 limit
//   of 1e-4; three (3xTF32, as the float32 forward runs them, mma_tf32.cuh)
//   would meet it. The float32 backward runs only in a batch-1 check step,
//   so it stays on the CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

// ----------------------------------------------------------------- scalar

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // key rows per tile
constexpr int NTHREADS = 256;  // 16 x 16 thread grid
constexpr int PS = 65;         // padded row stride of the 64-wide P/dS tiles

// rows [r0, r0 + 64) of a [T, D] matrix into a padded tile; rows past T
// read as 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int t) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    const int gr = r0 + r;
    dst[r * (D + 1) + c] = gr < t ? src[static_cast<size_t>(gr) * D + c] : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * PS);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BK * PS + 2 * BQ);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int t, float sm_scale, int causal) {
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int S = D + 1;    // padded row stride
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][S]
  float* sdO = sQ + BQ * S;    // [BQ][S]
  float* sK = sdO + BQ * S;    // [BK][S]
  float* sV = sK + BK * S;     // [BK][S]
  float* sdS = sV + BK * S;    // [BQ][PS]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t rbase = static_cast<size_t>(bh) * t;

  load_tile<D>(sQ, q + base, q0, t);
  load_tile<D>(sdO, dout + base, q0, t);

  float row_lse[4], row_delta[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    row_lse[i] = qr < t ? lse[rbase + qr] : 0.f;
    row_delta[i] = qr < t ? delta[rbase + qr] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query row contribute nothing
  const int kend = causal ? min(t, q0 + BQ) : t;
  const int ntiles = (kend + BK - 1) / BK;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK/sV/sdS are no longer read
    load_tile<D>(sK, k + base, k0, t);
    load_tile<D>(sV, v + base, k0, t);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float a[4], g[4], b[4], e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty * 4 + i) * S + kk];
        g[i] = sdO[(ty * 4 + i) * S + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sK[(tx + 16 * j) * S + kk];
        e[j] = sV[(tx + 16 * j) * S + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], e[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool keep = qr < t && kc < t && (!causal || qr >= kc);
        const float p = keep ? expf(s[i][j] * sm_scale - row_lse[i]) : 0.f;
        const float ds = p * (dp[i][j] - row_delta[i]) * sm_scale;
        sdS[(ty * 4 + i) * PS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float d[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = sdS[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sK[kk * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(d[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= t) continue;
    float* row = dq + base + static_cast<size_t>(qr) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = acc[i][c];
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int t,
               float sm_scale, int causal) {
  constexpr int DC = D / 16;
  constexpr int S = D + 1;
  extern __shared__ float smem[];
  float* sK = smem;            // [BK][S]
  float* sV = sK + BK * S;     // [BK][S]
  float* sQ = sV + BK * S;     // [BQ][S]
  float* sdO = sQ + BQ * S;    // [BQ][S]
  float* sP = sdO + BQ * S;    // [BK][PS]: P^T, key rows by query columns
  float* sdS = sP + BK * PS;   // [BK][PS]: dS^T
  float* sL = sdS + BK * PS;   // [BQ]: the q tile's LSE
  float* sD = sL + BQ;         // [BQ]: the q tile's delta

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t rbase = static_cast<size_t>(bh) * t;

  load_tile<D>(sK, k + base, k0, t);
  load_tile<D>(sV, v + base, k0, t);

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // causal: query tiles before the one holding the diagonal see no key of
  // this tile (BQ == BK, so that tile's index is the k tile's own)
  const int qstart = causal ? k0 / BQ : 0;
  const int ntiles = (t + BQ - 1) / BQ;

  for (int qt = qstart; qt < ntiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's sQ/sdO/sP/sdS are no longer read
    load_tile<D>(sQ, q + base, q0, t);
    load_tile<D>(sdO, dout + base, q0, t);
    if (threadIdx.x < BQ) {
      const int qr = q0 + threadIdx.x;
      sL[threadIdx.x] = qr < t ? lse[rbase + qr] : 0.f;
      sD[threadIdx.x] = qr < t ? delta[rbase + qr] : 0.f;
    }
    __syncthreads();

    // transposed tiles: row i = key k0 + 4*ty + i, column j = query
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float a[4], e[4], b[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sK[(ty * 4 + i) * S + kk];
        e[i] = sV[(ty * 4 + i) * S + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sQ[(tx + 16 * j) * S + kk];
        g[j] = sdO[(tx + 16 * j) * S + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(e[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int qr = q0 + qc;
        const bool keep = qr < t && kr < t && (!causal || qr >= kr);
        const float p = keep ? expf(s[i][j] * sm_scale - sL[qc]) : 0.f;
        const float ds = p * (dp[i][j] - sD[qc]) * sm_scale;
        sP[(ty * 4 + i) * PS + qc] = p;
        sdS[(ty * 4 + i) * PS + qc] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pp[4], dd[4], o[DC], x[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = sP[(ty * 4 + i) * PS + qq];
        dd[i] = sdS[(ty * 4 + i) * PS + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        o[c] = sdO[qq * S + tx + 16 * c];
        x[c] = sQ[qq * S + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[i][c] = fmaf(pp[i], o[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(dd[i], x[c], acc_k[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty * 4 + i;
    if (kr >= t) continue;
    float* krow = dk + base + static_cast<size_t>(kr) * D;
    float* vrow = dv + base + static_cast<size_t>(kr) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[tx + 16 * c] = acc_k[i][c];
      vrow[tx + 16 * c] = acc_v[i][c];
    }
  }
}


// --------------------------------------------------------------- bfloat16

constexpr int MMA_THREADS = 128;  // 4 warps x 16 key rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K and V once, then two stages of Q and dO ([64][D + 8] bf16 each) and
  // of LSE and delta (64 floats each)
  return sizeof(__nv_bfloat16) * 6 * BK * (D + 8) + sizeof(float) * 4 * BQ;
}

// Q, dO, LSE and delta of q tile q0 into one stage of the ring
template <int D>
__device__ __forceinline__ void load_q_stage(
    __nv_bfloat16* sQ, __nv_bfloat16* sdO, float* sL, float* sD,
    const __nv_bfloat16* q, const __nv_bfloat16* dout, const float* lse,
    const float* delta, int q0, int t) {
  using namespace mma_bf16;
  static_assert(MMA_THREADS == 2 * BQ, "one thread per LSE or delta entry");
  load_rows_async<BQ, D, MMA_THREADS>(sQ, q, q0, t);
  load_rows_async<BQ, D, MMA_THREADS>(sdO, dout, q0, t);
  const int r = threadIdx.x & (BQ - 1);
  const bool ok = q0 + r < t;
  const float* src = threadIdx.x < BQ ? lse : delta;
  cp_async_4((threadIdx.x < BQ ? sL : sD) + r, src + (ok ? q0 + r : 0), ok);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    dkv_kernel_mma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int t, float sm_scale,
                   int causal) {
  using namespace mma_bf16;
  constexpr int LD = D + 8;      // padded row stride (elements)
  constexpr int TILE = BQ * LD;  // elements of one staged tile
  constexpr int KD = D / 16;     // k steps over d
  constexpr int ND = D / 8;      // n-blocks over d
  // query columns of the score tile per compute pass (the head comment)
  constexpr int QC = D > 64 ? 32 : 64;
  constexpr int NQ = QC / 8;     // n-blocks of a score pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + TILE;
  __nv_bfloat16* sQ = sV + TILE;       // [2][BQ][LD]
  __nv_bfloat16* sdO = sQ + 2 * TILE;  // [2][BQ][LD]
  float* sL = reinterpret_cast<float*>(sdO + 2 * TILE);  // [2][BQ]
  float* sD = sL + 2 * BQ;                               // [2][BQ]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int row0 = k0 + warp * 16;  // the warp's first key row
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t rbase = static_cast<size_t>(bh) * t;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* ob = dout + base;

  // causal: query tiles before the one holding the diagonal see no key of
  // this tile (BQ == BK, so that tile's index is the k tile's own)
  const int qstart = causal ? k0 / BQ : 0;
  const int ntiles = (t + BQ - 1) / BQ;

  load_rows_async<BK, D, MMA_THREADS>(sK, k + base, k0, t);
  load_rows_async<BK, D, MMA_THREADS>(sV, v + base, k0, t);
  load_q_stage<D>(sQ, sdO, sL, sD, qb, ob, lse + rbase, delta + rbase,
                  qstart * BQ, t);
  cp_async_commit();

  const float scale = sm_scale * LOG2E;  // exponents in log2 units
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;

  for (int qt = qstart; qt < ntiles; ++qt) {
    const int q0 = qt * BQ;
    const int st = (qt - qstart) & 1;
    if (qt + 1 < ntiles)  // the next tile into the other stage
      load_q_stage<D>(sQ + (st ^ 1) * TILE, sdO + (st ^ 1) * TILE,
                      sL + (st ^ 1) * BQ, sD + (st ^ 1) * BQ, qb, ob,
                      lse + rbase, delta + rbase, q0 + BQ, t);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) has landed
    __syncthreads();
    const __nv_bfloat16* tQ = sQ + st * TILE;
    const __nv_bfloat16* tdO = sdO + st * TILE;
    const float* tL = sL + st * BQ;
    const float* tD = sD + st * BQ;
    // mask only the ragged last tile and the diagonal tile
    const bool edge = q0 + BQ > t || (causal && q0 < k0 + BK - 1);

#pragma unroll
    for (int j0 = 0; j0 < BQ; j0 += QC) {
      // S^T = K Q^T: the warp's 16 key rows x QC query columns
      float s[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, a_addr(sK, LD, warp * 16, kk * 16, lane));
#pragma unroll
        for (int n2 = 0; n2 < NQ / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4(b, bn_addr(tQ, LD, j0 + n2 * 16, kk * 16, lane));
          mma_16816(s[2 * n2], a, b[0], b[1]);
          mma_16816(s[2 * n2 + 1], a, b[2], b[3]);
        }
      }

      // P^T = exp(sm_scale S^T - LSE[q]) in float32; masked entries 0.
      // exp2f rather than mma_bf16.cuh's exp2_approx: as fast here, and
      // with exp2_approx ptxas spills the d = 128 instance (at 255
      // registers)
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = j0 + n * 8 + 2 * c + (i & 1);
          float p = exp2f(fmaf(s[n][i], scale, -tL[qc] * LOG2E));
          if (edge) {
            const int qr = q0 + qc;
            const int kr = row0 + g + (i >> 1) * 8;
            if (qr >= t || (causal && qr < kr)) p = 0.f;
          }
          s[n][i] = p;
        }

      // dV += bf16(P^T) dO
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t a[4];
        c_to_a<NQ>(a, s, kk);
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b,
                            bk_addr(tdO, LD, j0 + kk * 16, n2 * 16, lane));
          mma_16816(acc_v[2 * n2], a, b[0], b[1]);
          mma_16816(acc_v[2 * n2 + 1], a, b[2], b[3]);
        }
      }

      // dP^T = V dO^T
      float dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, a_addr(sV, LD, warp * 16, kk * 16, lane));
#pragma unroll
        for (int n2 = 0; n2 < NQ / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4(b, bn_addr(tdO, LD, j0 + n2 * 16, kk * 16, lane));
          mma_16816(dp[2 * n2], a, b[0], b[1]);
          mma_16816(dp[2 * n2 + 1], a, b[2], b[3]);
        }
      }

      // dS^T = P^T (dP^T - delta[q]) sm_scale, from the unrounded P^T
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = j0 + n * 8 + 2 * c + (i & 1);
          dp[n][i] = s[n][i] * (dp[n][i] - tD[qc]) * sm_scale;
        }

      // dK += bf16(dS^T) Q
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t a[4];
        c_to_a<NQ>(a, dp, kk);
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bk_addr(tQ, LD, j0 + kk * 16, n2 * 16, lane));
          mma_16816(acc_k[2 * n2], a, b[0], b[1]);
          mma_16816(acc_k[2 * n2 + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // dK, dV to bf16, staged in the warp's own rows of sK and sV (only this
  // warp read them), then stored as 16-byte rows
  __nv_bfloat16* wK = sK + warp * 16 * LD;
  __nv_bfloat16* wV = sV + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(wK + g * LD + col) =
        pack_bf16x2(acc_k[n][0], acc_k[n][1]);
    *reinterpret_cast<uint32_t*>(wK + (g + 8) * LD + col) =
        pack_bf16x2(acc_k[n][2], acc_k[n][3]);
    *reinterpret_cast<uint32_t*>(wV + g * LD + col) =
        pack_bf16x2(acc_v[n][0], acc_v[n][1]);
    *reinterpret_cast<uint32_t*>(wV + (g + 8) * LD + col) =
        pack_bf16x2(acc_v[n][2], acc_v[n][3]);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = i / CHUNKS, col = (i % CHUNKS) * 8;
    if (row0 + r >= t) continue;
    const size_t off = base + static_cast<size_t>(row0 + r) * D + col;
    *reinterpret_cast<uint4*>(dk + off) =
        *reinterpret_cast<const uint4*>(wK + r * LD + col);
    *reinterpret_cast<uint4*>(dv + off) =
        *reinterpret_cast<const uint4*>(wV + r * LD + col);
  }
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // Q and dO once, then two stages of K and V, all [64][D + 8] bf16
  return sizeof(__nv_bfloat16) * 6 * BK * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    dq_kernel_mma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int t, float sm_scale,
                  int causal) {
  using namespace mma_bf16;
  constexpr int LD = D + 8;      // padded row stride (elements)
  constexpr int TILE = BK * LD;  // elements of one staged tile
  constexpr int KD = D / 16;     // k steps over d
  constexpr int ND = D / 8;      // n-blocks over d
  // key columns of the score tile per compute pass (the head comment)
  constexpr int KC = D > 64 ? 32 : 64;
  constexpr int NK = KC / 8;     // n-blocks of a score pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + TILE;
  __nv_bfloat16* sK = sdO + TILE;     // [2][BK][LD]
  __nv_bfloat16* sV = sK + 2 * TILE;  // [2][BK][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row0 = q0 + warp * 16;  // the warp's first query row
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t rbase = static_cast<size_t>(bh) * t;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  // causal: keys past the block's last query row contribute nothing
  const int kend = causal ? min(t, q0 + BQ) : t;
  const int ntiles = (kend + BK - 1) / BK;

  load_rows_async<BQ, D, MMA_THREADS>(sQ, q + base, q0, t);
  load_rows_async<BQ, D, MMA_THREADS>(sdO, dout + base, q0, t);
  load_rows_async<BK, D, MMA_THREADS>(sK, kb, 0, t);
  load_rows_async<BK, D, MMA_THREADS>(sV, vb, 0, t);
  cp_async_commit();

  const float scale = sm_scale * LOG2E;  // exponents in log2 units
  // this lane's rows g (r = 0) and g + 8: LSE in log2 units, and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row0 + g + 8 * r;
    lse2[r] = qr < t ? lse[rbase + qr] * LOG2E : 0.f;
    dl[r] = qr < t ? delta[rbase + qr] : 0.f;
  }
  uint32_t qf[KD][4], of[KD][4];  // Q's and dO's A fragments
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < ntiles) {  // the next tile into the other stage
      const int st = (kt + 1) & 1;
      load_rows_async<BK, D, MMA_THREADS>(sK + st * TILE, kb, k0 + BK, t);
      load_rows_async<BK, D, MMA_THREADS>(sV + st * TILE, vb, k0 + BK, t);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) has landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_x4(qf[kk], a_addr(sQ, LD, warp * 16, kk * 16, lane));
        ldmatrix_x4(of[kk], a_addr(sdO, LD, warp * 16, kk * 16, lane));
      }
    }
    const __nv_bfloat16* tK = sK + (kt & 1) * TILE;
    const __nv_bfloat16* tV = sV + (kt & 1) * TILE;
    // mask only the ragged last tile and the diagonal tile
    const bool edge = k0 + BK > t || (causal && k0 + BK - 1 > q0);

#pragma unroll
    for (int j0 = 0; j0 < BK; j0 += KC) {
      // S = Q K^T: the warp's 16 query rows x KC key columns
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < NK / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4(b, bn_addr(tK, LD, j0 + n2 * 16, kk * 16, lane));
          mma_16816(s[2 * n2], qf[kk], b[0], b[1]);
          mma_16816(s[2 * n2 + 1], qf[kk], b[2], b[3]);
        }

      // P = exp(sm_scale S - LSE) in float32; masked entries 0 (exp2f, as
      // in dkv_kernel_mma)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = exp2f(fmaf(s[n][i], scale, -lse2[i >> 1]));
          if (edge) {
            const int kc = k0 + j0 + n * 8 + 2 * c + (i & 1);
            const int qr = row0 + g + (i >> 1) * 8;
            if (kc >= t || (causal && kc > qr)) p = 0.f;
          }
          s[n][i] = p;
        }

      // dP = dO V^T
      float dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int n2 = 0; n2 < NK / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4(b, bn_addr(tV, LD, j0 + n2 * 16, kk * 16, lane));
          mma_16816(dp[2 * n2], of[kk], b[0], b[1]);
          mma_16816(dp[2 * n2 + 1], of[kk], b[2], b[3]);
        }

      // dS = P (dP - delta) sm_scale, from the unrounded P
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[n][i] = s[n][i] * (dp[n][i] - dl[i >> 1]) * sm_scale;

      // dQ += bf16(dS) K
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[4];
        c_to_a<NK>(a, dp, kk);
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bk_addr(tK, LD, j0 + kk * 16, n2 * 16, lane));
          mma_16816(acc[2 * n2], a, b[0], b[1]);
          mma_16816(acc[2 * n2 + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // dQ to bf16, staged in the warp's own rows of sQ (only this warp read
  // them), then stored as 16-byte rows
  __nv_bfloat16* wQ = sQ + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * c;
    *reinterpret_cast<uint32_t*>(wQ + g * LD + col) =
        pack_bf16x2(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(wQ + (g + 8) * LD + col) =
        pack_bf16x2(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = i / CHUNKS, col = (i % CHUNKS) * 8;
    if (row0 + r < t)
      *reinterpret_cast<uint4*>(dq + base +
                                static_cast<size_t>(row0 + r) * D + col) =
          *reinterpret_cast<const uint4*>(wQ + r * LD + col);
  }
}

// ----------------------------------------------------------------- launch

// above 48 KB a block's shared memory must be requested explicitly; the
// attribute stays set, so each kernel instance sets it once and keeps the
// result for every later call
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int t,
                          float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kern = dq_kernel<D>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), t, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int t,
                           float sm_scale, int causal, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = dq_mma_smem_bytes<D>();
  auto kern = dq_kernel_mma<D>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), t, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int t, float sm_scale, int causal,
                           cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kern = dkv_kernel<D>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BK - 1) / BK, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), t, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int t, float sm_scale, int causal,
                            cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = dkv_mma_smem_bytes<D>();
  auto kern = dkv_kernel_mma<D>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BK - 1) / BK, bh);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t, sm_scale, causal);
  return cudaGetLastError();
}

// f(std::integral_constant<int, D>) for the head dims the kernels take
template <typename F>
cudaError_t with_head_dim(int d, F&& f) {
  switch (d) {
    case 32:
      return f(std::integral_constant<int, 32>());
    case 64:
      return f(std::integral_constant<int, 64>());
    case 128:
      return f(std::integral_constant<int, 128>());
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_shape(int bh, int t) { return bh <= 0 || t <= 0 || bh > 65535; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns the launch's cudaError_t.
// float32 runs dq_kernel, bfloat16 dq_kernel_mma
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int t, int d,
                                      float sm_scale, int causal, int dtype,
                                      void* stream) {
  if (bad_shape(bh, t)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return with_head_dim(d, [&](auto dc) {
        return launch_dq_f32<decltype(dc)::value>(
            q, k, v, dout, lse, delta, dq, bh, t, sm_scale, causal, s);
      });
    case 1:
      return with_head_dim(d, [&](auto dc) {
        return launch_dq_bf16<decltype(dc)::value>(
            q, k, v, dout, lse, delta, dq, bh, t, sm_scale, causal, s);
      });
    default:
      return cudaErrorInvalidValue;
  }
}

// float32 runs dkv_kernel, bfloat16 dkv_kernel_mma
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int t,
                                       int d, float sm_scale, int causal,
                                       int dtype, void* stream) {
  if (bad_shape(bh, t)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return with_head_dim(d, [&](auto dc) {
        return launch_dkv_f32<decltype(dc)::value>(
            q, k, v, dout, lse, delta, dk, dv, bh, t, sm_scale, causal, s);
      });
    case 1:
      return with_head_dim(d, [&](auto dc) {
        return launch_dkv_bf16<decltype(dc)::value>(
            q, k, v, dout, lse, delta, dk, dv, bh, t, sm_scale, causal, s);
      });
    default:
      return cudaErrorInvalidValue;
  }
}
