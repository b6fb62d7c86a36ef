// Flash attention forward for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel `_fwd_kernel` (paddle_tpu/ops/pallas/
// flash_attention.py:63, launched by `_fwd` at :159): online-softmax
// attention
//   O = softmax(sm_scale * Q K^T, masked) V,   LSE = rowwise log-sum-exp,
// over q, k, v of shape [bh, T, d] (row-major, contiguous), with keys
// >= kv_len masked and, in causal mode, keys after the query masked.
// O is written in the input dtype, LSE as [bh, T] float32 in natural-log
// units (the TPU kernel's [bh, 8, T] sublane copy is a TPU tiling
// artefact). As in the TPU kernel, the scores and every sum are float32,
// p = exp(S - m) is rounded to V's dtype before P V, and the accumulator
// is rescaled by exp(m_old - m_new) whenever the running max m grows.
//
// The TPU kernel walks a sequential k grid dimension and keeps the running
// (m, l, acc) state in VMEM scratch between grid steps. Blocks on Hopper
// run in no order, so here one thread block owns one (bh, q tile) of 64
// rows (128 in the bf16 kernel at d <= 64) and loops over 64-row k/v
// tiles itself; in causal mode the loop stops
// at the tile holding the diagonal, and the ragged tail (T not a multiple
// of 64) is masked in the kernel, so the caller need not pad T.
//
// Two kernels, chosen by dtype in the entry point:
//
// fwd_kernel_mma<D, MT> (bfloat16), the FlashAttention-2 design on the
//   tensor cores. 4 warps, each owning MT m-tiles of 16 query rows (MT = 2
//   at D <= 64, so a block owns 128 rows and every K or V fragment read
//   from shared memory feeds two mmas; MT = 1 at D = 128, where two would
//   not fit the registers); k/v tiles of BK = 64 rows. Q, K and V are
//   staged in shared memory as bf16 with rows padded to D + 8 elements (so
//   the eight rows an ldmatrix phase reads fall on distinct banks); K and
//   V go through a 2-stage cp.async ring, so the next tile's copy is in
//   flight while the current one is computed. Each warp keeps its Q rows
//   as mma A fragments in registers, computes S = Q K^T with
//   mma.m16n8k16 (bf16 in, float32 out; K's B fragments by ldmatrix),
//   masks only the diagonal and the ragged last tile, reduces the row max
//   and sum over the four lanes of a quad, turns the S accumulators into
//   the bf16 A fragments of P in registers (mma_bf16.cuh), and adds P V
//   (V's B fragments by ldmatrix.trans). The running max m is kept on the
//   raw scores; each p = 2^(s * c - m * c), c = sm_scale * log2 e, is one
//   FFMA and one ex2, and LSE = sm_scale * m + ln l is stored in natural-
//   log units. O leaves through shared memory as 16-byte rows.
//   Bound at the training path's shape ([bh=384, T=512, d=64] bf16): 4*d
//   operations per (query, key) pair, 25.8 GFLOP (26 us at the 989
//   TFLOP/s bf16 peak), against 101.5 MB of Q, K, V, O and LSE (30 us at
//   3.35 TB/s): bound by bytes.
//
// fwd_kernel_tf32x3<D> (float32, the serving path), the same
//   FlashAttention-2 design on the TF32 tensor cores with 3xTF32 products
//   (mma_tf32.cuh): each operand splits into a tf32 high and low part and
//   each product is lo hi + hi lo + hi hi with float32 accumulation. One
//   TF32 product keeps 11 bits of each operand and misses the float32
//   limit of 1e-4 on O (on the H100 it reads 2.9e-4 to 1.5e-3 over the
//   chip check's float32 cases); three read at most 4.4e-6. 4 warps of
//   16 query rows, k/v tiles of BK = 64 rows through the same 2-stage
//   cp.async ring; Q, K and V staged as float32 with rows padded to D + 4
//   words, which keeps both the ldmatrix reads of Q and K and the 32-bit
//   reads of V free of bank conflicts. Q's and K's fragments come by b16
//   ldmatrix (a float32 row of 16 bytes is four words, the tf32 fragment
//   layout) and are split as they are used. P stays float32, as the TPU
//   kernel keeps it when V is float32, and is split too; its C fragment
//   becomes P V's A fragment with the keys of each 8-key step taken in
//   the order 0, 2, 4, 6, 1, 3, 5, 7, and V's rows are read in that order.
//   Softmax, masking, early stop and LSE as in fwd_kernel_mma. Bound at
//   the serving path's shape ([bh=96, T=512, d=64] float32): 6.4 GFLOP,
//   three times over, 39 us at the 494.7 TFLOP/s TF32 peak (96 us if one
//   counts 6.4 GFLOP at the 67 TFLOP/s float32 peak of the CUDA cores),
//   against 50.5 MB (15 us at 3.35 TB/s): bound by operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key rows per k/v tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// --------------------------------------------------------------- bfloat16

constexpr int MMA_THREADS = 128;  // 4 warps

// Each warp owns MT m-tiles of 16 query rows, so a block owns 64 * MT
// rows and each K or V fragment loaded from shared memory feeds MT mmas.
template <int D, int MT>
constexpr size_t mma_smem_bytes() {
  // Q (64 * MT rows), then two stages each of K and V (BK rows), all
  // bf16 with rows of D + 8
  return sizeof(__nv_bfloat16) * (64 * MT + 4 * BK) * (D + 8);
}

template <int D, int MT>
__global__ void __launch_bounds__(MMA_THREADS)
    fwd_kernel_mma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int t, int kv_len, float sm_scale, int causal) {
  using namespace mma_bf16;
  constexpr int ROWS = 64 * MT;  // query rows per block
  constexpr int WROWS = 16 * MT;  // query rows per warp
  constexpr int LD = D + 8;      // padded row stride (elements)
  constexpr int TILE = BK * LD;  // elements of one staged K or V tile
  constexpr int KD = D / 16;     // k steps of Q K^T
  constexpr int NB = BK / 8;     // n-blocks of the score tile
  constexpr int ND = D / 8;      // n-blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + ROWS * LD;  // [2][BK][LD]
  __nv_bfloat16* sV = sK + 2 * TILE;   // [2][BK][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * ROWS;
  const int row0 = q0 + warp * WROWS;  // the warp's first query row
  const size_t base = static_cast<size_t>(bh) * t * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  // causal: keys past the block's last query row contribute nothing
  const int kend = causal ? min(kv_len, q0 + ROWS) : kv_len;
  const int ntiles = (kend + BK - 1) / BK;

  load_rows_async<ROWS, D, MMA_THREADS>(sQ, q + base, q0, t);
  load_rows_async<BK, D, MMA_THREADS>(sK, kb, 0, t);
  load_rows_async<BK, D, MMA_THREADS>(sV, vb, 0, t);
  cp_async_commit();

  const float scale = sm_scale * LOG2E;  // exponents in log2 units
  uint32_t qf[MT][KD][4];
  float acc[MT][ND][4];
  // m: running max of the unscaled scores; l: this lane's share of the
  // row sums
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;
  }

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < ntiles) {  // the next tile into the other stage
      const int st = (kt + 1) & 1;
      load_rows_async<BK, D, MMA_THREADS>(sK + st * TILE, kb, k0 + BK, t);
      load_rows_async<BK, D, MMA_THREADS>(sV + st * TILE, vb, k0 + BK, t);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldmatrix_x4(qf[mt][kk], a_addr(sQ, LD, warp * WROWS + mt * 16,
                                         kk * 16, lane));
    }
    const __nv_bfloat16* tK = sK + (kt & 1) * TILE;
    const __nv_bfloat16* tV = sV + (kt & 1) * TILE;

    // S = Q K^T, MT x 16 rows x BK keys per warp
    float s[MT][NB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t b[4];
        ldmatrix_x4(b, bn_addr(tK, LD, n2 * 16, kk * 16, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(s[mt][2 * n2], qf[mt][kk], b[0], b[1]);
          mma_16816(s[mt][2 * n2 + 1], qf[mt][kk], b[2], b[3]);
        }
      }

    // mask only the ragged last tile and the diagonal tiles
    if (k0 + BK > kv_len || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kc = k0 + n * 8 + 2 * c + (i & 1);
            const int qr = row0 + mt * 16 + g + (i >> 1) * 8;
            if (kc >= kv_len || (causal && kc > qr)) s[mt][n][i] = NEG_INF;
          }
    }

    // online softmax against the running max; per m-tile, rows g (r = 0)
    // and g + 8. p = exp(sm_scale (s - m)) = 2^(s scale - m scale): one
    // FFMA and one ex2 per score
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mt][r];
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * r], s[mt][n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2_approx((m[mt][r] - mx) * scale);
        const float mx_scaled = mx * scale;
        m[mt][r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          s[mt][n][2 * r] =
              exp2_approx(fmaf(s[mt][n][2 * r], scale, -mx_scaled));
          s[mt][n][2 * r + 1] =
              exp2_approx(fmaf(s[mt][n][2 * r + 1], scale, -mx_scaled));
          sum += s[mt][n][2 * r] + s[mt][n][2 * r + 1];
        }
        l[mt][r] = alpha * l[mt][r] + sum;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[mt][n][2 * r] *= alpha;
          acc[mt][n][2 * r + 1] *= alpha;
        }
      }

    // O += bf16(P) V, P's A fragments straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) c_to_a<NB>(a[mt], s[mt], kk);
#pragma unroll
      for (int n2 = 0; n2 < ND / 2; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bk_addr(tV, LD, kk * 16, n2 * 16, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][2 * n2], a[mt], b[0], b[1]);
          mma_16816(acc[mt][2 * n2 + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // O = acc / l, staged in the warp's own rows of sQ, then 16-byte rows
  __nv_bfloat16* sO = sQ + warp * WROWS * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_safe[r] = fmaxf(sum, 1e-20f);
      const int qr = row0 + mt * 16 + g + 8 * r;
      if (c == 0 && qr < t)
        lse[static_cast<size_t>(bh) * t + qr] =
            m[mt][r] * sm_scale + logf(l_safe[r]);
    }
    __nv_bfloat16* rows = sO + mt * 16 * LD;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(rows + g * LD + col) = pack_bf16x2(
          acc[mt][n][0] / l_safe[0], acc[mt][n][1] / l_safe[0]);
      *reinterpret_cast<uint32_t*>(rows + (g + 8) * LD + col) = pack_bf16x2(
          acc[mt][n][2] / l_safe[1], acc[mt][n][3] / l_safe[1]);
    }
  }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
  for (int i = lane; i < WROWS * CHUNKS; i += 32) {
    const int r = i / CHUNKS, col = (i % CHUNKS) * 8;
    if (row0 + r < t)
      *reinterpret_cast<uint4*>(o + base +
                                static_cast<size_t>(row0 + r) * D + col) =
          *reinterpret_cast<const uint4*>(sO + r * LD + col);
  }
}

// ---------------------------------------------------------------- float32

template <int D>
constexpr size_t tf32_smem_bytes() {
  // Q (BQ rows), then two stages each of K and V (BK rows), all float32
  // with rows of D + 4
  return sizeof(float) * (BQ + 4 * BK) * (D + 4);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    fwd_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int t, int kv_len,
                      float sm_scale, int causal) {
  using namespace mma_bf16;
  using namespace mma_tf32;
  constexpr int LD = D + 4;      // padded row stride (floats)
  constexpr int TILE = BK * LD;  // floats of one staged K or V tile
  constexpr int KD = D / 8;      // k steps of Q K^T
  constexpr int NB = BK / 8;     // n-blocks of the score tile
  constexpr int ND = D / 8;      // n-blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + BQ * LD;   // [2][BK][LD]
  float* sV = sK + 2 * TILE;  // [2][BK][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row0 = q0 + warp * 16;  // the warp's first query row
  const size_t base = static_cast<size_t>(bh) * t * D;
  const float* kb = k + base;
  const float* vb = v + base;

  // causal: keys past the block's last query row contribute nothing
  const int kend = causal ? min(kv_len, q0 + BQ) : kv_len;
  const int ntiles = (kend + BK - 1) / BK;

  load_rows_async<BQ, D, MMA_THREADS>(sQ, q + base, q0, t);
  load_rows_async<BK, D, MMA_THREADS>(sK, kb, 0, t);
  load_rows_async<BK, D, MMA_THREADS>(sV, vb, 0, t);
  cp_async_commit();

  const float scale = sm_scale * LOG2E;  // exponents in log2 units
  float acc[ND][4];
  // m: running max of the unscaled scores; l: this lane's share of the
  // row sums; rows g (r = 0) and g + 8
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < ntiles) {  // the next tile into the other stage
      const int st = (kt + 1) & 1;
      load_rows_async<BK, D, MMA_THREADS>(sK + st * TILE, kb,
                                                    k0 + BK, t);
      load_rows_async<BK, D, MMA_THREADS>(sV + st * TILE, vb,
                                                    k0 + BK, t);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();
    const float* tK = sK + (kt & 1) * TILE;
    const float* tV = sV + (kt & 1) * TILE;

    // S = Q K^T, 16 rows x BK keys per warp; Q's fragments are read from
    // shared memory per k step (kept in registers, they take D / 2 a
    // thread, and the D = 128 instance spills)
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], ah[4], al[4];
      ldmatrix_x4(a, a_addr(sQ, LD, warp * 16, kk * 8, lane));
      split4(a, ah, al);
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t b[4], kh[4], kl[4];
        ldmatrix_x4(b, bn_addr(tK, LD, n2 * 16, kk * 8, lane));
        split4(b, kh, kl);
        mma_1688_x3(s[2 * n2], s[2 * n2 + 1], ah, al, kh, kl);
      }
    }

    // mask only the ragged last tile and the diagonal tile
    if (k0 + BK > kv_len || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kc = k0 + n * 8 + 2 * c + (i & 1);
          const int qr = row0 + g + (i >> 1) * 8;
          if (kc >= kv_len || (causal && kc > qr)) s[n][i] = NEG_INF;
        }
    }

    // online softmax against the running max, as in fwd_kernel_mma
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < NB; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2_approx((m[r] - mx) * scale);
      const float mx_scaled = mx * scale;
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        s[n][2 * r] = exp2_approx(fmaf(s[n][2 * r], scale, -mx_scaled));
        s[n][2 * r + 1] =
            exp2_approx(fmaf(s[n][2 * r + 1], scale, -mx_scaled));
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l[r] = alpha * l[r] + sum;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // O += P V, one 8-key step per n-block j of S. The A fragment takes
    // this lane's keys 2c and 2c + 1 as columns c and c + 4 (mma_tf32.cuh),
    // so the B fragment reads V's rows 2c and 2c + 1.
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const uint32_t p[4] = {
          __float_as_uint(s[j][0]), __float_as_uint(s[j][2]),
          __float_as_uint(s[j][1]), __float_as_uint(s[j][3])};
      uint32_t ph[4], pl[4];
      split4(p, ph, pl);
      const float* vr = tV + (j * 8 + 2 * c) * LD + g;
#pragma unroll
      for (int n2 = 0; n2 < ND / 2; ++n2) {
        uint32_t vh[4], vl[4];
        split(vr[n2 * 16], vh[0], vl[0]);
        split(vr[LD + n2 * 16], vh[1], vl[1]);
        split(vr[n2 * 16 + 8], vh[2], vl[2]);
        split(vr[LD + n2 * 16 + 8], vh[3], vl[3]);
        mma_1688_x3(acc[2 * n2], acc[2 * n2 + 1], ph, pl, vh, vl);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // O = acc / l, staged in the warp's own rows of sQ, then 16-byte rows
  float* sO = sQ + warp * 16 * LD;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float l_safe = fmaxf(sum, 1e-20f);
    inv[r] = 1.f / l_safe;
    const int qr = row0 + g + 8 * r;
    if (c == 0 && qr < t)
      lse[static_cast<size_t>(bh) * t + qr] = m[r] * sm_scale + logf(l_safe);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * c;
    *reinterpret_cast<float2*>(sO + g * LD + col) =
        make_float2(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<float2*>(sO + (g + 8) * LD + col) =
        make_float2(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 4;
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = i / CHUNKS, col = (i % CHUNKS) * 4;
    if (row0 + r < t)
      *reinterpret_cast<float4*>(o + base +
                                 static_cast<size_t>(row0 + r) * D + col) =
          *reinterpret_cast<const float4*>(sO + r * LD + col);
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
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t, int kv_len, float sm_scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t smem = tf32_smem_bytes<D>();
  auto kern = fwd_kernel_tf32x3<D>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), t, kv_len, sm_scale, causal);
  return cudaGetLastError();
}

// two m-tiles a warp at D <= 64; at D = 128 two would not fit the
// registers
template <int D, int MT = (D <= 64 ? 2 : 1)>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int t, int kv_len, float sm_scale,
                        int causal, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D, MT>();
  auto kern = fwd_kernel_mma<D, MT>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + 64 * MT - 1) / (64 * MT), bh);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), t, kv_len, sm_scale, causal);
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

}  // namespace

// dtype: 0 = float32 (fwd_kernel_tf32x3), 1 = bfloat16 (fwd_kernel_mma).
// Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int t, int d, int kv_len, float sm_scale,
                                   int causal, int dtype, void* stream) {
  if (bh <= 0 || t <= 0 || kv_len <= 0 || kv_len > t || bh > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return with_head_dim(d, [&](auto dc) {
        return launch_f32<decltype(dc)::value>(q, k, v, o, lse, bh, t, kv_len,
                                               sm_scale, causal, s);
      });
    case 1:
      return with_head_dim(d, [&](auto dc) {
        return launch_bf16<decltype(dc)::value>(q, k, v, o, lse, bh, t,
                                                kv_len, sm_scale, causal, s);
      });
    default:
      return cudaErrorInvalidValue;
  }
}
