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
// fwd_kernel<D> (float32), scalar float32 FMAs: Q, K, V and the
//   probability tile staged in shared memory as float32 (rows padded by
//   one word); thread (ty, tx) of 256 owns query rows 4*ty .. 4*ty+3,
//   score columns tx + 16*j and output columns tx + 16*c, and reduces a
//   row's max and sum across its 16 lanes with warp shuffles. Float32
//   stays on the CUDA cores on purpose: the serving path's float32
//   forward ([96, 512, 64], 6.4 GFLOP, bound by operations at the 67
//   TFLOP/s float32 peak) already beats float32 SDPA, and TF32 tensor
//   cores would break the float32 limits of 1e-4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key rows per k/v tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- float32

constexpr int NTHREADS = 256;  // 16 x 16 thread grid

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int t, int kv_len, float sm_scale,
               int causal) {
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int QS = D + 1;   // padded row strides
  constexpr int KS = D + 1;
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][QS]
  float* sK = sQ + BQ * QS;    // [BK][KS]
  float* sV = sK + BK * KS;    // [BK][D]
  float* sP = sV + BK * D;     // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = static_cast<size_t>(bh) * t * D;

  for (int idx = tid; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    const int qr = q0 + r;
    sQ[r * QS + c] = qr < t ? q[base + static_cast<size_t>(qr) * D + c] : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query row contribute nothing
  const int kend = causal ? min(kv_len, q0 + BQ) : kv_len;
  const int ntiles = (kend + BK - 1) / BK;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK/sV/sP are no longer read
    for (int idx = tid; idx < BK * D; idx += NTHREADS) {
      const int r = idx / D, c = idx % D;
      const int kr = k0 + r;
      const bool ok = kr < t;
      const size_t g = base + static_cast<size_t>(kr) * D + c;
      sK[r * KS + c] = ok ? k[g] : 0.f;
      sV[r * D + c] = ok ? v[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * QS + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sK[(tx + 16 * j) * KS + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      float rowmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool keep = kc < kv_len && (!causal || qr >= kc);
        const float x = keep ? s[i][j] * sm_scale : NEG_INF;
        s[i][j] = x;
        rowmax = fmaxf(rowmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, off));
      const float m_new = fmaxf(m[i], rowmax);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rowsum += p;
        sP[(ty * 4 + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rowsum;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= t) continue;
    const float l_safe = fmaxf(l[i], 1e-20f);
    const float inv = 1.f / l_safe;
    float* orow = o + base + static_cast<size_t>(qr) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) lse[static_cast<size_t>(bh) * t + qr] = m[i] + logf(l_safe);
  }
}

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
  constexpr size_t smem = smem_bytes<D>();
  auto kern = fwd_kernel<D>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(
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

// dtype: 0 = float32 (fwd_kernel), 1 = bfloat16 (fwd_kernel_mma). Returns
// the launch's cudaError_t.
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
