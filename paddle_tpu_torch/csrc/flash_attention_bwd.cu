// Flash attention backward for Hopper (sm_90a), plain C entry points.
//
// Replaces the two TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// that `_bwd` launches, the FlashAttention-2 backward:
//   `_bwd_dq_kernel`  -> flash_attention_bwd_dq:
//       dQ = sum over k tiles of  dS K,
//   `_bwd_dkv_kernel` -> flash_attention_bwd_dkv:
//       dV = sum over q tiles of  P^T dO,   dK = sum over q tiles of dS^T Q,
// where per (q, k) tile, recomputed from the forward's row log-sum-exp,
//   S  = sm_scale * Q K^T (keys >= T and, causal, keys after the query
//        masked),   P = exp(S - LSE),   dP = dO V^T,
//   dS = P * (dP - delta) * sm_scale,   delta = rowsum(dO * O)
// (delta is computed once per row by the caller, as the TPU wrapper does).
// q, k, v, dO, dQ, dK, dV are [bh, T, d] row-major contiguous in one dtype
// (float32 or bfloat16); LSE and delta are [bh, T] float32. As in the TPU
// kernels, dS is rounded to the input dtype before dS K and dS^T Q, and P
// before P^T dO; every product accumulates in float32.
//
// Design. The TPU kernels walk a sequential grid dimension and carry dq (or
// dk, dv) in VMEM scratch between grid steps. Blocks on Hopper run in no
// order, so each block owns its output tile and loops itself:
//   dq:  one block per (bh, 64-row q tile); Q, dO stay in shared memory,
//        64-row K/V tiles stream through; in causal mode the loop stops at
//        the tile holding the diagonal.
//   dkv: one block per (bh, 64-row k tile); K, V stay in shared memory,
//        64-row Q/dO tiles stream through; in causal mode the loop starts
//        at the tile holding the diagonal.
// Tiles are staged as float32, rows padded by one word so the column walks
// do not collide on a bank. 256 threads: thread (ty, tx) owns tile rows
// 4*ty .. 4*ty+3, score columns tx + 16*j and output columns tx + 16*c.
// The accumulators (dq, or dk and dv) live in float32 registers and are
// stored once. The ragged tail (T not a multiple of 64) is masked in the
// kernels, so the caller need not pad T.
//
// Bound at the training path's shape (bh=384, T=512, d=64, bfloat16): the
// dq pass does 6*d operations per (q, k) pair (38.7 GFLOP) and the dk/dv
// pass 8*d (51.5 GFLOP) against ~130-150 MB of traffic, so both are bound
// by operations (0.039 / 0.052 ms at the bf16 tensor-core peak). This
// version computes with scalar float32 FMAs (67 TFLOP/s peak, 0.58 /
// 0.77 ms for that work); tensor-core (mma/wgmma) and TMA versions are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // key rows per tile
constexpr int NTHREADS = 256;  // 16 x 16 thread grid
constexpr int PS = 65;         // padded row stride of the 64-wide P/dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and widened back: the TPU kernels' astype before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// rows [r0, r0 + 64) of a [T, D] matrix into a padded float32 tile; rows
// past T read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int t) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    const int gr = r0 + r;
    dst[r * (D + 1) + c] =
        gr < t ? to_f(src[static_cast<size_t>(gr) * D + c]) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int t, float sm_scale, int causal) {
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

  load_tile<T, D>(sQ, q + base, q0, t);
  load_tile<T, D>(sdO, dout + base, q0, t);

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
    load_tile<T, D>(sK, k + base, k0, t);
    load_tile<T, D>(sV, v + base, k0, t);
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
        sdS[(ty * 4 + i) * PS + tx + 16 * j] = round_to<T>(ds);
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
    T* row = dq + base + static_cast<size_t>(qr) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int t, float sm_scale,
               int causal) {
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

  load_tile<T, D>(sK, k + base, k0, t);
  load_tile<T, D>(sV, v + base, k0, t);

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
    load_tile<T, D>(sQ, q + base, q0, t);
    load_tile<T, D>(sdO, dout + base, q0, t);
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
        sP[(ty * 4 + i) * PS + qc] = round_to<T>(p);
        sdS[(ty * 4 + i) * PS + qc] = round_to<T>(ds);
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
    T* krow = dk + base + static_cast<size_t>(kr) * D;
    T* vrow = dv + base + static_cast<size_t>(kr) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[tx + 16 * c] = from_f<T>(acc_k[i][c]);
      vrow[tx + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

// above 48 KB a block's shared memory must be requested explicitly; the
// attribute stays set, so each kernel instance sets it once and keeps the
// result for every later call
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int t, float sm_scale, int causal,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kern = dq_kernel<T, D>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), t, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int t, float sm_scale,
                       int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kern = dkv_kernel<T, D>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BK - 1) / BK, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), t, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_d(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int t, int d, float sm_scale, int causal,
                 cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, bh, t, sm_scale,
                              causal, s);
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, t, sm_scale,
                              causal, s);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, bh, t,
                               sm_scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_d(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int t, int d, float sm_scale,
                  int causal, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                               sm_scale, causal, s);
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                               sm_scale, causal, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                sm_scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_shape(int bh, int t) { return bh <= 0 || t <= 0 || bh > 65535; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns the launch's cudaError_t.
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
      return dq_d<float>(q, k, v, dout, lse, delta, dq, bh, t, d, sm_scale,
                         causal, s);
    case 1:
      return dq_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, t, d,
                                 sm_scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

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
      return dkv_d<float>(q, k, v, dout, lse, delta, dk, dv, bh, t, d,
                          sm_scale, causal, s);
    case 1:
      return dkv_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, t,
                                  d, sm_scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
