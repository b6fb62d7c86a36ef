// Flash attention forward for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel `_fwd_kernel` of paddle_tpu/ops/pallas/
// flash_attention.py (launched by `_fwd`): online-softmax attention
//   O = softmax(sm_scale * Q K^T, masked) V,   LSE = rowwise log-sum-exp,
// over q, k, v of shape [bh, T, d] (row-major, contiguous), with keys
// >= kv_len masked and, in causal mode, keys after the query masked.
// O is written in the input dtype, LSE as [bh, T] float32 (the TPU
// kernel's [bh, 8, T] sublane copy is a TPU tiling artefact).
//
// Design. The TPU kernel walks a sequential k grid dimension and keeps the
// running (m, l, acc) state in VMEM scratch between grid steps. Blocks on
// Hopper run in no order, so here one thread block owns one (bh, 64-row
// q tile) and loops over 64-row k/v tiles itself. Q, K, V and the
// probability tile are staged in shared memory as float32 (rows padded by
// one word so the column walks do not collide on a bank); m, l and the
// output accumulator live in float32 registers. 256 threads: thread
// (ty, tx) owns query rows 4*ty .. 4*ty+3 and score columns tx + 16*j,
// output columns tx + 16*c; a row's max and sum are reduced across the 16
// lanes that share it with warp shuffles. In causal mode the loop stops at
// the tile holding the diagonal; the ragged tail (T not a multiple of 64)
// is masked in the kernel, so the caller need not pad T.
//
// Bound at the slice's shape, B=8 BERT-base (bh=96, T=512, d=64, float32):
// 4*bh*T^2*d = 6.4 GFLOP per launch against ~50 MB of Q/K/V/O traffic
// (~15 us at 3.35 TB/s). This version computes with scalar float32 FMAs
// (67 TFLOP/s peak, ~0.1 ms for that work), so it is bound by operations,
// far above the memory floor. Tensor-core (mma/wgmma) and TMA versions
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key rows per k/v tile
constexpr int NTHREADS = 256;  // 16 x 16 thread grid
constexpr float NEG_INF = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
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
    sQ[r * QS + c] = qr < t ? to_f(q[base + static_cast<size_t>(qr) * D + c])
                            : 0.f;
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
      sK[r * KS + c] = ok ? to_f(k[g]) : 0.f;
      sV[r * D + c] = ok ? to_f(v[g]) : 0.f;
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
        // the TPU kernel multiplies p in V's dtype; do the same rounding
        sP[(ty * 4 + i) * PS + tx + 16 * j] = to_f(from_f<T>(p));
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
    T* orow = o + base + static_cast<size_t>(qr) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (tx == 0) lse[static_cast<size_t>(bh) * t + qr] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t, int kv_len, float sm_scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = fwd_kernel<T, D>;
  // above 48 KB a block's shared memory must be requested explicitly; the
  // attribute stays set, so it is set once per instance and its result is
  // kept for every later call
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), t, kv_len, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t, int d, int kv_len,
                       float sm_scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, bh, t, kv_len, sm_scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, t, kv_len, sm_scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, t, kv_len, sm_scale, causal,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int t, int d, int kv_len, float sm_scale,
                                   int causal, int dtype, void* stream) {
  if (bh <= 0 || t <= 0 || kv_len <= 0 || kv_len > t || bh > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_d<float>(q, k, v, o, lse, bh, t, d, kv_len, sm_scale,
                               causal, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, kv_len,
                                       sm_scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}
