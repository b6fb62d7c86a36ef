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
// run in no order, so here a block owns a query tile and loops over the
// k/v tiles itself; in causal mode the loop stops at the tile holding the
// diagonal, and the ragged tail (T not a multiple of the tile) is masked
// in the kernel, so the caller need not pad T.
//
// Two kernels, chosen by dtype in the entry point:
//
// fwd_kernel_wgmma<D, STAGES> (bfloat16), a Hopper design (wgmma, TMA and
//   mbarriers; helpers in sm90_bf16.cuh). Bound at the training path's
//   shape ([bh=384, T=512, d=64] bf16): 4*d operations per (query, key)
//   pair, 25.8 GFLOP (26 us at the 989 TFLOP/s bf16 peak), against
//   101.5 MB of Q, K, V, O and LSE (30 us at 3.35 TB/s): bound by bytes,
//   with the exp of every score (one MUFU ex2 a score, 16 a clock an SM)
//   as long again as the products at d = 64. What the design does:
//   - three warpgroups: a producer whose first thread keeps a ring of
//     STAGES k/v tiles (128 keys; 64 at d = 128, where a 128-key tile's
//     scores, P and O exceed a consumer's registers) full by TMA, with
//     full and empty mbarriers per stage, and two consumers of 64 query
//     rows each, so a block owns a 128-row query tile; setmaxnreg moves
//     registers from the producer to the consumers;
//   - tensor maps over (d, T, bh): a box past T comes back zero-filled
//     instead of holding the next head's rows, and keys >= kv_len are
//     masked in the kernel;
//   - S = Q K^T by SS wgmma (both K-major, 128-byte swizzle; 64-byte at
//     d = 32), the online softmax on the accumulators (quad shuffles, one
//     FFMA and one ex2 a score, the running max on the raw scores, LSE =
//     sm_scale * m + ln l in natural-log units), P to bf16 A operands in
//     registers, O += P V by RS wgmma with V as the MN-major B operand;
//   - S of key tile kt is issued before P V of tile kt - 1, so the
//     softmax of one tile runs while the tensor cores add the last one;
//   - persistent: one block an SM walks query tiles, Q double-buffered,
//     the k/v ring running on across tiles, and the next tile's first S
//     issued before this tile's epilogue (O through shared memory and a
//     TMA store that skips rows past T);
//   - tiles in head chunks (sm90::tile_order) so the K and V rows the
//     tiles of a head share are read from L2, and within a chunk the
//     heaviest (bottom, in causal mode) tiles first, so no tail of long
//     tiles ends the launch.
//   What holds it back is in PERF.md (PR 7).
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
//   Softmax, masking, early stop and LSE as in the bf16 kernel. Bound at
//   the serving path's shape ([bh=96, T=512, d=64] float32): 6.4 GFLOP,
//   three times over, 39 us at the 494.7 TFLOP/s TF32 peak (96 us if one
//   counts 6.4 GFLOP at the 67 TFLOP/s float32 peak of the CUDA cores),
//   against 50.5 MB (15 us at 3.35 TB/s): bound by operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "sm90_bf16.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key rows per k/v tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// --------------------------------------------------------------- bfloat16

constexpr int WG_THREADS = 128;                // one warpgroup
// two consumer warpgroups and a producer warpgroup (one thread of it
// issues the loads): 168 registers a thread at launch, then the producer
// gives all but PRODUCER_REGS of its share to the consumers (setmaxnreg)
constexpr int WGMMA_THREADS = 3 * WG_THREADS;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(WG_THREADS * (PRODUCER_REGS + 2 * CONSUMER_REGS) <=
                  WGMMA_THREADS * 168,
              "the consumers take only what the producer gives up");
constexpr int ROWS = 128;  // query rows per tile (64 per consumer)
// key rows per k/v tile: 128, or 64 at d = 128 (the scores, P and O of
// a 128-key tile take more registers than a consumer has)
__host__ __device__ constexpr int fwd_key_rows(int d) {
  return d > 64 ? 64 : 128;
}

// two Q tiles and the O staging tile ([ROWS][D]), then STAGES K tiles and
// STAGES V tiles ([fwd_key_rows(D)][D]), all bf16 as swizzled boxes
// (sm90_bf16.cuh), then the mbarriers: per Q tile full and empty, and per
// stage K full, V full and empty; 1024 bytes of slack to align the base
template <int D, int STAGES>
constexpr size_t wgmma_smem_bytes() {
  return 1024 +
         static_cast<size_t>(3 * ROWS + 2 * STAGES * fwd_key_rows(D)) * D *
             2 +
         8 * (4 + 3 * STAGES);
}

// query tile `i` of a persistent block's walk (sm90::tile_order): within
// each chunk of heads the heaviest first (the bottom tile of every head,
// then the one above it, ...; in causal mode tile x does x + 1 key tiles'
// work). Returns q0, sets bh and the number of key tiles.
template <int BK>
__device__ __forceinline__ int fwd_tile(int i, int heads, int chunk, int nq,
                                        int kv_len, int causal, int& bh,
                                        int& ntiles) {
  int j;
  sm90::tile_order(i, heads, nq, chunk, bh, j);
  const int q0 = (nq - 1 - j) * ROWS;
  // causal: keys past the tile's last query row contribute nothing
  const int kend = causal ? min(kv_len, q0 + ROWS) : kv_len;
  ntiles = (kend + BK - 1) / BK;
  return q0;
}

// S = Q K^T of one key tile: the warpgroup's 64 rows (Q at descriptor
// qd) x BK keys (the K tile at k_tile), both K-major
template <int D, int BK>
__device__ __forceinline__ void fwd_issue_s(float (&sc)[BK / 8][4],
                                            uint64_t qd, uint32_t k_tile) {
  using namespace sm90;
  const uint64_t kd = kmajor_desc<D>(k_tile, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BK>(sc, kstep<D>(qd, ROWS, kk), kstep<D>(kd, BK, kk), kk > 0);
  wgmma_commit();
}

// O += bf16(P) V: P's A operand from the score accumulators, the V tile
// at v_tile MN-major
template <int D, int BK>
__device__ __forceinline__ void fwd_issue_pv(float (&o_acc)[D / 8][4],
                                             const uint32_t (&pa)[BK / 16][4],
                                             uint32_t v_tile) {
  using namespace sm90;
  const uint64_t vd = mnmajor_desc<D>(v_tile, BK);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(o_acc, pa[kk], kstep_mn<D>(vd, kk * 16), 1);
  wgmma_commit();
}

// The scores of key tile k0 .. k0 + BK - 1 masked (only the ragged last tile
// and the diagonal tile), then the online softmax against the running max
// for this lane's rows row0 + g (r = 0) and row0 + g + 8: P into sc, the
// running max and sums updated, and alpha, the rescale factor of the
// rows' O. p = exp(sm_scale (s - m)) = 2^(s scale - m scale): one FFMA
// and one ex2 per score
template <int BK>
__device__ __forceinline__ void fwd_softmax(float (&sc)[BK / 8][4],
                                            float (&mrow)[2], float (&l)[2],
                                            float (&alpha)[2], int k0,
                                            int kv_len, int causal, int qw0,
                                            int row0, float scale) {
  using namespace mma_bf16;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  if (k0 + BK > kv_len || (causal && k0 + BK - 1 > qw0)) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = k0 + n * 8 + 2 * c + (i & 1);
        const int qr = row0 + g + (i >> 1) * 8;
        if (kc >= kv_len || (causal && kc > qr)) sc[n][i] = NEG_INF;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = mrow[r];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
      mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[r] = exp2_approx((mrow[r] - mx) * scale);
    const float mx_scaled = mx * scale;
    mrow[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      sc[n][2 * r] = exp2_approx(fmaf(sc[n][2 * r], scale, -mx_scaled));
      sc[n][2 * r + 1] =
          exp2_approx(fmaf(sc[n][2 * r + 1], scale, -mx_scaled));
      sum += sc[n][2 * r] + sc[n][2 * r + 1];
    }
    l[r] = alpha[r] * l[r] + sum;
  }
}

template <int D, int STAGES>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
    fwd_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map,
                     float* __restrict__ lse, int heads, int chunk, int nq,
                     int t, int kv_len, float sm_scale, int causal) {
  using namespace mma_bf16;
  using namespace sm90;
  using G = Tile<D>;
  constexpr int BK = fwd_key_rows(D);
  constexpr int TILE = ROWS * D * 2;   // bytes of the Q or O tile
  constexpr int KTILE = BK * D * 2;    // bytes of one K or V tile
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* sQ = wg_smem + (1024 - smem_u32(wg_smem) % 1024) % 1024;
  const uint32_t q_tiles = smem_u32(sQ), o_tile = q_tiles + 2 * TILE;
  const uint32_t k_tiles = o_tile + TILE;
  const uint32_t v_tiles = k_tiles + STAGES * KTILE;
  const uint32_t q_full = v_tiles + STAGES * KTILE, q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16, v_full = k_full + 8 * STAGES;
  const uint32_t empty = v_full + 8 * STAGES;
  const int total = nq * heads;  // query tiles of the whole launch

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + 8 * b, 1);
      mbar_init(q_empty + 8 * b, 2 * WG_THREADS);
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // A persistent block walks query tiles blockIdx.x, blockIdx.x +
  // gridDim.x, ...; its k/v ring runs on across tiles, so the next tile's
  // Q, K and V load while this one is computed and its O is stored
  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 2) {
    // producer: one thread keeps the TMA ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG_THREADS) {
      int n = 0, c = 0;  // tiles and k/v stages walked
      for (int i = blockIdx.x; i < total; i += gridDim.x, ++n) {
        int bh, ntiles;
        const int q0 =
            fwd_tile<BK>(i, heads, chunk, nq, kv_len, causal, bh, ntiles);
        // Q into buffer n % 2, once tile n - 2's S is done with it
        const uint32_t qf = q_full + 8 * (n & 1);
        const uint32_t qt_smem = q_tiles + (n & 1) * TILE;
        mbar_wait(q_empty + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(qf, TILE);
        for (int b = 0; b < G::NBOX; ++b)
          for (int h = 0; h < 2; ++h)
            tma_load_3d(qt_smem + (b * ROWS + h * 64) * G::ROWB, &q_map, qf,
                        b * G::ELEMS, q0 + h * 64, bh);
        for (int kt = 0; kt < ntiles; ++kt, ++c) {
          const int st = c % STAGES;
          mbar_wait(empty + 8 * st, ((c / STAGES) & 1) ^ 1);
          const uint32_t kd = k_tiles + st * KTILE;
          const uint32_t vd = v_tiles + st * KTILE;
          mbar_expect_tx(k_full + 8 * st, KTILE);
          for (int b = 0; b < G::NBOX; ++b)
            for (int h = 0; h < BK / 64; ++h)
              tma_load_3d(kd + (b * BK + h * 64) * G::ROWB, &k_map,
                          k_full + 8 * st, b * G::ELEMS, kt * BK + h * 64,
                          bh);
          mbar_expect_tx(v_full + 8 * st, KTILE);
          for (int b = 0; b < G::NBOX; ++b)
            for (int h = 0; h < BK / 64; ++h)
              tma_load_3d(vd + (b * BK + h * 64) * G::ROWB, &v_map,
                          v_full + 8 * st, b * G::ELEMS, kt * BK + h * 64,
                          bh);
        }
      }
    }
  } else {
    // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each query tile
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c = lane & 3;
    const float scale = sm_scale * LOG2E;  // exponents in log2 units

    float o_acc[D / 8][4];
    float sc[BK / 8][4];      // a tile's scores, then P
    uint32_t pa[BK / 16][4];  // P in bf16 as the A operand of P V
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;

    // tn, ks: query tiles and k/v stages walked; st: the stage of the
    // key tile in hand
    int tn = 0, ks = 0, st = 0;
    int i = blockIdx.x, bh, ntiles;
    int q0 = fwd_tile<BK>(i, heads, chunk, nq, kv_len, causal, bh, ntiles);
    uint64_t qd = kmajor_desc<D>(q_tiles, wg * 64);
    // the first tile's first S (each later tile's is issued before the
    // epilogue of the tile before it)
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    ++ks;
    fwd_issue_s<D, BK>(sc, qd, k_tiles);
    while (true) {
      const int qw0 = q0 + wg * 64;      // the warpgroup's first row
      const int row0 = qw0 + warp * 16;  // the warp's first row
      const uint32_t q_release = q_empty + 8 * (tn & 1);
      // mrow: running max of the unscaled scores; l: this lane's share
      // of the row sums; rows g (r = 0) and g + 8
      float mrow[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
      float alpha[2];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;

      // Pipelined over key tiles: S of tile kt is issued before P V of
      // tile kt - 1, so the softmax of tile kt runs while the tensor
      // cores add P V
      wgmma_wait<0>();  // S of key tile 0
      fence_regs(sc);
      if (ntiles == 1) mbar_arrive(q_release);  // the tile's last S is done
      fwd_softmax<BK>(sc, mrow, l, alpha, 0, kv_len, causal, qw0, row0,
                      scale);
      for (int kt = 1; kt < ntiles; ++kt) {
        // P of tile kt - 1 to bf16, so the score registers take tile kt
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) c_to_a<BK / 8>(pa[kk], sc, kk);
        const int prev = st;
        st = ks % STAGES;
        mbar_wait(k_full + 8 * st, (ks / STAGES) & 1);
        fwd_issue_s<D, BK>(sc, qd, k_tiles + st * KTILE);
        mbar_wait(v_full + 8 * prev, ((ks - 1) / STAGES) & 1);
        fwd_issue_pv<D, BK>(o_acc, pa, v_tiles + prev * KTILE);
        ++ks;
        wgmma_wait<1>();  // S of tile kt has landed
        fence_regs(sc);
        if (kt == ntiles - 1) mbar_arrive(q_release);
        fwd_softmax<BK>(sc, mrow, l, alpha, kt * BK, kv_len, causal, qw0,
                        row0, scale);
        wgmma_wait<0>();  // P V of tile kt - 1 too
        fence_regs(o_acc);
        fence_regs(pa);
        mbar_arrive(empty + 8 * prev);  // stage prev may be refilled
        // rescale O to the new running max
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o_acc[n][e] *= alpha[e >> 1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) c_to_a<BK / 8>(pa[kk], sc, kk);
      mbar_wait(v_full + 8 * st, ((ks - 1) / STAGES) & 1);
      fwd_issue_pv<D, BK>(o_acc, pa, v_tiles + st * KTILE);

      // the next tile's first S goes to the tensor cores before this
      // tile's epilogue. After the last tile an S of this tile's Q and
      // last K is issued all the same and dropped: a wgmma issued on a
      // branch makes ptxas serialize every wgmma of the kernel
      const int next = i + gridDim.x;
      const bool more = next < total;
      const int last = st;
      int nbh = 0, nntiles = 0, nq0 = 0;
      if (more) {
        nq0 = fwd_tile<BK>(next, heads, chunk, nq, kv_len, causal, nbh,
                           nntiles);
        qd = kmajor_desc<D>(q_tiles + ((tn + 1) & 1) * TILE, wg * 64);
        mbar_wait(q_full + 8 * ((tn + 1) & 1), ((tn + 1) >> 1) & 1);
        st = ks % STAGES;
        mbar_wait(k_full + 8 * st, (ks / STAGES) & 1);
        ++ks;
      }
      fwd_issue_s<D, BK>(sc, qd, k_tiles + st * KTILE);
      wgmma_wait<1>();  // this tile's last P V
      fence_regs(o_acc);
      fence_regs(pa);
      mbar_arrive(empty + 8 * last);

      // O = acc / l into the warpgroup's rows of the staging tile (once
      // the last tile's store has read them), then one TMA store a box
      // (rows past T are not written); LSE in natural log
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
          lse[static_cast<size_t>(bh) * t + qr] =
              mrow[r] * sm_scale + logf(l_safe);
      }
      if (tid == 0) tma_store_wait_read();
      named_barrier(1 + wg, WG_THREADS);
      stage_rows<D, D>(o_tile, ROWS, wg * 64 + warp * 16, 0, o_acc, inv[0],
                       inv[1]);
      fence_async_smem();
      named_barrier(1 + wg, WG_THREADS);
      if (tid == 0) {
        for (int b = 0; b < G::NBOX; ++b)
          tma_store_3d(&o_map, o_tile + (b * ROWS + wg * 64) * G::ROWB,
                       b * G::ELEMS, qw0, bh);
        tma_store_commit();
      }
      if (!more) break;
      i = next;
      ++tn;
      q0 = nq0;
      bh = nbh;
      ntiles = nntiles;
    }
    wgmma_wait<0>();  // the dropped S
    if (tid == 0) tma_store_wait_read();
  }
}

// ---------------------------------------------------------------- float32

constexpr int MMA_THREADS = 128;  // 4 warps

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

    // online softmax against the running max, as in the bf16 kernel
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

constexpr int FWD_STAGES = 2;  // k/v ring stages of the bf16 kernel

template <int D, int STAGES = FWD_STAGES>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int t, int kv_len, float sm_scale,
                        int causal, cudaStream_t stream) {
  constexpr size_t smem = wgmma_smem_bytes<D, STAGES>();
  auto kern = fwd_kernel_wgmma<D, STAGES>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  // the maps take boxes of 64 rows: each consumer's half of a tile
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = sm90::rows_map<D>(&maps[i], ptrs[i], bh, t, 64);
    if (err != cudaSuccess) return err;
  }
  // persistent blocks: one a streaming multiprocessor, or one a tile
  static const int sms = sm90::sm_count();
  const int nq = (t + ROWS - 1) / ROWS;
  kern<<<min(nq * bh, sms), WGMMA_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse), bh,
      sm90::head_chunk(sms, nq), nq, t, kv_len, sm_scale, causal);
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

// dtype: 0 = float32 (fwd_kernel_tf32x3), 1 = bfloat16 (fwd_kernel_wgmma).
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

// Dynamic shared memory the bf16 kernel's instance for head dim d takes
// (0 where there is none); chip_smoke.py's [build] prints it beside
// ptxas's registers.
extern "C" long long flash_attention_fwd_smem(int d) {
  switch (d) {
    case 32:
      return wgmma_smem_bytes<32, FWD_STAGES>();
    case 64:
      return wgmma_smem_bytes<64, FWD_STAGES>();
    case 128:
      return wgmma_smem_bytes<128, FWD_STAGES>();
    default:
      return 0;
  }
}
