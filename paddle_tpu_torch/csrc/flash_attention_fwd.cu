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
// fwd_kernel_tf32wg<D, STAGES> (float32: the serving path and float32
//   training), the bf16 design above carried over to the TF32 tensor cores
//   with 3xTF32 products (sm90_tf32.cuh): every operand splits into a tf32
//   high and low part, hi = cvt.rna.tf32(x) and lo = tf32(x - hi), and
//   every product is hi hi + lo hi + hi lo with float32 accumulation, three
//   m64nNk8 TF32 wgmmas a k step. One TF32 product keeps 11 bits of each
//   operand and misses the float32 limit of 1e-4 on O; three meet it. P
//   stays float32, as the TPU kernel keeps it when V is float32. Bound at
//   the float32 training path's shape ([bh=192, T=512, d=64]): 12.9 GFLOP,
//   three times over, 0.078 ms at the 494.7 TFLOP/s TF32 peak (0.192 ms
//   for the same work at the CUDA cores' 67 TFLOP/s float32 peak), against
//   101 MB of Q, K, V, O and LSE (0.030 ms at 3.35 TB/s): bound by
//   operations; at the serving path's [96, 512, 64], 0.039 ms. What TF32
//   wgmma forces on the bf16 design:
//   - shared-memory operands must be K-major (the transpose flags are for
//     16-bit types). S = Q K^T reads K as it lands, but in O += P V the k
//     index is the key and V is stored [keys][d], so P V reads a
//     transposed copy V^T [d][keys], whose k columns follow the order in
//     which P's register A operand, made from S's accumulator
//     (c_to_a_tf32), holds each 8-key step: 0, 2, 4, 6, 1, 3, 5, 7
//     (key_slot);
//   - a split stage between TMA and wgmma: TMA lands raw float32 K and V
//     tiles (32-column boxes, the 128-byte swizzle) in a ring of STAGES
//     32-key stages, and the producer warpgroup's warps 1 .. 3 (warp 0
//     issues the loads) split K into hi (in place) and lo and V into V^T's
//     hi and lo only (16-byte loads and stores: a thread takes four keys
//     of one parity, whose slots are adjacent), fence them for wgmma and
//     arrive on the stage's "ready" mbarrier. Each element is split once a
//     stage, not once per fragment read by every warp. The split paces
//     the kernel (PERF.md §6), so the three split warps take equal
//     shares of a stage (split_share): dealt round-robin, one warp held a
//     third more and the stage waited for it;
//   - registers for the operand a consumer keeps for its tile: up to d =
//     64 it reads its Q rows into registers once a tile and splits them
//     there (64 registers a thread at d = 64), so every product is an RS
//     wgmma and no A operand is reread from shared memory; its Q tile goes
//     back to the producer at once, and the next tile's Q loads while this
//     one is computed. S (32 keys), P's hi and lo, O and Q's hi and lo take
//     144 registers a consumer thread at d = 64 against ptxas's 168;
//   - shared memory sets the rest: a stage is K hi, K lo, the raw V and V^T
//     hi and lo (40 KB at d = 64), beside a Q and an O tile per consumer
//     (32 KB each for two consumers), so four stages fill 225 KB of the
//     227 KB. At d = 128 (one consumer, O alone 64 registers) Q's hi and
//     lo stay in shared memory (SS wgmmas), O is staged in Q's hi, and two
//     stages fit;
//   - each consumer's S, softmax and P V of a stage run in order, the two
//     consumers overlapping each other (S of the next stage issued before
//     P V, as the bf16 kernel does, spilled at d = 64 and 128 and read
//     slower; the consumers taking turns to issue S read no faster:
//     PERF.md). The online softmax, masking only
//     the ragged last tile and the causal diagonal tile, the causal early
//     stop, LSE, persistent blocks over head chunks (heaviest tiles first)
//     and O's TMA store are the bf16 kernel's.
//   What holds it back is in PERF.md §6.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "sm90_bf16.cuh"
#include "sm90_tf32.cuh"

namespace {

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
template <int BK, int QR = ROWS>
__device__ __forceinline__ int fwd_tile(int i, int heads, int chunk, int nq,
                                        int kv_len, int causal, int& bh,
                                        int& ntiles) {
  int j;
  sm90::tile_order(i, heads, nq, chunk, bh, j);
  const int q0 = (nq - 1 - j) * QR;
  // causal: keys past the tile's last query row contribute nothing
  const int kend = causal ? min(kv_len, q0 + QR) : kv_len;
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

// this lane's rows row0 + g (r = 0) and row0 + g + 8 at the end of a
// query tile: the row sums over the quad, their inverse into inv, and LSE
// in natural-log units (rows past T not written)
__device__ __forceinline__ void fwd_rows_out(const float (&mrow)[2],
                                             const float (&l)[2],
                                             float (&inv)[2], float* lse,
                                             int bh, int t, int row0,
                                             float sm_scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
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
    const int warp = tid >> 5;
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
      fwd_rows_out(mrow, l, inv, lse, bh, t, row0, sm_scale);
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

namespace tf = sm90_tf32;

// key rows per ring stage of fwd_kernel_tf32wg: S, P's hi and lo A
// operands, O and Q's hi and lo (fwd_q_regs) take 144 registers a
// consumer thread at d = 64 against ptxas's 168
constexpr int FWD_TF32_KEYS = 32;
// ring stages: as many as fit beside Q and O (the head comment)
__host__ __device__ constexpr int fwd_tf32_stages(int d) {
  return d > 64 ? 2 : 4;
}
// whether a consumer holds Q's hi and lo in registers, as the A operands
// of S for the whole query tile: up to d = 64 (64 registers a thread at d
// = 64); at d = 128 (128 registers) Q stays in shared memory
__host__ __device__ constexpr bool fwd_q_regs(int d) { return d <= 64; }

// Per consumer a Q tile and an O staging tile ([64][D] float32 as swizzled
// boxes, sm90_tf32.cuh; at d = 128 Q's hi and lo, and O is staged in Q's
// hi), then STAGES ring stages of K hi, K lo and the raw V tile
// ([FWD_TF32_KEYS][D]) and V^T hi, V^T lo ([D][FWD_TF32_KEYS]), then the
// mbarriers: Q full and empty, per stage full, ready and empty; 1024 bytes
// of slack to align the base
template <int D, int STAGES>
constexpr size_t tf32wg_smem_bytes() {
  return 1024 +
         static_cast<size_t>(2 * tf::consumers(D) * 64 * D +
                             5 * STAGES * FWD_TF32_KEYS * D) *
             4 +
         8 * (2 + 3 * STAGES);
}

// The split warps' share of a ring stage, in blocks of 32 tasks a warp:
// NV blocks of V^T tasks (split_transposed_task, 16 elements each) and NK
// of K chunks (split_chunk, 4 elements). V blocks go round the three warps;
// K blocks follow in one contiguous run a warp, cut so that each warp's
// elements come nearest a third of the stage's (a warp that waits for
// another's share holds the stage back). Sets warp w's K blocks [k0, k1).
__device__ __forceinline__ void split_share(int nv, int nk, int w, int& k0,
                                            int& k1) {
  // warp u's V blocks u, u + 3, ..., 4 K chunks' worth each
  auto v_units = [&](int u) { return 4 * ((nv - u + 2) / 3); };
  // where warp u's K run ends: warps 0 .. u then hold (u + 1) / 3 of it
  auto k_end = [&](int u) {
    int v = 0;
    for (int x = 0; x <= u; ++x) v += v_units(x);
    return u == 2 ? nk
                  : min(max(((u + 1) * (4 * nv + nk) + 1) / 3 - v, 0), nk);
  };
  k0 = w == 0 ? 0 : k_end(w - 1);
  k1 = max(k_end(w), k0);
}

// S = Q K^T of one ring stage as 3xTF32 over the warpgroup's 64 query rows
// x the stage's KR keys (its K hi and K lo tiles from s0, K-major): Q's hi
// and lo from the registers qa, ql (fwd_q_regs), else from the tiles qh,
// ql_tile (all RS, or all SS)
template <int D, int KR>
__device__ __forceinline__ void fwd_issue_s_f32(
    float (&s)[KR / 8][4], const uint32_t (&qa)[fwd_q_regs(D) ? D / 8 : 1][4],
    const uint32_t (&ql)[fwd_q_regs(D) ? D / 8 : 1][4], uint32_t qh,
    uint32_t ql_tile, uint32_t s0) {
  constexpr int KT = KR * D * 4;  // bytes of a K tile
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    if constexpr (fwd_q_regs(D))
      tf::wgmma_x3_rs<KR>(s, qa[kk], ql[kk], tf::desc<D>(s0, KR, kk),
                          tf::desc<D>(s0 + KT, KR, kk), kk > 0);
    else
      tf::wgmma_x3_ss<KR>(s, tf::desc<D>(qh, 64, kk),
                          tf::desc<D>(ql_tile, 64, kk),
                          tf::desc<D>(s0, KR, kk),
                          tf::desc<D>(s0 + KT, KR, kk), kk > 0);
  }
  sm90::wgmma_commit();
}

// O += P V as 3xTF32: P's hi and lo A operands from registers (keys in the
// 0, 2, 4, 6, 1, 3, 5, 7 order of c_to_a_tf32), the stage's V^T hi and lo
// tiles (k = key, n = d; from s0) K-major, written in that key order
template <int D, int KR>
__device__ __forceinline__ void fwd_issue_pv_f32(float (&o)[D / 8][4],
                                                 const uint32_t (&ph)[KR / 8][4],
                                                 const uint32_t (&pl)[KR / 8][4],
                                                 uint32_t s0) {
  constexpr int KT = KR * D * 4;  // bytes of a V^T tile
  sm90::wgmma_fence();
#pragma unroll
  for (int j = 0; j < KR / 8; ++j)
    tf::wgmma_x3_rs<D>(o, ph[j], pl[j], tf::desc<KR>(s0 + 3 * KT, D, j),
                       tf::desc<KR>(s0 + 4 * KT, D, j));
  sm90::wgmma_commit();
}

template <int D, int STAGES>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
    fwd_kernel_tf32wg(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap o_map,
                      float* __restrict__ lse, int heads, int chunk, int nq,
                      int t, int kv_len, float sm_scale, int causal) {
  using namespace mma_bf16;
  using namespace sm90;
  constexpr int NC = tf::consumers(D);
  constexpr int KR = FWD_TF32_KEYS;
  constexpr bool QREG = fwd_q_regs(D);
  constexpr int QR = 64 * NC;     // query rows a tile
  constexpr int CT = 64 * D * 4;  // bytes of a consumer's Q or O tile
  constexpr int KT = KR * D * 4;  // bytes of a K, V or V^T tile
  constexpr int NB = D / 32;      // 32-column boxes along d
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // q_tiles: the raw Q rows (QREG) or Q's hi; o_tiles: O's staging tiles
  // (QREG) or Q's lo
  const uint32_t q_tiles =
      smem_u32(wg_smem + (1024 - smem_u32(wg_smem) % 1024) % 1024);
  const uint32_t o_tiles = q_tiles + NC * CT;
  // stage st: K hi, K lo, V (raw), V^T hi, V^T lo, KT bytes each
  const uint32_t ring = o_tiles + NC * CT;
  const uint32_t q_full = ring + STAGES * 5 * KT, q_empty = q_full + 8;
  const uint32_t full = q_empty + 8, ready = full + 8 * STAGES;
  const uint32_t empty = ready + 8 * STAGES;
  const int total = nq * heads;  // query tiles of the whole launch

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    // QREG: every consumer thread, once Q is in its registers; else each
    // consumer's first thread, once its O store has read Q's hi tile
    mbar_init(q_empty, QREG ? NC * WG_THREADS : NC);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(ready + 8 * st, tf::SPLIT_THREADS);
      mbar_init(empty + 8 * st, NC * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // A persistent block walks query tiles blockIdx.x, blockIdx.x +
  // gridDim.x, ...; its k/v ring runs on across tiles
  const int wg = threadIdx.x / WG_THREADS;
  if (wg == NC) {
    setmaxnreg_dec<tf::SPLIT_REGS>();
    const int ptid = threadIdx.x - NC * WG_THREADS;
    if (ptid == 0) {
      // TMA: each query tile's Q raw, and a ring of K and V tiles. With Q
      // in registers its tile is free as soon as the consumers have read
      // it, and the next tile's Q loads first; else once the last tile's
      // O store has read it, after the next tile's first ring stages
      int c = 0;  // ring stages walked
      for (int i = blockIdx.x, n = 0; i < total; i += gridDim.x, ++n) {
        int bh, ntiles;
        const int q0 = fwd_tile<KR, QR>(i, heads, chunk, nq, kv_len, causal,
                                        bh, ntiles);
        const int pre = QREG ? 0 : min(STAGES, ntiles);
        for (int kt = 0; kt <= ntiles; ++kt) {
          if (kt == pre) {
            mbar_wait(q_empty, (n & 1) ^ 1);
            mbar_expect_tx(q_full, NC * CT);
            for (int w = 0; w < NC; ++w)
              for (int b = 0; b < NB; ++b)
                tma_load_3d(q_tiles + w * CT + b * 64 * 128, &q_map, q_full,
                            b * 32, q0 + 64 * w, bh);
          }
          if (kt < ntiles) {
            const int st = c % STAGES;
            const uint32_t s0 = ring + st * 5 * KT, bar = full + 8 * st;
            mbar_wait(empty + 8 * st, ((c / STAGES) & 1) ^ 1);
            mbar_expect_tx(bar, 2 * KT);
            for (int b = 0; b < NB; ++b) {
              tma_load_3d(s0 + b * KR * 128, &k_map, bar, b * 32, kt * KR,
                          bh);
              tma_load_3d(s0 + 2 * KT + b * KR * 128, &v_map, bar, b * 32,
                          kt * KR, bh);
            }
            ++c;
          }
        }
      }
    } else if (ptid >= 32) {
      // the split stage: each K tile into hi (in place) and lo, each V tile
      // into the transposed V^T hi and lo only (P V's B operand, keys in
      // key_slot order); then the stage is ready for the consumers
      constexpr int NV = KR * D / 512, NK = KR * D / 128;  // 32-task blocks
      const int sw = ptid / 32 - 1, lane = ptid % 32;
      int k0, k1;
      split_share(NV, NK, sw, k0, k1);
      int c = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        int bh, ntiles;
        fwd_tile<KR, QR>(i, heads, chunk, nq, kv_len, causal, bh, ntiles);
        for (int kt = 0; kt < ntiles; ++kt, ++c) {
          const int st = c % STAGES;
          const uint32_t s0 = ring + st * 5 * KT;
          mbar_wait(full + 8 * st, (c / STAGES) & 1);
          for (int v = sw; v < NV; v += 3)
            tf::split_transposed_task<KR, D>(s0 + 2 * KT, s0 + 3 * KT,
                                             s0 + 4 * KT, 32 * v + lane);
#pragma unroll 4
          for (int b = k0; b < k1; ++b)
            tf::split_chunk<KR, D>(s0, s0 + KT, 32 * b + lane);
          fence_async_smem();
          mbar_arrive(ready + 8 * st);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows 64 wg .. 64 wg + 63 of each tile
    setmaxnreg_inc<tf::CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5;
    const float scale = sm_scale * LOG2E;  // exponents in log2 units
    const uint32_t qw = q_tiles + wg * CT, ow = o_tiles + wg * CT;

    float o[D / 8][4];
    float s[KR / 8][4];                   // a stage's S, then P
    uint32_t ph[KR / 8][4], pl[KR / 8][4];  // P V's A operand, hi and lo
    // Q's hi and lo as the A operands of S
    uint32_t qa[QREG ? D / 8 : 1][4], ql[QREG ? D / 8 : 1][4];
#pragma unroll
    for (int nn = 0; nn < KR / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nn][e] = 0.f;
    int rs = 0;  // ring stages walked
    for (int i = blockIdx.x, n = 0; i < total; i += gridDim.x, ++n) {
      int bh, ntiles;
      const int q0 = fwd_tile<KR, QR>(i, heads, chunk, nq, kv_len, causal,
                                      bh, ntiles);
      const int qw0 = q0 + 64 * wg;      // the warpgroup's first row
      const int row0 = qw0 + 16 * warp;  // the warp's first row
      mbar_wait(q_full, n & 1);
      if constexpr (QREG) {
        // the warp's Q rows into registers, split; the tile goes back to
        // the producer
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          tf::load_a<D>(qw, 64, 16 * warp, kk, qa[kk]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mma_tf32::split(__uint_as_float(qa[kk][e]), qa[kk][e],
                            ql[kk][e]);
        }
        mbar_arrive(q_empty);
      } else {
        // the warpgroup's Q rows into hi (in place) and lo
        tf::split_rows<64, D, 0>(qw, ow, 0, 0, 0, tid, WG_THREADS);
        fence_async_smem();
        named_barrier(1 + wg, WG_THREADS);
      }
      // mrow: running max of the unscaled scores; l: this lane's share of
      // the row sums; rows g (r = 0) and g + 8
      float mrow[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nn][e] = 0.f;

      for (int kt = 0; kt < ntiles; ++kt, ++rs) {
        const int st = rs % STAGES;
        const uint32_t s0 = ring + st * 5 * KT;
        mbar_wait(ready + 8 * st, (rs / STAGES) & 1);
        fwd_issue_s_f32<D, KR>(s, qa, ql, qw, ow, s0);
        wgmma_wait<0>();
        fence_regs(s);
        fwd_softmax<KR>(s, mrow, l, alpha, kt * KR, kv_len, causal, qw0,
                        row0, scale);
        // rescale O to the new running max
#pragma unroll
        for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nn][e] *= alpha[e >> 1];
        tf::c_to_a_x3(s, ph, pl);
        fwd_issue_pv_f32<D, KR>(o, ph, pl, s0);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(ph);
        fence_regs(pl);
        mbar_arrive(empty + 8 * st);  // the stage may be refilled
      }

      // O = acc / l and LSE in natural log; O staged in the warpgroup's O
      // tile (once the last tile's store has read it), or in its Q hi tile
      // (its last S has been retired), then one TMA store a box (rows past
      // T are not written)
      float inv[2];
      fwd_rows_out(mrow, l, inv, lse, bh, t, row0, sm_scale);
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nn][e] *= inv[e >> 1];
      const uint32_t stage = QREG ? ow : qw;
      if constexpr (QREG) {
        if (tid == 0) tma_store_wait_read();
        named_barrier(1 + wg, WG_THREADS);
      }
      tf::stage_rows<D, D>(stage, 64, 16 * warp, 0, o);
      fence_async_smem();
      named_barrier(1 + wg, WG_THREADS);
      if (tid == 0) {
        for (int b = 0; b < NB; ++b)
          tma_store_3d(&o_map, stage + b * 64 * 128, b * 32, qw0, bh);
        tma_store_commit();
        if constexpr (!QREG) {
          tma_store_wait_read();
          mbar_arrive(q_empty);
        }
      }
    }
    if (tid == 0) tma_store_wait_read();
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

template <int D, int STAGES = fwd_tf32_stages(D)>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t, int kv_len, float sm_scale,
                       int causal, cudaStream_t stream) {
  constexpr int NC = tf::consumers(D);
  constexpr size_t smem = tf32wg_smem_bytes<D, STAGES>();
  auto kern = fwd_kernel_tf32wg<D, STAGES>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  // boxes of 64 rows, a consumer's Q or O rows, and of a ring stage's key
  // rows for K and V
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = tf::rows_map<D>(
        &maps[i], ptrs[i], bh, t, i == 1 || i == 2 ? FWD_TF32_KEYS : 64);
    if (err != cudaSuccess) return err;
  }
  // persistent blocks: one a streaming multiprocessor, or one a tile
  static const int sms = sm90::sm_count();
  const int nq = (t + 64 * NC - 1) / (64 * NC);
  const int tiles = nq * bh;
  kern<<<tiles < sms ? tiles : sms, (NC + 1) * WG_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse), bh,
      sm90::head_chunk(sms, nq), nq, t, kv_len, sm_scale, causal);
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

// dtype: 0 = float32 (fwd_kernel_tf32wg), 1 = bfloat16 (fwd_kernel_wgmma).
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

// Dynamic shared memory the bf16 and float32 kernels' instances for head
// dim d take (0 where there is none); chip_smoke.py's smem_phase prints
// them beside ptxas's registers.
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

extern "C" long long flash_attention_fwd_f32_smem(int d) {
  switch (d) {
    case 32:
      return tf32wg_smem_bytes<32, fwd_tf32_stages(32)>();
    case 64:
      return tf32wg_smem_bytes<64, fwd_tf32_stages(64)>();
    case 128:
      return tf32wg_smem_bytes<128, fwd_tf32_stages(128)>();
    default:
      return 0;
  }
}
