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
// order, so each block owns output tiles and loops itself:
//   dq:  128-row q tiles (64 in the float32 kernel); 64-row K/V tiles
//        stream through; in causal mode the loop stops at the tile
//        holding the diagonal.
//   dkv: 128-row k tiles (64 in the float32 kernel); 64-row Q/dO tiles
//        stream through; in causal mode the loop starts at the tile
//        holding the diagonal.
// The ragged tail (T not a multiple of the tile) is masked in the
// kernels, so the caller need not pad T.
//
// Bounds. The dq pass does 6*d operations per (q, k) pair and the dk/dv
// pass 8*d. At the bf16 training path's shape ([bh=384, T=512, d=64]):
// 38.7 and 51.5 GFLOP against 127-153 MB of traffic, so both are bound by
// operations: 0.039 / 0.052 ms at the 989 TFLOP/s bf16 tensor-core peak.
// At the float32 training path's shape ([bh=192, T=512, d=64]): 19.3 and
// 25.8 GFLOP, each product taken three times as 3xTF32 (below), 0.117 /
// 0.156 ms at the 494.7 TFLOP/s TF32 tensor-core peak (0.288 / 0.385 ms
// for the same work at the CUDA cores' 67 TFLOP/s float32 peak), against
// 127 / 152 MB (0.038 / 0.045 ms at 3.35 TB/s): bound by operations too.
//
// Kernels, chosen by dtype in the entry points:
//
// dkv_kernel_wgmma<D, STAGES> (bfloat16), a Hopper design (wgmma, TMA and
//   mbarriers; helpers in sm90_bf16.cuh). The transposed formulation:
//     S^T = K Q^T,  P^T = exp(sm_scale S^T - LSE[q]),
//     dV += bf16(P^T) dO,  dP^T = V dO^T,
//     dS^T = P^T (dP^T - delta[q]) sm_scale,  dK += bf16(dS^T) Q,
//   so every product is a wgmma and neither P^T nor dS^T goes through
//   shared memory:
//   - three warpgroups: a producer whose first warp loads each key
//     tile's K and V and keeps a ring of STAGES 64-row Q and dO tiles
//     full by TMA (tensor maps over (d, T, bh): a box past T is
//     zero-filled), its 32 lanes copying each stage's LSE and delta rows
//     by cp.async (rows of a [bh, T] float32 tensor have no 16-byte
//     alignment for TMA); two consumers of 64 key rows each, so a block
//     owns 128 key rows; setmaxnreg moves registers to the consumers;
//   - S^T and dP^T by SS wgmma (K, V and Q, dO all K-major), P^T and dS^T
//     from the accumulators into RS wgmma A operands in registers, dV and
//     dK by RS wgmma with dO and Q as MN-major B operands; LSE and delta
//     read per accumulator column pair into registers;
//   - the two consumers overlap each other's softmax with their products
//     (issuing a tile's S^T and dP^T before the last tile's dV and dK
//     were retired read no faster, and made ptxas spill);
//   - persistent: one block an SM walks key tiles, the Q/dO ring runs on
//     across them, the next tile's K and V load once the last S^T and
//     dP^T of this one are done, and dK, dV leave through staging tiles
//     of their own by TMA store (rows past T not written);
//   - tiles in head chunks (sm90::tile_order) so the Q and dO rows the
//     key tiles of a head share are read from L2, the top tiles (the
//     heaviest in causal mode) first.
//   At d = 128 dK and dV of all 128 columns would take 128 accumulator
//   registers a thread besides S^T, dP^T and the operands, more than a
//   consumer has: there a tile sums one 64-column box of dK and dV (two
//   tiles a key tile), at the price of computing S^T and dP^T twice.
//   What holds it back is in PERF.md (PR 7).
//
// dq_kernel_wgmma<D, STAGES> (bfloat16), the forward's Hopper design
//   (fwd_kernel_wgmma) with one more product and no online softmax, since
//   LSE is known. Per key tile:
//     S = Q K^T,  P = exp(sm_scale S - LSE),  dP = dO V^T,
//     dS = P (dP - delta) sm_scale,  dQ += bf16(dS) K:
//   - three warpgroups: a producer whose first thread loads each query
//     tile's Q and dO (double-buffered, so the next tile's load while this
//     one is computed) and keeps a ring of STAGES K and V tiles full by
//     TMA (tensor maps over (d, T, bh): a box past T is zero-filled), with
//     full and empty mbarriers. A stage is freed only when dS K of its
//     tile is retired, one key tile after its S and dP, so two stages are
//     in use at any time: with STAGES = 2 every load waited on the slot
//     just freed (PERF.md). Two consumers of 64
//     query rows each, so a block owns a 128-row query tile; setmaxnreg
//     moves registers to the consumers. Each consumer lane reads the LSE
//     and delta of its two rows into registers once a tile (no cp.async
//     warp: the rows are per query, fixed for the tile);
//   - S and dP by SS wgmma (Q, K, dO and V all K-major), P and dS on the
//     accumulators, dS to bf16 A operands in registers, dQ += dS K by RS
//     wgmma with K as the MN-major B operand (as the forward's P V reads
//     V);
//   - S and dP of key tile kt are issued before dS K of tile kt - 1, so
//     the exp and dS of one tile run while the tensor cores add the last
//     one;
//   - persistent: one block an SM walks query tiles, the k/v ring running
//     on across them; the next tile's first S and dP are issued before
//     this tile's epilogue, which stages dQ in bf16 in a tile of its own
//     and stores it by TMA (rows past T not written), so a tile's Q and
//     dO buffers go back to the producer once its last S and dP are
//     retired, as in the forward;
//   - tiles in head chunks (sm90::tile_order) so the K and V rows the
//     tiles of a head share are read from L2, the bottom tiles (the
//     heaviest in causal mode) first, and a block takes tiles b and
//     2 g - 1 - b of every 2 g (dq_walk), so one of a chunk's heaviest
//     tiles goes with one of its lightest (causal: 0.077 -> 0.072 ms
//     against blocks taking every g-th tile, PERF.md).
//   Only the ragged last key tile and the diagonal tile are masked (a
//   padded key's rows of K and V are zero, so its dS K term is 0 anyway;
//   the mask keeps exp(-LSE) of a padded key from overflowing into
//   inf * 0). Key tiles are 64 rows, 32 at d = 128: every register of S,
//   dP, dS's operand and dQ is an operand of a wgmma in flight at once,
//   112 a consumer thread at d = 64, and ptxas allocates at most 168 a
//   thread for the whole kernel, whatever setmaxnreg gives at run time;
//   at d = 128 64-key tiles (144) spilled and serialized every wgmma,
//   32-key tiles take 112. What holds it back is in PERF.md §6.
//
// dkv_kernel_tf32x3<D> (float32), an mma.sync design on the TF32
//   tensor cores with 3xTF32 products (mma_tf32.cuh): each operand splits
//   into a tf32 high and low part and each product is lo hi + hi lo + hi
//   hi with float32 accumulation. One TF32 product keeps 11 bits of each
//   operand and misses the float32 limit of 1e-4; three meet it. All four
//   products (S^T, dV, dP^T, dK) are mma.m16n8k8 taken three times, so the
//   kernel is bound by the tensor cores and by the ALU work of the splits.
//   4 warps of 16 key rows; K and V staged once, Q, dO, LSE and delta tiles
//   of 64 query rows through a 2-stage cp.async ring, all float32 with rows
//   padded to D + 4 words (no bank conflicts for ldmatrix or for 32-bit
//   reads). K's and V's A fragments and Q's and dO's B fragments for S^T
//   and dP^T come by b16 ldmatrix (a float32 row of 16 bytes is four
//   words, the tf32 fragment layout) and are split as they are used. For
//   dV and dK, dO and Q are the k-by-n operand, which b16 ldmatrix cannot
//   transpose for words: they come by 32-bit shared loads. P^T and dS^T
//   stay float32 (the input dtype) and go from one product's C fragment to
//   the next one's A fragment in registers, with the queries of each
//   8-query step taken in the order 0, 2, 4, 6, 1, 3, 5, 7 and dO's and Q's
//   rows read in that order. At d = 128 the dK and dV accumulators of all
//   128 columns would take 128 registers a thread, and ptxas spills 48 to
//   56 bytes whether the score tiles are computed 32 or 16 query columns
//   at a time: so there a block sums one 64-column half of dK and dV (a
//   grid dimension of two), at the price of computing S^T and dP^T twice;
//   score tiles 32 query columns at a time (64 below). K's and V's
//   fragments are read from shared memory per k step rather than held.
//   Shared memory: 203.8 KB at
//   d = 128 (one block an SM; the full 2-stage ring of 64-row tiles fits),
//   105.5 KB at d = 64.
//
// dq_kernel_tf32x3<D> (float32), the mma.sync design of dkv_kernel_tf32x3
//   turned around: 4 warps of 16 query rows, one block per (bh, 64-row q
//   tile); Q and dO staged once and read from shared memory per k step,
//   K and V tiles of 64 key rows through the 2-stage cp.async ring (rows
//   past T zero-filled), each lane's LSE and delta rows in registers;
//   S = Q K^T and dP = dO V^T with K's and V's B fragments by ldmatrix, dS
//   from dP's C fragment into dS K's A fragment in registers, K's rows for
//   dS K by 32-bit loads; every product 3xTF32. Masking and early stop as
//   in dq_kernel_wgmma; 32 key columns a pass at d = 128 (the accumulator
//   takes 64 registers a thread there); 202.8 KB of shared memory at
//   d = 128, 104.4 KB at d = 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "sm90_bf16.cuh"

namespace {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // key rows per tile
constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;

// Q, dO, LSE and delta of q tile q0 into one stage of the ring (Q and dO
// in bfloat16 or float32)
template <int D, typename T>
__device__ __forceinline__ void load_q_stage(T* sQ, T* sdO, float* sL,
                                             float* sD, const T* q,
                                             const T* dout, const float* lse,
                                             const float* delta, int q0,
                                             int t) {
  using namespace mma_bf16;
  static_assert(MMA_THREADS == 2 * BQ, "one thread per LSE or delta entry");
  load_rows_async<BQ, D, MMA_THREADS>(sQ, q, q0, t);
  load_rows_async<BQ, D, MMA_THREADS>(sdO, dout, q0, t);
  const int r = threadIdx.x & (BQ - 1);
  const bool ok = q0 + r < t;
  const float* src = threadIdx.x < BQ ? lse : delta;
  cp_async_4((threadIdx.x < BQ ? sL : sD) + r, src + (ok ? q0 + r : 0), ok);
}

// --------------------------------------------------------------- bfloat16

constexpr int WG_THREADS = 128;  // one warpgroup
// two consumer warpgroups and a producer warpgroup (its first warp issues
// the loads): 168 registers a thread at launch, then the producer gives
// all but PRODUCER_REGS of its share to the consumers (setmaxnreg)
constexpr int WGMMA_THREADS = 3 * WG_THREADS;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(WG_THREADS * (PRODUCER_REGS + 2 * CONSUMER_REGS) <=
                  WGMMA_THREADS * 168,
              "the consumers take only what the producer gives up");
constexpr int WBK = 128;  // key rows per dk/dv block (64 per consumer)

// columns of dK and dV one block sums: all of them up to d = 64; at
// d = 128 one 64-column box, a grid dimension of two (the head comment)
__host__ __device__ constexpr int dkv_columns(int d) { return d > 64 ? 64 : d; }

// K and V tiles ([WBK][D] bf16 as swizzled boxes, sm90_bf16.cuh), the dK
// and dV staging tiles ([WBK][dkv_columns(D)], one box each), then
// STAGES stages of Q and dO ([BQ][D]) and of LSE and delta (BQ floats
// each), then the mbarriers: K/V full and empty, and per stage full and
// empty; 1024 bytes of slack to align the base
template <int D, int STAGES>
constexpr size_t dkv_wgmma_smem_bytes() {
  return 1024 +
         static_cast<size_t>(2 * WBK * D + 2 * WBK * dkv_columns(D) +
                             2 * STAGES * BQ * D) *
             2 +
         STAGES * 2 * BQ * sizeof(float) + 8 * (2 + 2 * STAGES);
}

// S^T = K Q^T and dP^T = V dO^T of QC query columns: the warpgroup's 64
// key rows (of the K and V tiles at shared addresses k_rows, v_rows) x
// the QC query rows of the Q and dO tiles at q_tile, do_tile (at a row
// of a [BQ][D] tile whose 8-row groups stay whole), all operands
// K-major; two groups. The descriptors are put together here (desc_at):
// held through the main loop, they spilled.
template <int D, int QC>
__device__ __forceinline__ void dkv_issue_sdp(float (&s)[QC / 8][4],
                                              float (&dp)[QC / 8][4],
                                              uint32_t k_rows, uint32_t v_rows,
                                              uint32_t q_tile,
                                              uint32_t do_tile) {
  using namespace sm90;
  const uint64_t kd = kmajor_desc<D>(k_rows, 0);
  const uint64_t vd = kmajor_desc<D>(v_rows, 0);
  const uint64_t qd = kmajor_desc<D>(q_tile, 0);
  const uint64_t dod = kmajor_desc<D>(do_tile, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<QC>(s, desc_at(kstep<D>(kd, WBK, kk)),
                 desc_at(kstep<D>(qd, BQ, kk)), kk > 0);
  wgmma_commit();
  // a fence of its own: S^T's accumulators are written (P^T) while dP^T
  // is still in flight
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<QC>(dp, desc_at(kstep<D>(vd, WBK, kk)),
                 desc_at(kstep<D>(dod, BQ, kk)), kk > 0);
  wgmma_commit();
}

// key tile `i` of a persistent block's walk: z, the box of dK and dV
// columns summed (at d = 128 two tiles share a key tile), and by
// sm90::tile_order within each chunk of heads the tiles nearest the top of
// every head first (in causal mode they see the most queries). Returns
// k0; sets bh and z.
__device__ __forceinline__ int dkv_tile(int i, int heads, int chunk, int nk,
                                        int nz, int& bh, int& z) {
  int kt;
  z = i % nz;
  sm90::tile_order(i / nz, heads, nk, chunk, bh, kt);
  return kt * WBK;
}

template <int D, int STAGES>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
    dkv_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap dk_map,
                     const __grid_constant__ CUtensorMap dv_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int heads,
                     int chunk, int t, float sm_scale, int causal) {
  using namespace mma_bf16;
  using namespace sm90;
  using G = Tile<D>;
  constexpr int DN = dkv_columns(D);  // columns of dK and dV summed here
  constexpr int NZ = D / DN;          // key tiles a (head, k0) splits into
  constexpr int KTILE = WBK * D * 2;  // bytes of the K or V tile
  constexpr int OTILE = WBK * DN * 2; // bytes of the dK or dV staging tile
  constexpr int QTILE = BQ * D * 2;   // bytes of one Q or dO stage
  // query columns of the score tile per pass: a pass's S^T, dP^T, P^T and
  // dS^T take half the registers of a whole tile's, which keeps the
  // consumers free of spills
  constexpr int QC = 32;
  constexpr int NQ = QC / 8;          // column blocks of a score pass
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* sK = wg_smem + (1024 - smem_u32(wg_smem) % 1024) % 1024;
  float* sL = reinterpret_cast<float*>(sK + 2 * KTILE + 2 * OTILE +
                                       2 * STAGES * QTILE);
  float* sD = sL + STAGES * BQ;
  const uint32_t k_tile = smem_u32(sK), v_tile = k_tile + KTILE;
  const uint32_t dk_tile = v_tile + KTILE, dv_tile = dk_tile + OTILE;
  const uint32_t q_tiles = dv_tile + OTILE;
  const uint32_t do_tiles = q_tiles + STAGES * QTILE;
  const uint32_t l_rows = smem_u32(sL), d_rows = smem_u32(sD);
  const uint32_t kv_full = d_rows + STAGES * BQ * sizeof(float);
  const uint32_t kv_empty = kv_full + 8, full = kv_empty + 8;
  const uint32_t empty = full + 8 * STAGES;
  const int ntiles = (t + BQ - 1) / BQ;  // query tiles
  const int nk = (t + WBK - 1) / WBK;
  const int total = nk * heads * NZ;     // key tiles of the launch

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2 * WG_THREADS);
    for (int st = 0; st < STAGES; ++st) {
      // the TMA thread's arrival, and the cp.async warp's 32
      mbar_init(full + 8 * st, 1 + 32);
      mbar_init(empty + 8 * st, 2 * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // A persistent block walks key tiles blockIdx.x, blockIdx.x +
  // gridDim.x, ...; the Q/dO ring runs on across tiles, and the next
  // tile's K and V load while this one's last dV and dK and its epilogue
  // run
  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 2) {
    // producer: the first thread of its first warp loads K and V and
    // keeps the ring of Q and dO tiles full by TMA; the 32 lanes of its
    // second warp copy each stage's LSE and delta rows by cp.async (rows of
    // a [bh, T] float32 tensor have no 16-byte alignment for TMA), zero
    // past T. Two warps, so each fits the producer's registers.
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pw = (threadIdx.x - 2 * WG_THREADS) >> 5;  // producer warp
    const int lane = threadIdx.x & 31;
    if (pw == 0 && lane == 0) {
      int c = 0;  // ring stages walked
      for (int i = blockIdx.x, n = 0; i < total; i += gridDim.x, ++n) {
        int bh, z;
        const int k0 = dkv_tile(i, heads, chunk, nk, NZ, bh, z);
        // causal: query tiles before the one holding the tile's first key
        // see none of its keys
        const int qstart = causal ? k0 / BQ : 0;
        mbar_wait(kv_empty, (n & 1) ^ 1);  // the last tile's S^T, dP^T
        mbar_expect_tx(kv_full, 2 * KTILE);
        for (int b = 0; b < G::NBOX; ++b)
          for (int h = 0; h < 2; ++h) {
            const uint32_t off = (b * WBK + h * 64) * G::ROWB;
            tma_load_3d(k_tile + off, &k_map, kv_full, b * G::ELEMS,
                        k0 + h * 64, bh);
            tma_load_3d(v_tile + off, &v_map, kv_full, b * G::ELEMS,
                        k0 + h * 64, bh);
          }
        for (int qt = qstart; qt < ntiles; ++qt, ++c) {
          const int st = c % STAGES;
          mbar_wait(empty + 8 * st, ((c / STAGES) & 1) ^ 1);
          const uint32_t bar = full + 8 * st;
          mbar_expect_tx(bar, 2 * QTILE);
          for (int b = 0; b < G::NBOX; ++b) {
            const uint32_t off = st * QTILE + b * BQ * G::ROWB;
            tma_load_3d(q_tiles + off, &q_map, bar, b * G::ELEMS, qt * BQ,
                        bh);
            tma_load_3d(do_tiles + off, &do_map, bar, b * G::ELEMS,
                        qt * BQ, bh);
          }
        }
      }
    } else if (pw == 1) {
      int c = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        int bh, z;
        const int k0 = dkv_tile(i, heads, chunk, nk, NZ, bh, z);
        const int qstart = causal ? k0 / BQ : 0;
        const float* lrow = lse + static_cast<size_t>(bh) * t;
        const float* drow = delta + static_cast<size_t>(bh) * t;
        for (int qt = qstart; qt < ntiles; ++qt, ++c) {
          const int st = c % STAGES;
          mbar_wait(empty + 8 * st, ((c / STAGES) & 1) ^ 1);
#pragma unroll
          for (int j = 0; j < BQ / 32; ++j) {
            const int r = j * 32 + lane, q = qt * BQ + r;
            cp_async_4(sL + st * BQ + r, lrow + (q < t ? q : 0), q < t);
            cp_async_4(sD + st * BQ + r, drow + (q < t ? q : 0), q < t);
          }
          mbar_arrive_cp_async(full + 8 * st);
        }
      }
    }
  } else {
    // consumer warpgroup wg: key rows 64 wg .. 64 wg + 63 of each tile
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c = lane & 3;
    const float scale = sm_scale * LOG2E;  // exponents in log2 units
    // the warpgroup's rows of the K and V tiles
    const uint32_t k_rows = k_tile + wg * 64 * G::ROWB;
    const uint32_t v_rows = v_tile + wg * 64 * G::ROWB;

    float acc_k[DN / 8][4], acc_v[DN / 8][4];
    float s[NQ][4], dp[NQ][4];
    uint32_t pa[QC / 16][4], da[QC / 16][4];  // bf16 P^T and dS^T
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;

    int rs = 0;  // ring stages walked
    for (int i = blockIdx.x, n = 0; i < total; i += gridDim.x, ++n) {
      int bh, z;
      const int k0 = dkv_tile(i, heads, chunk, nk, NZ, bh, z);
      const int qstart = causal ? k0 / BQ : 0;
      const int kw0 = k0 + wg * 64;      // the warpgroup's first key row
      const int row0 = kw0 + warp * 16;  // the warp's first key row
#pragma unroll
      for (int nn = 0; nn < DN / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[nn][e] = acc_v[nn][e] = 0.f;
      mbar_wait(kv_full, n & 1);

      for (int qt = qstart; qt < ntiles; ++qt, ++rs) {
        const int st = rs % STAGES;
        const int q0 = qt * BQ;
        const uint32_t tq = q_tiles + st * QTILE;
        const uint32_t tdo = do_tiles + st * QTILE;
        const uint32_t tL = l_rows + st * BQ * sizeof(float);
        const uint32_t tD = d_rows + st * BQ * sizeof(float);
        const bool edge = q0 + BQ > t || (causal && q0 < kw0 + 63);
        mbar_wait(full + 8 * st, (rs / STAGES) & 1);
        // the tile in passes of QC query columns
#pragma unroll 1
        for (int j0 = 0; j0 < BQ; j0 += QC) {
          dkv_issue_sdp<D, QC>(s, dp, k_rows, v_rows, tq + j0 * G::ROWB,
                               tdo + j0 * G::ROWB);
          wgmma_wait<1>();  // S^T has landed
          fence_regs(s);

          // P^T = exp(sm_scale S^T - LSE[q]) in float32, LSE per column in
          // registers; masked entries (only in the ragged last tile and the
          // diagonal tiles) get a score of NEG_INF, so P^T = 0
          if (edge) {
#pragma unroll
            for (int nn = 0; nn < NQ; ++nn)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qr = q0 + j0 + nn * 8 + 2 * c + (e & 1);
                const int kr = row0 + g + (e >> 1) * 8;
                if (qr >= t || (causal && qr < kr)) s[nn][e] = NEG_INF;
              }
          }
#pragma unroll
          for (int nn = 0; nn < NQ; ++nn) {
            const float2 lq = lds_f2(tL + (j0 + nn * 8 + 2 * c) * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[nn][e] = exp2_approx(
                  fmaf(s[nn][e], scale, -((e & 1) ? lq.y : lq.x) * LOG2E));
          }

          // dV += bf16(P^T) dO: P^T's A operand from the accumulators, dO's
          // columns of this tile MN-major
#pragma unroll
          for (int kk = 0; kk < QC / 16; ++kk) c_to_a<NQ>(pa[kk], s, kk);
          const uint64_t dov = mnmajor_desc<D>(tdo + z * BQ * G::ROWB, BQ);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < QC / 16; ++kk)
            wgmma_rs<DN>(acc_v, pa[kk],
                         desc_at(kstep_mn<D>(dov, j0 + kk * 16)), 1);
          wgmma_commit();
          wgmma_wait<1>();  // dP^T has landed
          fence_regs(dp);
          // the tile's K and V are done with after its last S^T and dP^T
          if (qt == ntiles - 1 && j0 + QC == BQ) mbar_arrive(kv_empty);

          // dS^T = P^T (dP^T - delta[q]) sm_scale from the unrounded P^T,
          // delta per column in registers
#pragma unroll
          for (int nn = 0; nn < NQ; ++nn) {
            const float2 dq2 = lds_f2(tD + (j0 + nn * 8 + 2 * c) * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float dcol = (e & 1) ? dq2.y : dq2.x;
              dp[nn][e] = s[nn][e] * (dp[nn][e] - dcol) * sm_scale;
            }
          }

          // dK += bf16(dS^T) Q, Q's columns of this tile MN-major
#pragma unroll
          for (int kk = 0; kk < QC / 16; ++kk) c_to_a<NQ>(da[kk], dp, kk);
          const uint64_t qv = mnmajor_desc<D>(tq + z * BQ * G::ROWB, BQ);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < QC / 16; ++kk)
            wgmma_rs<DN>(acc_k, da[kk],
                         desc_at(kstep_mn<D>(qv, j0 + kk * 16)), 1);
          wgmma_commit();
          // dV and dK of the pass done: their register A operands may be
          // rewritten from here on (the accumulators are next touched by the
          // next wgmmas, in order)
          wgmma_wait<0>();
          fence_regs(pa);
          fence_regs(da);
        }
        mbar_arrive(empty + 8 * st);  // the stage may be refilled
      }
      fence_regs(acc_v);
      fence_regs(acc_k);

      // dK, dV to bf16 into the warpgroup's rows of the staging tiles
      // (once the last tile's stores have read them), then one TMA store
      // each (rows past T are not written)
      if (tid == 0) tma_store_wait_read();
      named_barrier(1 + wg, WG_THREADS);
      stage_rows<D, DN>(dk_tile, WBK, wg * 64 + warp * 16, 0, acc_k, 1.f,
                        1.f);
      stage_rows<D, DN>(dv_tile, WBK, wg * 64 + warp * 16, 0, acc_v, 1.f,
                        1.f);
      fence_async_smem();
      named_barrier(1 + wg, WG_THREADS);
      if (tid == 0) {
        const uint32_t off = wg * 64 * G::ROWB;
        tma_store_3d(&dk_map, dk_tile + off, z * DN, kw0, bh);
        tma_store_3d(&dv_map, dv_tile + off, z * DN, kw0, bh);
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait_read();
  }
}

constexpr int WBQ = 128;  // query rows per dq tile (64 per consumer)
// key rows per k/v tile of the dq kernel: 64, or 32 at d = 128 (the
// registers of the wgmma operands in flight; the head comment)
__host__ __device__ constexpr int dq_key_rows(int d) {
  return d > 64 ? 32 : 64;
}

// Two Q and two dO tiles and the dQ staging tile ([WBQ][D]), then STAGES
// K tiles and STAGES V tiles ([dq_key_rows(D)][D]), all bf16 as swizzled
// boxes (sm90_bf16.cuh), then the mbarriers: per Q/dO buffer full and
// empty, per stage full and empty; 1024 bytes of slack to align the base
template <int D, int STAGES>
constexpr size_t dq_wgmma_smem_bytes() {
  return 1024 +
         static_cast<size_t>(5 * WBQ + 2 * STAGES * dq_key_rows(D)) * D * 2 +
         8 * (4 + 2 * STAGES);
}

// The p-th query tile of block b's walk over a grid of g blocks: tiles b
// and 2 g - 1 - b of every 2 g, so a block that takes one of the first,
// heaviest tiles of a chunk (dq_tile) takes one of its lightest next;
// positions past the launch's tiles come only at the end of a walk
__device__ __forceinline__ int dq_walk(int p, int b, int g) {
  return (p >> 1) * 2 * g + ((p & 1) ? 2 * g - 1 - b : b);
}

// query tile `i` of a persistent block's walk (sm90::tile_order): within
// each chunk of heads the heaviest first (the bottom tile of every head,
// then the one above it, ...; in causal mode the bottom tile sees the
// most key tiles). Returns q0; sets bh and the number of key tiles of KR
// rows.
template <int KR>
__device__ __forceinline__ int dq_tile(int i, int heads, int chunk, int nq,
                                       int t, int causal, int& bh,
                                       int& ntiles) {
  int j;
  sm90::tile_order(i, heads, nq, chunk, bh, j);
  const int q0 = (nq - 1 - j) * WBQ;
  // causal: keys past the tile's last query row contribute nothing
  const int kend = causal ? min(t, q0 + WBQ) : t;
  ntiles = (kend + KR - 1) / KR;
  return q0;
}

// LSE in log2 units and delta of this lane's rows of an accumulator whose
// warp starts at query row row0: rows row0 + g (h = 0) and row0 + g + 8 of
// the head whose rows start at rbase; 0 past T
__device__ __forceinline__ void dq_rows(float (&lse2)[2], float (&dl)[2],
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        size_t rbase, int row0, int t) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = row0 + g + 8 * h;
    lse2[h] = qr < t ? lse[rbase + qr] * LOG2E : 0.f;
    dl[h] = qr < t ? delta[rbase + qr] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T of one key tile: the warpgroup's 64 rows of
// the Q and dO tiles (q_rows, do_rows: a row of a [WBQ][D] tile) x the KR
// keys of the K and V tiles, all K-major; two groups. The descriptors are
// put together here (desc_at), as in dkv_issue_sdp.
template <int D, int KR>
__device__ __forceinline__ void dq_issue_sdp(float (&s)[KR / 8][4],
                                             float (&dp)[KR / 8][4],
                                             uint32_t q_rows,
                                             uint32_t do_rows,
                                             uint32_t k_tile,
                                             uint32_t v_tile) {
  using namespace sm90;
  const uint64_t qd = kmajor_desc<D>(q_rows, 0);
  const uint64_t dod = kmajor_desc<D>(do_rows, 0);
  const uint64_t kd = kmajor_desc<D>(k_tile, 0);
  const uint64_t vd = kmajor_desc<D>(v_tile, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<KR>(s, desc_at(kstep<D>(qd, WBQ, kk)),
                 desc_at(kstep<D>(kd, KR, kk)), kk > 0);
  wgmma_commit();
  // a fence of its own: S's accumulators are written (P) while dP is
  // still in flight
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<KR>(dp, desc_at(kstep<D>(dod, WBQ, kk)),
                 desc_at(kstep<D>(vd, KR, kk)), kk > 0);
  wgmma_commit();
}

// dQ += bf16(dS) K: dS's A operands from registers, the K tile at k_tile
// as the MN-major B operand (k = key, n = d)
template <int D, int KR>
__device__ __forceinline__ void dq_issue_dsk(float (&acc)[D / 8][4],
                                             const uint32_t (&da)[KR / 16][4],
                                             uint32_t k_tile) {
  using namespace sm90;
  const uint64_t kd = mnmajor_desc<D>(k_tile, KR);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KR / 16; ++kk)
    wgmma_rs<D>(acc, da[kk], desc_at(kstep_mn<D>(kd, kk * 16)), 1);
  wgmma_commit();
}

// P = exp(sm_scale S - LSE) of key tile k0 .. k0 + KR - 1 on S's
// accumulators, for this lane's rows row0 + g and row0 + g + 8: one FFMA
// and one ex2 a score. Only the ragged last tile and the diagonal tile
// (qw0: the warpgroup's first row) are masked, to a score of NEG_INF
template <int KR>
__device__ __forceinline__ void dq_p(float (&s)[KR / 8][4],
                                     const float (&lse2)[2], int k0, int t,
                                     int causal, int qw0, int row0,
                                     float scale) {
  using namespace mma_bf16;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  if (k0 + KR > t || (causal && k0 + KR - 1 > qw0)) {
#pragma unroll
    for (int n = 0; n < KR / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = k0 + n * 8 + 2 * c + (i & 1);
        const int qr = row0 + g + (i >> 1) * 8;
        if (kc >= t || (causal && kc > qr)) s[n][i] = NEG_INF;
      }
  }
#pragma unroll
  for (int n = 0; n < KR / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[n][i] = exp2_approx(fmaf(s[n][i], scale, -lse2[i >> 1]));
}

// dS = P (dP - delta) sm_scale from the unrounded float32 P, on dP's
// accumulators
template <int KR>
__device__ __forceinline__ void dq_ds(float (&dp)[KR / 8][4],
                                      const float (&s)[KR / 8][4],
                                      const float (&dl)[2], float sm_scale) {
#pragma unroll
  for (int n = 0; n < KR / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dp[n][i] = s[n][i] * (dp[n][i] - dl[i >> 1]) * sm_scale;
}

template <int D, int STAGES>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
    dq_kernel_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap dq_map,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int heads, int chunk,
                    int nq, int t, float sm_scale, int causal) {
  using namespace mma_bf16;
  using namespace sm90;
  using G = Tile<D>;
  constexpr int KR = dq_key_rows(D);
  constexpr int TILE = WBQ * D * 2;  // bytes of a Q or dO tile
  constexpr int KTILE = KR * D * 2;  // bytes of one K or V tile
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* sQ = wg_smem + (1024 - smem_u32(wg_smem) % 1024) % 1024;
  const uint32_t q_tiles = smem_u32(sQ), do_tiles = q_tiles + 2 * TILE;
  const uint32_t dq_stage = do_tiles + 2 * TILE;
  const uint32_t k_tiles = dq_stage + TILE;
  const uint32_t v_tiles = k_tiles + STAGES * KTILE;
  const uint32_t q_full = v_tiles + STAGES * KTILE, q_empty = q_full + 16;
  const uint32_t full = q_empty + 16, empty = full + 8 * STAGES;
  const int total = nq * heads;  // query tiles of the whole launch

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + 8 * b, 1);
      mbar_init(q_empty + 8 * b, 2 * WG_THREADS);
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // A persistent block walks query tiles dq_walk(0, blockIdx.x,
  // gridDim.x), dq_walk(1, ...), ...; its k/v ring runs on across tiles,
  // so the next tile's Q, dO, K and V load while this one is computed and
  // its dQ is stored
  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 2) {
    // producer: one thread keeps the TMA ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG_THREADS) {
      int n = 0, c = 0;  // tiles and k/v stages walked
      for (int i = blockIdx.x; i < total;
           i = dq_walk(++n, blockIdx.x, gridDim.x)) {
        int bh, ntiles;
        const int q0 =
            dq_tile<KR>(i, heads, chunk, nq, t, causal, bh, ntiles);
        // Q and dO into buffer n % 2, once tile n - 2's last S and dP are
        // done with it
        const uint32_t qf = q_full + 8 * (n & 1);
        const uint32_t buf = (n & 1) * TILE;
        mbar_wait(q_empty + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(qf, 2 * TILE);
        for (int b = 0; b < G::NBOX; ++b)
          for (int h = 0; h < 2; ++h) {
            const uint32_t off = buf + (b * WBQ + h * 64) * G::ROWB;
            tma_load_3d(q_tiles + off, &q_map, qf, b * G::ELEMS,
                        q0 + h * 64, bh);
            tma_load_3d(do_tiles + off, &do_map, qf, b * G::ELEMS,
                        q0 + h * 64, bh);
          }
        for (int kt = 0; kt < ntiles; ++kt, ++c) {
          const int st = c % STAGES;
          const uint32_t bar = full + 8 * st;
          mbar_wait(empty + 8 * st, ((c / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar, 2 * KTILE);
          for (int b = 0; b < G::NBOX; ++b) {
            const uint32_t off = st * KTILE + b * KR * G::ROWB;
            tma_load_3d(k_tiles + off, &k_map, bar, b * G::ELEMS, kt * KR,
                        bh);
            tma_load_3d(v_tiles + off, &v_map, bar, b * G::ELEMS, kt * KR,
                        bh);
          }
        }
      }
    }
  } else {
    // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each query tile
    setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5;
    const float scale = sm_scale * LOG2E;  // exponents in log2 units
    const uint32_t rows = wg * 64 * G::ROWB;  // the warpgroup's first row

    float acc[D / 8][4];                // dQ
    float s[KR / 8][4], dp[KR / 8][4];  // a key tile's S, then P; dP, dS
    uint32_t da[KR / 16][4];            // dS in bf16 as dS K's A operand
#pragma unroll
    for (int n = 0; n < KR / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;

    // tn, ks: query tiles and k/v stages walked; st: the stage of the key
    // tile in hand
    int tn = 0, ks = 0, st = 0;
    int i = blockIdx.x, bh, ntiles;
    int q0 = dq_tile<KR>(i, heads, chunk, nq, t, causal, bh, ntiles);
    // this lane's rows: LSE in log2 units and delta
    float lse2[2], dl[2];
    dq_rows(lse2, dl, lse, delta, static_cast<size_t>(bh) * t,
            q0 + wg * 64 + warp * 16, t);
    // the first tile's first S and dP (each later tile's are issued
    // before the epilogue of the tile before it)
    mbar_wait(q_full, 0);
    mbar_wait(full, 0);
    ++ks;
    dq_issue_sdp<D, KR>(s, dp, q_tiles + rows, do_tiles + rows, k_tiles,
                        v_tiles);
    while (true) {
      const int qw0 = q0 + wg * 64;      // the warpgroup's first row
      const int row0 = qw0 + warp * 16;  // the warp's first row
      const uint32_t buf = (tn & 1) * TILE;
      const uint32_t q_release = q_empty + 8 * (tn & 1);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

      // key tile 0: P and dS
      wgmma_wait<1>();  // S
      fence_regs(s);
      dq_p<KR>(s, lse2, 0, t, causal, qw0, row0, scale);
      wgmma_wait<0>();  // dP
      fence_regs(dp);
      if (ntiles == 1) mbar_arrive(q_release);  // the tile's last S, dP
      dq_ds<KR>(dp, s, dl, sm_scale);
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk) c_to_a<KR / 8>(da[kk], dp, kk);

      // Pipelined over key tiles: S and dP of tile kt are issued before
      // dS K of tile kt - 1, so P and dS of tile kt are computed while
      // the tensor cores add dS K
      for (int kt = 1; kt < ntiles; ++kt) {
        const int prev = st;
        st = ks % STAGES;
        mbar_wait(full + 8 * st, (ks / STAGES) & 1);
        ++ks;
        dq_issue_sdp<D, KR>(s, dp, q_tiles + buf + rows,
                            do_tiles + buf + rows, k_tiles + st * KTILE,
                            v_tiles + st * KTILE);
        dq_issue_dsk<D, KR>(acc, da, k_tiles + prev * KTILE);
        wgmma_wait<2>();  // S of tile kt
        fence_regs(s);
        dq_p<KR>(s, lse2, kt * KR, t, causal, qw0, row0, scale);
        wgmma_wait<1>();  // dP of tile kt
        fence_regs(dp);
        if (kt == ntiles - 1) mbar_arrive(q_release);
        dq_ds<KR>(dp, s, dl, sm_scale);
        wgmma_wait<0>();  // dS K of tile kt - 1
        fence_regs(acc);
        fence_regs(da);
        mbar_arrive(empty + 8 * prev);  // stage prev may be refilled
#pragma unroll
        for (int kk = 0; kk < KR / 16; ++kk) c_to_a<KR / 8>(da[kk], dp, kk);
      }

      // this tile's last dS K, then the next tile's first S and dP ahead
      // of this tile's epilogue. After the last tile an S and dP of the
      // other Q and dO buffers and the last K and V are issued all the
      // same and dropped: a wgmma issued on a branch makes ptxas serialize
      // every wgmma of the kernel
      const int next = dq_walk(tn + 1, blockIdx.x, gridDim.x);
      const bool more = next < total;
      const int last = st;
      int nbh = 0, nntiles = 0, nq0 = 0;
      float nlse2[2] = {0.f, 0.f}, ndl[2] = {0.f, 0.f};
      if (more) {
        nq0 = dq_tile<KR>(next, heads, chunk, nq, t, causal, nbh, nntiles);
        dq_rows(nlse2, ndl, lse, delta, static_cast<size_t>(nbh) * t,
                nq0 + wg * 64 + warp * 16, t);
        mbar_wait(q_full + 8 * ((tn + 1) & 1), ((tn + 1) >> 1) & 1);
        st = ks % STAGES;
        mbar_wait(full + 8 * st, (ks / STAGES) & 1);
        ++ks;
      }
      dq_issue_dsk<D, KR>(acc, da, k_tiles + last * KTILE);
      const uint32_t nbuf = ((tn + 1) & 1) * TILE;
      dq_issue_sdp<D, KR>(s, dp, q_tiles + nbuf + rows,
                          do_tiles + nbuf + rows, k_tiles + st * KTILE,
                          v_tiles + st * KTILE);
      wgmma_wait<2>();  // this tile's last dS K
      fence_regs(acc);
      fence_regs(da);
      mbar_arrive(empty + 8 * last);

      // dQ to bf16 into the warpgroup's rows of the staging tile (once the
      // last tile's store, a tile ago, has read them), then one TMA store
      // a box (rows past T are not written)
      if (tid == 0) tma_store_wait_read();
      named_barrier(1 + wg, WG_THREADS);
      stage_rows<D, D>(dq_stage, WBQ, wg * 64 + warp * 16, 0, acc, 1.f, 1.f);
      fence_async_smem();
      named_barrier(1 + wg, WG_THREADS);
      if (tid == 0) {
        for (int b = 0; b < G::NBOX; ++b)
          tma_store_3d(&dq_map, dq_stage + b * WBQ * G::ROWB + rows,
                       b * G::ELEMS, qw0, bh);
        tma_store_commit();
      }
      if (!more) break;
      i = next;
      ++tn;
      q0 = nq0;
      bh = nbh;
      ntiles = nntiles;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lse2[h] = nlse2[h];
        dl[h] = ndl[h];
      }
    }
    wgmma_wait<0>();  // the dropped S and dP
    if (tid == 0) tma_store_wait_read();
  }
}

// ---------------------------------------------------------------- float32

// Columns of dK and dV one dkv_kernel_tf32x3 block sums: all of them up
// to d = 64; at d = 128 one half, each half by a block of its own
__host__ __device__ constexpr int dkv_tf32_columns(int d) {
  return d > 64 ? 64 : d;
}

template <int D>
constexpr size_t dkv_tf32_smem_bytes() {
  // K and V once, then two stages of Q and dO ([64][D + 4] float32 each)
  // and of LSE and delta (64 floats each)
  return sizeof(float) * (6 * BK * (D + 4) + 4 * BQ);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    dkv_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int t, float sm_scale,
                      int causal) {
  using namespace mma_bf16;
  using namespace mma_tf32;
  constexpr int LD = D + 4;      // padded row stride (floats)
  constexpr int TILE = BQ * LD;  // floats of one staged tile
  constexpr int KD = D / 8;      // k steps over d
  // columns of dK and dV this block sums, from c0 (the head comment)
  constexpr int DH = dkv_tf32_columns(D);
  constexpr int ND = DH / 8;     // n-blocks of those columns
  // query columns of the score tile per compute pass
  constexpr int QC = D > 64 ? 32 : 64;
  constexpr int NQ = QC / 8;     // n-blocks of a score pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + TILE;
  float* sQ = sV + TILE;       // [2][BQ][LD]
  float* sdO = sQ + 2 * TILE;  // [2][BQ][LD]
  float* sL = sdO + 2 * TILE;  // [2][BQ]
  float* sD = sL + 2 * BQ;     // [2][BQ]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int c0 = D > DH ? blockIdx.z * DH : 0;
  const int row0 = k0 + warp * 16;  // the warp's first key row
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t rbase = static_cast<size_t>(bh) * t;
  const float* qb = q + base;
  const float* ob = dout + base;

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
    const float* tQ = sQ + st * TILE;
    const float* tdO = sdO + st * TILE;
    const float* tL = sL + st * BQ;
    const float* tD = sD + st * BQ;
    // mask only the ragged last tile and the diagonal tile
    const bool edge = q0 + BQ > t || (causal && q0 < k0 + BK - 1);

#pragma unroll
    for (int j0 = 0; j0 < BQ; j0 += QC) {
      // S^T = K Q^T: the warp's 16 key rows x QC query columns; K's
      // fragments are read from shared memory per k step
      float p[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4], kh[4], kl[4];
        ldmatrix_x4(a, a_addr(sK, LD, warp * 16, kk * 8, lane));
        split4(a, kh, kl);
#pragma unroll
        for (int n2 = 0; n2 < NQ / 2; ++n2) {
          uint32_t b[4], qh[4], ql[4];
          ldmatrix_x4(b, bn_addr(tQ, LD, j0 + n2 * 16, kk * 8, lane));
          split4(b, qh, ql);
          mma_1688_x3(p[2 * n2], p[2 * n2 + 1], kh, kl, qh, ql);
        }
      }

      // P^T = exp(sm_scale S^T - LSE[q]); masked entries 0
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = j0 + n * 8 + 2 * c + (i & 1);
          float e = exp2f(fmaf(p[n][i], scale, -tL[qc] * LOG2E));
          if (edge) {
            const int query = q0 + qc;
            const int key = row0 + g + (i >> 1) * 8;
            if (query >= t || (causal && query < key)) e = 0.f;
          }
          p[n][i] = e;
        }

      // dV += P^T dO, one 8-query step per n-block j of P^T
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        uint32_t ph[4], pl[4];
        c_to_a_tf32(p[j], ph, pl);
        const float* rows = tdO + (j0 + j * 8 + 2 * c) * LD + c0 + g;
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t oh[4], ol[4];
          b_from_rows<LD>(rows, n2 * 16, oh, ol);
          mma_1688_x3(acc_v[2 * n2], acc_v[2 * n2 + 1], ph, pl, oh, ol);
        }
      }

      // dP^T = V dO^T
      float ds[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4], vh[4], vl[4];
        ldmatrix_x4(a, a_addr(sV, LD, warp * 16, kk * 8, lane));
        split4(a, vh, vl);
#pragma unroll
        for (int n2 = 0; n2 < NQ / 2; ++n2) {
          uint32_t b[4], oh[4], ol[4];
          ldmatrix_x4(b, bn_addr(tdO, LD, j0 + n2 * 16, kk * 8, lane));
          split4(b, oh, ol);
          mma_1688_x3(ds[2 * n2], ds[2 * n2 + 1], vh, vl, oh, ol);
        }
      }

      // dS^T = P^T (dP^T - delta[q]) sm_scale
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[n][i] = p[n][i] *
                     (ds[n][i] - tD[j0 + n * 8 + 2 * c + (i & 1)]) * sm_scale;

      // dK += dS^T Q
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        uint32_t sh[4], sl[4];
        c_to_a_tf32(ds[j], sh, sl);
        const float* rows = tQ + (j0 + j * 8 + 2 * c) * LD + c0 + g;
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t qh[4], ql[4];
          b_from_rows<LD>(rows, n2 * 16, qh, ql);
          mma_1688_x3(acc_k[2 * n2], acc_k[2 * n2 + 1], sh, sl, qh, ql);
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // dK, dV staged in the warp's own rows of sK and sV (only this warp
  // read them), then stored as 16-byte rows
  float* wK = sK + warp * 16 * LD;
  float* wV = sV + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * c;
    *reinterpret_cast<float2*>(wK + g * LD + col) =
        make_float2(acc_k[n][0], acc_k[n][1]);
    *reinterpret_cast<float2*>(wK + (g + 8) * LD + col) =
        make_float2(acc_k[n][2], acc_k[n][3]);
    *reinterpret_cast<float2*>(wV + g * LD + col) =
        make_float2(acc_v[n][0], acc_v[n][1]);
    *reinterpret_cast<float2*>(wV + (g + 8) * LD + col) =
        make_float2(acc_v[n][2], acc_v[n][3]);
  }
  __syncwarp();
  constexpr int CHUNKS = DH / 4;
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = i / CHUNKS, col = (i % CHUNKS) * 4;
    if (row0 + r >= t) continue;
    const size_t off = base + static_cast<size_t>(row0 + r) * D + c0 + col;
    *reinterpret_cast<float4*>(dk + off) =
        *reinterpret_cast<const float4*>(wK + r * LD + col);
    *reinterpret_cast<float4*>(dv + off) =
        *reinterpret_cast<const float4*>(wV + r * LD + col);
  }
}

template <int D>
constexpr size_t dq_tf32_smem_bytes() {
  // Q and dO once, then two stages of K and V, all [64][D + 4] float32
  return sizeof(float) * 6 * BK * (D + 4);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    dq_kernel_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int t, float sm_scale, int causal) {
  using namespace mma_bf16;
  using namespace mma_tf32;
  constexpr int LD = D + 4;      // padded row stride (floats)
  constexpr int TILE = BK * LD;  // floats of one staged tile
  constexpr int KD = D / 8;      // k steps over d
  constexpr int ND = D / 8;      // n-blocks over d
  // key columns of the score tile per compute pass (the head comment)
  constexpr int KC = D > 64 ? 32 : 64;
  constexpr int NK = KC / 8;     // n-blocks of a score pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + TILE;
  float* sK = sdO + TILE;     // [2][BK][LD]
  float* sV = sK + 2 * TILE;  // [2][BK][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row0 = q0 + warp * 16;  // the warp's first query row
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t rbase = static_cast<size_t>(bh) * t;
  const float* kb = k + base;
  const float* vb = v + base;

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
    const float* tK = sK + (kt & 1) * TILE;
    const float* tV = sV + (kt & 1) * TILE;
    // mask only the ragged last tile and the diagonal tile
    const bool edge = k0 + BK > t || (causal && k0 + BK - 1 > q0);

#pragma unroll
    for (int j0 = 0; j0 < BK; j0 += KC) {
      // S = Q K^T: the warp's 16 query rows x KC key columns; Q's
      // fragments are read from shared memory per k step
      float p[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4], qh[4], ql[4];
        ldmatrix_x4(a, a_addr(sQ, LD, warp * 16, kk * 8, lane));
        split4(a, qh, ql);
#pragma unroll
        for (int n2 = 0; n2 < NK / 2; ++n2) {
          uint32_t b[4], kh[4], kl[4];
          ldmatrix_x4(b, bn_addr(tK, LD, j0 + n2 * 16, kk * 8, lane));
          split4(b, kh, kl);
          mma_1688_x3(p[2 * n2], p[2 * n2 + 1], qh, ql, kh, kl);
        }
      }

      // P = exp(sm_scale S - LSE); masked entries 0
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float e = exp2f(fmaf(p[n][i], scale, -lse2[i >> 1]));
          if (edge) {
            const int key = k0 + j0 + n * 8 + 2 * c + (i & 1);
            const int query = row0 + g + (i >> 1) * 8;
            if (key >= t || (causal && key > query)) e = 0.f;
          }
          p[n][i] = e;
        }

      // dP = dO V^T
      float ds[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4], oh[4], ol[4];
        ldmatrix_x4(a, a_addr(sdO, LD, warp * 16, kk * 8, lane));
        split4(a, oh, ol);
#pragma unroll
        for (int n2 = 0; n2 < NK / 2; ++n2) {
          uint32_t b[4], vh[4], vl[4];
          ldmatrix_x4(b, bn_addr(tV, LD, j0 + n2 * 16, kk * 8, lane));
          split4(b, vh, vl);
          mma_1688_x3(ds[2 * n2], ds[2 * n2 + 1], oh, ol, vh, vl);
        }
      }

      // dS = P (dP - delta) sm_scale
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[n][i] = p[n][i] * (ds[n][i] - dl[i >> 1]) * sm_scale;

      // dQ += dS K, one 8-key step per n-block j of dS
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t sh[4], sl[4];
        c_to_a_tf32(ds[j], sh, sl);
        const float* rows = tK + (j0 + j * 8 + 2 * c) * LD + g;
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t kh[4], kl[4];
          b_from_rows<LD>(rows, n2 * 16, kh, kl);
          mma_1688_x3(acc[2 * n2], acc[2 * n2 + 1], sh, sl, kh, kl);
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // dQ staged in the warp's own rows of sQ (only this warp read them),
  // then stored as 16-byte rows
  float* wQ = sQ + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * c;
    *reinterpret_cast<float2*>(wQ + g * LD + col) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(wQ + (g + 8) * LD + col) =
        make_float2(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  constexpr int CHUNKS = D / 4;
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int r = i / CHUNKS, col = (i % CHUNKS) * 4;
    if (row0 + r < t)
      *reinterpret_cast<float4*>(dq + base +
                                 static_cast<size_t>(row0 + r) * D + col) =
          *reinterpret_cast<const float4*>(wQ + r * LD + col);
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
  constexpr size_t smem = dq_tf32_smem_bytes<D>();
  auto kern = dq_kernel_tf32x3<D>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), t, sm_scale, causal);
  return cudaGetLastError();
}

constexpr int DQ_STAGES = 4;  // k/v ring stages of the bf16 dq kernel

template <int D, int STAGES = DQ_STAGES>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int bh, int t,
                           float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_wgmma_smem_bytes<D, STAGES>();
  auto kern = dq_kernel_wgmma<D, STAGES>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  // boxes of 64 rows, each consumer's half of a Q, dO or dQ tile, and of
  // a key tile's rows for K and V
  CUtensorMap maps[5];
  const void* ptrs[5] = {q, k, v, dout, dq};
  for (int i = 0; i < 5; ++i) {
    const cudaError_t err = sm90::rows_map<D>(
        &maps[i], ptrs[i], bh, t, i == 1 || i == 2 ? dq_key_rows(D) : 64);
    if (err != cudaSuccess) return err;
  }
  // persistent blocks: one a streaming multiprocessor, or one a tile
  static const int sms = sm90::sm_count();
  const int nq = (t + WBQ - 1) / WBQ;
  const int tiles = nq * bh;
  kern<<<tiles < sms ? tiles : sms, WGMMA_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const float*>(lse), static_cast<const float*>(delta), bh,
      sm90::head_chunk(sms, nq), nq, t, sm_scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int t, float sm_scale, int causal,
                           cudaStream_t stream) {
  constexpr size_t smem = dkv_tf32_smem_bytes<D>();
  auto kern = dkv_kernel_tf32x3<D>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  const dim3 grid((t + BK - 1) / BK, bh, D / dkv_tf32_columns(D));
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), t, sm_scale, causal);
  return cudaGetLastError();
}

constexpr int DKV_STAGES = 2;  // Q/dO ring stages of the bf16 dK/dV kernel

template <int D, int STAGES = DKV_STAGES>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh,
                            int t, float sm_scale, int causal,
                            cudaStream_t stream) {
  constexpr size_t smem = dkv_wgmma_smem_bytes<D, STAGES>();
  auto kern = dkv_kernel_wgmma<D, STAGES>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  // boxes of 64 rows: a Q or dO stage, a consumer's half of K and V
  CUtensorMap maps[6];
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  for (int i = 0; i < 6; ++i) {
    const cudaError_t err = sm90::rows_map<D>(&maps[i], ptrs[i], bh, t, 64);
    if (err != cudaSuccess) return err;
  }
  // persistent blocks: one a streaming multiprocessor, or one a tile
  static const int sms = sm90::sm_count();
  const int nk = (t + WBK - 1) / WBK;
  const int tiles = nk * bh * (D / dkv_columns(D));
  kern<<<tiles < sms ? tiles : sms, WGMMA_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      static_cast<const float*>(lse), static_cast<const float*>(delta), bh,
      sm90::head_chunk(sms, nk), t, sm_scale, causal);
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
// float32 runs dq_kernel_tf32x3, bfloat16 dq_kernel_wgmma
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

// float32 runs dkv_kernel_tf32x3, bfloat16 dkv_kernel_wgmma
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

// Dynamic shared memory the bf16 dQ and dK/dV kernels' instances for
// head dim d take (0 where there is none); chip_smoke.py's [build] prints
// them beside ptxas's registers.
extern "C" long long flash_attention_bwd_dq_smem(int d) {
  switch (d) {
    case 32:
      return dq_wgmma_smem_bytes<32, DQ_STAGES>();
    case 64:
      return dq_wgmma_smem_bytes<64, DQ_STAGES>();
    case 128:
      return dq_wgmma_smem_bytes<128, DQ_STAGES>();
    default:
      return 0;
  }
}

extern "C" long long flash_attention_bwd_dkv_smem(int d) {
  switch (d) {
    case 32:
      return dkv_wgmma_smem_bytes<32, DKV_STAGES>();
    case 64:
      return dkv_wgmma_smem_bytes<64, DKV_STAGES>();
    case 128:
      return dkv_wgmma_smem_bytes<128, DKV_STAGES>();
    default:
      return 0;
  }
}
