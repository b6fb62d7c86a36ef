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
//   dq:  128-row q tiles (64 in float32 at d = 128); K/V tiles of 64 rows
//        (bf16; 32 at d = 128) or 32 (float32; 16 at d = 128) stream
//        through; in causal mode the loop stops at the tile holding the
//        diagonal.
//   dkv: 128-row k tiles (64 in float32 at d = 128); Q/dO tiles of 64 rows
//        (bf16) or 16 (float32) stream through; in causal mode the loop
//        starts at the tile holding the diagonal.
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
// dkv_kernel_tf32wg<D, STAGES> and dq_kernel_tf32wg<D, STAGES> (float32),
//   the two bf16 Hopper designs above carried over to the TF32 tensor
//   cores with 3xTF32 products (sm90_tf32.cuh): every operand splits into a
//   tf32 high and low part, hi = cvt.rna.tf32(x) and lo = tf32(x - hi), and
//   every product is hi hi + lo hi + hi lo with float32 accumulation, three
//   m64nNk8 TF32 wgmmas a k step. One TF32 product keeps 11 bits of each
//   operand and misses the float32 limit of 1e-4; three meet it. P^T, dS
//   and dS^T stay float32 (the input dtype): no rounding step. What TF32
//   wgmma forces on the bf16 shape:
//   - shared-memory operands must be K-major (the transpose flags are for
//     16-bit types), so dS K, P^T dO and dS^T Q read transposed copies, K^T,
//     dO^T and Q^T, with each 8-key (8-query) k step's rows in the order 0,
//     2, 4, 6, 1, 3, 5, 7: the order in which an A operand made from an
//     accumulator (c_to_a_tf32) holds its k columns;
//   - a split stage between TMA and wgmma: TMA lands raw float32 tiles (32-
//     column boxes, the 128-byte swizzle) in a ring, and the producer
//     warpgroup's warps 1 .. 3 (warp 0 issues the loads) split each stage's
//     tiles into hi (in place) and lo and write the transposed hi and lo,
//     fence them for wgmma and arrive on the stage's "ready" mbarrier,
//     which the consumers wait on. The consumers split the tiles they keep
//     for a whole output tile (dq: their Q and dO rows; dkv: their K and V
//     rows) themselves when those land. Each element is split once a tile,
//     not once per fragment read;
//   - hi and lo of every operand take twice the bytes of the float32 tile,
//     so shared memory sets the tiles: two consumer warpgroups of 64 rows up
//     to d = 64, one at d = 128; dq's ring stages hold 32 keys (16 at d =
//     128), dkv's 16 queries; STAGES as many as fit (dq 4 / 2 / 2, dkv 4 / 3
//     / 2 at d 32 / 64 / 128). Results are staged in the consumer's own hi
//     tile (Q hi, or K hi and V hi) once its last product has read it, then
//     stored by TMA (rows past T not written); the producer reloads that
//     tile once the store has read it, loading the next output tile's first
//     ring stages first;
//   - shared-memory bandwidth, not the tensor cores, paces the products
//     (PERF.md §6): an SS wgmma reads its 64-row A operand (2 KB) for
//     every instruction while N is only 16 or 32. So up to d = 64 the
//     operand a consumer keeps for its whole tile (dq: Q and dO; dkv: K and
//     V) has its hi in registers (mma.m16n8k8's TF32 A layout, 64 registers
//     a thread at d = 64): hi hi and hi lo are RS wgmmas and only lo hi
//     reads A from shared memory. dq pays for those registers by packing
//     dS for dS K half a tile at a time, dkv by packing dS^T into P^T's
//     registers once dV has read them. S, dP (S^T, dP^T), the packed
//     operands and dQ (dK, dV) then take 144 registers a consumer thread at
//     d = 64 against ptxas's 168; at d = 128 (one consumer, 64-column
//     halves of dK and dV as in bf16, grid z = 2) nothing sits in
//     registers;
//   - LSE and delta: dq's per row in registers; dkv's per stage written by
//     the split warps with plain loads ([bh, T] rows have no 16-byte
//     alignment for TMA).
//   Each consumer's products of a stage run in order, the two consumers
//   overlapping each other (issuing the next stage's products early, as
//   dq_kernel_wgmma does, read slower: PERF.md). Persistent blocks, head
//   chunks, dq's heavy-light tile pairing, the causal early stop and
//   masking only the ragged and diagonal tiles are the bf16 designs'.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "sm90_bf16.cuh"
#include "sm90_tf32.cuh"

namespace {

constexpr int BQ = 64;  // query rows per Q/dO stage of dkv_kernel_wgmma
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;

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

// key tile `i` (of KB rows) of a persistent block's walk: z, the box of
// dK and dV columns summed (at d = 128 two tiles share a key tile), and by
// sm90::tile_order within each chunk of heads the tiles nearest the top of
// every head first (in causal mode they see the most queries). Returns
// k0; sets bh and z.
template <int KB = WBK>
__device__ __forceinline__ int dkv_tile(int i, int heads, int chunk, int nk,
                                        int nz, int& bh, int& z) {
  int kt;
  z = i % nz;
  sm90::tile_order(i / nz, heads, nk, chunk, bh, kt);
  return kt * KB;
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

// query tile `i` (of QR rows) of a persistent block's walk
// (sm90::tile_order): within each chunk of heads the heaviest first (the
// bottom tile of every head, then the one above it, ...; in causal mode
// the bottom tile sees the most key tiles). Returns q0; sets bh and the
// number of key tiles of KR rows.
template <int KR, int QR = WBQ>
__device__ __forceinline__ int dq_tile(int i, int heads, int chunk, int nq,
                                       int t, int causal, int& bh,
                                       int& ntiles) {
  int j;
  sm90::tile_order(i, heads, nq, chunk, bh, j);
  const int q0 = (nq - 1 - j) * QR;
  // causal: keys past the tile's last query row contribute nothing
  const int kend = causal ? min(t, q0 + QR) : t;
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

namespace tf = sm90_tf32;

// key rows per ring stage of dq_kernel_tf32wg: 32 (16 at d = 128), so S,
// dP, dS's hi and lo A operands, dQ and Q's and dO's hi (dq_q_regs), all
// operands of wgmmas in flight at once, take 144 registers a consumer
// thread at d = 64 and 96 at d = 128
__host__ __device__ constexpr int dq_tf32_key_rows(int d) {
  return d > 64 ? 16 : 32;
}
// ring stages of dq_kernel_tf32wg: as many as fit beside Q and dO
constexpr int dq_tf32_stages(int d) { return d == 32 ? 4 : 2; }

// The consumers' Q and dO tiles, hi and lo ([64][D] a consumer, float32 as
// swizzled boxes, sm90_tf32.cuh), then STAGES ring stages of K hi, K lo, V
// hi, V lo ([KR][D]) and K^T hi, K^T lo ([D][KR]), then the mbarriers: Q/dO
// full and empty, per stage full, ready and empty; 1024 bytes of slack to
// align the base
template <int D, int STAGES>
constexpr size_t dq_tf32wg_smem_bytes() {
  return 1024 +
         static_cast<size_t>(4 * tf::consumers(D) * 64 * D +
                             6 * STAGES * dq_tf32_key_rows(D) * D) *
             4 +
         8 * (2 + 3 * STAGES);
}

// P = exp(sm_scale S - LSE) on S's accumulators for this lane's rows row0
// + g and row0 + g + 8; only the ragged last key tile and the diagonal tile
// (qw0: the warpgroup's first row) are masked, to a score of NEG_INF
template <int KR>
__device__ __forceinline__ void dq_p_f32(float (&s)[KR / 8][4],
                                         const float (&lse2)[2], int k0,
                                         int t, int causal, int qw0, int row0,
                                         float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  if (k0 + KR > t || (causal && k0 + KR - 1 > qw0)) {
#pragma unroll
    for (int n = 0; n < KR / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * c + (e & 1);
        const int query = row0 + g + (e >> 1) * 8;
        if (key >= t || (causal && key > query)) s[n][e] = NEG_INF;
      }
  }
#pragma unroll
  for (int n = 0; n < KR / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = mma_bf16::exp2_approx(fmaf(s[n][e], scale, -lse2[e >> 1]));
}

// k steps of Q's and dO's hi that dq_kernel_tf32wg holds in registers as
// the A operands of S and dP for a whole query tile: all of them up to d =
// 64 (64 registers a consumer thread at d = 64, paid for by packing dS for
// dS K half a key tile at a time), none at d = 128 (128 would not fit)
__host__ __device__ constexpr int dq_q_regs(int d) { return d > 64 ? 0 : d / 8; }
// key k steps of dS packed as dS K's A operand at once: half the tile's
// where Q and dO sit in registers
__host__ __device__ constexpr int dq_ds_steps(int d) {
  return dq_tf32_key_rows(d) / 8 / (dq_q_regs(d) > 0 ? 2 : 1);
}

// S = Q K^T and dP = dO V^T of one ring stage as 3xTF32, all shared-memory
// operands K-major: the warpgroup's 64 query rows (hi and lo tiles qh, ql,
// doh, dol; Q's and dO's hi from the registers qa, doa where dq_q_regs
// says so) x the stage's KR keys (its K hi, K lo, V hi, V lo tiles from
// s0); two groups (S's accumulators are written, P, while dP is in flight)
template <int D, int KR>
__device__ __forceinline__ void dq_issue_sdp_f32(
    float (&s)[KR / 8][4], float (&dp)[KR / 8][4],
    const uint32_t (&qa)[dq_q_regs(D) > 0 ? dq_q_regs(D) : 1][4],
    const uint32_t (&doa)[dq_q_regs(D) > 0 ? dq_q_regs(D) : 1][4],
    uint32_t qh, uint32_t ql, uint32_t doh, uint32_t dol, uint32_t s0) {
  constexpr int KT = KR * D * 4;  // bytes of a K or V tile
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    if constexpr (dq_q_regs(D) > 0)
      tf::wgmma_x3_rss<KR>(s, qa[kk], tf::desc<D>(ql, 64, kk),
                           tf::desc<D>(s0, KR, kk),
                           tf::desc<D>(s0 + KT, KR, kk), kk > 0);
    else
      tf::wgmma_x3_ss<KR>(s, tf::desc<D>(qh, 64, kk),
                          tf::desc<D>(ql, 64, kk), tf::desc<D>(s0, KR, kk),
                          tf::desc<D>(s0 + KT, KR, kk), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    if constexpr (dq_q_regs(D) > 0)
      tf::wgmma_x3_rss<KR>(dp, doa[kk], tf::desc<D>(dol, 64, kk),
                           tf::desc<D>(s0 + 2 * KT, KR, kk),
                           tf::desc<D>(s0 + 3 * KT, KR, kk), kk > 0);
    else
      tf::wgmma_x3_ss<KR>(dp, tf::desc<D>(doh, 64, kk),
                          tf::desc<D>(dol, 64, kk),
                          tf::desc<D>(s0 + 2 * KT, KR, kk),
                          tf::desc<D>(s0 + 3 * KT, KR, kk), kk > 0);
  }
  sm90::wgmma_commit();
}

// dQ += dS K as 3xTF32 over the key k steps j0 .. j0 + NJ - 1: dS's hi and
// lo A operands from registers (keys in the 0, 2, 4, 6, 1, 3, 5, 7 order of
// c_to_a_tf32), the stage's K^T hi and lo tiles (k = key, n = d; from s0)
// K-major, written in that key order
template <int D, int KR, int NJ>
__device__ __forceinline__ void dq_issue_dsk_f32(
    float (&acc)[D / 8][4], const uint32_t (&dsh)[NJ][4],
    const uint32_t (&dsl)[NJ][4], uint32_t s0, int j0) {
  constexpr int KT = KR * D * 4;  // bytes of a K^T tile
  sm90::wgmma_fence();
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    tf::wgmma_x3_rs<D>(acc, dsh[j], dsl[j],
                       tf::desc<KR>(s0 + 4 * KT, D, j0 + j),
                       tf::desc<KR>(s0 + 5 * KT, D, j0 + j));
  sm90::wgmma_commit();
}

// dS = P (dP - delta) sm_scale in float32 on dP's accumulators
template <int KR>
__device__ __forceinline__ void dq_ds_f32(float (&dp)[KR / 8][4],
                                          const float (&s)[KR / 8][4],
                                          const float (&dlt)[2],
                                          float sm_scale) {
#pragma unroll
  for (int nn = 0; nn < KR / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[nn][e] = s[nn][e] * (dp[nn][e] - dlt[e >> 1]) * sm_scale;
}

template <int D, int STAGES>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
    dq_kernel_tf32wg(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap dq_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, int heads, int chunk,
                     int nq, int t, float sm_scale, int causal) {
  using namespace mma_bf16;
  using namespace sm90;
  constexpr int NC = tf::consumers(D);
  constexpr int KR = dq_tf32_key_rows(D);
  constexpr int QR = 64 * NC;       // query rows a tile
  constexpr int CT = 64 * D * 4;    // bytes of a consumer's Q or dO tile
  constexpr int KT = KR * D * 4;    // bytes of a K, V or K^T tile
  constexpr int NB = D / 32;        // 32-column boxes along d
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t q_hi =
      smem_u32(wg_smem + (1024 - smem_u32(wg_smem) % 1024) % 1024);
  const uint32_t q_lo = q_hi + NC * CT, do_hi = q_lo + NC * CT;
  const uint32_t do_lo = do_hi + NC * CT;
  // stage st: K hi, K lo, V hi, V lo, K^T hi, K^T lo, KT bytes each
  const uint32_t ring = do_lo + NC * CT;
  const uint32_t q_full = ring + STAGES * 6 * KT, q_empty = q_full + 8;
  const uint32_t full = q_empty + 8, ready = full + 8 * STAGES;
  const uint32_t empty = ready + 8 * STAGES;
  const int total = nq * heads;  // query tiles of the whole launch

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, NC);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(ready + 8 * st, tf::SPLIT_THREADS);
      mbar_init(empty + 8 * st, NC * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // A persistent block walks query tiles dq_walk(0, blockIdx.x,
  // gridDim.x), dq_walk(1, ...), ...; its k/v ring runs on across tiles
  const int wg = threadIdx.x / WG_THREADS;
  if (wg == NC) {
    setmaxnreg_dec<tf::SPLIT_REGS>();
    const int ptid = threadIdx.x - NC * WG_THREADS;
    if (ptid == 0) {
      // TMA: each query tile's Q and dO raw into the hi tiles, once the
      // last tile's dQ store has read them, and a ring of K and V tiles.
      // The next tile's first stages load before its Q and dO, while the
      // consumers finish this tile
      int c = 0;  // ring stages walked
      for (int i = blockIdx.x, n = 0; i < total;
           i = dq_walk(++n, blockIdx.x, gridDim.x)) {
        int bh, ntiles;
        const int q0 =
            dq_tile<KR, QR>(i, heads, chunk, nq, t, causal, bh, ntiles);
        const int pre = min(STAGES, ntiles);
        for (int kt = 0; kt <= ntiles; ++kt) {
          if (kt == pre) {
            mbar_wait(q_empty, (n & 1) ^ 1);
            mbar_expect_tx(q_full, 2 * NC * CT);
            for (int w = 0; w < NC; ++w)
              for (int b = 0; b < NB; ++b) {
                const uint32_t off = w * CT + b * 64 * 128;
                tma_load_3d(q_hi + off, &q_map, q_full, b * 32, q0 + 64 * w,
                            bh);
                tma_load_3d(do_hi + off, &do_map, q_full, b * 32,
                            q0 + 64 * w, bh);
              }
          }
          if (kt < ntiles) {
            const int st = c % STAGES;
            const uint32_t s0 = ring + st * 6 * KT, bar = full + 8 * st;
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
      // the split stage: each K tile into hi, lo and the transposed K^T hi
      // and lo (dS K's B operand, keys in key_slot order), each V tile into
      // hi and lo; then the stage is ready for the consumers
      const int stid = ptid - 32;
      int c = 0;
      for (int i = blockIdx.x, n = 0; i < total;
           i = dq_walk(++n, blockIdx.x, gridDim.x)) {
        int bh, ntiles;
        dq_tile<KR, QR>(i, heads, chunk, nq, t, causal, bh, ntiles);
        for (int kt = 0; kt < ntiles; ++kt, ++c) {
          const int st = c % STAGES;
          const uint32_t s0 = ring + st * 6 * KT;
          mbar_wait(full + 8 * st, (c / STAGES) & 1);
          tf::split_rows<KR, D, D>(s0, s0 + KT, s0 + 4 * KT, s0 + 5 * KT, 0,
                                   stid, tf::SPLIT_THREADS);
          tf::split_rows<KR, D, 0>(s0 + 2 * KT, s0 + 3 * KT, 0, 0, 0, stid,
                                   tf::SPLIT_THREADS);
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
    const uint32_t qh = q_hi + wg * CT, ql = q_lo + wg * CT;
    const uint32_t doh = do_hi + wg * CT, dol = do_lo + wg * CT;

    float acc[D / 8][4];                // dQ
    float s[KR / 8][4], dp[KR / 8][4];  // a key tile's S, then P; dP, dS
    constexpr int NJ = dq_ds_steps(D);
    uint32_t dsh[NJ][4], dsl[NJ][4];  // dS K's A operand, hi and lo
    // Q's and dO's hi as the A operands of S and dP
    uint32_t qa[dq_q_regs(D) > 0 ? dq_q_regs(D) : 1][4];
    uint32_t doa[dq_q_regs(D) > 0 ? dq_q_regs(D) : 1][4];
#pragma unroll
    for (int nn = 0; nn < KR / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nn][e] = dp[nn][e] = 0.f;
    int c = 0;  // ring stages walked
    for (int i = blockIdx.x, n = 0; i < total;
         i = dq_walk(++n, blockIdx.x, gridDim.x)) {
      int bh, ntiles;
      const int q0 = dq_tile<KR, QR>(i, heads, chunk, nq, t, causal, bh,
                                     ntiles);
      const int qw0 = q0 + 64 * wg;      // the warpgroup's first row
      const int row0 = qw0 + 16 * warp;  // the warp's first row
      // this lane's rows: LSE in log2 units and delta
      float lse2[2], dlt[2];
      dq_rows(lse2, dlt, lse, delta, static_cast<size_t>(bh) * t, row0, t);
      // the warpgroup's Q and dO rows into hi (in place) and lo
      mbar_wait(q_full, n & 1);
      tf::split_rows<64, D, 0>(qh, ql, 0, 0, 0, tid, WG_THREADS);
      tf::split_rows<64, D, 0>(doh, dol, 0, 0, 0, tid, WG_THREADS);
      fence_async_smem();
      named_barrier(1 + wg, WG_THREADS);
#pragma unroll
      for (int kk = 0; kk < dq_q_regs(D); ++kk) {
        tf::load_a<D>(qh, 64, 16 * warp, kk, qa[kk]);
        tf::load_a<D>(doh, 64, 16 * warp, kk, doa[kk]);
      }
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

      for (int kt = 0; kt < ntiles; ++kt, ++c) {
        const int st = c % STAGES;
        const uint32_t s0 = ring + st * 6 * KT;
        mbar_wait(ready + 8 * st, (c / STAGES) & 1);
        dq_issue_sdp_f32<D, KR>(s, dp, qa, doa, qh, ql, doh, dol, s0);
        wgmma_wait<1>();  // S
        fence_regs(s);
        dq_p_f32<KR>(s, lse2, kt * KR, t, causal, qw0, row0, scale);
        wgmma_wait<0>();  // dP
        fence_regs(dp);
        dq_ds_f32<KR>(dp, s, dlt, sm_scale);
        // dQ += dS K, NJ key k steps at a time
#pragma unroll
        for (int j0 = 0; j0 < KR / 8; j0 += NJ) {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma_tf32::c_to_a_tf32(dp[j0 + j], dsh[j], dsl[j]);
          dq_issue_dsk_f32<D, KR, NJ>(acc, dsh, dsl, s0, j0);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(dsh);
          fence_regs(dsl);
        }
        mbar_arrive(empty + 8 * st);  // the stage may be refilled
      }

      // dQ in float32 into the warpgroup's Q hi tile (its last S has been
      // retired), one TMA store a box (rows past T are not written); the Q
      // and dO tiles go back to the producer once the store has read them
      tf::stage_rows<D, D>(qh, 64, 16 * warp, 0, acc);
      fence_async_smem();
      named_barrier(1 + wg, WG_THREADS);
      if (tid == 0) {
        for (int b = 0; b < NB; ++b)
          tma_store_3d(&dq_map, qh + b * 64 * 128, b * 32, qw0, bh);
        tma_store_commit();
        tma_store_wait_read();
        mbar_arrive(q_empty);
      }
    }
  }
}

// query rows per ring stage of dkv_kernel_tf32wg: S^T, dP^T, P^T's and
// dS^T's hi and lo A operands, dK and dV of 16 query columns take 112
// registers a consumer thread at d = 64
constexpr int DKV_TF32_QROWS = 16;
// ring stages of dkv_kernel_tf32wg: as many as fit beside K and V
constexpr int dkv_tf32_stages(int d) { return d == 32 ? 4 : d == 64 ? 3 : 2; }

// The consumers' K and V tiles, hi and lo ([64][D] a consumer), then STAGES
// ring stages of Q hi, Q lo, dO hi, dO lo ([BQ][D]) and Q^T hi, Q^T lo, dO^T
// hi, dO^T lo ([dkv_columns(D)][BQ]), then per stage LSE and delta (BQ
// floats each), then the mbarriers: K/V full and empty, per stage full,
// ready and empty; 1024 bytes of slack to align the base
template <int D, int STAGES>
constexpr size_t dkv_tf32wg_smem_bytes() {
  return 1024 +
         static_cast<size_t>(4 * tf::consumers(D) * 64 * D +
                             4 * STAGES * DKV_TF32_QROWS *
                                 (D + dkv_columns(D)) +
                             2 * STAGES * DKV_TF32_QROWS) *
             4 +
         8 * (2 + 3 * STAGES);
}

// k steps of K's and V's hi that dkv_kernel_tf32wg holds in registers as
// the A operands of S^T and dP^T for a whole key tile: all of them up to d
// = 64 (64 registers a consumer thread at d = 64, paid for by packing P^T
// and dS^T into the same registers), none at d = 128
__host__ __device__ constexpr int dkv_k_regs(int d) {
  return d > 64 ? 0 : d / 8;
}

// S^T = K Q^T and dP^T = V dO^T of one ring stage as 3xTF32, all
// shared-memory operands K-major: the warpgroup's 64 key rows (hi and lo
// tiles kh, kl, vh, vl; K's hi from the registers ka where dkv_k_regs says
// so) x the stage's DKV_TF32_QROWS query rows (its Q hi, Q lo, dO hi, dO lo
// tiles from s0); two groups (S^T's accumulators are written, P^T, while
// dP^T is in flight)
template <int D>
__device__ __forceinline__ void dkv_issue_sdp_f32(
    float (&s)[DKV_TF32_QROWS / 8][4], float (&dp)[DKV_TF32_QROWS / 8][4],
    const uint32_t (&ka)[dkv_k_regs(D) > 0 ? dkv_k_regs(D) : 1][4],
    const uint32_t (&va)[dkv_k_regs(D) > 0 ? dkv_k_regs(D) : 1][4],
    uint32_t kh, uint32_t kl, uint32_t vh, uint32_t vl, uint32_t s0) {
  constexpr int QB = DKV_TF32_QROWS;
  constexpr int QT = QB * D * 4;  // bytes of a Q or dO tile
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    if constexpr (dkv_k_regs(D) > 0)
      tf::wgmma_x3_rss<QB>(s, ka[kk], tf::desc<D>(kl, 64, kk),
                           tf::desc<D>(s0, QB, kk),
                           tf::desc<D>(s0 + QT, QB, kk), kk > 0);
    else
      tf::wgmma_x3_ss<QB>(s, tf::desc<D>(kh, 64, kk),
                          tf::desc<D>(kl, 64, kk), tf::desc<D>(s0, QB, kk),
                          tf::desc<D>(s0 + QT, QB, kk), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    if constexpr (dkv_k_regs(D) > 0)
      tf::wgmma_x3_rss<QB>(dp, va[kk], tf::desc<D>(vl, 64, kk),
                           tf::desc<D>(s0 + 2 * QT, QB, kk),
                           tf::desc<D>(s0 + 3 * QT, QB, kk), kk > 0);
    else
      tf::wgmma_x3_ss<QB>(dp, tf::desc<D>(vh, 64, kk),
                          tf::desc<D>(vl, 64, kk),
                          tf::desc<D>(s0 + 2 * QT, QB, kk),
                          tf::desc<D>(s0 + 3 * QT, QB, kk), kk > 0);
  }
  sm90::wgmma_commit();
}

// dV += P^T dO as 3xTF32: P^T's hi and lo from registers (queries in the
// c_to_a_tf32 order), the stage's dO^T hi and lo tiles (k = query, n = the
// tile's dK and dV columns) K-major, written in that order; s0: the stage
template <int D>
__device__ __forceinline__ void dkv_issue_dv_f32(
    float (&acc)[dkv_columns(D) / 8][4],
    const uint32_t (&ph)[DKV_TF32_QROWS / 8][4],
    const uint32_t (&pl)[DKV_TF32_QROWS / 8][4], uint32_t s0) {
  constexpr int QB = DKV_TF32_QROWS, DN = dkv_columns(D);
  const uint32_t t0 = s0 + 4 * QB * D * 4;  // the stage's transposed tiles
  constexpr int TT = DN * QB * 4;           // bytes of one
  sm90::wgmma_fence();
#pragma unroll
  for (int j = 0; j < QB / 8; ++j)
    tf::wgmma_x3_rs<DN>(acc, ph[j], pl[j], tf::desc<QB>(t0 + 2 * TT, DN, j),
                        tf::desc<QB>(t0 + 3 * TT, DN, j));
  sm90::wgmma_commit();
}

// dK += dS^T Q as 3xTF32, as dkv_issue_dv_f32 with the stage's Q^T tiles
template <int D>
__device__ __forceinline__ void dkv_issue_dk_f32(
    float (&acc)[dkv_columns(D) / 8][4],
    const uint32_t (&dsh)[DKV_TF32_QROWS / 8][4],
    const uint32_t (&dsl)[DKV_TF32_QROWS / 8][4], uint32_t s0) {
  constexpr int QB = DKV_TF32_QROWS, DN = dkv_columns(D);
  const uint32_t t0 = s0 + 4 * QB * D * 4;
  constexpr int TT = DN * QB * 4;
  sm90::wgmma_fence();
#pragma unroll
  for (int j = 0; j < QB / 8; ++j)
    tf::wgmma_x3_rs<DN>(acc, dsh[j], dsl[j], tf::desc<QB>(t0, DN, j),
                        tf::desc<QB>(t0 + TT, DN, j));
  sm90::wgmma_commit();
}

// P^T = exp(sm_scale S^T - LSE[q]) in float32 on S^T's accumulators for
// this lane's key rows row0 + g and row0 + g + 8 and the stage's query
// columns q0 ..; LSE per column from the stage's rows at tr. Only the
// ragged last stage and the diagonal stages (kw0: the warpgroup's first
// key) are masked, to a score of NEG_INF
__device__ __forceinline__ void dkv_p_f32(
    float (&s)[DKV_TF32_QROWS / 8][4], uint32_t tr, int q0, int t,
    int causal, int kw0, int row0, float scale) {
  constexpr int QB = DKV_TF32_QROWS;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  if (q0 + QB > t || (causal && q0 < kw0 + 63)) {
#pragma unroll
    for (int nn = 0; nn < QB / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int query = q0 + nn * 8 + 2 * c + (e & 1);
        const int key = row0 + g + (e >> 1) * 8;
        if (query >= t || (causal && query < key)) s[nn][e] = NEG_INF;
      }
  }
#pragma unroll
  for (int nn = 0; nn < QB / 8; ++nn) {
    const float2 lq = sm90::lds_f2(tr + (nn * 8 + 2 * c) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[nn][e] = mma_bf16::exp2_approx(
          fmaf(s[nn][e], scale, -((e & 1) ? lq.y : lq.x) * LOG2E));
  }
}

// dS^T = P^T (dP^T - delta[q]) sm_scale in float32 on dP^T's accumulators,
// delta per column from the stage's rows at tr
__device__ __forceinline__ void dkv_ds_f32(
    float (&dp)[DKV_TF32_QROWS / 8][4],
    const float (&s)[DKV_TF32_QROWS / 8][4], uint32_t tr, float sm_scale) {
  constexpr int QB = DKV_TF32_QROWS;
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int nn = 0; nn < QB / 8; ++nn) {
    const float2 dq2 = sm90::lds_f2(tr + (QB + nn * 8 + 2 * c) * 4);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[nn][e] =
          s[nn][e] * (dp[nn][e] - ((e & 1) ? dq2.y : dq2.x)) * sm_scale;
  }
}

template <int D, int STAGES>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
    dkv_kernel_tf32wg(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap dk_map,
                      const __grid_constant__ CUtensorMap dv_map,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int heads, int chunk,
                      int t, float sm_scale, int causal) {
  using namespace mma_bf16;
  using namespace sm90;
  constexpr int NC = tf::consumers(D);
  constexpr int QB = DKV_TF32_QROWS;  // query rows a stage
  constexpr int DN = dkv_columns(D);  // columns of dK and dV summed here
  constexpr int NZ = D / DN;          // key tiles a (head, k0) splits into
  constexpr int KB = 64 * NC;         // key rows a tile
  constexpr int CT = 64 * D * 4;      // bytes of a consumer's K or V tile
  constexpr int QT = QB * D * 4;      // bytes of a Q or dO tile
  constexpr int TT = DN * QB * 4;     // bytes of a Q^T or dO^T tile
  constexpr int SB = 4 * QT + 4 * TT; // bytes of a stage's tiles
  constexpr int NB = D / 32;          // 32-column boxes along d
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t k_hi =
      smem_u32(wg_smem + (1024 - smem_u32(wg_smem) % 1024) % 1024);
  const uint32_t k_lo = k_hi + NC * CT, v_hi = k_lo + NC * CT;
  const uint32_t v_lo = v_hi + NC * CT;
  // stage st: Q hi, Q lo, dO hi, dO lo, then Q^T hi, Q^T lo, dO^T hi, dO^T
  // lo; its LSE and delta rows at rows + 8 QB st
  const uint32_t ring = v_lo + NC * CT;
  const uint32_t rows = ring + STAGES * SB;
  const uint32_t kv_full = rows + STAGES * 2 * QB * 4;
  const uint32_t kv_empty = kv_full + 8, full = kv_empty + 8;
  const uint32_t ready = full + 8 * STAGES, empty = ready + 8 * STAGES;
  const int ntiles = (t + QB - 1) / QB;  // query tiles
  const int nk = (t + KB - 1) / KB;
  const int total = nk * heads * NZ;     // key tiles of the launch

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, NC);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(ready + 8 * st, tf::SPLIT_THREADS);
      mbar_init(empty + 8 * st, NC * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // A persistent block walks key tiles blockIdx.x, blockIdx.x +
  // gridDim.x, ...; the Q/dO ring runs on across tiles
  const int wg = threadIdx.x / WG_THREADS;
  if (wg == NC) {
    setmaxnreg_dec<tf::SPLIT_REGS>();
    const int ptid = threadIdx.x - NC * WG_THREADS;
    if (ptid == 0) {
      // TMA: each key tile's K and V raw into the hi tiles, once the last
      // tile's dK and dV stores have read them, and a ring of Q and dO
      // tiles. The next key tile's first stages load before its K and V
      int c = 0;  // ring stages walked
      for (int i = blockIdx.x, n = 0; i < total; i += gridDim.x, ++n) {
        int bh, z;
        const int k0 = dkv_tile<KB>(i, heads, chunk, nk, NZ, bh, z);
        // causal: query tiles before the tile's first key see none of it
        const int qstart = causal ? k0 / QB : 0;
        const int pre = min(STAGES, ntiles - qstart);
        for (int qt = qstart; qt <= ntiles; ++qt) {
          if (qt - qstart == pre) {
            mbar_wait(kv_empty, (n & 1) ^ 1);
            mbar_expect_tx(kv_full, 2 * NC * CT);
            for (int w = 0; w < NC; ++w)
              for (int b = 0; b < NB; ++b) {
                const uint32_t off = w * CT + b * 64 * 128;
                tma_load_3d(k_hi + off, &k_map, kv_full, b * 32, k0 + 64 * w,
                            bh);
                tma_load_3d(v_hi + off, &v_map, kv_full, b * 32, k0 + 64 * w,
                            bh);
              }
          }
          if (qt < ntiles) {
            const int st = c % STAGES;
            const uint32_t s0 = ring + st * SB, bar = full + 8 * st;
            mbar_wait(empty + 8 * st, ((c / STAGES) & 1) ^ 1);
            mbar_expect_tx(bar, 2 * QT);
            for (int b = 0; b < NB; ++b) {
              tma_load_3d(s0 + b * QB * 128, &q_map, bar, b * 32, qt * QB,
                          bh);
              tma_load_3d(s0 + 2 * QT + b * QB * 128, &do_map, bar, b * 32,
                          qt * QB, bh);
            }
            ++c;
          }
        }
      }
    } else if (ptid >= 32) {
      // the split stage: each Q and dO tile into hi, lo and the transposed
      // hi and lo of the tile's dK and dV columns (the B operands of dK += dS^T Q and dV += P^T dO,
      // queries in key_slot order); the stage's LSE and delta rows (0 past
      // T) by plain loads: [bh, T] float32 rows have no 16-byte alignment
      // for TMA
      const int stid = ptid - 32;
      int c = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        int bh, z;
        const int k0 = dkv_tile<KB>(i, heads, chunk, nk, NZ, bh, z);
        const int qstart = causal ? k0 / QB : 0;
        for (int qt = qstart; qt < ntiles; ++qt, ++c) {
          const int st = c % STAGES;
          const uint32_t s0 = ring + st * SB, t0 = s0 + 4 * QT;
          mbar_wait(full + 8 * st, (c / STAGES) & 1);
          tf::split_rows<QB, D, DN>(s0, s0 + QT, t0, t0 + TT, z * DN, stid,
                                    tf::SPLIT_THREADS);
          tf::split_rows<QB, D, DN>(s0 + 2 * QT, s0 + 3 * QT, t0 + 2 * TT,
                                    t0 + 3 * TT, z * DN, stid,
                                    tf::SPLIT_THREADS);
          if (stid < 2 * QB) {
            const int q = qt * QB + stid % QB;
            const float* src = stid < QB ? lse : delta;
            tf::sts(rows + (st * 2 * QB + stid) * 4,
                    __float_as_uint(
                        q < t ? src[static_cast<size_t>(bh) * t + q] : 0.f));
          }
          fence_async_smem();
          mbar_arrive(ready + 8 * st);
        }
      }
    }
  } else {
    // consumer warpgroup wg: key rows 64 wg .. 64 wg + 63 of each tile
    setmaxnreg_inc<tf::CONSUMER_REGS>();
    const int tid = threadIdx.x % WG_THREADS;
    const int warp = tid >> 5;
    const float scale = sm_scale * LOG2E;  // exponents in log2 units
    const uint32_t kh = k_hi + wg * CT, kl = k_lo + wg * CT;
    const uint32_t vh = v_hi + wg * CT, vl = v_lo + wg * CT;

    float acc_k[DN / 8][4], acc_v[DN / 8][4];
    float s[QB / 8][4], dp[QB / 8][4];  // S^T, then P^T; dP^T, then dS^T
    // P^T's, then dS^T's, hi and lo as the A operands of dV, then dK
    uint32_t ah[QB / 8][4], al[QB / 8][4];
    // K's and V's hi as the A operands of S^T and dP^T
    uint32_t ka[dkv_k_regs(D) > 0 ? dkv_k_regs(D) : 1][4];
    uint32_t va[dkv_k_regs(D) > 0 ? dkv_k_regs(D) : 1][4];
#pragma unroll
    for (int nn = 0; nn < QB / 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nn][e] = dp[nn][e] = 0.f;
    int rs = 0;  // ring stages walked
    for (int i = blockIdx.x, n = 0; i < total; i += gridDim.x, ++n) {
      int bh, z;
      const int k0 = dkv_tile<KB>(i, heads, chunk, nk, NZ, bh, z);
      const int qstart = causal ? k0 / QB : 0;
      const int kw0 = k0 + 64 * wg;      // the warpgroup's first key row
      const int row0 = kw0 + 16 * warp;  // the warp's first key row
      // the warpgroup's K and V rows into hi (in place) and lo
      mbar_wait(kv_full, n & 1);
      tf::split_rows<64, D, 0>(kh, kl, 0, 0, 0, tid, WG_THREADS);
      tf::split_rows<64, D, 0>(vh, vl, 0, 0, 0, tid, WG_THREADS);
      fence_async_smem();
      named_barrier(1 + wg, WG_THREADS);
#pragma unroll
      for (int kk = 0; kk < dkv_k_regs(D); ++kk) {
        tf::load_a<D>(kh, 64, 16 * warp, kk, ka[kk]);
        tf::load_a<D>(vh, 64, 16 * warp, kk, va[kk]);
      }
#pragma unroll
      for (int nn = 0; nn < DN / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[nn][e] = acc_v[nn][e] = 0.f;

      for (int qt = qstart; qt < ntiles; ++qt, ++rs) {
        const int st = rs % STAGES;
        const uint32_t s0 = ring + st * SB;
        const uint32_t tr = rows + st * 2 * QB * 4;  // LSE, delta rows
        mbar_wait(ready + 8 * st, (rs / STAGES) & 1);
        dkv_issue_sdp_f32<D>(s, dp, ka, va, kh, kl, vh, vl, s0);
        wgmma_wait<1>();  // S^T
        fence_regs(s);
        dkv_p_f32(s, tr, qt * QB, t, causal, kw0, row0, scale);
        tf::c_to_a_x3(s, ah, al);
        dkv_issue_dv_f32<D>(acc_v, ah, al, s0);
        wgmma_wait<0>();  // dP^T, and dV: its A registers are free
        fence_regs(dp);
        fence_regs(ah);
        fence_regs(al);
        dkv_ds_f32(dp, s, tr, sm_scale);
        tf::c_to_a_x3(dp, ah, al);
        dkv_issue_dk_f32<D>(acc_k, ah, al, s0);
        wgmma_wait<0>();
        fence_regs(ah);
        fence_regs(al);
        mbar_arrive(empty + 8 * st);  // the stage may be refilled
      }
      fence_regs(acc_v);
      fence_regs(acc_k);

      // dK and dV in float32 into the warpgroup's K hi and V hi tiles (the
      // tile's last S^T and dP^T have been retired), one TMA store a box
      // (rows past T are not written); K and V go back to the producer
      // once the stores have read them
      tf::stage_rows<D, DN>(kh, 64, 16 * warp, 0, acc_k);
      tf::stage_rows<D, DN>(vh, 64, 16 * warp, 0, acc_v);
      fence_async_smem();
      named_barrier(1 + wg, WG_THREADS);
      if (tid == 0) {
        for (int b = 0; b < DN / 32; ++b) {
          tma_store_3d(&dk_map, kh + b * 64 * 128, z * DN + b * 32, kw0, bh);
          tma_store_3d(&dv_map, vh + b * 64 * 128, z * DN + b * 32, kw0, bh);
        }
        tma_store_commit();
        tma_store_wait_read();
        mbar_arrive(kv_empty);
      }
    }
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

template <int D, int STAGES = dq_tf32_stages(D)>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int t,
                          float sm_scale, int causal, cudaStream_t stream) {
  constexpr int NC = tf::consumers(D);
  constexpr size_t smem = dq_tf32wg_smem_bytes<D, STAGES>();
  auto kern = dq_kernel_tf32wg<D, STAGES>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  // boxes of 64 rows, a consumer's Q, dO or dQ rows, and of a ring
  // stage's key rows for K and V
  CUtensorMap maps[5];
  const void* ptrs[5] = {q, k, v, dout, dq};
  for (int i = 0; i < 5; ++i) {
    const cudaError_t err = sm90_tf32::rows_map<D>(
        &maps[i], ptrs[i], bh, t, i == 1 || i == 2 ? dq_tf32_key_rows(D) : 64);
    if (err != cudaSuccess) return err;
  }
  // persistent blocks: one a streaming multiprocessor, or one a tile
  static const int sms = sm90::sm_count();
  const int nq = (t + 64 * NC - 1) / (64 * NC);
  const int tiles = nq * bh;
  kern<<<tiles < sms ? tiles : sms, (NC + 1) * WG_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const float*>(lse), static_cast<const float*>(delta), bh,
      sm90::head_chunk(sms, nq), nq, t, sm_scale, causal);
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

template <int D, int STAGES = dkv_tf32_stages(D)>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int t, float sm_scale, int causal,
                           cudaStream_t stream) {
  constexpr int NC = tf::consumers(D);
  constexpr size_t smem = dkv_tf32wg_smem_bytes<D, STAGES>();
  auto kern = dkv_kernel_tf32wg<D, STAGES>;
  static const cudaError_t attr_err = allow_smem(kern, smem);
  if (attr_err != cudaSuccess) return attr_err;
  // boxes of a ring stage's query rows for Q and dO, of 64 rows (a
  // consumer's key rows) for K, V, dK and dV
  CUtensorMap maps[6];
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  for (int i = 0; i < 6; ++i) {
    const cudaError_t err = sm90_tf32::rows_map<D>(
        &maps[i], ptrs[i], bh, t, i == 0 || i == 3 ? DKV_TF32_QROWS : 64);
    if (err != cudaSuccess) return err;
  }
  // persistent blocks: one a streaming multiprocessor, or one a tile
  static const int sms = sm90::sm_count();
  const int nk = (t + 64 * NC - 1) / (64 * NC);
  const int tiles = nk * bh * (D / dkv_columns(D));
  kern<<<tiles < sms ? tiles : sms, (NC + 1) * WG_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      static_cast<const float*>(lse), static_cast<const float*>(delta), bh,
      sm90::head_chunk(sms, nk), t, sm_scale, causal);
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
// float32 runs dq_kernel_tf32wg, bfloat16 dq_kernel_wgmma
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

// float32 runs dkv_kernel_tf32wg, bfloat16 dkv_kernel_wgmma
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

// Dynamic shared memory the dQ and dK/dV kernels' instances for head dim
// d take (0 where there is none), bf16 and float32; chip_smoke.py's
// smem_phase prints them beside ptxas's registers.
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

extern "C" long long flash_attention_bwd_dq_f32_smem(int d) {
  switch (d) {
    case 32:
      return dq_tf32wg_smem_bytes<32, dq_tf32_stages(32)>();
    case 64:
      return dq_tf32wg_smem_bytes<64, dq_tf32_stages(64)>();
    case 128:
      return dq_tf32wg_smem_bytes<128, dq_tf32_stages(128)>();
    default:
      return 0;
  }
}

extern "C" long long flash_attention_bwd_dkv_f32_smem(int d) {
  switch (d) {
    case 32:
      return dkv_tf32wg_smem_bytes<32, dkv_tf32_stages(32)>();
    case 64:
      return dkv_tf32wg_smem_bytes<64, dkv_tf32_stages(64)>();
    case 128:
      return dkv_tf32wg_smem_bytes<128, dkv_tf32_stages(128)>();
    default:
      return 0;
  }
}
