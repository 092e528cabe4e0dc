// Flash-attention backward (FA2) for Hopper, bf16 (fp16: the libraries
// flash_backward_f16.cu and flash_backward_d256_f16.cu, this source built
// with FA_F16), d_head 128 or 256, on wgmma + TMA.
//
// Replaces the TPU kernels of flash_attention_from_scratch_tpu/ops/
// flash_backward.py: _fused_kernel (K2, entry fa_flash_backward_fused) and
// the split pair _dkv_kernel / _dq_kernel (K3, entries fa_flash_backward_dkv
// and fa_flash_backward_dq). Same function: from the saved forward output's
// row statistics (LSE, natural log) and D = rowsum(dO * O), which the caller
// computes, each (Q tile, KV tile) pair recomputes
//   P^T  = exp2(S^T * scale * log2e - lse * log2e)   (S^T = K Q^T, fp32)
//   dP^T = V dO^T
//   dS^T = P^T * (dP^T - D) * [1 - tanh^2] * scale    (softcap slope)
// and accumulates dV += P^T dO, dK += dS^T Q, dQ += dS K, with P and dS*scale
// rounded to the inputs' type before their products (act_t, hopper.cuh: bf16
// or fp16; pack_p), as the TPU kernels do, and dQ, dK and dV stored in that
// type. In fp16 a P below 2^-24 rounds to 0 where bf16 keeps it. Causal masks
// with a q_offset and a sliding window zero P; tiles no row can see are
// skipped. GQA is summed in-kernel: a KV tile's CTA walks every Q head of its
// group, so dK and dV need no atomics. Sinks need nothing here: the
// forward's LSE already holds their term.
//
// What bounds it on the H100: five tile products per (Q, KV) pair, 2.5x the
// forward's operations, at the training shapes far above the card's ~295
// FLOP/byte balance point, so the bound is tensor-core operations (989
// TFLOP/s bf16, and fp16 alike). Every product runs on wgmma with 16-bit
// operands and fp32 sums, every tile arrives by TMA (128-byte-swizzled boxes
// of 64 16-bit columns from 4-D tensor maps over the (b, h, s, d) views,
// encoded per call, so strided views go through as they are) into mbarrier
// rings. The tile walk and masks are those of flash_wgmma.cuh. fp16 has
// bf16's bytes and wgmma shapes, so everything below holds for both.
//
// Registers set the shapes. A consumer that keeps dK and dV (two m64n128
// fp32 accumulators, 128 registers) and the scores S^T and dP^T of a Q tile
// at once needs about 200 registers, the dQ kernel's about 170. An SM's
// registers are four files of 16,384, one per quarter of its warps, and
// ptxas sizes a CTA for its fullest file: with a ninth warp (two consumer
// warpgroups and a producer warp, 288 threads) three warps share one, so a
// thread gets 168 registers whatever setmaxnreg grants, and the dK/dV
// kernel spilled 2.4-3.0 KB. So a CTA is NC consumer warpgroups and nothing
// else (NC * 128 threads, up to 255 registers, no spill); its thread 0
// issues every copy between its own tiles (refill below). With NC = 1 two
// CTAs share an SM where their shared memory fits. The launches (measured
// on the H100): K3's two kernels take NC = 1, two CTAs an SM; K2 takes
// NC = 2, which halves its dQ additions (a partial covers 128 keys).
//   - dK/dV kernel (K3's first half; K2 with kDQ): one CTA per (NC * 64 KV
//     rows, KV head, batch), a warpgroup per 64 KV rows holding its dK and
//     dV in registers over the walk of (head of the group, visible Q tile)
//     pairs, heaviest causal KV tiles first. Per pair, in transposed score
//     space: S^T = K Q^T and dP^T = V dO^T (SS: K or V and Q or dO from
//     shared memory, K-major), P^T and dS^T in registers, then dV += P^T dO
//     and dK += dS^T Q with P^T and dS^T repacked as A fragments and dO or
//     Q read MN-major (the transpose bit), as the forward's P V reads V.
//     Q, dO, LSE and D rows arrive per pair through a ring of slots. A
//     warpgroup whose 64 KV rows lie past seq_kv (the ragged last tile)
//     computes and stores nothing.
//   - K2's dQ: dS^T goes to a swizzled shared buffer (with two warpgroups,
//     two alternating), the consumer warps meet at a named barrier, and
//     each warpgroup computes dQ's partial dS K over all the CTA's keys for
//     its share of dQ's columns, 64 at a time (SS with both operands
//     MN-major: dS^T as stored, K as loaded), then adds it to a zeroed fp32
//     (b, h, s_q, d) workspace by TMA reduce-add from a swizzled stage a
//     warp (16-byte atomic adds from registers, the first form, took a
//     third of the kernel's time). The order of the additions changes from
//     run to run, so K2's dQ is not bitwise reproducible; its dK and dV
//     are.
//   - dQ kernel (K3's second half): the forward's walk with dQ for O: one
//     CTA (one warpgroup) per (64 Q rows, Q head, batch), 128-key K/V
//     slots through a ring of one (the other CTA on the SM runs while a
//     copy lands), per tile S = Q K^T and dP = dO V^T
//     (SS), P and dS in registers, dQ += dS K (A from registers, K
//     MN-major); dQ sums in registers in a fixed order.
// Each product starts with scale-d 0 rather than zeroed registers, and no
// register of a product in flight is written (ptxas would serialize the
// wgmmas, C7512).
//
// Head width 256 (Gemma-2-2B/9B) is its own instantiation of each kernel
// (the HD template argument; every tile has four 64-column boxes; d 128's
// shapes are those above), built from this file as a library of its own by
// flash_backward_d256.cu (BACKWARD_HD below). A warpgroup's dK and dV over 64 KV rows at d
// 256 would be 256 accumulator registers, more than a thread has, so:
//   - dK/dV kernel: two consumer warpgroups own the SAME 64 KV rows and
//     split dK's and dV's columns, 128 each (SPLIT = 2: the d-128
//     thread's 128 accumulator registers). Each computes S^T and dP^T over
//     the full width itself (the score products twice a CTA: twelve
//     products of 64 x 64 x 128 a pair where eight are needed, 1.5x the
//     dK/dV work), then its halves of dV += P^T dO and dK += dS^T Q. A
//     64-row Q + dO slot is 64 KB and the K and V tiles 32 KB each, so
//     K3's ring has 2 slots, refilled once both warpgroups have released a
//     step (LAG 0: the next step's copy lands while the step in between
//     runs). K2 adds its two dS^T buffers (8 KB each; each warpgroup
//     stores half of the identical fragments) and a dQ stage a warp (32
//     KB), which leave room for one slot: its copy starts when both
//     warpgroups have released the last step. Its dQ partial is dS K over
//     the CTA's 64 keys, each warpgroup 128 of dQ's columns.
//   - dQ kernel: one warpgroup of 64 Q rows keeps 64 x 256 fp32 dQ (128
//     registers), so its key slot is 64 keys (S and dP 32 registers each)
//     and dQ += dS K is two m64n128 products a k step (issue_pv at HD
//     256); 2 slots of 64 KB (K, then V), one CTA an SM.

#include "flash_wgmma.cuh"

namespace {

constexpr int DQ_BAR = 1;        // named barrier of K2's consumer warps
constexpr int SM_SMEM = 233472;  // an SM's shared memory (1 KB of it reserved per CTA)

// CTAs an SM holds: two of one consumer warpgroup where their shared memory
// fits (two warps on each register file at 255 registers), else one.
__host__ __device__ constexpr int per_sm(int nc, int smem) {
  return nc == 1 && 2 * (smem + 1024) <= SM_SMEM ? 2 : 1;
}

struct Params {
  const float* lse;   // (batch, heads, seq_q), natural log
  const float* dsum;  // (batch, heads, seq_q), D = rowsum(dO * O)
  float* dq_acc;      // fused: (batch, heads, seq_q, HD) fp32, zeroed
  act_t* dq;          // split dQ kernel: (batch, heads, seq_q, HD)
  act_t* dk;          // (batch, kv_heads, seq_kv, HD)
  act_t* dv;
  int heads, kv_heads, group, seq_q, seq_kv;
  int causal, q_offset, window;
  float scale, softcap;
};

// A warp's 16 rows x 64 columns of K2's dQ partial, fp32, as the two
// swizzled 16 x 32 boxes that a TMA reduce-add reads.
constexpr int WARP_STAGE = 16 * 64 * 4;

// The dK/dV kernel's geometry at head width HD: NC consumer warpgroups, a
// ring of NS slots of 64 Q rows (Q, then dO, then their LSE and D rows; 64
// is wgmma's M, which K2's dQ product takes in Q rows), with kDQ NC dS^T
// buffers (BKV x 64 act_t; two warpgroups alternate two) and a dQ stage
// for each warp. SPLIT warpgroups share 64 KV rows, each holding 128 of
// dK's and dV's columns (1 at d 128: a warpgroup a 64-row group; 2 at d
// 256). The ring's slot of step i - LAG is refilled after step i.
// ops/flash_backward.py::plan mirrors it.
template <int NC, int NS, bool kDQ, int HD>
struct DkvTile {
  static_assert(HD == 128 || (HD == 256 && NC == 2), "d 128, or d 256 on two warpgroups");
  static constexpr int SPLIT = HD / 128;                   // warpgroups a 64-row group
  static constexpr int BKV = NC / SPLIT * WG_ROWS;         // KV rows per CTA
  static constexpr int BQ = WG_ROWS;                       // Q rows per slot
  static constexpr int THREADS = NC * 128;
  static constexpr int BOXES = HD / BOX_COLS;              // 64-column boxes of a tile
  static constexpr int KV_BYTES = bf16_tile_bytes(BKV, HD);  // the K tile; the V tile
  static constexpr int SLOT = 2 * bf16_tile_bytes(BQ, HD);   // Q, then dO
  static constexpr int STATS = 2 * BQ * 4;                 // LSE, then D (fp32)
  static constexpr int DS_BYTES = kDQ ? BKV * BQ * 2 : 0;  // one dS^T buffer
  static constexpr int DS_BUFS = NC;
  static constexpr int STAGE = kDQ ? NC * 4 * WARP_STAGE : 0;  // dQ partials, a stage a warp
  static constexpr int LAG = SPLIT == 1 ? NC - 1 : 0;
  static constexpr int SMEM =
      2 * KV_BYTES + NS * (SLOT + STATS) + DS_BUFS * DS_BYTES + STAGE + ALIGN_SLACK;
  static constexpr int PER_SM = per_sm(NC, SMEM);
  static_assert(SMEM <= SMEM_LIMIT, "the dK/dV tiles do not fit a CTA's shared memory");
};

// The dQ kernel's geometry at head width HD: one consumer warpgroup of 64 Q
// rows (the Q and dO tiles) and a ring of NS slots of BK keys (K, then V;
// at d 128 the last tile of an odd multiple of 64 keys is half zeros,
// masked). On the H100 at d 128 two warpgroups of 64 rows a CTA, or 64-key
// slots, measured slower.
template <int NS, int BK_, int HD>
struct DqTile {
  static constexpr int BQ = WG_ROWS;  // Q rows per CTA
  static constexpr int BK = BK_;      // keys per slot
  static constexpr int THREADS = 128;
  static constexpr int BOXES = HD / BOX_COLS;
  static constexpr int Q_BYTES = bf16_tile_bytes(BQ, HD);    // the Q tile; the dO tile
  static constexpr int SLOT = 2 * bf16_tile_bytes(BK, HD);   // K, then V
  static constexpr int SMEM = 2 * Q_BYTES + NS * SLOT + ALIGN_SLACK;
  static constexpr int PER_SM = per_sm(1, SMEM);
  static_assert(SMEM <= SMEM_LIMIT, "the dQ ring does not fit a CTA's shared memory");
};

// The launches per head width (ops/flash_backward.py::plan mirrors them):
// the dK/dV kernel's (consumer warpgroups, ring slots, with dQ, HD) for K2
// and for K3's first half, and the dQ kernel's (ring slots, keys a slot,
// HD).
#define FUSED_TILE_128 2, 3, true, 128
#define DKV_TILE_128 1, 2, false, 128
#define DQ_TILE_128 1, 128, 128
#define FUSED_TILE_256 2, 1, true, 256
#define DKV_TILE_256 2, 2, false, 256
#define DQ_TILE_256 2, 64, 256

// ---------------------------------------------------------------------------
// The dK/dV walk. Its CTA owns keys kv0 .. kv_end - 1 and visits the Q tiles
// [qf, ql] (bq rows each) that some of its keys are visible to: causal rows
// from the first whose last row reaches kv0, to the last whose first row
// lies within the window of kv_end - 1 (the TPU kernel's _block_visible).
__device__ __forceinline__ void dkv_q_tiles(const Params& p, int kv0, int kv_end, int bq,
                                            int& qf, int& ql) {
  qf = 0;
  ql = p.seq_q / bq - 1;
  if (p.causal) {
    const int lo = kv0 - p.q_offset - (bq - 1);
    if (lo > 0) qf = (lo + bq - 1) / bq;
    if (p.window) {
      const int hi = p.window + kv_end - 2 - p.q_offset;
      ql = hi < 0 ? -1 : min(ql, hi / bq);
    }
  }
}

// One consumer warpgroup's 64 keys from k_lo, against the Q rows at
// positions p_lo .. p_lo + bq - 1 (RowGroup's tests with the roles of rows
// and keys exchanged).
struct KeyGroup {
  int k_lo;

  __device__ __forceinline__ bool sees(int causal, int window, int p_lo, int bq) const {
    return !causal ||
           (k_lo <= p_lo + bq - 1 && (!window || p_lo - (k_lo + WG_ROWS - 1) < window));
  }

  __device__ __forceinline__ bool needs_mask(int causal, int window, int p_lo, int bq) const {
    return causal && (k_lo + WG_ROWS - 1 > p_lo || (window && p_lo + bq - 1 - k_lo >= window));
  }
};

// ---------------------------------------------------------------------------
// The gradient of one block of scores, in place on the accumulators of S and
// dP as wgmma left them: s becomes P, dp becomes dS * scale. With kT the
// block is transposed (rows are keys, columns Q rows; the LSE and D of each
// column come from shared memory, col_stats: LSE then D, bq apart), else
// rows are Q rows (LSE * log2e and D of this thread's two rows in
// row_lse2, row_dsum) and columns keys. row_pos and col_pos: the position
// of this thread's first row and of column 0. The softcap and the mask are
// tested once a tile (the branch in grad_tile), not once a score. (P first,
// while dP's product still runs, then dS while dV's runs, measured slower
// on the H100 and spilled K2.)
struct GradMath {
  int causal, window, seq_kv;
  float scale, softcap;
};

struct BlockStats {
  const float* col_stats;
  int bq;
  float row_lse2[2], row_dsum[2];
};

template <int N, bool kT, bool CAP, bool MASK>
__device__ __forceinline__ void grad_block(float (&s)[N], float (&dp)[N], const GradMath& gm,
                                           const BlockStats& bs, int row_pos, int col_pos) {
  const int q = threadIdx.x & 3;
  const float c_log2 = gm.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = 8 * j + 2 * q;
    float2 lse2 = make_float2(0.f, 0.f), dsum = lse2;
    if constexpr (kT) {
      const float2 l = *reinterpret_cast<const float2*>(bs.col_stats + col);
      lse2 = make_float2(l.x * LOG2E, l.y * LOG2E);
      dsum = *reinterpret_cast<const float2*>(bs.col_stats + bs.bq + col);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, c = e & 1;
      const float l2 = kT ? (c ? lse2.y : lse2.x) : bs.row_lse2[r];
      const float dd = kT ? (c ? dsum.y : dsum.x) : bs.row_dsum[r];
      const float x = s[4 * j + e];
      float pe, ds_scale = gm.scale;
      if constexpr (CAP) {
        const float th = tanhf(x * (gm.scale / gm.softcap));
        ds_scale *= 1.f - th * th;
        pe = fast_exp2(fmaf(th, gm.softcap * LOG2E, -l2));
      } else {
        pe = fast_exp2(fmaf(x, c_log2, -l2));
      }
      if constexpr (MASK) {
        const int rp = row_pos + 8 * r, cp = col_pos + col + c;
        if (!(kT ? visible(gm.causal, gm.window, gm.seq_kv, cp, rp)
                 : visible(gm.causal, gm.window, gm.seq_kv, rp, cp)))
          pe = 0.f;
      }
      s[4 * j + e] = pe;
      dp[4 * j + e] = pe * (dp[4 * j + e] - dd) * ds_scale;
    }
  }
}

template <int N, bool kT>
__device__ __forceinline__ void grad_tile(float (&s)[N], float (&dp)[N], const GradMath& gm,
                                          bool masked, const BlockStats& bs, int row_pos,
                                          int col_pos) {
  if (gm.softcap > 0.f) {
    if (masked) grad_block<N, kT, true, true>(s, dp, gm, bs, row_pos, col_pos);
    else grad_block<N, kT, true, false>(s, dp, gm, bs, row_pos, col_pos);
  } else {
    if (masked) grad_block<N, kT, false, true>(s, dp, gm, bs, row_pos, col_pos);
    else grad_block<N, kT, false, false>(s, dp, gm, bs, row_pos, col_pos);
  }
}

// ---------------------------------------------------------------------------
// K2's dQ: dS^T into a swizzled (BKV x 64) act_t buffer, the partial dS K,
// and its 16-byte atomic adds.

// This thread's dS^T fragments (da: A fragments of its warp's 16 KV rows,
// rows krow and krow + 8 of the buffer) into the buffer. SPLIT warpgroups
// hold the same fragments: warpgroup `part` of them stores its share of
// the 16-column groups.
template <int SPLIT>
__device__ __forceinline__ void store_ds_t(uint8_t* buf, int bkv, const uint32_t (&da)[4][4],
                                           int krow, int part) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (kk / (4 / SPLIT) == part)
        *reinterpret_cast<uint32_t*>(
            buf + bf16_tile_offset(bkv, krow + 8 * (r & 1), 16 * kk + 8 * (r >> 1) + 2 * q)) =
            da[kk][r];
}

// This warp's 16 rows of an m64n64 accumulator into its stage: columns
// 0-31 and 32-63 as two boxes of 16 rows of 128 bytes, 128-byte swizzled.
__device__ __forceinline__ void stage_dq(uint8_t* stage, const float (&acc)[BOX_COLS / 2]) {
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int j = 0; j < BOX_COLS / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (lane >> 2) + 8 * h, c = 8 * (j & 3) + 2 * q;
      *reinterpret_cast<float2*>(stage + (j >> 2) * (WARP_STAGE / 2) + r * 128 +
                                 (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

// Issue 64 columns of dQ's partial = dS K (one wgmma group): A = dS read
// MN-major from the dS^T buffer (BKV rows of 64 Q columns), B = K read
// MN-major from box col0 / 64 of the K tile (BKV rows), columns col0 ..
// col0 + 63.
template <int BKV>
__device__ __forceinline__ void issue_dq(float (&acc)[BOX_COLS / 2], unsigned ds_addr,
                                         unsigned k_addr, int col0) {
  const unsigned kb = k_addr + (col0 / BOX_COLS) * bf16_box_bytes(BKV);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_ss_n64<1, 1>(acc, sw128_mn_desc(ds_addr + kk * 2048, bf16_box_bytes(BKV)),
                       sw128_mn_desc(kb + kk * 2048, bf16_box_bytes(BKV)), kk > 0);
  wgmma_commit();
}

// ---------------------------------------------------------------------------
// The ring. Thread 0 issues every copy, so that a CTA is consumer
// warpgroups only (NC * 128 threads): a ninth warp would put three warps
// on one of the SM's four register files, and ptxas then sizes the CTA
// for 168 registers a thread. After step i of the walk it refills the slot
// of step i - LAG with step i - LAG + NS once every consumer warp has
// released it: with one warpgroup (LAG 0) that is its own slot (it waits
// only for its other warps); with two that own different KV rows (LAG 1),
// the slot the other warpgroup released one step earlier, so that the two
// need not finish a step together; with two that share them (d 256, LAG
// 0), the slot both have just released.
template <int LAG, int NS, typename Load>
__device__ __forceinline__ void refill(int tid, int i, int n, uint64_t* empty, Load&& load) {
  const int j = i - LAG;
  if (tid == 0 && j >= 0 && j + NS < n) {
    mbar_wait(&empty[j % NS], (j / NS) & 1);
    load(j + NS);
  }
}

// ---------------------------------------------------------------------------
// dK/dV for one (BKV KV rows, KV head, batch); with kDQ also dQ's
// partials.
template <int NC, int NS, bool kDQ, int HD>
__global__ void __launch_bounds__(DkvTile<NC, NS, kDQ, HD>::THREADS,
                                  DkvTile<NC, NS, kDQ, HD>::PER_SM)
flash_backward_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_dq, const Params p) {
  using T = DkvTile<NC, NS, kDQ, HD>;
  constexpr int BKV = T::BKV, BQ = T::BQ;
  constexpr int N_DQ = HD / NC;  // dQ columns of one warpgroup's partial
  constexpr int COLS = HD / T::SPLIT;  // dK and dV columns of one warpgroup (128)
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[NS], empty[NS];
  uint8_t* k_s = align_1024(smem_raw);
  uint8_t* v_s = k_s + T::KV_BYTES;
  uint8_t* ring = v_s + T::KV_BYTES;             // NS slots: Q, then dO
  uint8_t* ds_s = ring + NS * T::SLOT;           // DS_BUFS dS^T buffers (kDQ)
  uint8_t* stage_s = ds_s + T::DS_BUFS * T::DS_BYTES;  // a dQ stage a warp (kDQ)
  float* stats = reinterpret_cast<float*>(stage_s + T::STAGE);  // NS x (LSE, D)

  const int tid = threadIdx.x;
  // The KV tile is the slowest grid axis, so blocks start in tile order:
  // low KV tiles see the most causal rows and start first.
  const int hk = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * BKV;
  int qf, ql;
  dkv_q_tiles(p, kv0, min(kv0 + BKV, p.seq_kv), BQ, qf, ql);
  const int nq = max(ql - qf + 1, 0);
  const int n = nq * p.group;  // (head of the group, Q tile) pairs

  if (tid == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Pair i's Q and dO tiles and LSE and D rows into slot i % NS.
  auto load_pair = [&](int i) {
    const int s = i % NS;
    const int h = hk * p.group + i / nq, q0 = (qf + i % nq) * BQ;
    uint8_t* slot = ring + s * T::SLOT;
    uint8_t* do_slot = slot + bf16_tile_bytes(BQ, HD);
    mbar_arrive_expect_tx(&full[s], T::SLOT + T::STATS);
#pragma unroll
    for (int bx = 0; bx < T::BOXES; ++bx)
      tma_load_4d(slot + bx * bf16_box_bytes(BQ), &tm_q, bx * BOX_COLS, q0, h, b, &full[s]);
#pragma unroll
    for (int bx = 0; bx < T::BOXES; ++bx)
      tma_load_4d(do_slot + bx * bf16_box_bytes(BQ), &tm_do, bx * BOX_COLS, q0, h, b,
                  &full[s]);
    const long long row = ((long long)b * p.heads + h) * p.seq_q + q0;
    float* st = stats + s * 2 * BQ;
    bulk_load(st, p.lse + row, BQ * 4, &full[s]);
    bulk_load(st + BQ, p.dsum + row, BQ * 4, &full[s]);
  };
  if (tid == 0 && n > 0) {  // thread 0 issues every copy: K, V, the first slots
    mbar_arrive_expect_tx(&kv_full, 2 * T::KV_BYTES);
#pragma unroll
    for (int bx = 0; bx < T::BOXES; ++bx)
      tma_load_4d(k_s + bx * bf16_box_bytes(BKV), &tm_k, bx * BOX_COLS, kv0, hk, b, &kv_full);
#pragma unroll
    for (int bx = 0; bx < T::BOXES; ++bx)
      tma_load_4d(v_s + bx * bf16_box_bytes(BKV), &tm_v, bx * BOX_COLS, kv0, hk, b, &kv_full);
    for (int i = 0; i < min(NS, n); ++i) load_pair(i);
  }

  const int cw = tid / 128, warp = (tid >> 5) & 3, lane = tid & 31;
  const int rg = cw / T::SPLIT;    // the warpgroup's 64 KV rows: group rg of the CTA
  const int half = cw % T::SPLIT;  // its columns of dK and dV: half * 128 on
  const KeyGroup kg{kv0 + rg * WG_ROWS};
  const bool active = kg.k_lo < p.seq_kv;  // the ragged last tile's second half is not
  const int krow = rg * WG_ROWS + warp * 16 + (lane >> 2);  // this thread's first row in the CTA
  const GradMath gm{p.causal, p.window, p.seq_kv, p.scale, p.softcap};
  const unsigned k_addr = smem_addr(k_s), v_addr = smem_addr(v_s);
  const unsigned kw_addr = k_addr + rg * WG_ROWS * 128, vw_addr = v_addr + rg * WG_ROWS * 128;
  // Byte offset of this warpgroup's columns in a Q or dO tile (two boxes).
  const unsigned half_off = half * 2 * bf16_box_bytes(BQ);

  float dk[COLS / 2], dv[COLS / 2];
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) dk[i] = dv[i] = 0.f;

  if (n > 0) mbar_wait(&kv_full, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % NS;
    mbar_wait(&full[s], (i / NS) & 1);
    const int h = hk * p.group + i / nq, q0 = (qf + i % nq) * BQ;
    const int p_lo = p.q_offset + q0;  // position of the tile's first Q row
    const unsigned q_addr = smem_addr(ring + s * T::SLOT);
    const unsigned do_addr = q_addr + bf16_tile_bytes(BQ, HD);
    uint8_t* ds = ds_s + (i % T::DS_BUFS) * T::DS_BYTES;
    if (active && kg.sees(p.causal, p.window, p_lo, BQ)) {
      float st[BQ / 2], dpt[BQ / 2];
      issue_qk<BQ, HD>(st, kw_addr, bf16_box_bytes(BKV), q_addr);    // S^T = K Q^T
      issue_qk<BQ, HD>(dpt, vw_addr, bf16_box_bytes(BKV), do_addr);  // dP^T = V dO^T
      wgmma_wait<0>();
      grad_tile<BQ / 2, true>(st, dpt, gm, kg.needs_mask(p.causal, p.window, p_lo, BQ),
                              BlockStats{stats + s * 2 * BQ, BQ, {0.f, 0.f}, {0.f, 0.f}},
                              kv0 + krow, p_lo);
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      pack_p<BQ>(st, pa);
      issue_pv<BQ>(dv, pa, do_addr + half_off);  // dV += P^T dO
      pack_p<BQ>(dpt, da);
      if constexpr (kDQ) store_ds_t<T::SPLIT>(ds, BKV, da, krow, half);
      issue_pv<BQ>(dk, da, q_addr + half_off);  // dK += dS^T Q
    } else if constexpr (kDQ) {
      // Keys this pair cannot see (or past seq_kv) add nothing to dQ: the
      // SPLIT warpgroups of the row group zero its rows of the buffer.
      constexpr int RG_THREADS = T::SPLIT * 128;
      uint4* rows = reinterpret_cast<uint4*>(ds + rg * WG_ROWS * 128);
#pragma unroll
      for (int c = 0; c < WG_ROWS * 128 / 16 / RG_THREADS; ++c)
        rows[(tid & (RG_THREADS - 1)) + c * RG_THREADS] = make_uint4(0, 0, 0, 0);
    }
    if constexpr (kDQ) {
      fence_proxy_async();  // dS^T's stores, before wgmma reads them
      named_bar_sync(DQ_BAR, NC * 128);
      // This warp's 16 rows of the partial: first rows of dQ's 2-D view.
      const int dq_row = (int)(((long long)b * p.heads + h) * p.seq_q + q0 + warp * 16);
      uint8_t* stage = stage_s + (tid >> 5) * WARP_STAGE;
#pragma unroll
      for (int c = 0; c < N_DQ / BOX_COLS; ++c) {  // 64 columns at a time
        float dq[BOX_COLS / 2];
        issue_dq<BKV>(dq, smem_addr(ds), k_addr, cw * N_DQ + c * BOX_COLS);
        wgmma_wait<0>();
        if (lane == 0) bulk_wait<0>();  // the stage's last reduce has read it
        __syncwarp();
        stage_dq(stage, dq);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          const int col = cw * N_DQ + c * BOX_COLS;
          tma_reduce_add_2d(&tm_dq, stage, col, dq_row);
          tma_reduce_add_2d(&tm_dq, stage + WARP_STAGE / 2, col + BOX_COLS / 2, dq_row);
          bulk_commit();
        }
      }
    } else {
      wgmma_wait<0>();
    }
    if (lane == 0) mbar_arrive(&empty[s]);
    refill<T::LAG, NS>(tid, i, n, empty, load_pair);
  }

  if (kDQ && lane == 0) bulk_wait<0, true>();  // the adds have completed
  // dK and dV of this thread's rows, cast to act_t.
  if (!active) return;
  const int q = lane & 3;
  const long long out_row = ((long long)b * p.kv_heads + hk) * p.seq_kv + kv0 + krow;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    act_t* dk_row = p.dk + (out_row + 8 * r) * HD + half * COLS;
    act_t* dv_row = p.dv + (out_row + 8 * r) * HD + half * COLS;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      store_act2(dk_row + 8 * j + 2 * q, dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      store_act2(dv_row + 8 * j + 2 * q, dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// dQ for one (64 Q rows, Q head, batch), summed in registers over the
// visible KV tiles.
template <int NS, int BK_, int HD>
__global__ void __launch_bounds__(DqTile<NS, BK_, HD>::THREADS, DqTile<NS, BK_, HD>::PER_SM)
flash_backward_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using T = DqTile<NS, BK_, HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[NS], empty[NS];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* do_s = q_s + T::Q_BYTES;
  uint8_t* ring = do_s + T::Q_BYTES;

  const int tid = threadIdx.x;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = q_tile * T::BQ;
  const int q_min = p.q_offset + q0;
  int first, last;
  cta_tiles(p.causal, p.window, q_min, T::BQ, p.seq_kv, T::BK, first, last);
  const int n = max(last - first + 1, 0);

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // KV tile i's K and V tiles into slot i % NS.
  auto load_kv = [&](int i) {
    const int s = i % NS;
    uint8_t* slot = ring + s * T::SLOT;
    const int kv0 = (first + i) * T::BK;
    mbar_arrive_expect_tx(&full[s], T::SLOT);
#pragma unroll
    for (int bx = 0; bx < T::BOXES; ++bx)
      tma_load_4d(slot + bx * bf16_box_bytes(T::BK), &tm_k, bx * BOX_COLS, kv0, hk, b,
                  &full[s]);
    uint8_t* vs = slot + bf16_tile_bytes(T::BK, HD);
#pragma unroll
    for (int bx = 0; bx < T::BOXES; ++bx)
      tma_load_4d(vs + bx * bf16_box_bytes(T::BK), &tm_v, bx * BOX_COLS, kv0, hk, b, &full[s]);
  };
  if (tid == 0) {  // thread 0 issues every copy: Q, dO, the first slots
    mbar_arrive_expect_tx(&q_full, 2 * T::Q_BYTES);
#pragma unroll
    for (int bx = 0; bx < T::BOXES; ++bx)
      tma_load_4d(q_s + bx * bf16_box_bytes(T::BQ), &tm_q, bx * BOX_COLS, q0, h, b, &q_full);
#pragma unroll
    for (int bx = 0; bx < T::BOXES; ++bx)
      tma_load_4d(do_s + bx * bf16_box_bytes(T::BQ), &tm_do, bx * BOX_COLS, q0, h, b,
                  &q_full);
    for (int i = 0; i < min(NS, n); ++i) load_kv(i);
  }

  const int lane = tid & 31;
  const RowGroup rg{q_min, T::BQ};
  const int row = q0 + (tid >> 5) * 16 + (lane >> 2);  // this thread's rows: row, row + 8
  const long long bh_row = ((long long)b * p.heads + h) * p.seq_q;
  const BlockStats bs{nullptr, 0,
                      {p.lse[bh_row + row] * LOG2E, p.lse[bh_row + row + 8] * LOG2E},
                      {p.dsum[bh_row + row], p.dsum[bh_row + row + 8]}};
  const GradMath gm{p.causal, p.window, p.seq_kv, p.scale, p.softcap};
  const unsigned q_addr = smem_addr(q_s), do_addr = smem_addr(do_s);

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  mbar_wait(&q_full, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % NS;
    mbar_wait(&full[s], (i / NS) & 1);
    const int kv0 = (first + i) * T::BK;
    if (rg.sees(p.causal, p.window, kv0, T::BK)) {
      const unsigned k_addr = smem_addr(ring + s * T::SLOT);
      const unsigned v_addr = k_addr + bf16_tile_bytes(T::BK, HD);
      float sc[T::BK / 2], dp[T::BK / 2];
      issue_qk<T::BK, HD>(sc, q_addr, bf16_box_bytes(T::BQ), k_addr);  // S = Q K^T
      issue_qk<T::BK, HD>(dp, do_addr, bf16_box_bytes(T::BQ), v_addr);  // dP = dO V^T
      wgmma_wait<0>();
      grad_tile<T::BK / 2, false>(sc, dp, gm,
                                  rg.needs_mask(p.causal, p.window, kv0, T::BK, p.seq_kv), bs,
                                  p.q_offset + row, kv0);
      uint32_t da[T::BK / 16][4];
      pack_p<T::BK>(dp, da);
      issue_pv<T::BK, HD>(dq, da, k_addr);  // dQ += dS K
      wgmma_wait<0>();
    }
    if (lane == 0) mbar_arrive(&empty[s]);
    refill<0, NS>(tid, i, n, empty, load_kv);
  }

  const int q = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    act_t* dq_row = p.dq + (bh_row + row + 8 * r) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store_act2(dq_row + 8 * j + 2 * q, dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// Host side.

struct Maps {
  CUtensorMap q, dout, k, v, dq;
};

// Tensor maps of q, dO (boxes of q_rows) and k, v (boxes of kv_rows) over
// their (b, h, s, hd) views; s: their element strides (q, k, v, dO).
bool encode_maps(Maps& m, const void* q, const void* k, const void* v, const void* dout,
                 const long long (&s)[12], int batch, const Params& p, int hd, int q_rows,
                 int kv_rows) {
  const auto bf = ACT_TMAP;
  return encode_bhsd(&m.q, bf, q, batch, p.heads, p.seq_q, hd, s[0] * 2, s[1] * 2, s[2] * 2,
                     q_rows, BOX_COLS, true) &&
         encode_bhsd(&m.k, bf, k, batch, p.kv_heads, p.seq_kv, hd, s[3] * 2, s[4] * 2,
                     s[5] * 2, kv_rows, BOX_COLS, true) &&
         encode_bhsd(&m.v, bf, v, batch, p.kv_heads, p.seq_kv, hd, s[6] * 2, s[7] * 2,
                     s[8] * 2, kv_rows, BOX_COLS, true) &&
         encode_bhsd(&m.dout, bf, dout, batch, p.heads, p.seq_q, hd, s[9] * 2, s[10] * 2,
                     s[11] * 2, q_rows, BOX_COLS, true);
}

template <int NC, int NS, bool kDQ, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const long long (&s)[12], int batch, const Params& p, cudaStream_t stream) {
  using T = DkvTile<NC, NS, kDQ, HD>;
  Maps m = {};
  // K2's dQ workspace as (batch * heads * seq_q, HD) fp32 rows, boxes of a
  // warp's 16 rows x 32 columns.
  if (!encode_maps(m, q, k, v, dout, s, batch, p, HD, T::BQ, T::BKV) ||
      (kDQ && !encode_2d(&m.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.dq_acc,
                         (long long)batch * p.heads * p.seq_q, HD, 16, BOX_COLS / 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_backward_dkv_kernel<NC, NS, kDQ, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.kv_heads, batch, (p.seq_kv + T::BKV - 1) / T::BKV);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(m.q, m.dout, m.k, m.v, m.dq, p);
  return static_cast<int>(cudaGetLastError());
}

template <int NS, int BK, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const long long (&s)[12], int batch, const Params& p, cudaStream_t stream) {
  using T = DqTile<NS, BK, HD>;
  Maps m = {};
  if (!encode_maps(m, q, k, v, dout, s, batch, p, HD, T::BQ, T::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_backward_dq_kernel<NS, BK, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.seq_q / T::BQ, p.heads, batch);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(m.q, m.dout, m.k, m.v, p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* lse, const void* dsum, void* dq, void* dk, void* dv, int heads,
                   int kv_heads, int seq_q, int seq_kv, int causal, int q_offset, int window,
                   float scale, float softcap) {
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.dq_acc = static_cast<float*>(dq);
  p.dq = static_cast<act_t*>(dq);
  p.dk = static_cast<act_t*>(dk);
  p.dv = static_cast<act_t*>(dv);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.group = heads / kv_heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.causal = causal;
  p.q_offset = q_offset;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  return p;
}

}  // namespace

// The head width of this library's entry points: 128, or 256 where
// flash_backward_d256.cu builds this file. In one file with the d-256
// kernels, nvcc compiled K2's d-128 kernel to 253 registers in place of
// 248 (the helper functions the two K2 kernels share were optimized for
// both), so each width is a library of its own.
#ifndef BACKWARD_HD
#define BACKWARD_HD 128
#endif
#define TILE_OF(name, hd) TILE_OF_(name, hd)
#define TILE_OF_(name, hd) name##_##hd

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Common arguments of the three entry points. q, dout (b, heads, seq_q,
// d_head) and k, v (b, kv_heads, seq_kv, d_head), d_head BACKWARD_HD, are
// act_t (bf16, or fp16 in an FA_F16 library) with the given element
// strides (d contiguous, strides multiples of 8 elements, base 16-byte
// aligned); lse and dsum are (b, heads, seq_q) fp32 contiguous, 16-byte
// aligned. Outputs are contiguous. seq_q and seq_kv are
// multiples of 64. Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for another head width or when a tensor map cannot
// be encoded.
#define FA_BWD_ARGS                                                              \
  const void *q, const void *k, const void *v, const void *dout,                 \
      const void *lse, const void *dsum, void *dq, void *dk, void *dv,          \
      long long q_sb, long long q_sh, long long q_ss, long long k_sb,            \
      long long k_sh, long long k_ss, long long v_sb, long long v_sh,            \
      long long v_ss, long long o_sb, long long o_sh, long long o_ss, int batch, \
      int heads, int kv_heads, int seq_q, int seq_kv, int causal, int q_offset,  \
      int window, float scale, float softcap, int d_head, void *stream

#define FA_BWD_PARAMS                                                            \
  const long long s[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,                   \
                           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};                  \
  const Params p = make_params(lse, dsum, dq, dk, dv, heads, kv_heads, seq_q,    \
                               seq_kv, causal, q_offset, window, scale, softcap); \
  cudaStream_t st = static_cast<cudaStream_t>(stream)

// K2: dK, dV (act_t) and dQ added into dq, a zeroed fp32 workspace.
int fa_flash_backward_fused(FA_BWD_ARGS) {
  FA_BWD_PARAMS;
  if (d_head != BACKWARD_HD) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dkv<TILE_OF(FUSED_TILE, BACKWARD_HD)>(q, k, v, dout, s, batch, p, st);
}

// K3, first half: dK and dV only (dq is unused).
int fa_flash_backward_dkv(FA_BWD_ARGS) {
  FA_BWD_PARAMS;
  if (d_head != BACKWARD_HD) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dkv<TILE_OF(DKV_TILE, BACKWARD_HD)>(q, k, v, dout, s, batch, p, st);
}

// K3, second half: dQ (act_t) into dq (dk and dv are unused).
int fa_flash_backward_dq(FA_BWD_ARGS) {
  FA_BWD_PARAMS;
  if (d_head != BACKWARD_HD) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dq<TILE_OF(DQ_TILE, BACKWARD_HD)>(q, k, v, dout, s, batch, p, st);
}

}  // extern "C"
