// The attention main loop for Hopper, shared by K1 (flash_forward.cu), K11
// (flash_forward_fori.cu) and K10's bf16 upcast modes (flash_quant.cu), each
// at head width 128 or 256; K10's int8-compute kernel shares its CTA, walk,
// masks and finalisation, and the backward (flash_backward.cu) its walk,
// masks and tile products. The head width HD is a template parameter of
// the tile products, the row state, the consumer's walk and the
// finalisation; it defaults to D = 128.
//
// A CTA is one producer warpgroup and two consumer warpgroups of 64 Q rows
// each, BQ = 128 Q rows of one (Q head, batch). The producer fills a ring of
// K/V slots through TMA (and, for K10, converts raw bytes into them); each
// slot has a full and an empty mbarrier. A consumer warpgroup computes, per
// BK-key tile, S = Q K^T on wgmma m64nBKk16 (Q and K from 128-byte-swizzled
// shared memory, K-major as stored), the fp32 online softmax in the exp2
// domain in registers (each row's max and sum over the four threads of a
// quad, as the accumulator layout spreads a row), then O += P V on wgmma
// m64n128k16 with P's accumulator repacked as 16-bit A fragments in
// registers and V read MN-major (the transpose bit); the two consumer warpgroups
// interleave on the tensor cores, one's softmax beside the other's
// products. A slot is released once its P V product has completed
// (wgmma.wait_group in each warp, then one arrival per warp).
//
// Shared-memory layout of a bf16 (rows x HD) tile: HD / 64 128-byte-swizzled
// boxes of 64 columns (two at HD 128, four at 256), each rows x 128 bytes
// (the layout a TMA box of 64 bf16 columns with CU_TENSOR_MAP_SWIZZLE_128B
// writes).
//
// The 16-bit type of Q, K, V, P and O is the library's act_t (hopper.cuh):
// bf16, or fp16 in the fp16 libraries of K1 and K11 (flash_forward_f16.cu,
// flash_forward_fori*_f16.cu), which have bf16's tile bytes; a "bf16" tile
// below is an act_t tile there.
//
// At HD 256 a 64 x 256 fp32 O accumulator is 128 registers a consumer
// thread, which a CTA of more than 8 warps (at most 168 registers a thread)
// cannot hold beside S and P: the d-256 CTAs of K1, K10 and K11 have one
// consumer warpgroup (CtaShape<256>), and O += P V is two m64n128 products
// a k step, one per 128-column half of V and O.

#pragma once

#include "hopper.cuh"

namespace {

constexpr int D = 128;                       // head width (the default HD)
constexpr int WG_ROWS = 64;                  // Q rows of one consumer warpgroup
constexpr int CONSUMER_WGS = 2;
constexpr int BQ = CONSUMER_WGS * WG_ROWS;   // Q rows per CTA
constexpr int THREADS = (CONSUMER_WGS + 1) * 128;  // + the producer warpgroup
constexpr int BOX_COLS = 64;                 // bf16 columns of one swizzled box
constexpr int SMEM_LIMIT = 232448;           // shared memory a block may use
constexpr int ALIGN_SLACK = 1024;            // swizzled tiles start 1024-aligned
constexpr int CONSUMER_ARRIVALS = CONSUMER_WGS * 4;  // one per consumer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_VALUE = -1e30f;  // finite, as in the JAX kernels

// The CTA of K10 and K11 at head width HD: a producer warpgroup and
// CONSUMERS consumer warpgroups of 64 Q rows, two at HD 128 (the CTA
// above), one at 256.
template <int HD>
struct CtaShape {
  static_assert(HD == 128 || HD == 256, "head widths 128 and 256");
  static constexpr int CONSUMERS = HD == 128 ? CONSUMER_WGS : 1;
  static constexpr int BQ = CONSUMERS * WG_ROWS;         // Q rows per CTA
  static constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
  static constexpr int ARRIVALS = CONSUMERS * 4;         // one per consumer warp
  static constexpr int BOXES = HD / BOX_COLS;            // 64-column boxes of a bf16 tile
};

// Bytes of a bf16 (rows x d) tile, and of one of its 64-column boxes.
__host__ __device__ constexpr int bf16_tile_bytes(int rows, int d = D) { return rows * d * 2; }
__host__ __device__ constexpr int bf16_box_bytes(int rows) { return rows * BOX_COLS * 2; }

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// Byte offset of bf16 element (r, c) in a swizzled (rows x d) tile, any
// width d (box c / 64).
__device__ __forceinline__ int bf16_tile_offset(int rows, int r, int c) {
  return (c / BOX_COLS) * bf16_box_bytes(rows) + r * 128 +
         ((((c % BOX_COLS) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// ---------------------------------------------------------------------------
// The walk. These are the function's semantics (JAX ops/flash_forward.py and
// ops/flash_quant.py): causal masks compare positions (Q row i sits at
// q_offset + i), a window of w keeps keys with qpos - kpos < w, keys at or
// past seq_kv (the zero-filled tail of a ragged last tile) are masked, and
// a window applies only with the causal mask.

// The CTA's visible KV tiles [first, last] (bk keys each): its Q rows sit at
// positions q_min .. q_min + q_rows - 1.
__device__ __forceinline__ void cta_tiles(int causal, int window, int q_min, int q_rows,
                                          int seq_kv, int bk, int& first, int& last) {
  first = 0;
  last = (seq_kv + bk - 1) / bk - 1;
  if (causal) {
    last = min(last, (q_min + q_rows - 1) / bk);
    if (window) first = max(0, q_min - window + 1) / bk;
  }
}

// One consumer warpgroup's rows: positions q_min .. q_min + rows - 1 (rows
// 0 when all 64 lie past seq_q).
struct RowGroup {
  int q_min, rows;

  // Whether some key of the bk-key tile at kv0 is visible to some row.
  __device__ __forceinline__ bool sees(int causal, int window, int kv0, int bk) const {
    if (rows <= 0) return false;
    if (!causal) return true;
    return kv0 <= q_min + rows - 1 && (!window || kv0 + bk - 1 > q_min - window);
  }

  // Whether the tile holds a key that some row may not see, so that its
  // scores need the per-element mask.
  __device__ __forceinline__ bool needs_mask(int causal, int window, int kv0, int bk,
                                             int seq_kv) const {
    return kv0 + bk > seq_kv ||
           (causal && (kv0 + bk - 1 > q_min || (window && kv0 <= q_min + WG_ROWS - 1 - window)));
  }
};

__device__ __forceinline__ bool visible(int causal, int window, int seq_kv, int qpos, int kpos) {
  return kpos < seq_kv && (!causal || (kpos <= qpos && (!window || qpos - kpos < window)));
}

// ---------------------------------------------------------------------------
// The consumer's state and its work on one tile.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What a consumer thread holds of its warpgroup's 64 rows: its part of the
// 64 x HD O accumulator (rows g and g + 8 of its warp's 16; at HD 256 the
// m64n128 accumulator of columns 0-127, then that of columns 128-255), their
// running max in the log2 domain and its partial row sums.
template <int HD = D>
struct RowStateT {
  float o[HD / 2];
  float m[2];
  float l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // O *= alpha per row.
  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  }
};
using RowState = RowStateT<>;

// exp2 on the special-function unit (ex2.approx.ftz: about 2 ulp). Results
// below 2^-126 flush to zero: a weight that small beside the row's largest,
// 1, moves no fp32 sum, and int8 P rounds it to 0 anyway.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issue S = Q K^T for this warpgroup's 64 rows and the tile's BK keys (128,
// 64 or 32; committed as one wgmma group, not waited on; the first k step
// overwrites S): q_addr its rows in the Q tile (box 0; box b b * q_box
// bytes on), k_addr the K tile (BK rows; box b b * BK * 128 bytes on), HD
// columns each.
template <int BK, int HD = D>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], unsigned q_addr, int q_box,
                                         unsigned k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = sw128_desc(q_addr + (kk >> 2) * q_box + (kk & 3) * 32);
    const uint64_t db = sw128_desc(k_addr + (kk >> 2) * bf16_box_bytes(BK) + (kk & 3) * 32);
    if constexpr (BK == 128) wgmma_ss_n128(s, da, db, kk > 0);
    else if constexpr (BK == 64) wgmma_ss_n64(s, da, db, kk > 0);
    else wgmma_ss_n32(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V (one wgmma group, not waited on): pa holds P's act_t A
// fragments, v_addr the V tile (BK rows of HD d, box b b * BK * 128 bytes
// on), read MN-major. At HD 256 each k step is two m64n128 products: V's
// boxes 0-1 into o[0..63], boxes 2-3 into o[64..127].
template <int BK, int HD = D>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[BK / 16][4],
                                         unsigned v_addr) {
  static_assert(HD == 128 || HD == 256, "O is one or two m64n128 accumulators");
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    if constexpr (HD == 128) {
      wgmma_n128<1>(o, pa[kk], sw128_mn_desc(v_addr + kk * 2048, bf16_box_bytes(BK)));
    } else {
#pragma unroll
      for (int h = 0; h < HD / 128; ++h)
        wgmma_n128<1>(*reinterpret_cast<float(*)[64]>(o + 64 * h), pa[kk],
                      sw128_mn_desc(v_addr + 2 * h * bf16_box_bytes(BK) + kk * 2048,
                                    bf16_box_bytes(BK)));
    }
  }
  wgmma_commit();
}

// What a tile's scores need to become P besides their positions: the mask's
// options, the score scale and the softcap.
struct TileMath {
  int causal, window, seq_kv;
  float score_scale, softcap;
};

// 1 / x on the special-function unit (rcp.approx.ftz: about 1 ulp; 0 for
// inf).
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The FA2 softmax of one tile in registers, on S as wgmma left it: the
// softcap (tanh(x / cap) * cap) and the mask where a tile needs them, each
// row's max over the quad that shares it, S <- exp2(S * scale - m) in the
// log2 domain, the running sums. A tile with neither keeps S unscaled and
// folds the scale into the exp's FFMA (the scale is positive, so the max
// commutes with it). Returns each row's alpha = exp2(m_old - m_new) for the
// caller to rescale O. At HD 256 (K1's d-256 CTA, which has no second
// warpgroup to hide the softmax behind) the softcap's tanh is 1 - 2 / (e^2y
// + 1) on the special-function unit, one ex2 and one rcp (absolute error
// about 1e-7 of the cap, against tanhf's some 20 instructions); HD 128
// keeps tanhf.
template <int BK, int HD>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], RowStateT<HD>& st, float (&alpha)[2],
                                             const TileMath& tm, int row0, int kv0,
                                             bool masked) {
  const int q = threadIdx.x & 3;
  // Each option behind one branch a tile, so that a tile without a cap or
  // a mask does no per-score work for them.
  const float c_log2 = tm.score_scale * LOG2E;
  float cs = c_log2;  // the factor still to apply inside the exp
  if (tm.softcap > 0.f) {
    if constexpr (HD == D) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] = tanhf(s[i] * tm.score_scale / tm.softcap) * (tm.softcap * LOG2E);
    } else {
      // cap * log2(e) * tanh(y), y = x * scale / cap: cap * log2(e) * (1 -
      // 2 / (2^(2 y log2(e)) + 1)).
      const float to_exp2 = 2.f * LOG2E * tm.score_scale / tm.softcap;
      const float cap = tm.softcap * LOG2E;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] = fmaf(-2.f * cap, fast_rcp(fast_exp2(s[i] * to_exp2) + 1.f), cap);
    }
    cs = 1.f;
  } else if (masked) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= c_log2;
    cs = 1.f;
  }
  if (masked) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int qpos = row0 + ((i >> 1) & 1) * 8, kpos = kv0 + (i >> 2) * 8 + 2 * q + (i & 1);
      if (!visible(tm.causal, tm.window, tm.seq_kv, qpos, kpos)) s[i] = MASK_VALUE;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    const float m_new = fmaxf(st.m[r], mx * cs);
    alpha[r] = fast_exp2(st.m[r] - m_new);
    st.m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(fmaf(s[i], cs, -st.m[r]));
    rs[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + rs[r];
}

// P as act_t A fragments (P rounded to the inputs' type, as the JAX
// kernels' cast_p_to_dtype): the accumulator of key columns 16 kk .. 16 kk
// + 15 is P's A fragment for that k step.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_act(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Finalise this thread's two rows: full row sums over the quad, an optional
// sink (its logit in the log2 domain, -INFINITY for none) merged into the
// softmax, then O = acc / l * out_scale as act_t into o (the (batch, head)
// base, rows o_ss elements apart) at row `row` and row + 8 where they are
// below seq_q, and where lse is not null, the natural-log LSE of each row
// into lse[row].
template <int HD>
__device__ __forceinline__ void store_rows(const RowStateT<HD>& st, int row, int seq_q, act_t* o,
                                           long long o_ss, float out_scale, float sink_log2,
                                           float* lse) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = st.l[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    float m = st.m[r];
    float scale_o = 1.f;
    if (sink_log2 != -INFINITY) {
      const float m_tot = fmaxf(m, sink_log2);
      scale_o = fast_exp2(m - m_tot);
      l = l * scale_o + fast_exp2(sink_log2 - m_tot);
      m = m_tot;
    }
    const float inv = l > 0.f ? scale_o * out_scale / l : 0.f;
    const int rr = row + r * 8;
    if (rr >= seq_q) continue;
    act_t* o_row = o + rr * o_ss;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store_act2(o_row + 8 * j + 2 * q, st.o[4 * j + 2 * r] * inv,
                 st.o[4 * j + 2 * r + 1] * inv);
    if (lse && q == 0) lse[rr] = l > 0.f ? (m + log2f(l)) / LOG2E : -INFINITY;
  }
}

// A consumer warpgroup's walk over the CTA's n KV tiles from `first` (bk
// keys each) through a ring of NB slots: each tile is waited on its full
// barrier, run by `tile(i)` where the warpgroup sees some of it (returning
// once its last product has completed), and released on its empty barrier,
// in order. Tile i sits at ring position pos0 + i (slot (pos0 + i) % NB):
// a persistent CTA's walks follow each other through one ring.
template <int NB, typename Tile>
__device__ __forceinline__ void walk_tiles(const RowGroup& rg, const TileMath& tm, int bk,
                                           int first, int n, uint64_t* full, uint64_t* empty,
                                           Tile&& tile, int pos0 = 0) {
  for (int i = 0; i < n; ++i) {
    const int j = pos0 + i;
    mbar_wait(&full[j % NB], (j / NB) & 1);
    if (rg.sees(tm.causal, tm.window, (first + i) * bk, bk)) tile(i);
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[j % NB]);
  }
}

// The consumer side of the bf16 main loop: a warpgroup's walk (slot s at
// ring + s * slot_bytes: the K tile, then the V tile; the walk's first tile
// at ring position pos0), each seen tile running S = Q K^T, the softmax, O
// rescaled, then O += P V; HD columns.
template <int BK, int NB, int HD>
__device__ __forceinline__ void consume_bf16(RowStateT<HD>& st, const RowGroup& rg,
                                             uint64_t* full, uint64_t* empty,
                                             const uint8_t* ring, int slot_bytes,
                                             unsigned q_addr, int q_box, int first, int n,
                                             const TileMath& tm, int pos0 = 0) {
  const int row0 = rg.q_min + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  walk_tiles<NB>(rg, tm, BK, first, n, full, empty, [&](int i) {
    const unsigned k_addr = smem_addr(ring + ((pos0 + i) % NB) * slot_bytes);
    const int kv0 = (first + i) * BK;
    float s[BK / 2];
    issue_qk<BK, HD>(s, q_addr, q_box, k_addr);
    wgmma_wait<0>();
    float alpha[2];
    softmax_tile<BK>(s, st, alpha, tm, row0, kv0,
                     rg.needs_mask(tm.causal, tm.window, kv0, BK, tm.seq_kv));
    st.rescale(alpha);
    uint32_t pa[BK / 16][4];
    pack_p<BK>(s, pa);
    issue_pv<BK, HD>(st.o, pa, k_addr + bf16_tile_bytes(BK, HD));
    wgmma_wait<0>();
  }, pos0);
}

}  // namespace
