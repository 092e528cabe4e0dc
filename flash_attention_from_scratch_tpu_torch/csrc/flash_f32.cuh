// The fp32 attention main loop for Hopper, shared by K1's and K11's fp32
// libraries (flash_forward_f32.cu, flash_forward_fori_f32.cu and its d-256
// build flash_forward_fori_d256_f32.cu), at head width 128 or 256.
//
// The function is the JAX kernels' at DType.FP32 (ops/flash_forward.py
// _grid_kernel and _fori_kernel, whose products run at Precision.HIGHEST
// and whose cast_p_to_dtype keeps P in fp32): softmax(scale * Q K^T) V with
// an fp32 online softmax in the exp2 domain, causal masks with a q_offset, a
// sliding window, a Gemma-2 softcap, per-head attention sinks merged at
// finalisation, GQA and an optional natural-log LSE. The walk, the masks'
// semantics and the row state are flash_wgmma.cuh's (cta_tiles, RowGroup,
// TileMath, walk_tiles, RowStateT); everything that touches a tile is fp32's
// own, because three things of the 16-bit loop do not carry over: wgmma's
// transpose bit, which reads V MN-major, is for 16-bit operands only; P is
// not rounded before P V; and every tile is 4 bytes an element.
//
// Exact products on TF32 tensor cores (3xTF32). A TF32 product keeps 11
// significant bits of each operand, which misses the fp32 rule (err/bound
// 49-123 at s 512-2,048, tests/test_torch_fp32_kernels.py). Each operand x
// is split in registers into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x -
// hi), and a product is lo*hi + hi*lo + hi*hi on mma.sync m16n8k8 with fp32
// sums: 22 significant bits of each operand. Each k step's three products
// start from zero (the small ones first) and join the running sum by an
// FADD, rounded to nearest: a sum carried through the tensor cores over
// all of d (or of a tile's keys) drifted further from the plain fp32
// version at d 256 on an H100 than this form does. A tile's P V joins O by
// one FFMA a value (O = O * alpha + tile).
//
// The CTA is WARPS consumer warps of 16 Q rows (an m16 tile each) and one
// producer warp (warp 0), whose lane 0 issues every copy as a TMA box of 32
// fp32 columns (128 bytes, 128-byte swizzle) from 4-D tensor maps over the
// (b, h, s, d) views, as K11's bf16 producer does: the Q tile once, then the
// K and V tiles of each visible KV tile into a ring of NB slots (full and
// empty mbarriers; the consumers release a slot once every warp has read
// it). Fragments are loaded from shared memory by the threads themselves
// (ld.shared), so V needs no transposed copy and K and V no lo tiles: the
// A fragment of Q and the B fragments of K read rows g and columns t, t + 4
// (lane = 4 g + t), V's B fragments rows 2t, 2t + 1 of column g, each warp
// access free of bank conflicts under the swizzle. P's A fragment is the
// S accumulator as it stands, its key columns permuted (key 2t at column t,
// 2t + 1 at t + 4) and V's rows read in the same order.
//
// What bounds it: the products at 3x TF32's rate, 495 / 3 = 165 TFLOP/s of
// fp32 products on the H100's tensor cores, at every prompt length the
// model serves; mma.sync reaches a fraction of wgmma's rate. The wgmma form
// (K-major TF32 operands, V^T in shared memory, lo tiles of K and V) is left
// for a speed PR (ROADMAP).

#pragma once

#include "flash_wgmma.cuh"

namespace {

constexpr int F32_BOX_COLS = 32;   // fp32 columns of one 128-byte swizzled box
constexpr int F32_WARP_ROWS = 16;  // Q rows of one consumer warp

// Bytes of an fp32 (rows x d) tile, and of one of its 32-column boxes.
__host__ __device__ constexpr int f32_tile_bytes(int rows, int d) { return rows * d * 4; }
__host__ __device__ constexpr int f32_box_bytes(int rows) { return rows * 128; }

// The launch geometry: WARPS consumer warps of 16 Q rows and a ring of NB
// slots of BK keys (ops/flash_forward.py mirrors it in grid_plan and
// fori_plan). At most 8 warps, so that ptxas may give a thread 255
// registers (a 16 x 256 fp32 O is 128 of them); one CTA an SM.
template <int NB, int HD, int WARPS, int BK>
struct F32Tile {
  static_assert(HD == 128 || HD == 256, "head widths 128 and 256");
  static constexpr int BQ = WARPS * F32_WARP_ROWS;  // Q rows per CTA
  static constexpr int THREADS = (WARPS + 1) * 32;  // + the producer warp
  static constexpr int ARRIVALS = WARPS;            // one per consumer warp
  static constexpr int BOXES = HD / F32_BOX_COLS;   // 32-column boxes of a tile
  static constexpr int Q_BYTES = f32_tile_bytes(BQ, HD);
  static constexpr int SLOT = 2 * f32_tile_bytes(BK, HD);  // the K tile, then the V tile
  static constexpr int SMEM = Q_BYTES + NB * SLOT + ALIGN_SLACK;
  static_assert(SMEM <= SMEM_LIMIT, "the ring does not fit a CTA's shared memory");
  static_assert(WARPS + 1 <= 8, "more than 8 warps get at most 168 registers a thread");
  static_assert(BK % 8 == 0 && BK <= 256, "a slot is whole m16n8k8 steps, one TMA box deep");
};

struct F32Params {
  float* o;
  float* lse;          // (batch, heads, seq_q) or null
  const float* sinks;  // (heads,) or null
  long long o_sb, o_sh, o_ss;  // element strides; d is contiguous
  int heads, group, seq_q, seq_kv;
  int causal, q_offset, window;
  float scale, softcap;
};

__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// x = hi + lo + (a rest below 2^-22 |x|), hi and lo TF32, each rounded to
// nearest.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// d += a b on one m16n8k8 TF32 tile, fp32 sums.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// S = Q K^T for one warp's 16 rows and a tile of BK keys, in 3xTF32. q_addr
// is the warp's row 0 in box 0 of the Q tile (box b b * q_box bytes on),
// k_addr the K tile (BK rows; box b b * BK * 128 bytes on). S comes back in
// the accumulator layout of the m16n8 tiles: s[4 j + r] is row g (+ 8 for r
// >= 2), key 8 j + 2 t + (r & 1).
template <int BK, int HD>
__device__ __forceinline__ void qk_f32(float (&s)[BK / 2], unsigned q_addr, int q_box,
                                       unsigned k_addr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  // Row g of the warp's 16 (and of each 8-key group of K) sits at a row
  // whose low three bits are g: the swizzle XORs the 16-byte chunk with g.
  const unsigned qa = q_addr + g * 128 + t * 4, ka = k_addr + g * 128 + t * 4;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const unsigned box = kk >> 2;  // four 8-column k steps a box
    const unsigned c0 = ((2 * (kk & 3)) ^ g) << 4, c1 = ((2 * (kk & 3) + 1) ^ g) << 4;
    const unsigned qb = qa + box * q_box;
    uint32_t ah[4], al[4];
    split_tf32(lds(qb + c0), ah[0], al[0]);            // (g, t)
    split_tf32(lds(qb + 8 * 128 + c0), ah[1], al[1]);  // (g + 8, t)
    split_tf32(lds(qb + c1), ah[2], al[2]);            // (g, t + 4)
    split_tf32(lds(qb + 8 * 128 + c1), ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const unsigned kr = ka + box * f32_box_bytes(BK) + j * 8 * 128;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(lds(kr + c0), bh0, bl0);  // key 8 j + g, column t
      split_tf32(lds(kr + c1), bh1, bl1);  // column t + 4
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(part, al, bh0, bh1);
      mma_tf32(part, ah, bl0, bl1);
      mma_tf32(part, ah, bh0, bh1);
#pragma unroll
      for (int r = 0; r < 4; ++r) s[4 * j + r] += part[r];
    }
  }
}

// O = O * alpha + P V for one warp's 16 rows over a tile of BK keys, in
// 3xTF32: p is P in S's accumulator layout (fp32, not rounded), v_addr the
// V tile (BK rows of HD columns, box b b * BK * 128 bytes on), o the
// warp's RowStateT<HD>::o (n tile e' of 8 columns at o[4 e']). Each
// 32-column box of V and O is summed over the tile from zero, then folded
// into O.
template <int BK, int HD>
__device__ __forceinline__ void pv_f32(float (&o)[HD / 2], const float (&p)[BK / 2],
                                       const float (&alpha)[2], unsigned v_addr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // P's A fragment of key step j: key 8 j + 2 t at column t (rows g, g +
  // 8), key 8 j + 2 t + 1 at column t + 4.
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    split_tf32(p[4 * j], ph[j][0], pl[j][0]);
    split_tf32(p[4 * j + 2], ph[j][1], pl[j][1]);
    split_tf32(p[4 * j + 1], ph[j][2], pl[j][2]);
    split_tf32(p[4 * j + 3], ph[j][3], pl[j][3]);
  }
  // V rows 8 j + 2 t and 8 j + 2 t + 1 (low three bits 2t and 2t + 1), column
  // 8 e + g of a box: 16-byte chunk 2 e + g / 4, word g % 4.
  const unsigned va = v_addr + 2 * t * 128 + (g & 3) * 4;
#pragma unroll
  for (int c = 0; c < HD / F32_BOX_COLS; ++c) {
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const unsigned vr = va + c * f32_box_bytes(BK) + j * 8 * 128;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned ch = 2 * e + (g >> 2);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(lds(vr + ((ch ^ (2 * t)) << 4)), bh0, bl0);
        split_tf32(lds(vr + 128 + ((ch ^ (2 * t + 1)) << 4)), bh1, bl1);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, pl[j], bh0, bh1);
        mma_tf32(part, ph[j], bl0, bl1);
        mma_tf32(part, ph[j], bh0, bh1);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[4 * e + r] += part[r];
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) o[16 * c + i] = fmaf(o[16 * c + i], alpha[(i >> 1) & 1], acc[i]);
  }
}

// The FA2 softmax of one tile, as flash_wgmma.cuh's softmax_tile at d 128
// (its softcap through tanhf: the d-256 shortcut's absolute error, about
// 1e-7 of the cap, is above the fp32 rule at short rows), on S in the
// m16n8 accumulator layout; the running max and sums in st, each row's
// alpha = exp2(m_old - m_new) out for the caller to rescale O.
template <int BK, int HD>
__device__ __forceinline__ void softmax_f32(float (&s)[BK / 2], RowStateT<HD>& st,
                                            float (&alpha)[2], const TileMath& tm, int row0,
                                            int kv0, bool masked) {
  const int q = threadIdx.x & 3;
  const float c_log2 = tm.score_scale * LOG2E;
  float cs = c_log2;  // the factor still to apply inside the exp
  if (tm.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      s[i] = tanhf(s[i] * tm.score_scale / tm.softcap) * (tm.softcap * LOG2E);
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

// Finalise this thread's two rows as flash_wgmma.cuh's store_rows does (row
// sums over the quad, the sink merged, O / l, the natural-log LSE), storing
// fp32: o is the (batch, head) base, rows o_ss elements apart.
template <int HD>
__device__ __forceinline__ void store_rows_f32(const RowStateT<HD>& st, int row, int seq_q,
                                               float* o, long long o_ss, float sink_log2,
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
    const float inv = l > 0.f ? scale_o / l : 0.f;
    const int rr = row + r * 8;
    if (rr >= seq_q) continue;
    float* o_row = o + rr * o_ss;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(o_row + 8 * j + 2 * q) =
          make_float2(st.o[4 * j + 2 * r] * inv, st.o[4 * j + 2 * r + 1] * inv);
    if (lse && q == 0) lse[rr] = l > 0.f ? (m + log2f(l)) / LOG2E : -INFINITY;
  }
}

// One consumer warp's walk (ring slot s at ring + s * slot_bytes: the K
// tile, then the V tile; the walk's first tile at ring position pos0), each
// tile it sees running S = Q K^T, the softmax and O = O * alpha + P V.
template <int BK, int NB, int HD>
__device__ __forceinline__ void consume_f32(RowStateT<HD>& st, const RowGroup& rg,
                                            uint64_t* full, uint64_t* empty,
                                            const uint8_t* ring, int slot_bytes,
                                            unsigned q_addr, int q_box, int first, int n,
                                            const TileMath& tm, int pos0 = 0) {
  const int row0 = rg.q_min + ((threadIdx.x & 31) >> 2);
  walk_tiles<NB>(rg, tm, BK, first, n, full, empty, [&](int i) {
    const unsigned k_addr = smem_addr(ring + ((pos0 + i) % NB) * slot_bytes);
    const int kv0 = (first + i) * BK;
    float s[BK / 2];
    qk_f32<BK, HD>(s, q_addr, q_box, k_addr);
    float alpha[2];
    softmax_f32<BK>(s, st, alpha, tm, row0, kv0,
                    rg.needs_mask(tm.causal, tm.window, kv0, BK, tm.seq_kv));
    pv_f32<BK, HD>(st.o, s, alpha, k_addr + f32_tile_bytes(BK, HD));
    __syncwarp();  // every lane's reads of the slot are done before lane 0 releases it
  }, pos0);
}

// One CTA a (Q tile, head, batch): the grid is (Q tiles, heads, batch),
// the heaviest causal Q tiles first.
template <int NB, int HD, int WARPS, int BK>
__global__ void __launch_bounds__(F32Tile<NB, HD, WARPS, BK>::THREADS, 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const F32Params p) {
  using T = F32Tile<NB, HD, WARPS, BK>;
  constexpr int BQ = T::BQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[NB], empty[NB];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* ring = q_s + T::Q_BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = q_tile * BQ;
  int first, last;
  cta_tiles(p.causal, p.window, p.q_offset + q0, min(BQ, p.seq_q - q0), p.seq_kv, BK, first,
            last);
  const int n = max(last - first + 1, 0);

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < NB; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::ARRIVALS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 0) {  // producer: lane 0 issues every copy
    if (lane == 0) {
      mbar_arrive_expect_tx(&q_full, T::Q_BYTES);
#pragma unroll
      for (int bx = 0; bx < T::BOXES; ++bx)
        tma_load_4d(q_s + bx * f32_box_bytes(BQ), &tm_q, bx * F32_BOX_COLS, q0, h, b, &q_full);
      for (int i = 0; i < n; ++i) {
        const int s = i % NB;
        if (i >= NB) mbar_wait(&empty[s], (i / NB - 1) & 1);
        uint8_t* slot = ring + s * T::SLOT;
        uint8_t* vs = slot + f32_tile_bytes(BK, HD);
        const int kv0 = (first + i) * BK;
        mbar_arrive_expect_tx(&full[s], T::SLOT);
#pragma unroll
        for (int bx = 0; bx < T::BOXES; ++bx)
          tma_load_4d(slot + bx * f32_box_bytes(BK), &tm_k, bx * F32_BOX_COLS, kv0, hk, b,
                      &full[s]);
#pragma unroll
        for (int bx = 0; bx < T::BOXES; ++bx)
          tma_load_4d(vs + bx * f32_box_bytes(BK), &tm_v, bx * F32_BOX_COLS, kv0, hk, b,
                      &full[s]);
      }
    }
    return;
  }

  const int cw = warp - 1;  // consumer warp
  const int r0 = q0 + cw * F32_WARP_ROWS;
  const RowGroup rg{p.q_offset + r0, min(max(p.seq_q - r0, 0), F32_WARP_ROWS)};
  RowStateT<HD> st;
  st.init();
  mbar_wait(&q_full, 0);
  consume_f32<BK, NB>(st, rg, full, empty, ring, T::SLOT,
                      smem_addr(q_s) + cw * F32_WARP_ROWS * 128, f32_box_bytes(BQ), first, n,
                      TileMath{p.causal, p.window, p.seq_kv, p.scale, p.softcap});
  store_rows_f32(st, r0 + (lane >> 2), p.seq_q, p.o + b * p.o_sb + h * p.o_sh, p.o_ss,
                 p.sinks ? p.sinks[h] * LOG2E : -INFINITY,
                 p.lse ? p.lse + ((long long)b * p.heads + h) * p.seq_q : nullptr);
}

// The launch of F32Tile<NB, HD, WARPS, BK>: q (batch, heads, seq_q, HD), k
// and v (batch, kv_heads, seq_kv, HD), fp32 with element strides qs, ks, vs
// (batch, head, row; d contiguous).
template <int NB, int HD, int WARPS, int BK>
int launch_f32(const void* q, const void* k, const void* v, const F32Params& p, int batch,
               int kv_heads, const long long (&qs)[3], const long long (&ks)[3],
               const long long (&vs)[3], cudaStream_t stream) {
  using T = F32Tile<NB, HD, WARPS, BK>;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bhsd(&tm_q, F32, q, batch, p.heads, p.seq_q, HD, qs[0] * 4, qs[1] * 4,
                   qs[2] * 4, T::BQ, F32_BOX_COLS, true) ||
      !encode_bhsd(&tm_k, F32, k, batch, kv_heads, p.seq_kv, HD, ks[0] * 4, ks[1] * 4,
                   ks[2] * 4, BK, F32_BOX_COLS, true) ||
      !encode_bhsd(&tm_v, F32, v, batch, kv_heads, p.seq_kv, HD, vs[0] * 4, vs[1] * 4,
                   vs[2] * 4, BK, F32_BOX_COLS, true))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_f32_kernel<NB, HD, WARPS, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.seq_q + T::BQ - 1) / T::BQ, p.heads, batch);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

// The C entries' parameters as F32Params.
inline F32Params f32_params(void* o, void* lse, const void* sinks, long long o_sb,
                            long long o_sh, long long o_ss, int heads, int kv_heads,
                            int seq_q, int seq_kv, int causal, int q_offset, int window,
                            float scale, float softcap) {
  F32Params p;
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.sinks = static_cast<const float*>(sinks);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.heads = heads;
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
