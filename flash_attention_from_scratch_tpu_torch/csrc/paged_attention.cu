// Paged decode attention for Hopper: 1..t query tokens per sequence over a
// paged KV cache, bf16 (or, in the fp16 library paged_attention_f16.cu,
// fp16) queries, d_head 128 or 256; pages dense in the queries' type, int8,
// fp8 (e4m3) or int4 packed along the tokens of a page; optionally int8
// compute on int8 pages. The 16-bit type is act_t (hopper.cuh): the
// pages are converted to it, P is rounded to it and out is stored in it, as
// the JAX kernels compute in q's dtype; "bf16" below reads as act_t (int8,
// int4 and e4m3 values, and int8 P, are exact in fp16 too). A split-KV
// kernel over pages streamed through a ring of shared-memory slots, its
// products on the tensor cores, and a merge kernel.
//
// Replaces the TPU kernels flash_attention_from_scratch_tpu/ops/
// paged_attention.py _full_kernel (whole window per sequence) and _loop_kernel
// (online softmax per page). Both compute the same function; on Hopper it is
// one kernel pair. The rows of KV head hk are its group's Q heads times the t
// query tokens, row r = g * t + j (Q head hk * group + g, token j), the JAX
// kernels' order. Token j sits at position length - t + j and attends
// softmax(scale * q K^T) V over tokens [lo_j, limit_j), limit_j = length -
// (t - 1) + j and lo_j = max(limit_j - window, 0) under a sliding window
// (else 0), with a Gemma-2 softcap on the scaled scores; a row that sees no
// token (a length-0 row) gives zeros. Tokens in [limit_j, length) are the
// later draft tokens: read (they are written) and masked for row j.
// Quantized pages carry one fp32 scale per (kv_head, page): the K scale
// multiplies the page's scores before the softcap, the V scale multiplies P
// before PV (the softmax denominator is P's own sum). Int4 page rows hold
// token t in the low nibble and token t + page_size/2 in the high nibble of
// row t.
//
// int8 compute (mode INT8C, int8 pages; the TPU kernels' int8_compute): each
// Q row is quantized in the kernel, q_i8 = rint(q / s_q) with s_q = max(max
// |q|, 1e-12) * (1/127); S is the exact integer dot q_i8 . k_i8 (int8
// values are exact in bf16, their products exact in the tensor cores' fp32
// sums, and a dot of d of them stays below 2^24: at d 256, 256 * 127^2 =
// 4,129,024 < 16,777,216) times s_q * scale *
// log2(e) * the page's K scale; P = exp2(S - m) is rounded at the constant
// scale 127 against the running max m of the warp that rounds it, within
// its split (never above the row's final max, so the rounding error of a
// weight is at most what rounding against the final max gives; the warps'
// and the splits' partial sums are rescaled exactly as fp32 weights); the
// products of the int8 P and the int8 V values are exact integers, scaled
// by the page's V scale / 127 and summed in fp32; the denominator sums the
// unrounded P.
//
// What bounds it on the H100: each call reads every cached K/V byte of the
// window once and does 4 FLOPs per byte pair and row, far below the card's
// ~295 FLOP/byte balance point, so the bound is memory: K/V bytes / 3.35
// TB/s. The design (flash-decoding, the H100 role of K5's online softmax):
//   - the KV walk is split: the grid is (sequence, KV head, split x row
//     block); split s owns page-table columns [s * pages_per_split, (s + 1)
//     * pages_per_split), clipped on the card to [the first page any row of
//     the sequence can see, the sequence's last page], so that no -1 padding
//     of the table and no page below every row's window is read; a split
//     left with no page (a short sequence's later ones) writes "nothing
//     seen" for its rows and ends at once. The split count
//     (ops/paged_attention.py::plan) is a function of shapes only, so the
//     host reads no device value and a call can be captured in a graph;
//   - pages arrive in chunks of up to 64 tokens (an int4 page whole: its
//     rows hold two tokens half a page apart), K and V contiguous within a
//     page of one KV head, by copies one thread issues into a ring of slots,
//     each completing on its full mbarrier, so tens of KB are in flight per
//     SM: dense pages by TMA boxes (128-byte swizzle), straight into the
//     tile the products read; quantized pages by cp.async.bulk as raw
//     bytes, which the CTA's threads convert, 64 tokens at a time, into a
//     swizzled bf16 tile (int8, int4 and e4m3 values are exact in bf16);
//     two CTAs fit an SM at d 128 (registers: 256 threads and two CTAs an
//     SM leave 128 a thread). At d 256 a warp's 16 x 256 fp32 O alone is
//     128 registers a thread, so that instantiation runs one CTA an SM (up
//     to 255 registers a thread) with twice the ring budget, the bytes in
//     flight an SM of d 128's two CTAs (a 64-token dense chunk is 64 KB);
//   - that chunk walk takes pages whose chunks are a multiple of 8 tokens
//     (a warp's share of a product tile, and the swizzle atom a TMA box
//     starts on): 8-64 tokens, multiples of 64, int4 pages of up to 256.
//     Every other page size (1 token, as SGLang's default; 12; 72; 100;
//     int4 pages past 256) takes the gather walk, paged_decode_gather_kernel:
//     tiles of 64 consecutive positions copied page run by page run
//     (cp.async.bulk, dense pages too) into a raw slot, converted into the
//     bf16 tile, with K and V factors per token. At page 1 a tile is 64
//     copies of one row each: right, and slower than the chunk walk (PERF.md);
//   - all rows of a (sequence, KV head) share one CTA and one copy of each
//     page, up to 16 rows, the M of mma.sync: a verify call's 4 heads x 4
//     tokens, or a decode step's 4 rows and 12 zero rows, whose products
//     cost less than CUDA cores' dot products and shuffles; beyond 16 rows
//     (32 at t = 8) the rows go in blocks of 16, one CTA each, which read
//     the same pages. Warp w takes a tile's tokens 8w .. 8w + 7: S (16 x 8)
//     = Q K^T on m16n8k16 (K's fragments by ldmatrix), the online softmax of
//     its own tokens in registers (each row's max over the quad that shares
//     it), then O (16 x d) += P V on m16n8k8 (P's fp32 accumulator
//     repacked as the bf16 A fragment, V's by ldmatrix.trans); the warps'
//     partials are merged through shared memory at the end;
//   - whole chunks arrive, slots past the length (or in a window's gap)
//     included, and they may hold anything (an fp8 byte there can be a NaN
//     pattern): a score whose position the row cannot see is replaced by
//     -inf (a select, not arithmetic), and V's fragment halves at or past
//     the length are zeroed, so such slots cannot reach the sum (0 x NaN is
//     NaN on the tensor cores too; the TPU kernels' select on V rows);
//   - with more than one split each CTA writes its partial (O in fp32,
//     relative to its max m, with its sum l) to a workspace, and
//     paged_decode_merge_kernel combines the splits in a fixed order, out =
//     sum_s exp2(m_s - M) O_s / sum_s exp2(m_s - M) l_s (M the largest m_s;
//     zeros where the sums are 0), so the output is the same bit for bit on
//     every call; with one split the first kernel writes out itself.

#include <cuda_fp8.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MMA_ROWS = 16;          // rows a CTA: the M of mma.sync
constexpr int TILE_TOKENS = 64;       // tokens of a product tile (8 a warp)
constexpr int RING_BYTES = 98304;     // dense pages: the TMA ring's budget a CTA at d 128
constexpr int RAW_RING_BYTES = 65536;  // quantized pages: the raw ring's budget at d 128
constexpr int MIN_SLOTS = 2;
constexpr int MAX_SLOTS = 8;
constexpr int ALIGN_SLACK = 1024;     // swizzled tiles start 1024-aligned
constexpr int SMEM_LIMIT = 232448;    // shared memory a block may use
constexpr int STATIC_RESERVE = 1024;  // of it kept for the kernel's static arrays
constexpr int INT4_WHOLE_PAGE = 256;  // int4 pages up to this many tokens go whole
constexpr int FAC_BYTES = 512;        // the gather walk's K and V factors of a tile's tokens

// The geometry of head width D (128 or 256; ops/paged_attention.py::plan
// mirrors it).
template <int D>
struct Geo {
  static_assert(D == 128 || D == 256, "K4/K5 take head widths 128 and 256");
  static constexpr int CTAS_PER_SM = D == 128 ? 2 : 1;  // the launch bound's CTAs an SM
  static constexpr int RING = RING_BYTES * (D / 128);   // a CTA's ring budgets
  static constexpr int RAW_RING = RAW_RING_BYTES * (D / 128);
  static constexpr int STAGE_BYTES = 2 * TILE_TOKENS * D * 2;  // quantized: the bf16 K, V tile
  static constexpr int Q_TILE_BYTES = MMA_ROWS * D * 2;
  // The merge's scratch (reusing the tiles): acc, m and l of every warp's 16
  // rows, rows MERGE_STRIDE floats apart so that a half-warp's 8-byte stores
  // fall in distinct banks.
  static constexpr int MERGE_STRIDE = D + 8;
  static constexpr int MERGE_BYTES = NWARPS * MMA_ROWS * (MERGE_STRIDE + 2) * 4;
};
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Page formats (the wrapper's mode argument); INT8C: int8 pages, int8 compute.
constexpr int DENSE = 0, INT8 = 1, FP8 = 2, INT4 = 3, INT8C = 4;

// Stored rows of a page and bytes of one K (or V) page of one KV head.
__host__ __device__ inline int stored_rows(int store, int page_size) {
  return store == INT4 ? page_size / 2 : page_size;
}
__host__ __device__ inline int page_bytes(int store, int page_size, int d) {
  return stored_rows(store, page_size) * d * (store == DENSE ? 2 : 1);
}

// Tokens of a ring slot's chunk on the chunk walk: a page of up to
// TILE_TOKENS, else runs of TILE_TOKENS consecutive tokens (contiguous
// within the page; the page size a multiple of it); an int4 page, whose
// stored rows hold two tokens half a page apart, stays whole.
__host__ __device__ inline int chunk_tokens(int store, int page_size) {
  if (store == INT4 || page_size <= TILE_TOKENS) return page_size;
  return page_size % TILE_TOKENS == 0 ? TILE_TOKENS : 0;
}

// The host's choice of walk: the chunk walk's chunk where it takes the page
// size, a multiple of 8 tokens (a warp's tokens of a product tile, and the
// 8-row swizzle atom a TMA box starts on; an int4 page whole up to
// INT4_WHOLE_PAGE tokens, so that two slots fit); 0 for the gather walk
// (paged_decode_gather_kernel). The kernel keeps chunk_tokens as it was:
// folding this rule into it moved the int8 and fp8 kernels' registers.
inline int walk_chunk_tokens(int store, int page_size) {
  const int ct = chunk_tokens(store, page_size);
  if (ct % 8 || (store == INT4 && page_size > INT4_WHOLE_PAGE)) return 0;
  return ct;
}

// Bytes of a token's row in a gather slot of K (or V): a dense row, or one
// stored row of D bytes (an int4 row holds the token in one of its nibbles).
__host__ __device__ constexpr int gather_row_bytes(int store, int d) {
  return store == DENSE ? 2 * d : d;
}

// Slots of a ring of `budget` bytes for chunks of `slot_bytes` (K and V)
// each, and the CTA's dynamic shared memory (ops/paged_attention.py::plan
// mirrors both).
inline int ring_slots(int budget, int slot_bytes) {
  return std::max(MIN_SLOTS, std::min(MAX_SLOTS, budget / slot_bytes));
}
template <int D>
inline int smem_bytes(bool raw, int slots, int slot_bytes) {
  using G = Geo<D>;
  return ALIGN_SLACK + G::Q_TILE_BYTES +
         std::max((raw ? G::STAGE_BYTES : 0) + slots * slot_bytes, G::MERGE_BYTES);
}
// The gather walk's: the bf16 tile, the tokens' factors, then the raw ring.
template <int D>
inline int gather_smem_bytes(int slots, int slot_bytes) {
  using G = Geo<D>;
  return ALIGN_SLACK + G::Q_TILE_BYTES +
         std::max(G::STAGE_BYTES + FAC_BYTES + slots * slot_bytes, G::MERGE_BYTES);
}

// 8 stored values of one row -> fp32. int4: the low or high nibble of each
// byte, sign-extended.
template <int STORE>
__device__ __forceinline__ void unpack8q(const uint2& raw, bool hi, float (&f)[8]) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (STORE == INT8) {
      f[i] = static_cast<float>(static_cast<int8_t>(b[i]));
    } else if constexpr (STORE == FP8) {
      __nv_fp8_e4m3 v;
      v.__x = b[i];
      f[i] = static_cast<float>(v);
    } else {
      const int nib = hi ? (b[i] >> 4) : (b[i] & 0xF);
      f[i] = static_cast<float>((nib ^ 8) - 8);
    }
  }
}

// exp2 on the special-function unit (ex2.approx.ftz: about 2 ulp; 0 for
// -inf).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of bf16 element (r, c) of a (rows x d) tile stored as d / 64
// 128-byte-swizzled boxes of 64 columns (as TMA writes them).
__device__ __forceinline__ int sw_offset(int rows, int r, int c) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16 act_t, row) * b (16x8 act_t, col), fp32.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32" FA_AB ".f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8 act_t, row) * b (8x8 act_t, col), fp32.
__device__ __forceinline__ void mma_1688(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32" FA_AB ".f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

struct Params {
  const act_t* q;
  const uint8_t* k_pages;
  const uint8_t* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* lengths;
  const int* page_tables;
  act_t* out;
  float* ws_o;   // (batch * kv_heads, splits, rows, d) fp32, or null for one split
  float* ws_ml;  // (batch * kv_heads, splits, rows, 2) fp32: m (log2 domain), l
  int kv_heads, num_pages, page_size, pages_per_seq, q_tokens, rows_total;
  int splits, pages_per_split, slots;
  float scale, softcap;
  int window;
};

// A CTA whose split sees no page ends at once: its rows [r_begin, r_end)
// get m = -inf and l = 0 (the merge skips them) or, with one split, zeros.
template <int D>
__device__ __forceinline__ void empty_split(const Params& p, int pair, int split, int r_begin,
                                            int r_end) {
  const long long row_base = (long long)pair * p.rows_total;
  for (int idx = threadIdx.x; idx < (r_end - r_begin) * D; idx += blockDim.x) {
    const int r = r_begin + idx / D, c = idx % D;
    if (!p.ws_o) {
      p.out[(row_base + r) * D + c] = to_act(0.f);
    } else if (c == 0) {
      const long long pr = ((long long)pair * p.splits + split) * p.rows_total + r;
      p.ws_ml[2 * pr] = -INFINITY;
      p.ws_ml[2 * pr + 1] = 0.f;
    }
  }
}

// Raw tokens [t0, t0 + ntok) of a quantized chunk (its K bytes, then its V
// bytes `cbytes` on; int4: a whole page of `half` stored rows) as a
// swizzled bf16 tile of TILE_TOKENS rows (K, then V STAGE_BYTES / 2 on).
template <int D, int STORE>
__device__ __forceinline__ void convert_tile(const uint8_t* raw, int cbytes, int half, int t0,
                                             int ntok, uint8_t* stage) {
  for (int idx = threadIdx.x; idx < 2 * ntok * (D / 8); idx += NTHREADS) {
    const int kv = idx / (ntok * (D / 8)), rem = idx % (ntok * (D / 8));
    const int tok = rem / (D / 8), c = (rem % (D / 8)) * 8;
    const int tk = t0 + tok;
    const bool hi = STORE == INT4 && tk >= half;
    const int row = hi ? tk - half : tk;
    float f[8];
    unpack8q<STORE>(*reinterpret_cast<const uint2*>(raw + kv * cbytes + row * D + c), hi, f);
    *reinterpret_cast<uint4*>(stage + kv * (Geo<D>::STAGE_BYTES / 2) +
                              sw_offset(TILE_TOKENS, tok, c)) =
        make_uint4(pack_act(f[0], f[1]), pack_act(f[2], f[3]), pack_act(f[4], f[5]),
                   pack_act(f[6], f[7]));
  }
}

// What a thread holds of its warp's partial: O (rows g, g + 8 of the 16;
// columns 8 j + 2 qd, + 1), each row's running max (log2 domain) and its
// partial sum over the quad's columns.
template <int D>
struct Partial {
  float o[D / 8][4];
  float m[2], l[2];
};

// One tile of the warp's 8 tokens (tok0 .. tok0 + 7 of a tile of `rows`
// rows; positions pos0 ..), K and V swizzled bf16 at ks and vs: S = Q K^T,
// the scores' scale, softcap and mask, the online softmax and O += P V.
// k_fac multiplies the raw dot (the K scale; with int8 compute also s_q *
// scale * log2(e) of each row, q_fac), v_fac P before PV (the V scale).
// G (the gather walk): a tile's tokens come from several pages, so the
// factors are per token, fac[token] and fac[TILE_TOKENS + token] (0 past
// the tile's last token), and positions at or past `len` (the walk's end,
// which may lie below the length) are masked in S as well as in V.
template <int D, bool I8C, bool G = false>
__device__ __forceinline__ void tile_products(Partial<D>& st, unsigned q_addr, const uint8_t* ks,
                                              const uint8_t* vs, int rows, int tok0, int pos0,
                                              const int (&lim)[2], int win, int len,
                                              const float (&q_fac)[2], float k_fac, float v_fac,
                                              const float* fac, const Params& p) {
  const int lane = threadIdx.x & 31, qd = lane & 3;
  // S = Q K^T: rows g, g + 8; tokens 2 qd, 2 qd + 1 of the warp's 8.
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kp = 0; kp < D / 32; ++kp) {  // k-steps 2 kp and 2 kp + 1
    uint32_t kf[4], qa[4], qb[4];
    ldsm_x4(kf, smem_addr(ks + sw_offset(rows, tok0 + (lane & 7), (4 * kp + (lane >> 3)) * 8)));
    const int mq = lane >> 3, qr = (mq & 1) * 8 + (lane & 7);
    ldsm_x4(qa, q_addr + sw_offset(MMA_ROWS, qr, (4 * kp + (mq >> 1)) * 8));
    ldsm_x4(qb, q_addr + sw_offset(MMA_ROWS, qr, (4 * kp + 2 + (mq >> 1)) * 8));
    mma_16816(s, qa, kf[0], kf[1]);
    mma_16816(s, qb, kf[2], kf[3]);
  }
  // Scores in the log2 domain; a select on each position (a slot the row
  // cannot see never reaches the sum, whatever its bytes hold).
  const float cap_log2 = p.softcap * LOG2E;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int tok = pos0 + 2 * qd + (e & 1), lm = lim[e >> 1];
    const float kf = G ? fac[tok0 + 2 * qd + (e & 1)] : k_fac;
    float x;
    if constexpr (I8C) {
      x = s[e] * q_fac[e >> 1] * kf;  // the exact integer dot, scaled
      if (p.softcap > 0.f) x = tanhf(x / cap_log2) * cap_log2;
    } else {
      x = s[e] * kf;
      x = p.softcap > 0.f ? tanhf(x * p.scale / p.softcap) * cap_log2 : x * p.scale * LOG2E;
    }
    if constexpr (G)
      s[e] = tok < lm && tok >= lm - win && tok < len ? x : -INFINITY;
    else
      s[e] = tok < lm && tok >= lm - win ? x : -INFINITY;
  }
  // The online softmax of each row over the warp's tokens.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = fmaxf(s[2 * rr], s[2 * rr + 1]);
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    if (mx > st.m[rr]) {
      const float alpha = fast_exp2(st.m[rr] - mx);  // 0 from -inf
      st.m[rr] = mx;
      st.l[rr] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        st.o[j][2 * rr] *= alpha;
        st.o[j][2 * rr + 1] *= alpha;
      }
    }
    const float mu = st.m[rr] == -INFINITY ? 0.f : st.m[rr];
    s[2 * rr] = fast_exp2(s[2 * rr] - mu);
    s[2 * rr + 1] = fast_exp2(s[2 * rr + 1] - mu);
    st.l[rr] += s[2 * rr] + s[2 * rr + 1];
  }
  // P as the bf16 A fragment: with int8 compute the rounded integers
  // (exact), O divided by the V factor around the product so that it adds
  // the exact integer products times that factor; else P times the factor.
  // A zero V factor (an all-zero page) adds nothing. G: P (int8 compute:
  // its rounded integers) times each token's V factor, rounded to bf16 as
  // the other formats' P is.
  uint32_t a0, a1;
  if constexpr (G) {
    const float v0 = fac[TILE_TOKENS + tok0 + 2 * qd], v1 = fac[TILE_TOKENS + tok0 + 2 * qd + 1];
    const float p0 = I8C ? rintf(s[0] * 127.f) : s[0], p1 = I8C ? rintf(s[1] * 127.f) : s[1];
    const float p2 = I8C ? rintf(s[2] * 127.f) : s[2], p3 = I8C ? rintf(s[3] * 127.f) : s[3];
    a0 = pack_act(p0 * v0, p1 * v1);
    a1 = pack_act(p2 * v0, p3 * v1);
  } else if (v_fac == 0.f) {
    return;
  } else if constexpr (I8C) {
    a0 = pack_act(rintf(s[0] * 127.f), rintf(s[1] * 127.f));
    a1 = pack_act(rintf(s[2] * 127.f), rintf(s[3] * 127.f));
    const float inv = 1.f / v_fac;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.o[j][e] *= inv;
  } else {
    a0 = pack_act(s[0] * v_fac, s[1] * v_fac);
    a1 = pack_act(s[2] * v_fac, s[3] * v_fac);
  }
  // O += P V over the warp's 8 tokens; V's halves past the length zeroed.
  const uint32_t keep = (pos0 + 2 * qd < len ? 0x0000FFFFu : 0u) |
                        (pos0 + 2 * qd + 1 < len ? 0xFFFF0000u : 0u);
#pragma unroll
  for (int jj = 0; jj < D / 32; ++jj) {
    uint32_t vf[4];
    ldsm_x4_t(vf, smem_addr(vs + sw_offset(rows, tok0 + (lane & 7), (4 * jj + (lane >> 3)) * 8)));
#pragma unroll
    for (int m4 = 0; m4 < 4; ++m4) mma_1688(st.o[4 * jj + m4], a0, a1, vf[m4] & keep);
  }
  if constexpr (I8C && !G) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.o[j][e] *= v_fac;
  }
}

// The Q tile: rows rblock * 16 .. + 15 of this KV head (D / 8 threads a
// row, 8 values each: two rows a warp at d 128, one at d 256, over
// MMA_ROWS * D / 8 / NTHREADS passes), zeros past the last row, swizzled
// as the K/V tiles are; with int8 compute each row quantized (its abs-max
// over the lanes that hold it) and stored as its int8 values.
template <int D, bool I8C>
__device__ __forceinline__ void load_q_tile(const Params& p, uint8_t* q_s, float* q_fac_s,
                                            long long row_base, int rblock, int r_end) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int pass = 0; pass < MMA_ROWS * (D / 8) / NTHREADS; ++pass) {
    const int idx = tid + pass * NTHREADS;
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int row = rblock * MMA_ROWS + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < r_end) v = *reinterpret_cast<const uint4*>(p.q + (row_base + row) * D + c);
    if constexpr (I8C) {
      const uint32_t* h = reinterpret_cast<const uint32_t*>(&v);
      float f[8], amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = act_pair(h[i]);
        f[2 * i] = x.x;
        f[2 * i + 1] = x.y;
        amax = fmaxf(amax, fmaxf(fabsf(x.x), fabsf(x.y)));
      }
#pragma unroll
      for (int off = D / 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
      const float s_q = fmaxf(amax, 1e-12f) * (1.0f / 127.0f);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = pack_act(rintf(__fdiv_rn(f[2 * i], s_q)), rintf(__fdiv_rn(f[2 * i + 1], s_q)));
      v = make_uint4(w[0], w[1], w[2], w[3]);
      if (c == 0) q_fac_s[r] = s_q * p.scale * LOG2E;
    }
    *reinterpret_cast<uint4*>(q_s + sw_offset(MMA_ROWS, r, c)) = v;
  }
}

// This lane's fragment rows g and g + 8 (rows past the last see nothing):
// row r sees tokens [lim - win, lim); with int8 compute, each row's factor.
template <int D, bool I8C>
__device__ __forceinline__ void lane_rows(const Params& p, const float* q_fac_s, int rblock,
                                          int len, int (&lim)[2], float (&q_fac)[2],
                                          Partial<D>& st) {
  const int g = (threadIdx.x & 31) >> 2, t = p.q_tokens;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = rblock * MMA_ROWS + g + 8 * rr;
    lim[rr] = r < p.rows_total ? len - (t - 1) + r % t : 0;
    q_fac[rr] = 1.f;
    if constexpr (I8C) q_fac[rr] = q_fac_s[g + 8 * rr];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) st.o[j][0] = st.o[j][1] = st.o[j][2] = st.o[j][3] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
}

// Each warp's partial (O, m, l) of the CTA's real rows (a padded row of
// the tile is skipped), then the rows' merge over the warps, into out (one
// split) or this split's partial; `scratch` is the tiles' memory, free now.
template <int D>
__device__ __forceinline__ void merge_warps(const Partial<D>& st, const Params& p,
                                            uint8_t* scratch, int pair, int split,
                                            long long row_base, int rblock, int r_end) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  constexpr int MERGE_STRIDE = Geo<D>::MERGE_STRIDE;
  float* sm_acc = reinterpret_cast<float*>(scratch);          // [NWARPS][16][MERGE_STRIDE]
  float* sm_m = sm_acc + NWARPS * MMA_ROWS * MERGE_STRIDE;  // [NWARPS][16]
  float* sm_l = sm_m + NWARPS * MMA_ROWS;                   // [NWARPS][16]
  const int rows_here = r_end - rblock * MMA_ROWS;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lq = st.l[rr];
    lq += __shfl_xor_sync(FULL, lq, 1);
    lq += __shfl_xor_sync(FULL, lq, 2);
    const int r = g + 8 * rr;
    if (r >= rows_here) continue;
    float* row = sm_acc + (warp * MMA_ROWS + r) * MERGE_STRIDE + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(st.o[j][2 * rr], st.o[j][2 * rr + 1]);
    if (qd == 0) {
      sm_m[warp * MMA_ROWS + r] = st.m[rr];
      sm_l[warp * MMA_ROWS + r] = lq;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < rows_here * D; idx += NTHREADS) {
    const int rl = idx / D, c = idx % D;
    const int r = rblock * MMA_ROWS + rl;
    float m_tot = -INFINITY;
    for (int w = 0; w < NWARPS; ++w) m_tot = fmaxf(m_tot, sm_m[w * MMA_ROWS + rl]);
    float lt = 0.f, ot = 0.f;
    if (m_tot != -INFINITY) {
      for (int w = 0; w < NWARPS; ++w) {
        const float mw = sm_m[w * MMA_ROWS + rl];
        if (mw == -INFINITY) continue;
        const float wt = fast_exp2(mw - m_tot);
        lt += sm_l[w * MMA_ROWS + rl] * wt;
        ot += sm_acc[(w * MMA_ROWS + rl) * MERGE_STRIDE + c] * wt;
      }
    }
    if (!p.ws_o) {
      p.out[(row_base + r) * D + c] = to_act(lt > 0.f ? ot / lt : 0.f);
    } else {
      const long long pr = ((long long)pair * p.splits + split) * p.rows_total + r;
      p.ws_o[pr * D + c] = ot;
      if (c == 0) {
        p.ws_ml[2 * pr] = m_tot;
        p.ws_ml[2 * pr + 1] = lt;
      }
    }
  }
}

// The chunk walk's kernel. It keeps the Q tile, the rows' setup and the
// merge written out here, not through the gather kernel's helpers above:
// built through them, its int8-compute instantiation at d 128 took one
// register more (127 against its baseline's 126, kernel_sass/).
template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS, Geo<D>::CTAS_PER_SM)
paged_decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using G = Geo<D>;
  constexpr bool I8C = MODE == INT8C;
  constexpr int STORE = I8C ? INT8 : MODE;  // how the pages are stored
  constexpr bool RAW = STORE != DENSE;      // raw bytes, converted into a bf16 tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_SLOTS];
  __shared__ float q_fac_s[MMA_ROWS];  // int8 compute: s_q * scale * log2(e) a row
  uint8_t* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* stage = q_s + G::Q_TILE_BYTES;  // quantized pages' bf16 tile
  uint8_t* ring = stage + (RAW ? G::STAGE_BYTES : 0);

  const int b = blockIdx.x, hk = blockIdx.y;
  const int split = blockIdx.z % p.splits, rblock = blockIdx.z / p.splits;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;  // fragment row / column pair
  const int ps = p.page_size, len = p.lengths[b];
  const int t = p.q_tokens;
  // The lowest window start of all t tokens: pages below it are never read.
  const int start = p.window ? max(len - (t - 1) - p.window, 0) : 0;
  const int pair = b * p.kv_heads + hk;
  const long long row_base = (long long)pair * p.rows_total;

  // This split's page-table columns, clipped to the pages a row can see,
  // walked in chunks of ct tokens (cpp a page).
  const int c_begin = max(split * p.pages_per_split, start / ps);
  const int c_end = min(min((split + 1) * p.pages_per_split, p.pages_per_seq),
                        (len + ps - 1) / ps);
  const int ct = chunk_tokens(STORE, ps), cpp = ps / ct;
  const int n = max(min((c_end - c_begin) * cpp, (len - c_begin * ps + ct - 1) / ct), 0);
  const int* pt = p.page_tables + (long long)b * p.pages_per_seq;
  const int pbytes = page_bytes(STORE, ps, D);
  const int cbytes = page_bytes(STORE, ct, D);  // the K (or V) chunk
  const int slot_bytes = 2 * cbytes;
  const int r_end = min((rblock + 1) * MMA_ROWS, p.rows_total);  // past this CTA's rows
  if (n == 0) {
    empty_split<D>(p, pair, split, rblock * MMA_ROWS, r_end);
    return;
  }

  // One thread issues the copies of the split's chunk i into slot i % slots,
  // the first ones before anything else.
  auto issue = [&](int i) {
    const int page = pt[c_begin + i / cpp];
    uint8_t* dst = ring + (i % p.slots) * slot_bytes;
    uint64_t* bar = &full[i % p.slots];
    mbar_arrive_expect_tx(bar, slot_bytes);
    if constexpr (RAW) {
      const long long off = ((long long)hk * p.num_pages + page) * pbytes + (i % cpp) * cbytes;
      bulk_load(dst, p.k_pages + off, cbytes, bar);
      bulk_load(dst + cbytes, p.v_pages + off, cbytes, bar);
    } else {
      const int row0 = (i % cpp) * ct;
#pragma unroll
      for (int bx = 0; bx < D / 64; ++bx)
        tma_load_4d(dst + bx * ct * 128, &tm_k, 64 * bx, row0, page, hk, bar);
#pragma unroll
      for (int bx = 0; bx < D / 64; ++bx)
        tma_load_4d(dst + cbytes + bx * ct * 128, &tm_v, 64 * bx, row0, page, hk, bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int i = 0; i < min(n, p.slots); ++i) issue(i);
  }
  // The Q tile: rows rblock * 16 .. + 15 of this KV head (D / 8 threads a
  // row, 8 values each: two rows a warp at d 128, one at d 256, over
  // MMA_ROWS * D / 8 / NTHREADS passes), zeros past the last row, swizzled
  // as the K/V tiles are; with int8 compute each row quantized (its abs-max
  // over the lanes that hold it) and stored as its int8 values.
#pragma unroll
  for (int pass = 0; pass < MMA_ROWS * (D / 8) / NTHREADS; ++pass) {
    const int idx = tid + pass * NTHREADS;
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int row = rblock * MMA_ROWS + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < r_end) v = *reinterpret_cast<const uint4*>(p.q + (row_base + row) * D + c);
    if constexpr (I8C) {
      const uint32_t* h = reinterpret_cast<const uint32_t*>(&v);
      float f[8], amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = act_pair(h[i]);
        f[2 * i] = x.x;
        f[2 * i + 1] = x.y;
        amax = fmaxf(amax, fmaxf(fabsf(x.x), fabsf(x.y)));
      }
#pragma unroll
      for (int off = D / 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
      const float s_q = fmaxf(amax, 1e-12f) * (1.0f / 127.0f);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = pack_act(rintf(__fdiv_rn(f[2 * i], s_q)), rintf(__fdiv_rn(f[2 * i + 1], s_q)));
      v = make_uint4(w[0], w[1], w[2], w[3]);
      if (c == 0) q_fac_s[r] = s_q * p.scale * LOG2E;
    }
    *reinterpret_cast<uint4*>(q_s + sw_offset(MMA_ROWS, r, c)) = v;
  }
  __syncthreads();

  // This lane's fragment rows g and g + 8 (rows past the last see nothing):
  // row r sees tokens [lim - win, lim).
  const int win = p.window > 0 ? p.window : (1 << 30);
  int lim[2];
  float q_fac[2] = {1.f, 1.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = rblock * MMA_ROWS + g + 8 * rr;
    lim[rr] = r < p.rows_total ? len - (t - 1) + r % t : 0;
    if constexpr (I8C) q_fac[rr] = q_fac_s[g + 8 * rr];
  }
  Partial<D> st;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) st.o[j][0] = st.o[j][1] = st.o[j][2] = st.o[j][3] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;
  const unsigned q_addr = smem_addr(q_s);
  const int tok0 = warp * 8;  // the warp's tokens of a tile

  for (int i = 0; i < n; ++i) {
    mbar_wait(&full[i % p.slots], (i / p.slots) & 1);
    const int col = c_begin + i / cpp;
    const int pos0 = col * ps + (i % cpp) * ct;  // position of the chunk's first token
    const uint8_t* slot = ring + (i % p.slots) * slot_bytes;
    if constexpr (RAW) {
      const float k_fac = p.k_scales[(long long)hk * p.num_pages + pt[col]];
      const float v_fac = p.v_scales[(long long)hk * p.num_pages + pt[col]] *
                          (I8C ? 1.0f / 127.0f : 1.0f);
      // The chunk in tiles of up to 64 tokens (one tile, but for an int4
      // page of more than 64), the tiles past the length skipped.
      for (int t0 = 0; t0 < ct && pos0 + t0 < len; t0 += TILE_TOKENS) {
        const int ntok = min(TILE_TOKENS, ct - t0);
        convert_tile<D, STORE>(slot, cbytes, ps / 2, t0, ntok, stage);
        __syncthreads();
        if (tok0 < ntok)
          tile_products<D, I8C>(st, q_addr, stage, stage + G::STAGE_BYTES / 2, TILE_TOKENS,
                                tok0, pos0 + t0 + tok0, lim, win, len, q_fac, k_fac, v_fac,
                                nullptr, p);
        __syncthreads();  // the tile is read: the next conversion may write it
      }
    } else {
      if (tok0 < ct)
        tile_products<D, false>(st, q_addr, slot, slot + cbytes, ct, tok0, pos0 + tok0, lim,
                                win, len, q_fac, 1.f, 1.f, nullptr, p);
      __syncthreads();  // every warp is done with the slot
    }
    if (tid == 0 && i + p.slots < n) issue(i + p.slots);
  }
  __syncthreads();  // the tiles' memory becomes the merge's scratch

  // Each warp's partial (O, m, l) of the CTA's real rows (a padded row of
  // the tile is skipped), then the rows' merge over the warps.
  constexpr int MERGE_STRIDE = G::MERGE_STRIDE;
  float* sm_acc = reinterpret_cast<float*>(stage);          // [NWARPS][16][MERGE_STRIDE]
  float* sm_m = sm_acc + NWARPS * MMA_ROWS * MERGE_STRIDE;  // [NWARPS][16]
  float* sm_l = sm_m + NWARPS * MMA_ROWS;                   // [NWARPS][16]
  const int rows_here = r_end - rblock * MMA_ROWS;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lq = st.l[rr];
    lq += __shfl_xor_sync(FULL, lq, 1);
    lq += __shfl_xor_sync(FULL, lq, 2);
    const int r = g + 8 * rr;
    if (r >= rows_here) continue;
    float* row = sm_acc + (warp * MMA_ROWS + r) * MERGE_STRIDE + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j) = make_float2(st.o[j][2 * rr], st.o[j][2 * rr + 1]);
    if (qd == 0) {
      sm_m[warp * MMA_ROWS + r] = st.m[rr];
      sm_l[warp * MMA_ROWS + r] = lq;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < rows_here * D; idx += NTHREADS) {
    const int rl = idx / D, c = idx % D;
    const int r = rblock * MMA_ROWS + rl;
    float m_tot = -INFINITY;
    for (int w = 0; w < NWARPS; ++w) m_tot = fmaxf(m_tot, sm_m[w * MMA_ROWS + rl]);
    float lt = 0.f, ot = 0.f;
    if (m_tot != -INFINITY) {
      for (int w = 0; w < NWARPS; ++w) {
        const float mw = sm_m[w * MMA_ROWS + rl];
        if (mw == -INFINITY) continue;
        const float wt = fast_exp2(mw - m_tot);
        lt += sm_l[w * MMA_ROWS + rl] * wt;
        ot += sm_acc[(w * MMA_ROWS + rl) * MERGE_STRIDE + c] * wt;
      }
    }
    if (!p.ws_o) {
      p.out[(row_base + r) * D + c] = to_act(lt > 0.f ? ot / lt : 0.f);
    } else {
      const long long pr = ((long long)pair * p.splits + split) * p.rows_total + r;
      p.ws_o[pr * D + c] = ot;
      if (c == 0) {
        p.ws_ml[2 * pr] = m_tot;
        p.ws_ml[2 * pr + 1] = lt;
      }
    }
  }
}

// The gather walk: page sizes the chunk walk does not take (chunk_tokens
// 0: not a multiple of 8, or above 64 and not a multiple of 64, or an int4
// page above INT4_WHOLE_PAGE). The split's positions [pos_begin, pos_end)
// go in tiles of TILE_TOKENS consecutive positions, whatever pages hold
// them: warp 0's lanes copy each page's run of a tile (cp.async.bulk, a
// page a lane; an int4 page's run as its low-nibble rows, then its
// high-nibble rows) into a raw slot of TILE_TOKENS token rows, so slot row
// j holds the stored row of position pos + j (int4: the byte row whose low
// or high nibble it is). The CTA converts the slot into the bf16 tile (a
// copy for dense pages) and each token's K and V factors (its page's
// scales; 1 for dense pages) into `fac`, frees the slot for the tile
// `slots` on, and runs the products with the factors per token and the
// positions past pos_end masked: a tile may end below the length where the
// split ends.
template <int D, int MODE>
__global__ void __launch_bounds__(NTHREADS, Geo<D>::CTAS_PER_SM)
paged_decode_gather_kernel(const Params p) {
  using G = Geo<D>;
  constexpr bool I8C = MODE == INT8C;
  constexpr int STORE = I8C ? INT8 : MODE;
  constexpr int RB = gather_row_bytes(STORE, D);  // a token's row of one K (or V) slot
  constexpr int SLOT = 2 * TILE_TOKENS * RB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_SLOTS];
  __shared__ float q_fac_s[MMA_ROWS];
  uint8_t* q_s = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* stage = q_s + G::Q_TILE_BYTES;
  float* fac = reinterpret_cast<float*>(stage + G::STAGE_BYTES);  // [K, V][TILE_TOKENS]
  uint8_t* ring = stage + G::STAGE_BYTES + FAC_BYTES;

  const int b = blockIdx.x, hk = blockIdx.y;
  const int split = blockIdx.z % p.splits, rblock = blockIdx.z / p.splits;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ps = p.page_size, len = p.lengths[b];
  const int t = p.q_tokens;
  const int start = p.window ? max(len - (t - 1) - p.window, 0) : 0;
  const int pair = b * p.kv_heads + hk;
  const long long row_base = (long long)pair * p.rows_total;
  const int c_begin = max(split * p.pages_per_split, start / ps);
  const int c_end = min(min((split + 1) * p.pages_per_split, p.pages_per_seq),
                        (len + ps - 1) / ps);
  const int pos_begin = c_begin * ps, pos_end = min(c_end * ps, len);
  const int n = pos_end > pos_begin ? (pos_end - pos_begin + TILE_TOKENS - 1) / TILE_TOKENS : 0;
  const int* pt = p.page_tables + (long long)b * p.pages_per_seq;
  const int pbytes = page_bytes(STORE, ps, D);
  const int r_end = min((rblock + 1) * MMA_ROWS, p.rows_total);
  if (n == 0) {
    empty_split<D>(p, pair, split, rblock * MMA_ROWS, r_end);
    return;
  }

  // Warp 0 issues tile i's copies into slot i % slots, a page a lane.
  auto issue = [&](int i) {
    const int pos = pos_begin + i * TILE_TOKENS, valid = min(TILE_TOKENS, pos_end - pos);
    uint8_t* dst = ring + (i % p.slots) * SLOT;
    uint64_t* bar = &full[i % p.slots];
    if (lane == 0) mbar_arrive_expect_tx(bar, 2 * valid * RB);
    __syncwarp();
    auto copy = [&](long long page_off, int row, int first, int count) {
      bulk_load(dst + (first - pos) * RB, p.k_pages + page_off + (long long)row * RB,
                count * RB, bar);
      bulk_load(dst + (TILE_TOKENS + first - pos) * RB,
                p.v_pages + page_off + (long long)row * RB, count * RB, bar);
    };
    for (int c = pos / ps + lane; c <= (pos + valid - 1) / ps; c += 32) {
      const long long off = ((long long)hk * p.num_pages + pt[c]) * pbytes;
      const int a = max(pos, c * ps) - c * ps, e = min(pos + valid, (c + 1) * ps) - c * ps;
      if constexpr (STORE == INT4) {  // tokens [a, e) of the page, by half
        const int half = ps / 2, lo_end = min(e, half), hi_begin = max(a, half);
        if (a < lo_end) copy(off, a, c * ps + a, lo_end - a);
        if (hi_begin < e) copy(off, hi_begin - half, c * ps + hi_begin, e - hi_begin);
      } else {
        copy(off, a, c * ps + a, e - a);
      }
    }
  };
  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  if (warp == 0) {
    __syncwarp();
    for (int i = 0; i < min(n, p.slots); ++i) issue(i);
  }
  load_q_tile<D, I8C>(p, q_s, q_fac_s, row_base, rblock, r_end);
  __syncthreads();

  const int win = p.window > 0 ? p.window : (1 << 30);
  int lim[2];
  float q_fac[2];
  Partial<D> st;
  lane_rows<D, I8C>(p, q_fac_s, rblock, len, lim, q_fac, st);
  const unsigned q_addr = smem_addr(q_s);
  const int tok0 = warp * 8;

  for (int i = 0; i < n; ++i) {
    mbar_wait(&full[i % p.slots], (i / p.slots) & 1);
    const int pos = pos_begin + i * TILE_TOKENS, valid = min(TILE_TOKENS, pos_end - pos);
    const uint8_t* slot = ring + (i % p.slots) * SLOT;
    for (int idx = tid; idx < 2 * valid * (D / 8); idx += NTHREADS) {
      const int kv = idx / (valid * (D / 8)), rem = idx % (valid * (D / 8));
      const int tok = rem / (D / 8), c = (rem % (D / 8)) * 8;
      const uint8_t* src = slot + (kv * TILE_TOKENS + tok) * RB;
      uint4 v;
      if constexpr (STORE == DENSE) {
        v = *reinterpret_cast<const uint4*>(src + 2 * c);
      } else {
        float f[8];
        unpack8q<STORE>(*reinterpret_cast<const uint2*>(src + c),
                        STORE == INT4 && (pos + tok) % ps >= ps / 2, f);
        v = make_uint4(pack_act(f[0], f[1]), pack_act(f[2], f[3]),
                       pack_act(f[4], f[5]), pack_act(f[6], f[7]));
      }
      *reinterpret_cast<uint4*>(stage + kv * (G::STAGE_BYTES / 2) +
                                sw_offset(TILE_TOKENS, tok, c)) = v;
    }
    if (tid < TILE_TOKENS) {
      float kf = 0.f, vf = 0.f;
      if (tid < valid) {
        if constexpr (STORE == DENSE) {
          kf = vf = 1.f;
        } else {
          const long long at = (long long)hk * p.num_pages + pt[(pos + tid) / ps];
          kf = p.k_scales[at];
          vf = p.v_scales[at] * (I8C ? 1.0f / 127.0f : 1.0f);
        }
      }
      fac[tid] = kf;
      fac[TILE_TOKENS + tid] = vf;
    }
    __syncthreads();  // the tile and its factors are written; the slot is free
    if (warp == 0 && i + p.slots < n) issue(i + p.slots);
    if (tok0 < valid)
      tile_products<D, I8C, true>(st, q_addr, stage, stage + G::STAGE_BYTES / 2, TILE_TOKENS,
                                  tok0, pos + tok0, lim, win, pos_end, q_fac, 1.f, 1.f, fac, p);
    __syncthreads();  // the tile is read: the next conversion may write it
  }

  merge_warps<D>(st, p, stage, pair, split, row_base, rblock, r_end);
}

// The merge: one CTA of D threads per (sequence, KV head, row); the splits
// in order 0, 1, ...
template <int D>
__global__ void __launch_bounds__(D)
paged_decode_merge_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                          act_t* __restrict__ out, int splits, int rows_total) {
  const long long pr = blockIdx.x;  // pair * rows_total + r
  const long long pair = pr / rows_total, r = pr % rows_total;
  const int c = threadIdx.x;
  const long long first = pair * splits * rows_total + r;  // split 0's (pair, r)
  float m_tot = -INFINITY;
  for (int s = 0; s < splits; ++s) m_tot = fmaxf(m_tot, ws_ml[2 * (first + s * rows_total)]);
  float l = 0.f, o = 0.f;
  if (m_tot != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const long long at = first + (long long)s * rows_total;
      const float m = ws_ml[2 * at];
      if (m == -INFINITY) continue;
      const float wt = exp2f(m - m_tot);
      l += ws_ml[2 * at + 1] * wt;
      o += ws_o[at * D + c] * wt;
    }
  }
  out[pr * D + c] = to_act(l > 0.f ? o / l : 0.f);
}

template <int D, int MODE>
int launch_gather(const Params& p, int batch, int row_blocks, int smem, cudaStream_t stream) {
  auto kernel = paged_decode_gather_kernel<D, MODE>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT - STATIC_RESERVE);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  dim3 grid(batch, p.kv_heads, p.splits * row_blocks);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MODE>
int launch(const Params& p, int batch, int row_blocks, int smem, cudaStream_t stream) {
  // Dense pages: the pool as (kv_heads, num_pages, page_size, D) bf16,
  // boxes of 64 columns x one chunk of slots in one page of one KV head.
  CUtensorMap tm_k{}, tm_v{};
  if constexpr (MODE == DENSE) {
    const int ct = chunk_tokens(DENSE, p.page_size);
    const long long row = D * 2, page = row * p.page_size, head = page * p.num_pages;
    if (!encode_bhsd(&tm_k, ACT_TMAP, p.k_pages, p.kv_heads,
                     p.num_pages, p.page_size, D, head, page, row, ct, 64, true) ||
        !encode_bhsd(&tm_v, ACT_TMAP, p.v_pages, p.kv_heads,
                     p.num_pages, p.page_size, D, head, page, row, ct, 64, true))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = paged_decode_kernel<D, MODE>;
  // Once per kernel (every ring fits the limit): nothing but the launch
  // itself on the path of a call, which a CUDA graph may capture.
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT - STATIC_RESERVE);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  dim3 grid(batch, p.kv_heads, p.splits * row_blocks);
  kernel<<<grid, NTHREADS, smem, stream>>>(tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

// The split kernel's launch at head width D: the walk, the ring's slots and
// the CTA's shared memory from the page format and size (plan() mirrors
// them), then the page format's kernel.
template <int D>
int split_launch(Params& p, int batch, int heads, int mode, cudaStream_t stream) {
  const int store = mode == INT8C ? INT8 : mode;
  const int rows = heads / p.kv_heads * p.q_tokens;
  const int row_blocks = (rows + MMA_ROWS - 1) / MMA_ROWS;
  const bool raw = store != DENSE;
  const int ct = walk_chunk_tokens(store, p.page_size);
  const bool gather = ct == 0;
  const int slot_bytes = gather ? 2 * TILE_TOKENS * gather_row_bytes(store, D)
                                : 2 * page_bytes(store, ct, D);
  const int slots = ring_slots(raw || gather ? Geo<D>::RAW_RING : Geo<D>::RING, slot_bytes);
  const int smem = gather ? gather_smem_bytes<D>(slots, slot_bytes)
                          : smem_bytes<D>(raw, slots, slot_bytes);
  if (smem > SMEM_LIMIT - STATIC_RESERVE || (long long)p.splits * row_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.rows_total = rows;
  p.slots = slots;
  if (gather) {
    switch (mode) {
      case DENSE: return launch_gather<D, DENSE>(p, batch, row_blocks, smem, stream);
      case INT8: return launch_gather<D, INT8>(p, batch, row_blocks, smem, stream);
      case FP8: return launch_gather<D, FP8>(p, batch, row_blocks, smem, stream);
      case INT4: return launch_gather<D, INT4>(p, batch, row_blocks, smem, stream);
      default: return launch_gather<D, INT8C>(p, batch, row_blocks, smem, stream);
    }
  }
  switch (mode) {
    case DENSE: return launch<D, DENSE>(p, batch, row_blocks, smem, stream);
    case INT8: return launch<D, INT8>(p, batch, row_blocks, smem, stream);
    case FP8: return launch<D, FP8>(p, batch, row_blocks, smem, stream);
    case INT4: return launch<D, INT4>(p, batch, row_blocks, smem, stream);
    default: return launch<D, INT8C>(p, batch, row_blocks, smem, stream);
  }
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The split kernel. q (batch, heads, q_tokens, d_head) act_t contiguous
// (q_tokens 1: (batch, heads, d_head)), d_head 128 or 256; k/v pages
// (kv_heads, num_pages, rows, d_head) contiguous: act_t (mode 0), int8 (1,
// and 4 = int8 compute), fp8 e4m3 (2), or int4 packed along tokens (3, rows
// = page_size / 2); k/v scales (kv_heads, num_pages) fp32 (read for modes
// 1-4); lengths (batch,) int32, the q tokens included; page_tables (batch,
// pages_per_seq) int32, -1 padded. Any heads divisible by kv_heads and any
// q_tokens >= 1; any page_size >= 1 (int4: even). `splits` splits of
// `pages_per_split` page-table columns (splits * pages_per_split >=
// pages_per_seq). With one split, out (like q) is written here and ws_o,
// ws_ml are not read; with more, each split's partial goes to ws_o (batch *
// kv_heads, splits, rows, d_head) and ws_ml (..., 2) fp32, and
// fa_paged_decode_merge writes out. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int fa_paged_decode_split(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scales, const void* v_scales,
                          const void* lengths, const void* page_tables, void* out,
                          int batch, int heads, int kv_heads, int num_pages,
                          int page_size, int pages_per_seq, int q_tokens, int d_head,
                          float scale, float softcap, int window, int mode, int splits,
                          int pages_per_split, void* ws_o, void* ws_ml, void* stream) {
  const int store = mode == INT8C ? INT8 : mode;
  if (kv_heads <= 0 || heads % kv_heads || q_tokens < 1 || batch < 1 || page_size < 1 ||
      mode < DENSE || mode > INT8C || (store == INT4 && page_size % 2) || splits < 1 ||
      pages_per_split < 1 || (long long)splits * pages_per_split < pages_per_seq ||
      (splits > 1 && !(ws_o && ws_ml)) || (d_head != 128 && d_head != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const act_t*>(q);
  p.k_pages = static_cast<const uint8_t*>(k_pages);
  p.v_pages = static_cast<const uint8_t*>(v_pages);
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.lengths = static_cast<const int*>(lengths);
  p.page_tables = static_cast<const int*>(page_tables);
  p.out = static_cast<act_t*>(out);
  p.ws_o = splits > 1 ? static_cast<float*>(ws_o) : nullptr;
  p.ws_ml = splits > 1 ? static_cast<float*>(ws_ml) : nullptr;
  p.kv_heads = kv_heads;
  p.num_pages = num_pages;
  p.page_size = page_size;
  p.pages_per_seq = pages_per_seq;
  p.q_tokens = q_tokens;
  p.splits = splits;
  p.pages_per_split = pages_per_split;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d_head == 128 ? split_launch<128>(p, batch, heads, mode, s)
                       : split_launch<256>(p, batch, heads, mode, s);
}

// The merge of fa_paged_decode_split's partials into out (like q).
int fa_paged_decode_merge(const void* ws_o, const void* ws_ml, void* out, int batch,
                          int heads, int kv_heads, int q_tokens, int splits, int d_head,
                          void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || q_tokens < 1 || batch < 1 || splits < 1 ||
      (d_head != 128 && d_head != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = heads / kv_heads * q_tokens;
  const long long blocks = (long long)batch * kv_heads * rows;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = d_head == 128 ? paged_decode_merge_kernel<128> : paged_decode_merge_kernel<256>;
  kernel<<<static_cast<unsigned>(blocks), d_head, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws_o), static_cast<const float*>(ws_ml),
      static_cast<act_t*>(out), splits, rows);
  return static_cast<int>(cudaGetLastError());
}

// One split (the whole walk in one CTA per (sequence, KV head, row block)):
// the split kernel's arguments without the plan's, out written directly.
int fa_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                    const void* k_scales, const void* v_scales,
                    const void* lengths, const void* page_tables, void* out,
                    int batch, int heads, int kv_heads, int num_pages,
                    int page_size, int pages_per_seq, int q_tokens, int d_head, float scale,
                    float softcap, int window, int mode, void* stream) {
  return fa_paged_decode_split(q, k_pages, v_pages, k_scales, v_scales, lengths, page_tables,
                               out, batch, heads, kv_heads, num_pages, page_size,
                               pages_per_seq, q_tokens, d_head, scale, softcap, window, mode, 1,
                               std::max(pages_per_seq, 1), nullptr, nullptr, stream);
}

}  // extern "C"
