// Prefill attention over quantized K/V for Hopper, d_head 128 or 256: int8,
// fp8 (e4m3) or int4 K/V with one fp32 scale per (batch, KV head); Q in the
// compute type or quantized (int8 or fp8, one scale per (batch, Q head));
// output in the compute type. The compute type is the library's act_t
// (hopper.cuh): bf16, or fp16 in flash_quant_f16.cu and
// flash_quant_d256_f16.cu (this source built with FA_F16), the type the
// JAX kernel computes in (its cfg.dtype: a dense Q's type, or a quantized
// Q's orig_dtype). Below, "bf16" tiles and products are act_t ones: fp16
// has bf16's bytes and wgmma shapes and the same 989 TFLOP/s.
//
// Replaces the TPU kernel flash_attention_from_scratch_tpu/ops/flash_quant.py
// _quant_kernel, with its int8-compute update _attend_i8. Two kernels on the
// CTA of flash_wgmma.cuh (a producer warpgroup and two consumer warpgroups
// of 64 Q rows, 128 Q rows of one (Q head, batch) per CTA, heaviest causal
// tiles first); both read K and V as stored, through TMA, and write no
// dequantized K/V to device memory:
//
//   flash_quant_kernel<QT, KV> (the upcast modes): one producer thread
//     brings each 128-key tile's raw K and V bytes by TMA into one of two
//     raw slots; the producer warpgroup converts them into a ring of two
//     bf16 K/V slots (128-byte swizzled, the layout the consumers' wgmma
//     reads) while the consumers run the previous tile and the next raw
//     tile is in flight, then arrives on the slot's full barrier. The
//     conversions are exact: int8 through the fp32 magic number 2^23 + u
//     (as K6's dequantization in quant_matmul.cu; fp16: the fp16 word
//     0x6400 | u = 1024 + u, minus 1152), fp8-e4m3 through
//     cvt.rn.f16x2.e4m3x2 (every e4m3 value is exact in fp16 and in bf16),
//     int4 (half-split along d: byte j holds column j in its low nibble and
//     column j + d/2 in its high) by the bf16 bits 0x4300 | (n ^ 8) minus
//     136 (fp16: 0x6400 | (n ^ 8) minus 1032), the low nibbles into the
//     boxes of columns 0 .. d/2 - 1 (box 0 at d 128, boxes 0-1 at d 256) and
//     the high ones into the boxes of the columns after (box 1, boxes 2-3).
//     An int8 or fp8 Q is upcast the same way once per CTA. The consumers run flash_wgmma.cuh's bf16 tile math
//     (consume_bf16). The K scale (and Q's) folds into the softmax scale,
//     the V scale into the final normalisation, as at flash_quant.py:155-159
//     and :273.
//   flash_quant_i8_kernel (int8_compute: int8 Q, K and V): both products on
//     wgmma m64n128k32 s8 with exact int32 sums. Each 128-key tile is one P
//     quantization group, as the JAX kernel at block_kv=128 quantizes P:
//     s = Q_i8 K_i8^T (int32; 127 * 127 * 256 < 2^22 at d 256, exact also
//     through the fp32 magic-number conversion below), m = max(s) * c over
//     the group, P = exp2(s * c - m) rounded to int8 at the constant 127,
//     l = the integer row sum of that P, acc = P_i8 V_i8 (int32); groups
//     merge online in fp32 and O = acc / l * v_scale. Q and K arrive by TMA
//     (128-byte rows, swizzled) and feed S's wgmma as they are. 8-bit wgmma
//     takes no transposed operand, so the producer warpgroup transposes
//     each raw V tile into (d, kv) rows (4x4 byte transposes in registers,
//     __byte_perm) with the kv order permuted within each 16-key chunk:
//     position 4 t + i holds key {2t, 2t+1, 8+2t, 9+2t}[i], the columns a
//     thread holds of S's accumulator, so P's int8 A fragments are S's own
//     registers and the product over k is unchanged.
//
// What bounds it on the H100: at prefill lengths the two products are far
// above the ~295 operations-per-byte balance point, so tensor-core
// operations bound it: 989 TFLOP/s for the bf16 products of the upcast
// modes, 1979 TOP/s for int8_compute.
//
// Head width 256 (Gemma-2) is the same two kernels at HD = 256, built as a
// library of their own (flash_quant_d256.cu; QUANT_HD below), so that the
// d-128 kernels compile as they did alone. The 64 x 256 fp32 O is 128
// registers a consumer thread, which no CTA of more than 8 warps can hold
// beside S and P, so both kernels' CTA is CtaShape<256>: one producer
// warpgroup (which also converts or transposes the raw bytes) and ONE
// consumer warpgroup of 64 Q rows, 256 threads. Every bf16 tile has four
// 64-column boxes.
//   Upcast modes at d 256: tiles of 64 keys (UpcastTile::BK). The bf16 Q
//     tile is 32 KB, two bf16 K/V slots 128 KB, two raw slots 64 KB (int8,
//     fp8) or 32 KB (int4): 225 KB with the slack. A quantized Q's raw 16
//     KB passes through a raw slot, as at d 128. O += P V is two m64n128
//     products a k step over V's column halves (flash_wgmma.cuh).
//   int8_compute at d 256: the P group stays 128 keys (the JAX kernel's
//     block_kv group). A consumer thread cannot hold S (int32 m64n128: 64
//     registers), an int32 P V accumulator over 256 columns (128) and the
//     fp32 O (128) at once, so P V runs over V's two column halves, one
//     m64n128 s8 product each into one 64-register accumulator, each folded
//     into its half of O before the next is issued: the peak is O, one
//     half's accumulator and P's 16 fragment registers. The int8 Q tile is
//     16 KB; a slot holds K (128 keys, 32 KB) and V^T (32 KB), so two slots
//     and two raw V slots (32 KB each) fit: 209 KB. Q, K and the raw V
//     arrive as two 128-byte-swizzled boxes of 128 d bytes each (a
//     128-byte swizzle spans 128 bytes).

#include <cuda_fp16.h>

#include "flash_wgmma.cuh"

namespace {

enum { Q_BF16 = 0, Q_INT8 = 1, Q_FP8 = 2 };
enum { KV_INT8 = 1, KV_FP8 = 2, KV_INT4 = 3 };

constexpr int BKQ = 128;  // the P group of int8_compute: its keys per tile
constexpr int SW_BYTES = 128;  // bytes of a row of a 128-byte-swizzled int8 box
constexpr int PRODUCER_BAR = 1;  // named barrier of the producer warpgroup

// Stored bytes of one K/V row: hd (int8, fp8) or hd / 2 (int4).
__host__ __device__ constexpr int row_bytes(int kv, int hd) {
  return kv == KV_INT4 ? hd / 2 : hd;
}

// The launch geometry of the upcast kernel at head width HD
// (ops/flash_quant.py::plan mirrors it): the bf16 Q tile, two bf16 K/V
// slots and two raw K/V slots of BK keys; a quantized Q's raw bytes pass
// through raw slot 1 before its first tile.
template <int QT, int KV, int HD>
struct UpcastTile : CtaShape<HD> {
  static constexpr int BK = HD == 128 ? 128 : 64;  // keys per tile
  static constexpr int SLOTS = 2;
  static constexpr int RAW_SLOTS = 2;
  static constexpr int Q_BYTES = bf16_tile_bytes(CtaShape<HD>::BQ, HD);
  static constexpr int Q_RAW = QT == Q_BF16 ? 0 : CtaShape<HD>::BQ * HD;
  static constexpr int SLOT = 2 * bf16_tile_bytes(BK, HD);
  static constexpr int RAW = 2 * BK * row_bytes(KV, HD);  // raw K, then raw V
  static constexpr int SMEM = Q_BYTES + SLOTS * SLOT + RAW_SLOTS * RAW + ALIGN_SLACK;
  static_assert(Q_RAW <= RAW, "a raw slot holds the raw Q tile");
  static_assert(SMEM <= SMEM_LIMIT, "the ring does not fit a CTA's shared memory");
};

// The int8-compute kernel's: the int8 Q tile, SLOTS slots of the int8 K
// tile and the transposed V tile, two raw V slots; tiles of BKQ keys.
template <int HD>
struct I8Tile : CtaShape<HD> {
  static constexpr int SLOTS = HD == 128 ? 4 : 2;
  static constexpr int RAW_SLOTS = 2;
  static constexpr int Q_BYTES = CtaShape<HD>::BQ * HD;
  static constexpr int SLOT = 2 * BKQ * HD;  // K (kv, d), then V^T (d, kv')
  static constexpr int RAW = BKQ * HD;
  static constexpr int SMEM = Q_BYTES + SLOTS * SLOT + RAW_SLOTS * RAW + ALIGN_SLACK;
  static_assert(SMEM <= SMEM_LIMIT, "the ring does not fit a CTA's shared memory");
};

struct Params {
  act_t* o;
  const float* qs;  // (batch, heads), or null for bf16 Q
  const float* ks;  // (batch, kv_heads)
  const float* vs;  // (batch, kv_heads)
  long long o_sb, o_sh, o_ss;  // element strides
  int heads, kv_heads, group, seq_q, seq_kv;
  int causal, window;
  float scale, softcap;
};

// ---------------------------------------------------------------------------
// Exact conversions to act_t pairs (bf16x2 or fp16x2 words).

#ifdef FA_F16
// The fp16 pair w minus the fp16 value with bits `bias` from each half
// (exact here: integers below 2^11 on both sides).
__device__ __forceinline__ uint32_t half2_minus(uint32_t w, unsigned short bias) {
  const __half2 b = __halves2half2(__ushort_as_half(bias), __ushort_as_half(bias));
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&w), b);
  return *reinterpret_cast<const uint32_t*>(&r);
}
#endif

// int8 bytes 0, 1 (lo) and 2, 3 (hi) of w.
__device__ __forceinline__ void int8x4_to_act(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // u = v + 128 per byte
#ifdef FA_F16
  // Bytes 0, 1 (2, 3) of u under the byte 0x64 (selector 4: the second
  // operand's): the fp16 words 0x64uu = 1024 + u, minus 1152 (0x6480).
  lo = half2_minus(__byte_perm(u, 0x64646464u, 0x4140), 0x6480);
  hi = half2_minus(__byte_perm(u, 0x64646464u, 0x4342), 0x6480);
#else
  const float magic = 8388736.0f;      // 2^23 + 128
  lo = bf16x2_upper(byte_value<0>(u, magic), byte_value<1>(u, magic));
  hi = bf16x2_upper(byte_value<2>(u, magic), byte_value<3>(u, magic));
#endif
}

// Two e4m3 bytes (the low 16 bits of w) -> an act_t pair: fp16 directly,
// bf16 through fp16 (exact).
__device__ __forceinline__ uint32_t e4m3x2_to_act(uint32_t w) {
  uint32_t h2;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h2) : "h"(static_cast<unsigned short>(w)));
#ifdef FA_F16
  return h2;
#else
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
  return pack_bf16(f.x, f.y);
#endif
}

// Two signed nibbles (bits 0-3 and 16-19 of t) -> an act_t pair: the bf16
// bits 0x4300 | (n ^ 8) are 128 + (v + 8), minus 136; the fp16 bits
// 0x6400 | (n ^ 8) are 1024 + (v + 8), minus 1032.
__device__ __forceinline__ uint32_t nibbles_to_act(uint32_t t) {
#ifdef FA_F16
  return half2_minus((t & 0x000F000Fu) ^ 0x64086408u, 0x6408);
#else
  const uint32_t x = (t & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 bias = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                 __ushort_as_bfloat16(0x4308));
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x), bias);
  return *reinterpret_cast<const uint32_t*>(&r);
#endif
}

// 16 raw int8 or fp8 bytes -> 16 act_t values (8 words).
template <bool FP8>
__device__ __forceinline__ void bytes16_to_act(const uint4& raw, uint32_t (&o)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (FP8) {
      o[2 * i] = e4m3x2_to_act(w[i]);
      o[2 * i + 1] = e4m3x2_to_act(w[i] >> 16);
    } else {
      int8x4_to_act(w[i], o[2 * i], o[2 * i + 1]);
    }
  }
}

// One 16-byte unit u of a raw tile (rows of row_bytes(KV, HD) bytes, unit u
// at byte 16 u) -> its bf16 values in the swizzled (ROWS x HD) tile at dst.
// int8 and fp8: 16 columns of a row; int4: 16 bytes of a row, whose low
// nibbles are 16 columns of the first half and high nibbles the same 16
// columns of the second (HD / 2 columns on).
template <int KV, int ROWS, int HD>
__device__ __forceinline__ void convert_unit(uint8_t* dst, unsigned u, const uint4& raw16) {
  // 16-byte units of a raw row, a power of two: u's row and column are a
  // shift and a mask of the unsigned u.
  constexpr unsigned UNITS_ROW = row_bytes(KV, HD) / 16;
  if constexpr (KV == KV_INT4) {
    const int r = u / UNITS_ROW, c = (u % UNITS_ROW) * 16;
    const uint32_t w[4] = {raw16.x, raw16.y, raw16.z, raw16.w};
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t t01 = __byte_perm(w[i], 0, 0x4140), t23 = __byte_perm(w[i], 0, 0x4342);
      lo[2 * i] = nibbles_to_act(t01);
      lo[2 * i + 1] = nibbles_to_act(t23);
      hi[2 * i] = nibbles_to_act(t01 >> 4);
      hi[2 * i + 1] = nibbles_to_act(t23 >> 4);
    }
    // At d 256 a row's 8 units span boxes 0 and 1: the units in box 1 store
    // their second chunk first, as the int8 path below does.
    const bool flip = HD > 128 && (c & BOX_COLS);
    const int a = flip ? 8 : 0, b = flip ? 0 : 8;
    *reinterpret_cast<uint4*>(dst + bf16_tile_offset(ROWS, r, c + a)) =
        flip ? make_uint4(lo[4], lo[5], lo[6], lo[7]) : make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(dst + bf16_tile_offset(ROWS, r, c + b)) =
        flip ? make_uint4(lo[0], lo[1], lo[2], lo[3]) : make_uint4(lo[4], lo[5], lo[6], lo[7]);
    *reinterpret_cast<uint4*>(dst + bf16_tile_offset(ROWS, r, c + HD / 2 + a)) =
        flip ? make_uint4(hi[4], hi[5], hi[6], hi[7]) : make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + bf16_tile_offset(ROWS, r, c + HD / 2 + b)) =
        flip ? make_uint4(hi[0], hi[1], hi[2], hi[3]) : make_uint4(hi[4], hi[5], hi[6], hi[7]);
  } else {
    const int r = u / UNITS_ROW, c = (u % UNITS_ROW) * 16;
    uint32_t o[8];
    bytes16_to_act<KV == KV_FP8>(raw16, o);
    // The row's threads for the columns of odd boxes (64-127, 192-255)
    // store their second chunk first, so that each store of 8 threads covers
    // the 8 chunk positions (the boxes are a multiple of 128 bytes apart).
    // At d 128 the test stays c >= BOX_COLS: with c & BOX_COLS there, ptxas
    // spilled 16-20 bytes in six of the nine upcast kernels.
    const uint4 lo = make_uint4(o[0], o[1], o[2], o[3]), hi = make_uint4(o[4], o[5], o[6], o[7]);
    const bool flip = HD == 128 ? c >= BOX_COLS : (c & BOX_COLS) != 0;
    *reinterpret_cast<uint4*>(dst + bf16_tile_offset(ROWS, r, c + (flip ? 8 : 0))) =
        flip ? hi : lo;
    *reinterpret_cast<uint4*>(dst + bf16_tile_offset(ROWS, r, c + (flip ? 0 : 8))) =
        flip ? lo : hi;
  }
}

// TILES raw (ROWS x row_bytes(KV, HD)) tiles, raw_stride bytes apart, -> as
// many swizzled bf16 (ROWS x HD) tiles, bf16_tile_bytes(ROWS, HD) apart; the
// 128 threads of the producer warpgroup, thread pt. Every load is issued
// before the first store, so that the loads' latency overlaps.
template <int KV, int ROWS, int TILES, int HD>
__device__ __forceinline__ void convert_tiles(uint8_t* dst, const uint8_t* raw, int raw_stride,
                                              int pt) {
  constexpr int UNITS = ROWS * row_bytes(KV, HD) / 16 / 128;  // a thread's units a tile
  uint4 in[TILES][UNITS];
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int it = 0; it < UNITS; ++it)
      in[t][it] = *reinterpret_cast<const uint4*>(raw + t * raw_stride + (it * 128 + pt) * 16);
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int it = 0; it < UNITS; ++it)
      convert_unit<KV, ROWS, HD>(dst + t * bf16_tile_bytes(ROWS, HD), it * 128 + pt,
                                 in[t][it]);
}

// The position geometry every kernel here shares: CTAs of BQ Q rows over
// tiles of BK keys.
template <int BQ, int BK>
struct Cta {
  int h, b, hk, q0, first, n;

  __device__ __forceinline__ Cta(const Params& p) {
    const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
    h = blockIdx.y;
    b = blockIdx.z;
    hk = h / p.group;
    q0 = q_tile * BQ;
    int last;
    cta_tiles(p.causal, p.window, q0, min(BQ, p.seq_q - q0), p.seq_kv, BK, first, last);
    n = max(last - first + 1, 0);
  }

  // Consumer warpgroup cw's rows (top-left aligned: position = index).
  __device__ __forceinline__ RowGroup rows(const Params& p, int cw) const {
    const int r0 = q0 + cw * WG_ROWS;
    return RowGroup{r0, min(max(p.seq_q - r0, 0), WG_ROWS)};
  }
};

// ---------------------------------------------------------------------------
// The upcast modes.

template <int QT, int KV, int HD>
__global__ void __launch_bounds__(UpcastTile<QT, KV, HD>::THREADS, 1)
flash_quant_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using T = UpcastTile<QT, KV, HD>;
  constexpr int BQ = T::BQ, BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, q_raw_full, raw_full[T::RAW_SLOTS], full[T::SLOTS],
      empty[T::SLOTS];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* ring = q_s + T::Q_BYTES;
  uint8_t* raw = ring + T::SLOTS * T::SLOT;  // slot r: raw K, then raw V
  uint8_t* q_raw = raw + T::RAW;             // raw slot 1, before its first tile

  const int tid = threadIdx.x, wg = tid / 128;
  const Cta<BQ, BK> cta(p);

  if (tid == 0) {
    mbar_init(&q_full, 1);
    mbar_init(&q_raw_full, 1);
    for (int r = 0; r < T::RAW_SLOTS; ++r) mbar_init(&raw_full[r], 1);
    for (int s = 0; s < T::SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::ARRIVALS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: thread 0 copies, the warpgroup converts
    const int pt = tid;
    auto issue_raw = [&](int i) {
      const int kv0 = (cta.first + i) * BK, r = i % T::RAW_SLOTS;
      uint8_t* dst = raw + r * T::RAW;
      mbar_arrive_expect_tx(&raw_full[r], T::RAW);
      tma_load_4d(dst, &tm_k, 0, kv0, cta.hk, cta.b, &raw_full[r]);
      tma_load_4d(dst + T::RAW / 2, &tm_v, 0, kv0, cta.hk, cta.b, &raw_full[r]);
    };
    if (pt == 0) {
      if constexpr (QT == Q_BF16) {
        mbar_arrive_expect_tx(&q_full, T::Q_BYTES);
#pragma unroll
        for (int bx = 0; bx < T::BOXES; ++bx)
          tma_load_4d(q_s + bx * bf16_box_bytes(BQ), &tm_q, bx * BOX_COLS, cta.q0, cta.h, cta.b,
                      &q_full);
      } else {
        mbar_arrive_expect_tx(&q_raw_full, T::Q_RAW);
        tma_load_4d(q_raw, &tm_q, 0, cta.q0, cta.h, cta.b, &q_raw_full);
      }
      if (cta.n > 0) issue_raw(0);
    }
    if constexpr (QT != Q_BF16) {  // upcast Q once
      mbar_wait(&q_raw_full, 0);
      convert_tiles<QT == Q_FP8 ? KV_FP8 : KV_INT8, BQ, 1, HD>(q_s, q_raw, 0, pt);
      fence_proxy_async();
      named_bar_sync(PRODUCER_BAR, 128);  // raw slot 1 is free again
      if (pt == 0) mbar_arrive(&q_full);
    }
    if (pt == 0 && cta.n > 1) issue_raw(1);
    for (int i = 0; i < cta.n; ++i) {
      const int s = i % T::SLOTS, r = i % T::RAW_SLOTS;
      mbar_wait(&raw_full[r], (i / T::RAW_SLOTS) & 1);
      if (i >= T::SLOTS) mbar_wait(&empty[s], (i / T::SLOTS - 1) & 1);
      uint8_t* slot = ring + s * T::SLOT;
      const uint8_t* src = raw + r * T::RAW;
      convert_tiles<KV, BK, 2, HD>(slot, src, T::RAW / 2, pt);  // K, then V
      fence_proxy_async();
      named_bar_sync(PRODUCER_BAR, 128);  // the raw slot is read, the bf16 slot written
      if (pt == 0) {
        mbar_arrive(&full[s]);
        if (i + T::RAW_SLOTS < cta.n) issue_raw(i + T::RAW_SLOTS);
      }
    }
    return;
  }

  const int cw = wg - 1;
  // The K (and Q) scale folds into the softmax scale, V's into the output.
  float eff = p.scale * p.ks[cta.b * p.kv_heads + cta.hk];
  if (QT != Q_BF16) eff *= p.qs[cta.b * p.heads + cta.h];
  const float v_scale = p.vs[cta.b * p.kv_heads + cta.hk];
  RowStateT<HD> st;
  st.init();
  mbar_wait(&q_full, 0);
  consume_bf16<BK, T::SLOTS>(st, cta.rows(p, cw), full, empty, ring, T::SLOT,
                              smem_addr(q_s) + cw * WG_ROWS * 128, bf16_box_bytes(BQ),
                              cta.first, cta.n,
                              TileMath{p.causal, p.window, p.seq_kv, eff, p.softcap});
  const int lane = tid & 31;
  store_rows(st, cta.q0 + cw * WG_ROWS + ((tid >> 5) & 3) * 16 + (lane >> 2), p.seq_q,
             p.o + cta.b * p.o_sb + cta.h * p.o_sh, p.o_ss, v_scale, -INFINITY, nullptr);
}

// ---------------------------------------------------------------------------
// int8_compute.

// Byte offset of (row r, byte c) in a 128-byte-swizzled tile of 128-byte
// rows.
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * 128 + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15);
}

// The raw V tile (kv rows of HD d bytes, swizzled by TMA as HD / 128 boxes
// of 128 d bytes, BKQ * 128 bytes apart) -> V^T (HD d rows of 128 kv' bytes,
// swizzled): kv' = 16 c + 4 t + i holds kv row 16 c + {2t, 2t+1, 8+2t,
// 9+2t}[i]. Thread pt: d columns 4 dg .. 4 dg + 3 of each box and one t.
template <int HD>
__device__ __forceinline__ void transpose_v(uint8_t* vt, const uint8_t* vr, int pt) {
  const int t = pt & 3, dg = pt >> 2;
  // A thread writes its 4 d rows starting at row `rot`, so that the rows
  // of one store across a warp (4 dg + (k + rot) % 4, dg = 8 w .. 8 w + 7)
  // fall in 8 different swizzle phases: 32 stores on 32 banks.
  const int rot = (dg >> 1) & 3;
#pragma unroll
  for (int bx = 0; bx < HD / SW_BYTES; ++bx) {
    const uint8_t* vb = vr + bx * BKQ * SW_BYTES;
    uint8_t* tb = vt + bx * SW_BYTES * SW_BYTES;  // V^T rows 128 bx ..
#pragma unroll
    for (int ch = 0; ch < BKQ / 16; ++ch) {
      const int r0 = ch * 16 + 2 * t;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(vb + sw128_offset(r0, 4 * dg));
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(vb + sw128_offset(r0 + 1, 4 * dg));
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(vb + sw128_offset(r0 + 8, 4 * dg));
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(vb + sw128_offset(r0 + 9, 4 * dg));
      const uint32_t t01l = __byte_perm(w0, w1, 0x5140);
      const uint32_t t23l = __byte_perm(w2, w3, 0x5140);
      const uint32_t t01h = __byte_perm(w0, w1, 0x7362);
      const uint32_t t23h = __byte_perm(w2, w3, 0x7362);
      uint32_t o[4] = {__byte_perm(t01l, t23l, 0x5410), __byte_perm(t01l, t23l, 0x7632),
                       __byte_perm(t01h, t23h, 0x5410), __byte_perm(t01h, t23h, 0x7632)};
      if (rot & 1) {
        const uint32_t x = o[0];
        o[0] = o[1], o[1] = o[2], o[2] = o[3], o[3] = x;
      }
      if (rot & 2) {
        uint32_t x = o[0];
        o[0] = o[2], o[2] = x;
        x = o[1];
        o[1] = o[3], o[3] = x;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)  // o[k] is d row 4 dg + (k + rot) % 4
        *reinterpret_cast<uint32_t*>(tb + sw128_offset(4 * dg + ((k + rot) & 3),
                                                       ch * 16 + 4 * t)) = o[k];
    }
  }
}

// One 128-key group of int8_compute for this warpgroup's 64 rows: S =
// Q K^T, the P quantization, the online merge and O = O alpha +
// (P_i8 V_i8) w. q_addr: its rows in the Q tile (box b b * q_box bytes on);
// k_addr the K tile and vt_addr V^T, each HD / 128 boxes of 128 bytes a row.
template <int HD>
__device__ __forceinline__ void attend_i8(RowStateT<HD>& st, unsigned q_addr, int q_box,
                                          unsigned k_addr, unsigned vt_addr, int row0, int kv0,
                                          bool masked, const TileMath& tm, float c) {
  // The words 0x4B400000 + v are the fp32 values 1.5 * 2^23 + v for the
  // integers |v| < 2^22 (|s| <= 127 * 127 * 256 < 2^22 at d 256, 0 <= P <=
  // 127, |P V| <= 127 * 127 * 128): the exact conversions without the
  // quarter-rate I2F and F2I.
  constexpr int MAGIC_BITS = 0x4B400000;
  constexpr float MAGIC = 12582912.0f;
  const int q = threadIdx.x & 3;
  int si[BKQ / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 32; ++kk)
    wgmma_ss_s8_n128(si, sw128_desc(q_addr + (kk >> 2) * q_box + (kk & 3) * 32),
                     sw128_desc(k_addr + (kk >> 2) * BKQ * SW_BYTES + (kk & 3) * 32), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();

  // The group's masked scores and their row max, times c.
  float sf[BKQ / 2];
  float mg[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BKQ / 2; ++j) {
    float x = __int_as_float(si[j] + MAGIC_BITS) - MAGIC;
    if (masked) {
      const int qpos = row0 + ((j >> 1) & 1) * 8, kpos = kv0 + (j >> 2) * 8 + 2 * q + (j & 1);
      if (!visible(tm.causal, tm.window, tm.seq_kv, qpos, kpos)) x = MASK_VALUE;
    }
    sf[j] = x;
    mg[(j >> 1) & 1] = fmaxf(mg[(j >> 1) & 1], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mg[r] = fmaxf(mg[r], __shfl_xor_sync(0xffffffff, mg[r], 1));
    mg[r] = fmaxf(mg[r], __shfl_xor_sync(0xffffffff, mg[r], 2));
    mg[r] *= c;
  }

  // P = exp2(s c - m) * 127 rounded to the nearest integer (ties to even)
  // as the low byte of the word of MAGIC + P, and the integer row sums
  // (the words' sum less 32 MAGIC_BITS, mod 2^32).
  uint32_t pw[BKQ / 2];
  uint32_t lw[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < BKQ / 2; ++j) {
    pw[j] = __float_as_uint(fmaf(fast_exp2(fmaf(sf[j], c, -mg[(j >> 1) & 1])), 127.f, MAGIC));
    lw[(j >> 1) & 1] += pw[j];
  }
  int lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    lsum[r] = static_cast<int>(lw[r] - (BKQ / 4) * static_cast<uint32_t>(MAGIC_BITS));

  // P as s8 A fragments: for key step kk (32 keys), register 2 hh + (row
  // half) holds in byte 2 (j & 1) + (e & 1) accumulator block
  // j = 4 kk + 2 hh + (j & 1), element e of that row half; V^T's kv' order
  // matches.
  uint32_t pa[BKQ / 32][4];
#pragma unroll
  for (int kk = 0; kk < BKQ / 32; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i0 = 4 * (4 * kk + 2 * (r >> 1)) + 2 * (r & 1), i1 = i0 + 4;
      pa[kk][r] = __byte_perm(__byte_perm(pw[i0], pw[i0 + 1], 0x0040),
                              __byte_perm(pw[i1], pw[i1 + 1], 0x0040), 0x5410);
    }

  // Merge the group online: m_new = max(m, m_g), the running sums by
  // exp2(m - m_new), the group's by exp2(m_g - m_new).
  float alpha[2], w[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(st.m[r], mg[r]);
    alpha[r] = fast_exp2(st.m[r] - m_new);
    w[r] = fast_exp2(mg[r] - m_new);
    st.m[r] = m_new;
    st.l[r] = st.l[r] * alpha[r] + static_cast<float>(lsum[r]) * w[r];
  }

  // O = O alpha + (P_i8 V_i8) w, one 128-column half of O at a time (V^T's
  // rows 128 h ..): each half's int32 accumulator is folded into O before
  // the next is issued. acc w as (MAGIC + acc) w - MAGIC w: the rounding of
  // MAGIC w moves each term by at most half a unit of acc (times w <= 1).
  // Each group's row sum is at least 127 (its max key gives P = 127), so
  // O = sum(acc w) / sum(l w) moves by at most 1 / 254 of a V unit, 2^-15 of
  // the largest |V| (127 units): below the bf16 output's half-unit and
  // fp16's (2^-9 and 2^-12 of a value of that size). The fp16 library
  // stores the same sums in fp16; its checks hold it to fp16's rule.
  const float off[2] = {-MAGIC * w[0], -MAGIC * w[1]};
#pragma unroll
  for (int h = 0; h < HD / 128; ++h) {
    int acc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKQ / 32; ++kk)
      wgmma_s8_n128(acc, pa[kk], sw128_desc(vt_addr + h * 128 * SW_BYTES + kk * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int r = (j >> 1) & 1;
      st.o[64 * h + j] =
          fmaf(st.o[64 * h + j], alpha[r], fmaf(__int_as_float(acc[j] + MAGIC_BITS), w[r], off[r]));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(I8Tile<HD>::THREADS, 1)
flash_quant_i8_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using T = I8Tile<HD>;
  constexpr int BQ = T::BQ, BOXES = HD / SW_BYTES;  // 128-byte boxes of a row
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[T::SLOTS], empty[T::SLOTS],
      raw_full[T::RAW_SLOTS];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* ring = q_s + T::Q_BYTES;  // slot s: K, then V^T
  uint8_t* raw = ring + T::SLOTS * T::SLOT;

  const int tid = threadIdx.x, wg = tid / 128;
  const Cta<BQ, BKQ> cta(p);

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < T::SLOTS; ++s) {
      mbar_init(&full[s], 2);  // the K copy's arrival, then the transpose's
      mbar_init(&empty[s], T::ARRIVALS);
    }
    for (int r = 0; r < T::RAW_SLOTS; ++r) mbar_init(&raw_full[r], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: thread 0 copies, the warpgroup transposes V
    const int pt = tid;
    // Tile j's K into its slot (once the slot is free) and its raw V.
    auto issue = [&](int j) {
      const int s = j % T::SLOTS, r = j % T::RAW_SLOTS;
      const int kv0 = (cta.first + j) * BKQ;
      if (j >= T::SLOTS) mbar_wait(&empty[s], (j / T::SLOTS - 1) & 1);
      mbar_arrive_expect_tx(&full[s], BKQ * HD);
#pragma unroll
      for (int bx = 0; bx < BOXES; ++bx)
        tma_load_4d(ring + s * T::SLOT + bx * BKQ * SW_BYTES, &tm_k, bx * SW_BYTES, kv0, cta.hk,
                    cta.b, &full[s]);
      mbar_arrive_expect_tx(&raw_full[r], T::RAW);
#pragma unroll
      for (int bx = 0; bx < BOXES; ++bx)
        tma_load_4d(raw + r * T::RAW + bx * BKQ * SW_BYTES, &tm_v, bx * SW_BYTES, kv0, cta.hk,
                    cta.b, &raw_full[r]);
    };
    if (pt == 0) {
      mbar_arrive_expect_tx(&q_full, T::Q_BYTES);
#pragma unroll
      for (int bx = 0; bx < BOXES; ++bx)
        tma_load_4d(q_s + bx * BQ * SW_BYTES, &tm_q, bx * SW_BYTES, cta.q0, cta.h, cta.b,
                    &q_full);
      for (int j = 0; j < T::RAW_SLOTS && j < cta.n; ++j) issue(j);
    }
    for (int i = 0; i < cta.n; ++i) {
      const int s = i % T::SLOTS, r = i % T::RAW_SLOTS;
      mbar_wait(&raw_full[r], (i / T::RAW_SLOTS) & 1);
      if (i >= T::SLOTS) mbar_wait(&empty[s], (i / T::SLOTS - 1) & 1);
      transpose_v<HD>(ring + s * T::SLOT + BKQ * HD, raw + r * T::RAW, pt);
      fence_proxy_async();
      named_bar_sync(PRODUCER_BAR, 128);  // the raw slot is read, V^T written
      if (pt == 0) {
        mbar_arrive(&full[s]);
        if (i + T::RAW_SLOTS < cta.n) issue(i + T::RAW_SLOTS);
      }
    }
    return;
  }

  const int cw = wg - 1;
  // c: the total log2-domain scale (sm_scale * k_scale * q_scale * log2 e).
  const float c = p.scale * p.ks[cta.b * p.kv_heads + cta.hk] * p.qs[cta.b * p.heads + cta.h] *
                  LOG2E;
  const float v_scale = p.vs[cta.b * p.kv_heads + cta.hk];
  const RowGroup rg = cta.rows(p, cw);
  const int lane = tid & 31, wq = (tid >> 5) & 3;
  const int row0 = rg.q_min + wq * 16 + (lane >> 2);
  const unsigned q_addr = smem_addr(q_s) + cw * WG_ROWS * SW_BYTES;
  const TileMath tm{p.causal, p.window, p.seq_kv, 0.f, 0.f};
  RowStateT<HD> st;
  st.init();
  mbar_wait(&q_full, 0);
  walk_tiles<T::SLOTS>(rg, tm, BKQ, cta.first, cta.n, full, empty, [&](int i) {
    const unsigned k_addr = smem_addr(ring + (i % T::SLOTS) * T::SLOT);
    const int kv0 = (cta.first + i) * BKQ;
    attend_i8<HD>(st, q_addr, BQ * SW_BYTES, k_addr, k_addr + BKQ * HD, row0, kv0,
                  rg.needs_mask(p.causal, p.window, kv0, BKQ, p.seq_kv), tm, c);
  });
  store_rows(st, cta.q0 + cw * WG_ROWS + wq * 16 + (lane >> 2), p.seq_q,
             p.o + cta.b * p.o_sb + cta.h * p.o_sh, p.o_ss, v_scale, -INFINITY, nullptr);
}

// ---------------------------------------------------------------------------
// Launch.

struct Maps {
  CUtensorMap q, k, v;
};

template <typename Tile, typename Kernel>
int launch(Kernel kernel, const Maps& m, const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.seq_q + Tile::BQ - 1) / Tile::BQ, p.heads, batch);
  kernel<<<grid, Tile::THREADS, Tile::SMEM, stream>>>(m.q, m.k, m.v, p);
  return static_cast<int>(cudaGetLastError());
}

template <int QT, int HD>
int launch_kv(int kv_mode, const Maps& m, const Params& p, int batch, cudaStream_t stream) {
  switch (kv_mode) {
    case KV_INT8:
      return launch<UpcastTile<QT, KV_INT8, HD>>(flash_quant_kernel<QT, KV_INT8, HD>, m, p,
                                                 batch, stream);
    case KV_FP8:
      return launch<UpcastTile<QT, KV_FP8, HD>>(flash_quant_kernel<QT, KV_FP8, HD>, m, p,
                                                batch, stream);
    case KV_INT4:
      return launch<UpcastTile<QT, KV_INT4, HD>>(flash_quant_kernel<QT, KV_INT4, HD>, m, p,
                                                 batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The head width this library is built for: 128 here, 256 in
// flash_quant_d256.cu, which defines it and includes this file. Each width
// is a library of its own, so that nvcc optimizes the helpers the two share
// for one width at a time (the d-128 kernels compile as they did alone; the
// backward's d-128 kernel gained registers when both widths shared a file:
// flash_backward.cu).
#ifndef QUANT_HD
#define QUANT_HD 128
#endif

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (b, heads, seq_q, d): act_t (q_type 0), int8 (1) or fp8 e4m3 (2); k/v
// (b, kv_heads, seq_kv, d) int8 (kv_mode 1) or fp8 (2), or (b, kv_heads,
// seq_kv, d / 2) packed int4 (3); d = d_head = QUANT_HD; q/k/v strides in
// bytes (multiples of 16, d contiguous, bases 16-byte aligned). qs (b,
// heads) fp32 (read for q_type 1, 2), ks/vs (b, kv_heads) fp32. o (b, heads,
// seq_q, d) act_t, element strides. int8c (q_type 1, kv_mode 1 only): both
// products in int8. seq_q and seq_kv are multiples of 128. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernels
// do not take or a tensor map that cannot be encoded.
int fa_flash_quant(const void* q, const void* k, const void* v, void* o, const void* qs,
                   const void* ks, const void* vs,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss,
                   long long o_sb, long long o_sh, long long o_ss,
                   int batch, int heads, int kv_heads, int seq_q, int seq_kv,
                   int q_type, int kv_mode, int int8c, int causal, int window,
                   float scale, float softcap, int d_head, void* stream) {
  constexpr int HD = QUANT_HD;
  if (d_head != HD || seq_q % BKQ || seq_kv % BKQ || q_type < Q_BF16 || q_type > Q_FP8 ||
      kv_mode < KV_INT8 || kv_mode > KV_INT4 || (int8c && (q_type != Q_INT8 || kv_mode != KV_INT8)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.o = static_cast<act_t*>(o);
  p.qs = static_cast<const float*>(qs);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.group = heads / kv_heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  // Q: act_t as swizzled 64-column boxes, or its raw bytes (swizzled boxes
  // of 128 bytes as int8c's wgmma reads them, one plain box a row for the
  // upcast). K/V: raw rows, swizzled 128-byte boxes for int8c (K feeds
  // wgmma, V the transpose), one plain box a row for the upcast. Box rows:
  // the CTA's Q rows and the kernel's keys a tile.
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const int kv_row = row_bytes(kv_mode, HD);
  const int q_rows = CtaShape<HD>::BQ;
  const int kv_rows = int8c ? BKQ : UpcastTile<Q_BF16, KV_INT8, HD>::BK;
  Maps m;
  const bool q_ok =
      q_type == Q_BF16
          ? encode_bhsd(&m.q, ACT_TMAP, q, batch, heads, seq_q, HD, q_sb, q_sh, q_ss, q_rows,
                        BOX_COLS, true)
          : encode_bhsd(&m.q, u8, q, batch, heads, seq_q, HD, q_sb, q_sh, q_ss, q_rows,
                        int8c ? SW_BYTES : HD, int8c);
  if (!q_ok ||
      !encode_bhsd(&m.k, u8, k, batch, kv_heads, seq_kv, kv_row, k_sb, k_sh, k_ss, kv_rows,
                   int8c ? SW_BYTES : kv_row, int8c) ||
      !encode_bhsd(&m.v, u8, v, batch, kv_heads, seq_kv, kv_row, v_sb, v_sh, v_ss, kv_rows,
                   int8c ? SW_BYTES : kv_row, int8c))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8c) return launch<I8Tile<HD>>(flash_quant_i8_kernel<HD>, m, p, batch, s);
  switch (q_type) {
    case Q_BF16: return launch_kv<Q_BF16, HD>(kv_mode, m, p, batch, s);
    case Q_INT8: return launch_kv<Q_INT8, HD>(kv_mode, m, p, batch, s);
    default: return launch_kv<Q_FP8, HD>(kv_mode, m, p, batch, s);
  }
}

}  // extern "C"
