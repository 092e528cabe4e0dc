// Prefill attention over quantized K/V for Hopper, d_head 128: int8, fp8
// (e4m3) or int4 K/V with one fp32 scale per (batch, KV head); Q in bf16 or
// quantized (int8 or fp8, one scale per (batch, Q head)); bf16 output.
//
// Replaces the TPU kernel flash_attention_from_scratch_tpu/ops/flash_quant.py
// _quant_kernel, with its int8-compute update _attend_i8. Two kernels:
//
//   flash_quant_kernel<QT, KV> (the upcast modes): each K/V tile is upcast to
//     bf16 once, in shared memory, and the math is K1's (flash_tile.cuh's
//     attend_tile): mma.sync m16n8k16 bf16 with fp32 sums, an fp32
//     online softmax in the exp2 domain, P cast to bf16 before PV. int8 and
//     fp8-e4m3 values convert to bf16 exactly; int4 is half-split along d
//     (byte j holds column j in its low nibble, column j + 64 in its high)
//     and sign-extended four bytes at a time. The K scale (and Q's) folds
//     into the softmax scale, the V scale into the final normalisation,
//     as at flash_quant.py:155-159 and :273.
//   flash_quant_i8_kernel (int8_compute: int8 Q, K and V): both products on
//     mma.sync m16n8k32 s8 with exact int32 sums. Each 128-column KV tile is
//     one P quantization group, as the JAX kernel at block_kv=128 quantizes
//     P: s = Q_i8 K_i8^T (int32), m = max(s) * c over the group,
//     P = exp2(s * c - m) rounded to int8 at the constant 127, l = the int32
//     row sum of that P, acc = P_i8 V_i8 (int32); groups merge online in
//     fp32 and O = acc / l * v_scale. The P operand's A fragment holds, per
//     thread, columns {2t, 2t+1, 8+2t, 9+2t} of each 16-column chunk (the S
//     accumulator's own columns, so P never leaves registers); V is
//     transposed into (d, kv) rows in shared memory with a 4x4 byte
//     transpose in registers (__byte_perm, as K8/K9 do in quant_matmul.cu)
//     that puts the kv rows in that same order, so the product over k is
//     unchanged.
//
// One CTA per (64 Q rows, Q head, batch), 4 warps of 16 rows; Q head h reads
// KV head h / group. Causal walks stop at the diagonal tile (top-left
// aligned) and windowed walks start at the first visible tile; raw K/V
// tiles stream through a two-stage cp.async ring.
//
// What bounds it on the H100: at prefill lengths the two products are far
// above the ~295 operations-per-byte balance point, so tensor-core
// operations bound it: 989 TFLOP/s for the bf16 products of the upcast
// modes, 1979 TOP/s for int8_compute. This first version runs mma.sync
// (not wgmma) and converts each tile once in shared memory; native fp8
// wgmma, TMA and a producer warp are later work.

#include <cuda_fp8.h>

#include "flash_tile.cuh"

namespace {

constexpr int BK8 = 128;       // keys per KV tile = P group, int8_compute
constexpr int ROW8 = D + 16;   // padded int8 shared row, in bytes

enum { Q_BF16 = 0, Q_INT8 = 1, Q_FP8 = 2 };
enum { KV_INT8 = 1, KV_FP8 = 2, KV_INT4 = 3 };

struct Params {
  const uint8_t* q;
  const uint8_t* k;
  const uint8_t* v;
  bf16* o;
  const float* qs;  // (batch, heads), or null for bf16 Q
  const float* ks;  // (batch, kv_heads)
  const float* vs;  // (batch, kv_heads)
  long long q_sb, q_sh, q_ss;  // byte strides; d is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;  // element strides
  int heads, kv_heads, group, seq_q, seq_kv;
  int causal, window;
  float scale, softcap;
};

// c += a (16x32 s8, row) * b (32x8 s8, col), exact int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four packed bytes -> their low (hi = false) or high nibbles as four
// sign-extended int8 bytes: (v ^ 8) - 8 per byte, -8 included.
__device__ __forceinline__ uint32_t nibbles(uint32_t w, bool hi) {
  uint32_t v = (hi ? (w >> 4) : w) & 0x0F0F0F0Fu;
  return __vsub4(v ^ 0x08080808u, 0x08080808u);
}

// Byte i of w as a float: int8, or fp8 e4m3 (exact in bf16 either way).
template <bool FP8>
__device__ __forceinline__ float byte_value(uint32_t w, int i) {
  const uint32_t b = (w >> (8 * i)) & 0xFFu;
  if constexpr (FP8) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b);
    return static_cast<float>(v);
  } else {
    return static_cast<float>(static_cast<int8_t>(b));
  }
}

// 16 int8 or fp8 bytes -> 16 bf16 values at dst (16-byte aligned).
template <bool FP8>
__device__ __forceinline__ void store_bf16x16(bf16* dst, uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = pack_bf16(byte_value<FP8>(w[i], 0), byte_value<FP8>(w[i], 1));
    o[2 * i + 1] = pack_bf16(byte_value<FP8>(w[i], 2), byte_value<FP8>(w[i], 3));
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// Stored bytes of one K/V row: 128 (int8, fp8) or 64 (int4).
template <int KV>
__host__ __device__ constexpr int row_bytes() { return KV == KV_INT4 ? D / 2 : D; }

// A raw BK-row K or V tile into shared memory (unpadded rows).
template <int KV>
__device__ __forceinline__ void load_raw(uint8_t* dst, const uint8_t* g, long long row_stride,
                                         int tid) {
  constexpr int RB = row_bytes<KV>(), CH = RB / 16;
#pragma unroll
  for (int c = tid; c < BK * CH; c += NTHREADS) {
    const int r = c / CH, ch = c % CH;
    cp_async16(dst + r * RB + ch * 16, g + r * row_stride + ch * 16);
  }
}

// A raw tile -> bf16 rows (LDS apart) for the mma fragments.
template <int KV>
__device__ __forceinline__ void convert_tile(bf16* dst, const uint8_t* raw, int tid) {
  if constexpr (KV == KV_INT4) {
    // Byte j of a row: column j (low nibble) and column j + 64 (high).
#pragma unroll
    for (int c = tid; c < BK * 4; c += NTHREADS) {
      const int r = c >> 2, j = (c & 3) * 16;
      const uint4 w = *reinterpret_cast<const uint4*>(raw + r * (D / 2) + j);
      store_bf16x16<false>(dst + r * LDS + j,
                           make_uint4(nibbles(w.x, false), nibbles(w.y, false),
                                      nibbles(w.z, false), nibbles(w.w, false)));
      store_bf16x16<false>(dst + r * LDS + D / 2 + j,
                           make_uint4(nibbles(w.x, true), nibbles(w.y, true),
                                      nibbles(w.z, true), nibbles(w.w, true)));
    }
  } else {
#pragma unroll
    for (int c = tid; c < BK * 8; c += NTHREADS) {
      const int r = c >> 3, j = (c & 7) * 16;
      store_bf16x16<KV == KV_FP8>(dst + r * LDS + j,
                                  *reinterpret_cast<const uint4*>(raw + r * D + j));
    }
  }
}

// The CTA's Q tile as bf16 rows: copied (bf16) or upcast (int8, fp8).
template <int QT>
__device__ __forceinline__ void load_q(bf16* q_s, const uint8_t* g, long long row_stride,
                                       int tid) {
  if constexpr (QT == Q_BF16) {
#pragma unroll
    for (int i = 0; i < (BQ * D / 8) / NTHREADS; ++i) {
      const int c = tid + i * NTHREADS;
      const int r = c >> 4, col = (c & 15) * 8;
      cp_async16(q_s + r * LDS + col, g + r * row_stride + col * 2);
    }
  } else {
#pragma unroll
    for (int c = tid; c < BQ * 8; c += NTHREADS) {
      const int r = c >> 3, j = (c & 7) * 16;
      store_bf16x16<QT == Q_FP8>(q_s + r * LDS + j,
                                 *reinterpret_cast<const uint4*>(g + r * row_stride + j));
    }
  }
}

template <int QT, int KV>
__global__ void __launch_bounds__(NTHREADS)
flash_quant_kernel(const Params p) {
  constexpr int RAW = BK * row_bytes<KV>();  // bytes of one raw tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + BQ * LDS;
  bf16* v_s = k_s + BK * LDS;
  uint8_t* raw = reinterpret_cast<uint8_t*>(v_s + BK * LDS);  // 2 stages x (K, V)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = q_tile * BQ;

  const uint8_t* q_g = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const uint8_t* k_g = p.k + b * p.k_sb + hk * p.k_sh;
  const uint8_t* v_g = p.v + b * p.v_sb + hk * p.v_sh;
  // The K (and Q) scale folds into the softmax scale, V's into the output.
  float eff = p.scale * p.ks[b * p.kv_heads + hk];
  if (QT != Q_BF16) eff *= p.qs[b * p.heads + h];
  const float v_scale = p.vs[b * p.kv_heads + hk];

  int first, last;
  kv_tiles(p.causal, p.window, q0, p.seq_kv, BK, first, last);

  load_q<QT>(q_s, q_g, p.q_ss, tid);
  if (first <= last) {
    load_raw<KV>(raw, k_g + first * BK * p.k_ss, p.k_ss, tid);
    load_raw<KV>(raw + RAW, v_g + first * BK * p.v_ss, p.v_ss, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[D / 16][4];
  load_q_fragments(qa, q_s, warp, lane);
  RowState st;
  st.init();

  for (int j = first; j <= last; ++j) {
    const int stage = (j - first) & 1;
    if (j + 1 <= last) {
      uint8_t* nxt = raw + (stage ^ 1) * 2 * RAW;
      load_raw<KV>(nxt, k_g + (long long)(j + 1) * BK * p.k_ss, p.k_ss, tid);
      load_raw<KV>(nxt + RAW, v_g + (long long)(j + 1) * BK * p.v_ss, p.v_ss, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed; tile j + 1 may be in flight
    __syncthreads();
    convert_tile<KV>(k_s, raw + stage * 2 * RAW, tid);
    convert_tile<KV>(v_s, raw + stage * 2 * RAW + RAW, tid);
    __syncthreads();
    attend_tile(st, qa, k_s, v_s, warp, lane, j * BK, p.causal, q0, p.window, eff, p.softcap);
    __syncthreads();  // k_s/v_s and this raw stage are rewritten next
  }

  // Finalise: O = acc / l * v_scale.
  store_rows(st, warp, lane, q0, p.o + b * p.o_sb + h * p.o_sh, p.o_ss, v_scale, -INFINITY,
             nullptr);
}

// A raw BK8-row int8 tile into padded shared rows (ROW8 bytes apart).
__device__ __forceinline__ void load_i8_rows(uint8_t* dst, const uint8_t* g, int rows,
                                             long long row_stride, int tid) {
  for (int c = tid; c < rows * 8; c += NTHREADS) {
    const int r = c >> 3, ch = c & 7;
    cp_async16(dst + r * ROW8 + ch * 16, g + r * row_stride + ch * 16);
  }
}

__global__ void __launch_bounds__(NTHREADS)
flash_quant_i8_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* q_s = smem;                    // BQ x ROW8
  uint8_t* k_raw = q_s + BQ * ROW8;       // 2 stages x BK8 x ROW8
  uint8_t* v_raw = k_raw + 2 * BK8 * ROW8;
  uint8_t* vt = v_raw + 2 * BK8 * ROW8;   // (d, kv) rows: D x ROW8

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = q_tile * BQ;

  const uint8_t* q_g = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const uint8_t* k_g = p.k + b * p.k_sb + hk * p.k_sh;
  const uint8_t* v_g = p.v + b * p.v_sb + hk * p.v_sh;
  // c: the total log2-domain scale (sm_scale * k_scale * q_scale * log2 e).
  const float c = p.scale * p.ks[b * p.kv_heads + hk] * p.qs[b * p.heads + h] * LOG2E;
  const float v_scale = p.vs[b * p.kv_heads + hk];

  int first, last;
  kv_tiles(p.causal, p.window, q0, p.seq_kv, BK8, first, last);

  load_i8_rows(q_s, q_g, BQ, p.q_ss, tid);
  if (first <= last) {
    load_i8_rows(k_raw, k_g + (long long)first * BK8 * p.k_ss, BK8, p.k_ss, tid);
    load_i8_rows(v_raw, v_g + (long long)first * BK8 * p.v_ss, BK8, p.v_ss, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // This warp's 16 Q rows as s8 A fragments, one per 32-wide d step.
  uint32_t qa[D / 32][4];
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    ldmatrix_x4(qa[kk], q_s + (warp * 16 + (lane & 15)) * ROW8 + kk * 32 + (lane >> 4) * 16);

  RowState st;
  st.init();
  const int row0 = q0 + warp * 16 + g;
  const int j4 = lane >> 3;  // which 8x8 matrix this lane addresses in ldmatrix_x4

  for (int j = first; j <= last; ++j) {
    const int stage = (j - first) & 1;
    if (j + 1 <= last) {
      load_i8_rows(k_raw + (stage ^ 1) * BK8 * ROW8, k_g + (long long)(j + 1) * BK8 * p.k_ss,
                   BK8, p.k_ss, tid);
      load_i8_rows(v_raw + (stage ^ 1) * BK8 * ROW8, v_g + (long long)(j + 1) * BK8 * p.v_ss,
                   BK8, p.v_ss, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    // V (kv, d) -> vt (d, kv'): kv' = 16 c + 4 t4 + i holds kv row
    // 16 c + {2 t4, 2 t4 + 1, 8 + 2 t4, 9 + 2 t4}[i], the order of P's
    // A-fragment bytes below. Thread: d columns 4 dg..4 dg+3, one t4.
    {
      const uint8_t* vr = v_raw + stage * BK8 * ROW8;
      const int t4 = tid & 3, dg = tid >> 2;
#pragma unroll
      for (int ch = 0; ch < BK8 / 16; ++ch) {
        const int r0 = ch * 16 + 2 * t4;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(vr + r0 * ROW8 + 4 * dg);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(vr + (r0 + 1) * ROW8 + 4 * dg);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(vr + (r0 + 8) * ROW8 + 4 * dg);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(vr + (r0 + 9) * ROW8 + 4 * dg);
        const uint32_t t01l = __byte_perm(w0, w1, 0x5140);
        const uint32_t t23l = __byte_perm(w2, w3, 0x5140);
        const uint32_t t01h = __byte_perm(w0, w1, 0x7362);
        const uint32_t t23h = __byte_perm(w2, w3, 0x7362);
        const uint32_t o[4] = {__byte_perm(t01l, t23l, 0x5410), __byte_perm(t01l, t23l, 0x7632),
                               __byte_perm(t01h, t23h, 0x5410), __byte_perm(t01h, t23h, 0x7632)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint32_t*>(vt + (4 * dg + i) * ROW8 + ch * 16 + 4 * t4) = o[i];
      }
    }
    __syncthreads();

    // S = Q K^T (int32) for this warp's 16 rows x 128 keys.
    const uint8_t* kr = k_raw + stage * BK8 * ROW8;
    int s[BK8 / 8][4];
#pragma unroll
    for (int n = 0; n < BK8 / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0;
#pragma unroll
    for (int np = 0; np < BK8 / 16; ++np) {
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kr + (np * 16 + (j4 >> 1) * 8 + (lane & 7)) * ROW8 + kk * 32 +
                            (j4 & 1) * 16);
        mma_s8(s[2 * np], qa[kk], kf[0], kf[1]);
        mma_s8(s[2 * np + 1], qa[kk], kf[2], kf[3]);
      }
    }

    // The group's masked float scores and their row max, times c.
    const int kv0 = j * BK8;
    const bool edge = tile_needs_mask(p.causal, p.window, q0, kv0, BK8);
    float sf[BK8 / 8][4];
    float mg[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK8 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = static_cast<float>(s[n][e]);
        if (edge) {
          if (!visible(row0 + (e >> 1) * 8, kv0 + n * 8 + 2 * t + (e & 1), p.window))
            x = MASK_VALUE;
        }
        sf[n][e] = x;
        mg[e >> 1] = fmaxf(mg[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mg[r] = fmaxf(mg[r], __shfl_xor_sync(0xffffffff, mg[r], 1));
      mg[r] = fmaxf(mg[r], __shfl_xor_sync(0xffffffff, mg[r], 2));
      mg[r] *= c;
    }

    // P = exp2(s c - m) rounded to int8 at 127, packed as s8 A fragments:
    // for key step kk, registers 0/1 (rows g / g + 8) hold columns
    // {2t, 2t+1} of 8-column blocks 4kk and 4kk+1, registers 2/3 those of
    // blocks 4kk+2 and 4kk+3.
    uint32_t pa[BK8 / 32][4];
#pragma unroll
    for (int kk = 0; kk < BK8 / 32; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = 0u;
    int lsum[2] = {0, 0};
#pragma unroll
    for (int n = 0; n < BK8 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pq = __float2int_rn(exp2f(sf[n][e] * c - mg[e >> 1]) * 127.f);
        lsum[e >> 1] += pq;
        const int reg = ((n >> 1) & 1) * 2 + (e >> 1), pos = (n & 1) * 2 + (e & 1);
        pa[n >> 2][reg] |= static_cast<uint32_t>(pq) << (8 * pos);
      }
    }

    // Merge the group online: m_new = max(m, m_g), the running sums by
    // exp2(m - m_new), the group's by exp2(m_g - m_new).
    float alpha[2], w[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(st.m[r], mg[r]);
      alpha[r] = exp2f(st.m[r] - m_new);
      w[r] = exp2f(mg[r] - m_new);
      st.m[r] = m_new;
      st.l[r] = st.l[r] * alpha[r] + static_cast<float>(lsum[r]) * w[r];
    }

    // O = O alpha + (P_i8 V_i8) w, two 8-wide d blocks at a time.
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int kk = 0; kk < BK8 / 32; ++kk) {
        uint32_t vf[4];
        ldmatrix_x4(vf, vt + (np * 16 + (j4 >> 1) * 8 + (lane & 7)) * ROW8 + kk * 32 +
                            (j4 & 1) * 16);
        mma_s8(acc[0], pa[kk], vf[0], vf[1]);
        mma_s8(acc[1], pa[kk], vf[2], vf[3]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st.o[2 * np + q][e] =
              st.o[2 * np + q][e] * alpha[e >> 1] + static_cast<float>(acc[q][e]) * w[e >> 1];
    }
    __syncthreads();  // vt and this raw stage are rewritten next
  }

  // Finalise: O = acc / l * v_scale.
  store_rows(st, warp, lane, q0, p.o + b * p.o_sb + h * p.o_sh, p.o_ss, v_scale, -INFINITY,
             nullptr);
}

template <typename Kernel>
int launch(Kernel kernel, int smem, const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.seq_q / BQ, p.heads, batch);
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int QT, int KV>
int launch_upcast(const Params& p, int batch, cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * LDS * static_cast<int>(sizeof(bf16)) +
                   4 * BK * row_bytes<KV>();
  return launch(flash_quant_kernel<QT, KV>, smem, p, batch, stream);
}

template <int QT>
int launch_kv(int kv_mode, const Params& p, int batch, cudaStream_t stream) {
  switch (kv_mode) {
    case KV_INT8: return launch_upcast<QT, KV_INT8>(p, batch, stream);
    case KV_FP8: return launch_upcast<QT, KV_FP8>(p, batch, stream);
    case KV_INT4: return launch_upcast<QT, KV_INT4>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (b, heads, seq_q, 128): bf16 (q_type 0), int8 (1) or fp8 e4m3 (2);
// k/v (b, kv_heads, seq_kv, 128) int8 (kv_mode 1) or fp8 (2), or
// (b, kv_heads, seq_kv, 64) packed int4 (3); q/k/v strides in bytes (rows
// 16-byte aligned, d contiguous). qs (b, heads) fp32 (read for q_type 1, 2),
// ks/vs (b, kv_heads) fp32. o (b, heads, seq_q, 128) bf16, element strides.
// int8c (q_type 1, kv_mode 1 only): both products in int8. seq_q % 64 == 0,
// seq_kv % 64 == 0 (% 128 for int8c). Returns cudaGetLastError().
int fa_flash_quant(const void* q, const void* k, const void* v, void* o, const void* qs,
                   const void* ks, const void* vs,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss,
                   long long v_sb, long long v_sh, long long v_ss,
                   long long o_sb, long long o_sh, long long o_ss,
                   int batch, int heads, int kv_heads, int seq_q, int seq_kv,
                   int q_type, int kv_mode, int int8c, int causal, int window,
                   float scale, float softcap, void* stream) {
  Params p;
  p.q = static_cast<const uint8_t*>(q);
  p.k = static_cast<const uint8_t*>(k);
  p.v = static_cast<const uint8_t*>(v);
  p.o = static_cast<bf16*>(o);
  p.qs = static_cast<const float*>(qs);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8c) {
    if (q_type != Q_INT8 || kv_mode != KV_INT8 || seq_kv % BK8)
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = BQ * ROW8 + 4 * BK8 * ROW8 + D * ROW8;
    return launch(flash_quant_i8_kernel, smem, p, batch, s);
  }
  switch (q_type) {
    case Q_BF16: return launch_kv<Q_BF16>(kv_mode, p, batch, s);
    case Q_INT8: return launch_kv<Q_INT8>(kv_mode, p, batch, s);
    case Q_FP8: return launch_kv<Q_FP8>(kv_mode, p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
