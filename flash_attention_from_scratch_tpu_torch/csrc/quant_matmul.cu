// Quantized matmuls for Hopper: out (M, N) = x (M, K) @ W (K, N), W stored
// int8 or packed int4 with one fp32 scale per output column; x and out bf16
// or, in the library quant_matmul_f16.cu (this source built with FA_F16),
// fp16: act_t (hopper.cuh). K6/K7 convert the weight to x's type before the
// product (the JAX kernels' w.astype(x.dtype)); "bf16" below reads as act_t.
//
// Replaces four TPU kernels of flash_attention_from_scratch_tpu/ops/
// quant_matmul.py:
//   K6 _qmm_kernel_int8 (and _qmm_kernel_int8_nlast, the same product with
//      the K loop outside the N loop): bf16 x, int8 W upcast, fp32 sums,
//      times s[col] at the end;
//   K7 _qmm_kernel_int4: the same with int4 W, half-split along K (byte
//      (k, n) holds W[k, n] in the low nibble, W[k + K/2, n] in the high);
//   K8 _qmm_kernel_int8_a8: int8 x (quantized per row, scale xs[row]) times
//      int8 W, exact int32 sums, then acc * xs[row] * s[col] in fp32;
//   K9 _qmm_kernel_int4_a8: the same with int4 W. The TPU kernel masks
//      nibbles with & 0xF0 / ^ 8 and removes a +8 * rowsum bias because
//      Mosaic cannot shift int8; here the nibbles are sign-extended into int8
//      fragments, and the int32 sum is exact either way.
// and, as the first kernel of a K8/K9 call, the JAX package's per-row
// activation quantization (quantize_activations, plain jnp there), which
// quantize_rows_kernel computes in one launch.
//
// What bounds them on the H100: at decode (M = 16) every weight byte is read
// once for 2 * 16 operations, far below the card's ~295 FLOP/byte balance:
// the bound is the weight stream, bytes / 3.35 TB/s. At prefill (M = 1024)
// it is the tensor cores, 2 M K N / 989 TFLOP/s (bf16) or / 1979 (int8).
//
// All four are one kernel, quant_matmul_kernel<W4, A8, BT>. It computes the
// transposed product out^T (N, M) = W^T (N, K) x^T (K, M) with wgmma: the
// weight, built in registers, is the A operand, x the B operand in shared
// memory, so the tokens are the product's N dimension (BT = 16, 32, 64 or
// 128 tokens per CTA) and one design serves decode and prefill. A CTA is one
// producer warp and one consumer warpgroup per 128 weight columns (two m64
// row tiles): two warpgroups at BT 128, which share each x box and so halve
// the x bytes read per product from L2, one below. The producer keeps a ring
// of raw bytes in flight by TMA, as deep as the CTAs an SM holds leave room
// for (2-D boxes with 128-byte swizzle, zero-filled past M, N and K, so
// ragged edges need no masking in the main loop): per stage and warpgroup
// the stored weight rows of one x box row, and that x box (int4: two, the
// low half's K range and the high half's). An x box row is 128 bytes: 64
// bf16 (K6/K7: 64 stored rows a stage) or 128 int8 (K8/K9: 128 stored rows,
// two 64-row weight boxes), since the 128-byte-swizzle descriptor takes
// K-major rows 128 bytes wide, and 8-bit wgmma takes its shared operand only
// K-major (the transpose bits are for 16-bit types): x (M, K) is K-major, W
// (K, N) is not, so W enters as register fragments.
//
// K6/K7: each consumer thread reads the 4 bytes of its 4 columns at 4 K
// rows, converts them to bf16 in registers (the fp32 magic number 2^23 + u,
// exact for the whole int8 range and every nibble, then the upper half of
// each fp32 word, which is the bf16 value; for fp16 the fp16 word 0x6400 |
// u, 1024 + u, minus the bias: f16x2_bytes in hopper.cuh, since the upper
// half of an fp32 word is no fp16 value), and feeds them to 16-bit wgmma
// (m64nBTk16) as its A fragments, with fp32 sums.
// K8/K9: the s8 A fragment holds 4 consecutive K of one row in a register,
// so a thread reads its 4 columns at 8 K rows (4 consecutive, twice) and
// transposes each 4 x 4 block of bytes with __byte_perm (int4: the nibbles
// of each half sign-extended first); no conversion, s8 wgmma (m64nBTk32) at
// the int8 rate, exact int32 sums. Lanes q and q + 2 of a quad read rows 8
// apart, which the swizzle puts on the same banks: lanes q >= 2 read the
// rows of each 4 in another order and undo it in the transpose's selectors,
// so each load is free of bank conflicts.
// The 4 columns of a thread are rows g and g + 8 of both row tiles, so the
// epilogue writes each token's 4 columns as 8 contiguous bytes into a
// staging tile, and the global stores are 16-byte and coalesced; K8/K9 scale
// (float(acc) * xs[tok]) * s[col] in that order, as the plain version and
// the JAX kernel do. The wrapper picks BT and a split of the K walk
// (ops/quant_matmul.py::plan) so that the CTAs fill the 132 SMs in whole
// waves; a split writes partial sums (fp32, K8/K9 int32) and
// quant_matmul_finalize adds them in a fixed order, so results are
// reproducible run to run (K8/K9's are exact, the plain version's bits).
//
// Ragged shapes: every (K, N) that the JAX package's quantize_weight makes
// (int4: K even). TMA takes only row strides that are multiples of 16
// bytes, so a weight of N % 16 != 0 is stored once with its rows padded to
// such a stride (ops/quant_matmul.py::QuantizedWeight; the map's width stays
// N, so the pad is never read and no call copies the weight), and an x of K
// % 8 != 0 (int8 x: K % 16) is copied by the wrapper into rows of a padded
// stride (m x K elements a call); so is an x whose int4 high half would
// start off TMA's 16-byte quantum (K/2 % 8, int8 x: % 16), its high half
// moved to the next aligned column. Past K the boxes read zeros; an int4
// weight's low-half box may reach into x's high half (or the pad), against
// weight rows past K/2, which read as zeros. Output rows of N % 8 != 0 are not 16-byte
// aligned: those shapes run quant_matmul_edge_kernel, the same body storing
// column by column.
//
// quantize_rows_kernel: one CTA a row, read once into registers (rows up
// to 16384 values; a longer row's rest twice): the row's absmax in fp32,
// the scale absmax * fp32(1/127) floored at 1e-12, then rint(x / scale) (a
// true IEEE division, half to even) clamped to +-127: the bytes and scales
// of ops/quant_matmul.py::quantize_activations, bit for bit. It stays a
// kernel of its own: inside the product every CTA of a row's split walk
// would re-read the whole row.

#include <mutex>
#include <type_traits>

#include "hopper.cuh"

namespace {

// Four packed bytes -> their low (hi = false) or high nibbles as four
// sign-extended int8 bytes: (v ^ 8) - 8 per byte, -8 included.
__device__ __forceinline__ uint32_t nibbles(uint32_t w, bool hi) {
  uint32_t v = (hi ? (w >> 4) : w) & 0x0F0F0F0Fu;
  return __vsub4(v ^ 0x08080808u, 0x08080808u);
}

// ---------------------------------------------------------------------------
// Activation quantization (the first kernel of a K8/K9 call)

constexpr int QR_THREADS = 256;
constexpr int QR_HELD = 8;  // 16-byte chunks a thread keeps from the first read
// fp32(1 / 127): the scale is absmax times it, as XLA compiles absmax / 127
// under jit and ops/quant.py::div_const copies.
constexpr float INV_QMAX = 1.0f / 127.0f;

// The low and the high act_t of a word as fp32, exactly: a bf16 value is
// the upper half of its fp32 word; an fp16 value converts (its bits are
// not an fp32 word's half).
#ifdef FA_F16
__device__ __forceinline__ float act_lo(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xFFFFu)));
}
__device__ __forceinline__ float act_hi(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}
#else
__device__ __forceinline__ float act_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float act_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
#endif

__device__ __forceinline__ float absmax8(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) m = fmaxf(m, fmaxf(fabsf(act_lo(w[i])), fabsf(act_hi(w[i]))));
  return m;
}

// rint(v / scale) clamped to +-127, as int8 bytes: 8 act_t in, 8 bytes out.
__device__ __forceinline__ uint2 quantize8(uint4 v, float scale) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t out[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float f = (i & 1) ? act_hi(w[i >> 1]) : act_lo(w[i >> 1]);
    const float r = fminf(fmaxf(rintf(__fdiv_rn(f, scale)), -127.f), 127.f);
    out[i >> 2] |= (static_cast<uint32_t>(__float2int_rn(r)) & 0xFFu) << (8 * (i & 3));
  }
  return make_uint2(out[0], out[1]);
}

// x (M, K) act_t -> xq (M, K) int8 and xs (M,) fp32, one CTA a row. A row of
// up to QR_THREADS * QR_HELD * 8 values (16384) is read once and kept in
// registers; the rest of a longer row is read again. Finite inputs; K % 8
// == 0, rows 16-byte aligned.
__global__ void __launch_bounds__(QR_THREADS)
quantize_rows_kernel(const act_t* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int K) {
  const long long base = static_cast<long long>(blockIdx.x) * K;
  const uint4* src = reinterpret_cast<const uint4*>(x + base);
  uint2* dst = reinterpret_cast<uint2*>(xq + base);
  const int chunks = K / 8, tid = threadIdx.x;
  uint4 held[QR_HELD];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < QR_HELD; ++i) {
    const int c = tid + i * QR_THREADS;
    held[i] = c < chunks ? src[c] : make_uint4(0u, 0u, 0u, 0u);
    amax = fmaxf(amax, absmax8(held[i]));
  }
  for (int c = tid + QR_HELD * QR_THREADS; c < chunks; c += QR_THREADS)
    amax = fmaxf(amax, absmax8(src[c]));
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, o));
  __shared__ float part[QR_THREADS / 32];
  if ((tid & 31) == 0) part[tid >> 5] = amax;
  __syncthreads();
  amax = part[0];
#pragma unroll
  for (int i = 1; i < QR_THREADS / 32; ++i) amax = fmaxf(amax, part[i]);
  const float scale = fmaxf(amax * INV_QMAX, 1e-12f);
  if (tid == 0) xs[blockIdx.x] = scale;
#pragma unroll
  for (int i = 0; i < QR_HELD; ++i) {
    const int c = tid + i * QR_THREADS;
    if (c < chunks) dst[c] = quantize8(held[i], scale);
  }
  for (int c = tid + QR_HELD * QR_THREADS; c < chunks; c += QR_THREADS)
    dst[c] = quantize8(src[c], scale);
}

// ---------------------------------------------------------------------------
// Split-K: sum the partials of every split in order, then scale and cast.

template <bool A8>
__global__ void quant_matmul_finalize(const void* __restrict__ ws, const float* __restrict__ xs,
                                      const float* __restrict__ scales, act_t* __restrict__ out,
                                      int M, int N, int splits) {
  const long long mn = (long long)M * N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  const int row = static_cast<int>(idx / N), col = static_cast<int>(idx % N);
  float v;
  if constexpr (A8) {
    const int* p = static_cast<const int*>(ws);
    int acc = 0;
    for (int z = 0; z < splits; ++z) acc += p[z * mn + idx];
    v = static_cast<float>(acc) * xs[row] * scales[col];
  } else {
    const float* p = static_cast<const float*>(ws);
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += p[z * mn + idx];
    v = acc * scales[col];
  }
  out[idx] = to_act(v);
}

int finalize(bool a8, const void* ws, const void* xs, const void* scales, void* out, int M,
             int N, int splits, cudaStream_t stream) {
  const long long mn = (long long)M * N;
  const unsigned blocks = static_cast<unsigned>((mn + 255) / 256);
  if (a8)
    quant_matmul_finalize<true><<<blocks, 256, 0, stream>>>(
        ws, static_cast<const float*>(xs), static_cast<const float*>(scales),
        static_cast<act_t*>(out), M, N, splits);
  else
    quant_matmul_finalize<false><<<blocks, 256, 0, stream>>>(
        ws, nullptr, static_cast<const float*>(scales), static_cast<act_t*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K6-K9: wgmma with the weight as register A fragments

constexpr int WBN = 128;                 // weight columns per CTA
constexpr int WROWS = 64;                // stored weight rows per TMA box
constexpr int WTILE = WROWS * WBN;       // bytes of one raw weight box
constexpr int XROW = 128;                // bytes of an x box row (the swizzle's width)
constexpr int MAX_STAGES = 8;
constexpr int SM_SMEM = 233472;          // shared memory of an SM (228 KB)
constexpr int SMEM_LIMIT = 232448;       // shared memory a block may use
constexpr int CTA_RESERVED = 1024;       // shared memory the system keeps a CTA

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int BT>
__device__ __forceinline__ void wgmma_tile(float (&d)[BT / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BT == 16) wgmma_n16(d, a, desc);
  else if constexpr (BT == 32) wgmma_n32(d, a, desc);
  else if constexpr (BT == 64) wgmma_n64(d, a, desc);
  else wgmma_n128(d, a, desc);
}

template <int BT>
__device__ __forceinline__ void wgmma_tile(int (&d)[BT / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BT == 16) wgmma_s8_n16(d, a, desc, 1);
  else if constexpr (BT == 32) wgmma_s8_n32(d, a, desc, 1);
  else if constexpr (BT == 64) wgmma_s8_n64(d, a, desc, 1);
  else wgmma_s8_n128(d, a, desc, 1);
}

// act_t A fragments of both row tiles for one 16-wide K step. wv: the 4
// bytes of this thread's columns c..c+3 at K rows 2q, 2q+1, 2q+8, 2q+9 of
// the step (int4: the low nibbles for half 0, the high ones for half 1).
// Row tile t takes columns c+2t (fragment row g) and c+2t+1 (row g+8).
template <bool W4>
__device__ __forceinline__ void dequant_fragments(const uint32_t (&wv)[4], int half,
                                                  uint32_t (&a)[2][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // K rows (2q, 2q+1), then (2q+8, 2q+9)
    const uint32_t r0 = wv[2 * p], r1 = wv[2 * p + 1];
    if constexpr (W4) {
      // Nibble n of column j from both rows into one word's halves, as the
      // bf16 bits 0x4300 | (n ^ 8) = 128 + (v + 8), then minus 136 (fp16:
      // 0x6400 | (n ^ 8) = 1024 + (v + 8), minus 1032): exact.
      const uint32_t s0 = half ? r0 >> 4 : r0, s1 = half ? r1 >> 4 : r1;
#ifdef FA_F16
      const __half2 bias = __halves2half2(__ushort_as_half(0x6408), __ushort_as_half(0x6408));
#else
      const __nv_bfloat162 bias = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                     __ushort_as_bfloat16(0x4308));
#endif
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#ifdef FA_F16
        const uint32_t t = (__byte_perm(s0, s1, j | ((4 + j) << 8)) & 0x000F000Fu) ^ 0x64086408u;
        const __half2 b = __hsub2(*reinterpret_cast<const __half2*>(&t), bias);
#else
        const uint32_t t = (__byte_perm(s0, s1, j | ((4 + j) << 8)) & 0x000F000Fu) ^ 0x43084308u;
        const __nv_bfloat162 b = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t), bias);
#endif
        v[j] = *reinterpret_cast<const uint32_t*>(&b);
      }
      a[0][2 * p] = v[0];
      a[0][2 * p + 1] = v[1];
      a[1][2 * p] = v[2];
      a[1][2 * p + 1] = v[3];
    } else {
      // u = v + 128 per byte; the fp32 word 0x4B0000uu is 2^23 + u (fp16:
      // the word 0x64uu is 1024 + u, f16x2_bytes).
      const uint32_t u0 = r0 ^ 0x80808080u, u1 = r1 ^ 0x80808080u;
#ifdef FA_F16
      a[0][2 * p] = f16x2_bytes<0>(u0, u1);
      a[0][2 * p + 1] = f16x2_bytes<1>(u0, u1);
      a[1][2 * p] = f16x2_bytes<2>(u0, u1);
      a[1][2 * p + 1] = f16x2_bytes<3>(u0, u1);
#else
      const float magic = 8388736.0f;  // 2^23 + 128
      a[0][2 * p] = bf16x2_upper(byte_value<0>(u0, magic), byte_value<0>(u1, magic));
      a[0][2 * p + 1] = bf16x2_upper(byte_value<1>(u0, magic), byte_value<1>(u1, magic));
      a[1][2 * p] = bf16x2_upper(byte_value<2>(u0, magic), byte_value<2>(u1, magic));
      a[1][2 * p + 1] = bf16x2_upper(byte_value<3>(u0, magic), byte_value<3>(u1, magic));
#endif
    }
  }
}

// s8 A fragments of both row tiles for one 32-wide K step. wv: the 4 bytes
// of this thread's columns c..c+3 at K rows 4q..4q+3, then 16+4q..16+4q+3
// of the step, in the order the lane read them: rows (2, 3, 0, 1) where
// the lane swaps (sel_a, sel_b put them back); int4: the low nibbles for
// half 0, the high ones for half 1. A 4 x 4 byte transpose turns the rows
// into columns: register 2p of row tile t is column c+2t (fragment row g),
// 2p+1 column c+2t+1 (row g+8).
template <bool W4>
__device__ __forceinline__ void s8_fragments(const uint32_t (&wv)[8], int half, uint32_t sel_a,
                                             uint32_t sel_b, uint32_t (&a)[2][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // K rows 4q.., then 16 + 4q..
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W4 ? nibbles(wv[4 * p + i], half) : wv[4 * p + i];
    // Bytes of the first two rows read, then of the last two, for columns
    // 0, 1 (lo) and 2, 3 (hi); then all four rows into one word a column.
    const uint32_t l0 = __byte_perm(w[0], w[1], 0x5140), l1 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t h0 = __byte_perm(w[0], w[1], 0x7362), h1 = __byte_perm(w[2], w[3], 0x7362);
    a[0][2 * p] = __byte_perm(l0, l1, sel_a);
    a[0][2 * p + 1] = __byte_perm(l0, l1, sel_b);
    a[1][2 * p] = __byte_perm(h0, h1, sel_a);
    a[1][2 * p + 1] = __byte_perm(h0, h1, sel_b);
  }
}

template <bool W4, bool A8, int BT>
struct WTile {
  // Consumer warpgroups, each 128 weight columns: two at BT 128, sharing
  // each x box (half the x bytes per product), else one.
  static constexpr int NWG = BT >= 128 ? 2 : 1;
  static constexpr int COLS = NWG * WBN;       // weight columns per CTA
  static constexpr int THREADS = NWG * 128 + 32;  // + the producer warp
  // CTAs an SM holds (ops/quant_matmul.py::plan splits the K walk for it).
  static constexpr int PER_SM = NWG == 2 ? 1 : 2;
  // Stored weight rows per stage: the K values of one x box row.
  static constexpr int ROWS = A8 ? XROW : XROW / 2;
  static constexpr int WBOX = ROWS * WBN;     // weight bytes per stage and warpgroup
  static constexpr int NX = W4 ? 2 : 1;       // x boxes per stage
  static constexpr int XBOX = BT * XROW;      // bytes of one x box
  static constexpr int STAGE = NWG * WBOX + NX * XBOX;
  static constexpr int OROW = COLS + 8;       // staging row, act_t elements
  // The ring is as deep as PER_SM CTAs on one SM allow (each less its
  // reserved 1 KB, its barriers and the 1 KB alignment slack), at most
  // MAX_STAGES; the epilogue reuses it as the staging tile.
  static constexpr int BUDGET =
      cmin(SMEM_LIMIT, SM_SMEM / PER_SM - CTA_RESERVED) - 2 * MAX_STAGES * 8 - 1024;
  static constexpr int STAGES = cmin(MAX_STAGES, BUDGET / STAGE);
  static constexpr int RING = cmax(STAGES * STAGE, BT * OROW * 2);
  static constexpr int SMEM = RING + 1024;  // dynamic: + the alignment slack
  static_assert(STAGES >= 2 && RING <= BUDGET, "the ring does not fit PER_SM CTAs an SM");
  static_assert(ROWS % WROWS == 0, "a stage is whole weight boxes");
};

// The scales of a thread's columns col..col+3 (0 past N). EDGE: N % 8 != 0,
// so the four may straddle N and the vector may leave the array.
template <bool EDGE>
__device__ __forceinline__ float4 column_scales(const float* __restrict__ scales, int col, int N) {
  if constexpr (EDGE) {
    float s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u] = col + u < N ? scales[col + u] : 0.f;
    return make_float4(s[0], s[1], s[2], s[3]);
  } else {
    return col < N ? *reinterpret_cast<const float4*>(scales + col)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The kernel's body. EDGE (N % 8 != 0: output rows off 16-byte alignment, a
// thread's 4 columns possibly straddling N) stores column by column, and is
// an instantiation of its own, quant_matmul_edge_kernel, so that the
// aligned kernels are compiled as they were.
template <bool W4, bool A8, int BT, bool EDGE>
__device__ __forceinline__ void quant_matmul_body(const CUtensorMap& tm_w, const CUtensorMap& tm_x,
                                                  const float* __restrict__ xs,
                                                  const float* __restrict__ scales,
                                                  act_t* __restrict__ out, void* __restrict__ ws,
                                                  int M, int N, int K, int k_tiles_per_split) {
  using T = WTile<W4, A8, BT>;
  using Acc = std::conditional_t<A8, int, float>;
  constexpr int stages = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  // 128-byte swizzled boxes want 1024-byte aligned destinations.
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tok0 = blockIdx.x * BT, col0 = blockIdx.y * T::COLS;
  const int k_rows = W4 ? K / 2 : K;  // stored weight rows
  const int k_tiles = (k_rows + T::ROWS - 1) / T::ROWS;
  const int t0 = blockIdx.z * k_tiles_per_split;
  const int nt = max(min(k_tiles, t0 + k_tiles_per_split) - t0, 0);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * T::NWG);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * T::NWG) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < nt; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) + 1) & 1);
        uint8_t* st = ring + s * T::STAGE;
        const int r = (t0 + i) * T::ROWS;
        mbar_arrive_expect_tx(&full[s], T::STAGE);
        for (int wg = 0; wg < T::NWG; ++wg)
          for (int b = 0; b < T::ROWS / WROWS; ++b)  // boxes past K read as zeros
            tma_load_2d(st + wg * T::WBOX + b * WTILE, &tm_w, col0 + wg * WBN, r + b * WROWS,
                        &full[s]);
        uint8_t* xb = st + T::NWG * T::WBOX;
        tma_load_2d(xb, &tm_x, r, tok0, &full[s]);
        if constexpr (W4) tma_load_2d(xb + T::XBOX, &tm_x, K / 2 + r, tok0, &full[s]);
      }
    }
    return;
  }

  // Consumer warpgroup. Thread (g, q) of warp w owns weight columns
  // c..c+3 of the CTA's 128; row tile t's accumulator row 16w + g (+ 8)
  // is column c + 2t (+ 1), its column 8j + 2q (+ 1) the token.
  const int g = lane >> 2, q = lane & 3;
  const int wg = warp >> 2;
  const int c = wg * WBN + (warp & 3) * 32 + g * 4;  // of the CTA's COLS
  const int cw = c - wg * WBN;  // the column within this warpgroup's box
  Acc acc[2][BT / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[t][i] = 0;

  // K8/K9: the box offsets of rows 4q + (j ^ swap), j < 4, at this thread's
  // columns. The box's 16-byte chunks are swizzled by the row's low 3 bits
  // (rows 16 apart share them), and a lane's 4 columns are half a 32-byte
  // chunk pair, which bits 1-2 of the row pick: lanes q >= 2 read rows
  // (2, 3, 0, 1) where the others read (0, 1, 2, 3), so the four lanes of a
  // quad meet four distinct pairs, each bank once; sel_a and sel_b take the
  // rows back in order.
  const int swap = A8 && q >= 2 ? 2 : 0;
  const uint32_t sel_a = swap ? 0x1054u : 0x5410u, sel_b = swap ? 0x3276u : 0x7632u;
  int off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 4 * q + (j ^ swap);
    off[j] = r * WBN + ((((cw >> 4) ^ (r & 7)) << 4) | (cw & 15));
  }

  for (int i = 0; i < nt; ++i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const uint8_t* wt = ring + s * T::STAGE + wg * T::WBOX;
    const unsigned xt = smem_addr(ring + s * T::STAGE + T::NWG * T::WBOX);
    if constexpr (A8) {
#pragma unroll
      for (int ks = 0; ks < T::ROWS / 32; ++ks) {
        uint32_t wv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          wv[j] = *reinterpret_cast<const uint32_t*>(wt + (ks * 32 + (j >> 2) * 16) * WBN +
                                                     off[j & 3]);
#pragma unroll
        for (int h = 0; h < T::NX; ++h) {
          uint32_t a[2][4];
          s8_fragments<W4>(wv, h, sel_a, sel_b, a);
          const uint64_t desc = sw128_desc(xt + h * T::XBOX + ks * 32);
          wgmma_fence();
          wgmma_tile<BT>(acc[0], a[0], desc);
          wgmma_tile<BT>(acc[1], a[1], desc);
          wgmma_commit();
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < T::ROWS / 16; ++ks) {
        uint32_t wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ks * 16 + 2 * q + (j & 1) + (j >> 1) * 8;
          // The box's 16-byte chunks are swizzled by the row's low 3 bits.
          wv[j] = *reinterpret_cast<const uint32_t*>(
              wt + r * WBN + ((((cw >> 4) ^ (r & 7)) << 4) | (cw & 15)));
        }
#pragma unroll
        for (int h = 0; h < T::NX; ++h) {
          uint32_t a[2][4];
          dequant_fragments<W4>(wv, h, a);
          const uint64_t desc = sw128_desc(xt + h * T::XBOX + ks * 32);
          wgmma_fence();
          wgmma_tile<BT>(acc[0], a[0], desc);
          wgmma_tile<BT>(acc[1], a[1], desc);
          wgmma_commit();
        }
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const int col = col0 + c;  // N % 8 == 0 (not EDGE): c..c+3 are all in or all out
  const bool col_ok = col < N;
  if (gridDim.z > 1) {  // partial sums, unscaled
    Acc* p = static_cast<Acc*>(ws) + (long long)blockIdx.z * M * N;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = tok0 + 8 * j + 2 * q + e;
        if (col_ok && tok < M) {
          Acc* dst = p + (long long)tok * N + col;
          if constexpr (EDGE) {
            const Acc v[4] = {acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                              acc[1][4 * j + 2 + e]};
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (col + u < N) dst[u] = v[u];
          } else if constexpr (A8)
            *reinterpret_cast<int4*>(dst) = make_int4(acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                                                      acc[1][4 * j + e], acc[1][4 * j + 2 + e]);
          else
            *reinterpret_cast<float4*>(dst) = make_float4(
                acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                acc[1][4 * j + 2 + e]);
        }
      }
    return;
  }
  const float4 sc = column_scales<EDGE>(scales, col, N);
  // Every consumer warp is past its last wgmma: the ring becomes the
  // staging tile (BT tokens x 128 columns of act_t).
  asm volatile("bar.sync 1, %0;\n" ::"n"(T::NWG * 128) : "memory");
  act_t* stage_out = reinterpret_cast<act_t*>(ring);
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tl = 8 * j + 2 * q + e;
      float v[4] = {static_cast<float>(acc[0][4 * j + e]),
                    static_cast<float>(acc[0][4 * j + 2 + e]),
                    static_cast<float>(acc[1][4 * j + e]),
                    static_cast<float>(acc[1][4 * j + 2 + e])};
      if constexpr (A8) {  // (acc * xs[tok]) * s[col], in that order
        const float xv = tok0 + tl < M ? xs[tok0 + tl] : 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] *= xv;
      }
      uint2 pk;
      pk.x = pack_act(v[0] * sc.x, v[1] * sc.y);
      pk.y = pack_act(v[2] * sc.z, v[3] * sc.w);
      *reinterpret_cast<uint2*>(stage_out + tl * T::OROW + c) = pk;
    }
  asm volatile("bar.sync 1, %0;\n" ::"n"(T::NWG * 128) : "memory");
  for (int id = tid; id < BT * (T::COLS / 8); id += T::NWG * 128) {
    const int tl = id / (T::COLS / 8), cc = (id % (T::COLS / 8)) * 8;
    const int tok = tok0 + tl, gc = col0 + cc;
    if (tok < M && gc < N) {
      if constexpr (EDGE) {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (gc + u < N) out[(long long)tok * N + gc + u] = stage_out[tl * T::OROW + cc + u];
      } else {
        *reinterpret_cast<uint4*>(out + (long long)tok * N + gc) =
            *reinterpret_cast<const uint4*>(stage_out + tl * T::OROW + cc);
      }
    }
  }
}

template <bool W4, bool A8, int BT>
__global__ void __launch_bounds__(WTile<W4, A8, BT>::THREADS, WTile<W4, A8, BT>::PER_SM)
quant_matmul_kernel(const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_x, const float* __restrict__ xs,
                    const float* __restrict__ scales, act_t* __restrict__ out,
                    void* __restrict__ ws, int M, int N, int K, int k_tiles_per_split) {
  quant_matmul_body<W4, A8, BT, false>(tm_w, tm_x, xs, scales, out, ws, M, N, K,
                                       k_tiles_per_split);
}

template <bool W4, bool A8, int BT>
__global__ void __launch_bounds__(WTile<W4, A8, BT>::THREADS, WTile<W4, A8, BT>::PER_SM)
quant_matmul_edge_kernel(const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_x, const float* __restrict__ xs,
                         const float* __restrict__ scales, act_t* __restrict__ out,
                         void* __restrict__ ws, int M, int N, int K, int k_tiles_per_split) {
  quant_matmul_body<W4, A8, BT, true>(tm_w, tm_x, xs, scales, out, ws, M, N, K,
                                      k_tiles_per_split);
}

// A weight's tensor map, encoded once per weight: the weights are the
// same tensors every call, and the encode is host work on the decode path,
// where the host sets the pace. The key is everything the map depends on,
// so a hit is always the right map. `ld`: the bytes from one stored row to
// the next (N, or N rounded up to 16 for a weight stored with padded rows:
// TMA takes only strides that are multiples of 16 bytes); columns past N
// read as zeros either way.
bool weight_map(CUtensorMap* map, const void* w, int rows, int cols, int ld) {
  struct Entry {
    const void* ptr;
    int rows, cols, ld;
    CUtensorMap map;
  };
  constexpr int SLOTS = 1024;  // direct-mapped; a miss re-encodes
  static Entry cache[SLOTS];
  static std::mutex lock;
  const size_t slot = (reinterpret_cast<uintptr_t>(w) >> 9) % SLOTS;
  std::lock_guard<std::mutex> held(lock);
  Entry& e = cache[slot];
  if (e.ptr != w || e.rows != rows || e.cols != cols || e.ld != ld) {
    e.ptr = nullptr;
    if (!encode_2d(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, rows, cols, WROWS, WBN, ld))
      return false;
    e.ptr = w;
    e.rows = rows;
    e.cols = cols;
    e.ld = ld;
  }
  *map = e.map;
  return true;
}

// One launch (and, with splits, the finalize) of one instantiation: EDGE
// picks quant_matmul_edge_kernel, for N % 8 != 0.
template <bool W4, bool A8, int BT, bool EDGE>
int launch(const void* x, const void* xs, const void* w, const void* scales, void* out, void* ws,
           int M, int N, int K, int ldx, int ldw, int xhi, int splits, cudaStream_t stream) {
  using T = WTile<W4, A8, BT>;
  auto kernel = EDGE ? quant_matmul_edge_kernel<W4, A8, BT> : quant_matmul_kernel<W4, A8, BT>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int k_rows = W4 ? K / 2 : K;
  // x's columns: int4, its low half then its high half from column xhi
  // (K/2, or past a pad where K/2 * the element size is no multiple of 16
  // bytes, TMA's quantum for a box's start). The kernel takes the high half
  // at K/2 of the K it is given, so it gets 2 * xhi; its K tiles are the
  // same, as a tile is a multiple of the quantum. Box columns past the
  // map's width read as zeros, whatever the row stride holds there.
  const int x_cols = W4 ? xhi + K / 2 : K;
  CUtensorMap tm_w, tm_x;
  const bool x_ok =
      A8 ? encode_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, M, x_cols, BT, XROW, ldx)
         : encode_2d(&tm_x, ACT_TMAP, 2, x, M, x_cols, BT, XROW / 2,
                     2LL * ldx);
  if (!weight_map(&tm_w, w, k_rows, N, ldw) || !x_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k_tiles = (k_rows + T::ROWS - 1) / T::ROWS;
  const int per = (k_tiles + splits - 1) / splits;
  dim3 grid((M + BT - 1) / BT, (N + T::COLS - 1) / T::COLS, splits);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      tm_w, tm_x, static_cast<const float*>(xs), static_cast<const float*>(scales),
      static_cast<act_t*>(out), ws, M, N, W4 ? 2 * xhi : K, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return finalize(A8, ws, xs, scales, out, M, N, splits, stream);
}

template <bool W4, bool A8, bool EDGE>
int launch_bt(int bt, const void* x, const void* xs, const void* w, const void* scales,
              void* out, void* ws, int M, int N, int K, int ldx, int ldw, int xhi, int splits,
              cudaStream_t s) {
  switch (bt) {
    case 16: return launch<W4, A8, 16, EDGE>(x, xs, w, scales, out, ws, M, N, K, ldx, ldw, xhi, splits, s);
    case 32: return launch<W4, A8, 32, EDGE>(x, xs, w, scales, out, ws, M, N, K, ldx, ldw, xhi, splits, s);
    case 64: return launch<W4, A8, 64, EDGE>(x, xs, w, scales, out, ws, M, N, K, ldx, ldw, xhi, splits, s);
    case 128: return launch<W4, A8, 128, EDGE>(x, xs, w, scales, out, ws, M, N, K, ldx, ldw, xhi, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool W4, bool A8>
int launch_edge(int bt, const void* x, const void* xs, const void* w, const void* scales,
                void* out, void* ws, int M, int N, int K, int ldx, int ldw, int xhi,
                int splits, cudaStream_t s) {
  if (N % 8)
    return launch_bt<W4, A8, true>(bt, x, xs, w, scales, out, ws, M, N, K, ldx, ldw, xhi,
                                   splits, s);
  return launch_bt<W4, A8, false>(bt, x, xs, w, scales, out, ws, M, N, K, ldx, ldw, xhi,
                                  splits, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K6-K9: x (M, K), rows ldx elements apart, act_t (a8 = 0) or int8 (a8 = 1,
// with xs (M,) fp32 per-row activation scales; else xs is unused); w (K, N)
// int8, or (K/2, N) packed int4 (w4 = 1), rows ldw bytes apart; scales (N,)
// fp32; out (M, N) act_t contiguous; ws (splits, M, N) fp32 (a8: int32) when
// splits > 1. int4: x's high half (its K/2 columns from K/2) starts at
// column xhi >= K/2, xhi times the element size a multiple of 16 (the
// columns between hold zeros); xhi is not read otherwise. bt: tokens per CTA
// (16, 32, 64, 128); splits: ranges of the K walk. Any M, N and K (int4: K
// even); x, w, scales, out and ws 16-byte aligned, ldx * (a8 ? 1 : 2) and
// ldw multiples of 16 (TMA's strides), ldx at least x's columns, ldw >= N.
// Returns cudaGetLastError().
int fa_quant_matmul(const void* x, const void* xs, const void* w, const void* scales, void* out,
                    void* ws, int M, int N, int K, int ldx, int ldw, int xhi, int w4, int a8,
                    int bt, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = a8 ? 1 : 2;
  const bool aligned =
      aligned16(x) && aligned16(w) && aligned16(scales) && aligned16(out) && aligned16(ws);
  const bool halves = !w4 || (xhi >= K / 2 && (xhi * elem) % 16 == 0 && ldx >= xhi + K / 2);
  const bool strides = ldx >= K && ldw >= N && (ldx * elem) % 16 == 0 && ldw % 16 == 0;
  if (M < 1 || N < 1 || K < 1 || (w4 && K % 2) || splits < 1 || !aligned || !strides ||
      !halves || (a8 && !xs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a8) {
    if (w4)
      return launch_edge<true, true>(bt, x, xs, w, scales, out, ws, M, N, K, ldx, ldw, xhi,
                                     splits, s);
    return launch_edge<false, true>(bt, x, xs, w, scales, out, ws, M, N, K, ldx, ldw, xhi,
                                    splits, s);
  }
  if (w4)
    return launch_edge<true, false>(bt, x, xs, w, scales, out, ws, M, N, K, ldx, ldw, xhi,
                                    splits, s);
  return launch_edge<false, false>(bt, x, xs, w, scales, out, ws, M, N, K, ldx, ldw, xhi,
                                   splits, s);
}

// The activation quantization of K8/K9: x (M, K) act_t contiguous -> xq (M,
// K) int8, xs (M,) fp32. x 16-byte aligned, xq 8-byte aligned, K % 8 == 0.
// Returns cudaGetLastError().
int fa_quantize_rows(const void* x, void* xq, void* xs, int M, int K, void* stream) {
  if (K % 8 || M < 1 || !aligned16(x) || reinterpret_cast<uintptr_t>(xq) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows_kernel<<<M, QR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const act_t*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
