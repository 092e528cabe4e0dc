// Quantized matmuls for Hopper: out (M, N) = x (M, K) @ W (K, N), W stored
// int8 or packed int4 with one fp32 scale per output column.
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
//
// What bounds them on the H100: at decode (M = 16) every weight byte is read
// once for 2 * 16 operations, far below the card's ~295 FLOP/byte balance:
// the bound is the weight stream, bytes / 3.35 TB/s. At prefill (M = 1024)
// it is the tensor cores, 2 M K N / 989 TFLOP/s (bf16) or / 1979 (int8).
//
// K6 and K7 (quant_matmul_wonly_kernel) compute the transposed product
// out^T (N, M) = W^T (N, K) x^T (K, M) with wgmma: the weight, dequantized
// in registers, is the A operand, x the B operand in shared memory, so the
// tokens are the product's N dimension (BT = 16, 32, 64 or 128 tokens per
// CTA) and one design serves decode and prefill. A CTA is one producer warp
// and one consumer warpgroup per 128 weight columns (two m64 row tiles):
// two warpgroups at BT 128, which share each x box and so halve the x bytes
// read per product from L2, one below. The producer keeps a ring of raw
// bytes in flight by TMA, as deep as the CTAs an SM holds leave room for
// (2-D boxes with 128-byte swizzle, zero-filled past M, N and K, so ragged
// edges need no masking in the main loop): per stage and warpgroup 64 stored weight rows x 128
// columns, and the matching 64-wide x box (int4: two, the low half's K
// range and the high half's). Each consumer thread reads the 4 bytes of its
// 4 columns at 4 K rows, converts them to bf16 in registers (the fp32 magic
// number 2^23 + u, exact for the whole int8 range and every nibble, then the
// upper half of each fp32 word, which is the bf16 value), and feeds them to
// wgmma as its A fragments: no converted tile goes through shared memory.
// The 4 columns of a thread are rows g and g + 8 of both row tiles, so the
// epilogue writes each token's 4 columns as 8 contiguous bytes into a
// staging tile, and the global stores are 16-byte and coalesced. The
// wrapper picks BT and a split of the K walk (ops/quant_matmul.py::plan) so
// that the CTAs fill the 132 SMs in whole waves; a split writes fp32
// partial sums and quant_matmul_finalize adds them in a fixed order, so
// results are reproducible run to run.
//
// K8 and K9 (quant_matmul_a8_kernel) stay on mma.sync m16n8k16 s8: a CTA
// computes a BM x 64 output tile (BM = 16 for M <= 16, else 64) with 4
// warps of 16 columns each, walking K in tiles of 64 rows through a 4-stage
// cp.async ring; each stage's raw weight tile is transposed to (n, k) int8
// with a 4x4 byte transpose in registers; split-K sums stay exact int32.
// Both need N % 16 == 0 and K % 32 == 0; the wrapper checks.

#include <mutex>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// K8, K9: int8 activations (mma.sync s8)

constexpr int NTHREADS = 128;
constexpr int BN = 64;
constexpr int BK = 64;  // dequantized K rows per stage
constexpr int STAGES = 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

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

template <bool W4, int MI>
struct Tile {
  static constexpr int BM = 16 * MI;
  // Shared-memory row strides in bytes, padded so ldmatrix rows of one
  // 8x8 matrix fall in distinct banks.
  static constexpr int XROW = 64 + 16;
  static constexpr int WRAW_ROWS = W4 ? BK / 2 : BK;  // stored rows per stage
  static constexpr int WRAW = WRAW_ROWS * BN;
  static constexpr int CROW = BK + 16;  // transposed (n, k) tile
  static constexpr int CONV = BN * CROW;
  static constexpr int SMEM = STAGES * (BM * XROW + WRAW) + CONV;
};

template <bool W4, int MI>
__global__ void __launch_bounds__(NTHREADS)
quant_matmul_a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ xs,
                       const int8_t* __restrict__ w, const float* __restrict__ scales,
                       bf16* __restrict__ out, int* __restrict__ ws, int M, int N, int K,
                       int k_tiles_per_split) {
  using T = Tile<W4, MI>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* xs_s = smem;
  uint8_t* raw_s = smem + STAGES * T::BM * T::XROW;
  uint8_t* conv_s = raw_s + STAGES * T::WRAW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * T::BM;
  const int k_rows = W4 ? K / 2 : K;  // stored weight rows
  const int k_tiles = (k_rows + T::WRAW_ROWS - 1) / T::WRAW_ROWS;
  const int t0 = blockIdx.z * k_tiles_per_split;
  const int t1 = min(k_tiles, t0 + k_tiles_per_split);
  const int nt = max(t1 - t0, 0);

  auto load_stage = [&](int stage, int t) {
    // x tile: BM rows x 64 K columns (int4: 32 from each half of K).
    uint8_t* xd = xs_s + stage * T::BM * T::XROW;
    for (int c = tid; c < T::BM * 4; c += NTHREADS) {
      const int r = c / 4, ch = c % 4;
      int gcol;
      bool valid;
      if constexpr (W4) {
        const int half = ch / 2, within = (ch % 2) * 16;
        const int p = t * T::WRAW_ROWS + within;
        gcol = half * (K / 2) + p;
        valid = p < K / 2;
      } else {
        gcol = t * BK + ch * 16;
        valid = gcol < K;
      }
      valid = valid && row0 + r < M;
      const int8_t* src = valid ? x + (long long)(row0 + r) * K + gcol : x;
      cp_async16(xd + r * T::XROW + ch * 16, src, valid);
    }
    // Raw weight tile: WRAW_ROWS stored rows x 64 columns.
    uint8_t* wd = raw_s + stage * T::WRAW;
    for (int c = tid; c < T::WRAW_ROWS * 4; c += NTHREADS) {
      const int r = c >> 2, ch = c & 3;
      const int grow = t * T::WRAW_ROWS + r, gcol = col0 + ch * 16;
      const bool valid = grow < k_rows && gcol < N;
      const int8_t* src = valid ? w + (long long)grow * N + gcol : w;
      cp_async16(wd + r * BN + ch * 16, src, valid);
    }
  };

  // Raw stage -> (n, k) int8 in 4x4 byte blocks: 16 x 16 blocks.
  auto convert = [&](int stage) {
    const uint32_t* raw = reinterpret_cast<const uint32_t*>(raw_s + stage * T::WRAW);
    for (int blk = tid; blk < (BK / 4) * (BN / 4); blk += NTHREADS) {
      const int bk = blk / (BN / 4), bn = blk % (BN / 4);
      uint32_t wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (W4) {
          const bool hi = bk >= BK / 8;
          const int prow = 4 * (hi ? bk - BK / 8 : bk) + i;
          wv[i] = nibbles(raw[prow * (BN / 4) + bn], hi);
        } else {
          wv[i] = raw[(4 * bk + i) * (BN / 4) + bn];
        }
      }
      const uint32_t t01l = __byte_perm(wv[0], wv[1], 0x5140);
      const uint32_t t23l = __byte_perm(wv[2], wv[3], 0x5140);
      const uint32_t t01h = __byte_perm(wv[0], wv[1], 0x7362);
      const uint32_t t23h = __byte_perm(wv[2], wv[3], 0x7362);
      const uint32_t o[4] = {__byte_perm(t01l, t23l, 0x5410), __byte_perm(t01l, t23l, 0x7632),
                             __byte_perm(t01h, t23h, 0x5410), __byte_perm(t01h, t23h, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(conv_s + (4 * bn + j) * T::CROW + 4 * bk) = o[j];
    }
  };

  int acc[MI][2][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load_stage(s, t0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage i landed; every warp is done with stage i - 1
    const int nxt = i + STAGES - 1;
    if (nxt < nt) load_stage(nxt % STAGES, t0 + nxt);
    cp_async_commit();
    convert(i % STAGES);
    __syncthreads();
    const uint8_t* xt = xs_s + (i % STAGES) * T::BM * T::XROW;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t b[4];
      const int j = lane >> 3;
      ldmatrix_x4(b, conv_s + (warp * 16 + (j >> 1) * 8 + (lane & 7)) * T::CROW +
                         kk * 32 + (j & 1) * 16);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t a[4];
        ldmatrix_x4(a, xt + (mi * 16 + (lane & 15)) * T::XROW + kk * 32 + (lane >> 4) * 16);
        mma_s8(acc[mi][0], a, b[0], b[1]);
        mma_s8(acc[mi][1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: c0, c1 at (row g, cols 2q, 2q+1); c2, c3 at row g + 8.
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int col = col0 + warp * 16 + ni * 8 + (lane & 3) * 2;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mi * 16 + (lane >> 2) + h * 8;
        if (row >= M) continue;
        const long long at = (long long)row * N + col;
        const int c0 = acc[mi][ni][2 * h], c1 = acc[mi][ni][2 * h + 1];
        if (split) {
          int* p = ws + (long long)blockIdx.z * M * N + at;
          p[0] = c0;
          p[1] = c1;
        } else {
          const float v0 = static_cast<float>(c0) * xs[row] * scales[col];
          const float v1 = static_cast<float>(c1) * xs[row] * scales[col + 1];
          *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

// Split-K: sum the partials of every split in order, then scale and cast.
template <bool A8>
__global__ void quant_matmul_finalize(const void* __restrict__ ws, const float* __restrict__ xs,
                                      const float* __restrict__ scales, bf16* __restrict__ out,
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
  out[idx] = __float2bfloat16(v);
}

int finalize(bool a8, const void* ws, const void* xs, const void* scales, void* out, int M,
             int N, int splits, cudaStream_t stream) {
  const long long mn = (long long)M * N;
  const unsigned blocks = static_cast<unsigned>((mn + 255) / 256);
  if (a8)
    quant_matmul_finalize<true><<<blocks, 256, 0, stream>>>(
        ws, static_cast<const float*>(xs), static_cast<const float*>(scales),
        static_cast<bf16*>(out), M, N, splits);
  else
    quant_matmul_finalize<false><<<blocks, 256, 0, stream>>>(
        ws, nullptr, static_cast<const float*>(scales), static_cast<bf16*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool W4, int MI>
int launch_a8(const void* x, const void* xs, const void* w, const void* scales, void* out,
              void* ws, int M, int N, int K, int splits, cudaStream_t stream) {
  using T = Tile<W4, MI>;
  auto kernel = quant_matmul_a8_kernel<W4, MI>;
  static bool attr_set = false;  // once per instantiation
  cudaError_t err;
  if (!attr_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int k_rows = W4 ? K / 2 : K;
  const int k_tiles = (k_rows + T::WRAW_ROWS - 1) / T::WRAW_ROWS;
  const int per = (k_tiles + splits - 1) / splits;
  dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM, splits);
  kernel<<<grid, NTHREADS, T::SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), static_cast<const float*>(scales),
      static_cast<bf16*>(out), static_cast<int*>(ws), M, N, K, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return finalize(true, ws, xs, scales, out, M, N, splits, stream);
}

// ---------------------------------------------------------------------------
// K6, K7: bf16 activations (wgmma, the weight dequantized in registers)

constexpr int WBN = 128;                 // weight columns per CTA
constexpr int WROWS = 64;                // stored weight rows per stage
constexpr int WTILE = WROWS * WBN;       // bytes of one raw weight box
constexpr int XK = 64;                   // K columns per x box (128 bytes)
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


// A fragments of both row tiles for one 16-wide K step. wv: the 4 bytes of
// this thread's columns c..c+3 at K rows 2q, 2q+1, 2q+8, 2q+9 of the step
// (int4: the low nibbles for half 0, the high ones for half 1). Row tile t
// takes columns c+2t (fragment row g) and c+2t+1 (row g+8).
template <bool W4>
__device__ __forceinline__ void dequant_fragments(const uint32_t (&wv)[4], int half,
                                                  uint32_t (&a)[2][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // K rows (2q, 2q+1), then (2q+8, 2q+9)
    const uint32_t r0 = wv[2 * p], r1 = wv[2 * p + 1];
    if constexpr (W4) {
      // Nibble n of column j from both rows into one word's halves, as the
      // bf16 bits 0x4300 | (n ^ 8) = 128 + (v + 8), then minus 136: exact.
      const uint32_t s0 = half ? r0 >> 4 : r0, s1 = half ? r1 >> 4 : r1;
      const __nv_bfloat162 bias = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                     __ushort_as_bfloat16(0x4308));
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t t = (__byte_perm(s0, s1, j | ((4 + j) << 8)) & 0x000F000Fu) ^ 0x43084308u;
        const __nv_bfloat162 b = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t), bias);
        v[j] = *reinterpret_cast<const uint32_t*>(&b);
      }
      a[0][2 * p] = v[0];
      a[0][2 * p + 1] = v[1];
      a[1][2 * p] = v[2];
      a[1][2 * p + 1] = v[3];
    } else {
      // u = v + 128 per byte; the fp32 word 0x4B0000uu is 2^23 + u.
      const uint32_t u0 = r0 ^ 0x80808080u, u1 = r1 ^ 0x80808080u;
      const float magic = 8388736.0f;  // 2^23 + 128
      a[0][2 * p] = bf16x2_upper(byte_value<0>(u0, magic), byte_value<0>(u1, magic));
      a[0][2 * p + 1] = bf16x2_upper(byte_value<1>(u0, magic), byte_value<1>(u1, magic));
      a[1][2 * p] = bf16x2_upper(byte_value<2>(u0, magic), byte_value<2>(u1, magic));
      a[1][2 * p + 1] = bf16x2_upper(byte_value<3>(u0, magic), byte_value<3>(u1, magic));
    }
  }
}

template <bool W4, int BT>
struct WTile {
  // Consumer warpgroups, each 128 weight columns: two at BT 128, sharing
  // each x box (half the x bytes per product), else one.
  static constexpr int NWG = BT >= 128 ? 2 : 1;
  static constexpr int COLS = NWG * WBN;       // weight columns per CTA
  static constexpr int THREADS = NWG * 128 + 32;  // + the producer warp
  // CTAs an SM holds (ops/quant_matmul.py::plan splits the K walk for it).
  static constexpr int PER_SM = NWG == 2 ? 1 : 2;
  static constexpr int NX = W4 ? 2 : 1;       // x boxes per stage
  static constexpr int XBOX = BT * XK * 2;    // bytes of one x box
  static constexpr int STAGE = NWG * WTILE + NX * XBOX;
  static constexpr int OROW = COLS + 8;       // staging row, bf16 elements
  // The ring is as deep as PER_SM CTAs on one SM allow (each less its
  // reserved 1 KB, its barriers and the 1 KB alignment slack), at most
  // MAX_STAGES; the epilogue reuses it as the staging tile.
  static constexpr int BUDGET =
      cmin(SMEM_LIMIT, SM_SMEM / PER_SM - CTA_RESERVED) - 2 * MAX_STAGES * 8 - 1024;
  static constexpr int STAGES = cmin(MAX_STAGES, BUDGET / STAGE);
  static constexpr int RING = cmax(STAGES * STAGE, BT * OROW * 2);
  static constexpr int SMEM = RING + 1024;  // dynamic: + the alignment slack
  static_assert(STAGES >= 2 && RING <= BUDGET, "the ring does not fit PER_SM CTAs an SM");
};

template <bool W4, int BT>
__global__ void __launch_bounds__(WTile<W4, BT>::THREADS, WTile<W4, BT>::PER_SM)
quant_matmul_wonly_kernel(const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_x,
                          const float* __restrict__ scales, bf16* __restrict__ out,
                          float* __restrict__ ws, int M, int N, int K,
                          int k_tiles_per_split) {
  using T = WTile<W4, BT>;
  constexpr int stages = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  // 128-byte swizzled boxes want 1024-byte aligned destinations.
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tok0 = blockIdx.x * BT, col0 = blockIdx.y * T::COLS;
  const int k_rows = W4 ? K / 2 : K;  // stored weight rows
  const int k_tiles = (k_rows + WROWS - 1) / WROWS;
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
        const int r = (t0 + i) * WROWS;
        mbar_arrive_expect_tx(&full[s], T::STAGE);
        for (int wg = 0; wg < T::NWG; ++wg)
          tma_load_2d(st + wg * WTILE, &tm_w, col0 + wg * WBN, r, &full[s]);
        uint8_t* xs = st + T::NWG * WTILE;
        tma_load_2d(xs, &tm_x, r, tok0, &full[s]);
        if constexpr (W4) tma_load_2d(xs + T::XBOX, &tm_x, K / 2 + r, tok0, &full[s]);
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
  float acc[2][BT / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[t][i] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const uint8_t* wt = ring + s * T::STAGE + wg * WTILE;
    const unsigned xt = smem_addr(ring + s * T::STAGE + T::NWG * WTILE);
    const int cw = c - wg * WBN;  // the column within this warpgroup's box
#pragma unroll
    for (int ks = 0; ks < WROWS / 16; ++ks) {
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
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const int col = col0 + c;  // N % 16 == 0: c..c+3 are all in or all out
  const bool col_ok = col < N;
  if (gridDim.z > 1) {  // fp32 partial sums, unscaled
    float* p = ws + (long long)blockIdx.z * M * N;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = tok0 + 8 * j + 2 * q + e;
        if (col_ok && tok < M)
          *reinterpret_cast<float4*>(p + (long long)tok * N + col) =
              make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                          acc[1][4 * j + 2 + e]);
      }
    return;
  }
  const float4 sc = col_ok ? *reinterpret_cast<const float4*>(scales + col)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  // Every consumer warp is past its last wgmma: the ring becomes the
  // staging tile (BT tokens x 128 columns of bf16).
  asm volatile("bar.sync 1, %0;\n" ::"n"(T::NWG * 128) : "memory");
  bf16* stage_out = reinterpret_cast<bf16*>(ring);
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(acc[0][4 * j + e] * sc.x, acc[0][4 * j + 2 + e] * sc.y);
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(acc[1][4 * j + e] * sc.z, acc[1][4 * j + 2 + e] * sc.w);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&lo);
      v.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(stage_out + (8 * j + 2 * q + e) * T::OROW + c) = v;
    }
  asm volatile("bar.sync 1, %0;\n" ::"n"(T::NWG * 128) : "memory");
  for (int id = tid; id < BT * (T::COLS / 8); id += T::NWG * 128) {
    const int tl = id / (T::COLS / 8), cc = (id % (T::COLS / 8)) * 8;
    const int tok = tok0 + tl, gc = col0 + cc;
    if (tok < M && gc < N)
      *reinterpret_cast<uint4*>(out + (long long)tok * N + gc) =
          *reinterpret_cast<const uint4*>(stage_out + tl * T::OROW + cc);
  }
}

// A weight's tensor map, encoded once per weight: the weights are the
// same tensors every call, and the encode is host work on the decode path,
// where the host sets the pace. The key is everything the map depends on,
// so a hit is always the right map.
bool weight_map(CUtensorMap* map, const void* w, int rows, int cols) {
  struct Entry {
    const void* ptr;
    int rows, cols;
    CUtensorMap map;
  };
  constexpr int SLOTS = 1024;  // direct-mapped; a miss re-encodes
  static Entry cache[SLOTS];
  static std::mutex lock;
  const size_t slot = (reinterpret_cast<uintptr_t>(w) >> 9) % SLOTS;
  std::lock_guard<std::mutex> held(lock);
  Entry& e = cache[slot];
  if (e.ptr != w || e.rows != rows || e.cols != cols) {
    e.ptr = nullptr;
    if (!encode_2d(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, rows, cols, WROWS, WBN))
      return false;
    e.ptr = w;
    e.rows = rows;
    e.cols = cols;
  }
  *map = e.map;
  return true;
}

template <bool W4, int BT>
int launch_wonly(const void* x, const void* w, const void* scales, void* out, void* ws, int M,
                 int N, int K, int splits, cudaStream_t stream) {
  using T = WTile<W4, BT>;
  auto kernel = quant_matmul_wonly_kernel<W4, BT>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int k_rows = W4 ? K / 2 : K;
  CUtensorMap tm_w, tm_x;
  if (!weight_map(&tm_w, w, k_rows, N) ||
      !encode_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BT, XK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int k_tiles = (k_rows + WROWS - 1) / WROWS;
  const int per = (k_tiles + splits - 1) / splits;
  dim3 grid((M + BT - 1) / BT, (N + T::COLS - 1) / T::COLS, splits);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(tm_w, tm_x, static_cast<const float*>(scales),
                                                static_cast<bf16*>(out),
                                                static_cast<float*>(ws), M, N, K, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return finalize(false, ws, nullptr, scales, out, M, N, splits, stream);
}

template <bool W4>
int launch_wonly_bt(int bt, const void* x, const void* w, const void* scales, void* out,
                    void* ws, int M, int N, int K, int splits, cudaStream_t s) {
  switch (bt) {
    case 16: return launch_wonly<W4, 16>(x, w, scales, out, ws, M, N, K, splits, s);
    case 32: return launch_wonly<W4, 32>(x, w, scales, out, ws, M, N, K, splits, s);
    case 64: return launch_wonly<W4, 64>(x, w, scales, out, ws, M, N, K, splits, s);
    case 128: return launch_wonly<W4, 128>(x, w, scales, out, ws, M, N, K, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K6/K7: x (M, K) bf16 contiguous; w (K, N) int8, or (K/2, N) packed int4
// (w4 = 1); scales (N,) fp32; out (M, N) bf16; ws (splits, M, N) fp32 when
// splits > 1. bt: tokens per CTA (16, 32, 64, 128); splits: ranges of the
// K walk. Pointers 16-byte aligned, N % 16 == 0, K % 32 == 0. Returns
// cudaGetLastError().
int fa_quant_matmul_wonly(const void* x, const void* w, const void* scales, void* out,
                          void* ws, int M, int N, int K, int w4, int bt, int splits,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = !(reinterpret_cast<uintptr_t>(x) % 16 ||
                         reinterpret_cast<uintptr_t>(w) % 16 ||
                         reinterpret_cast<uintptr_t>(scales) % 16 ||
                         reinterpret_cast<uintptr_t>(out) % 16 ||
                         reinterpret_cast<uintptr_t>(ws) % 16);
  if (N % 16 || K % 32 || splits < 1 || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w4) return launch_wonly_bt<true>(bt, x, w, scales, out, ws, M, N, K, splits, s);
  return launch_wonly_bt<false>(bt, x, w, scales, out, ws, M, N, K, splits, s);
}

// K8/K9: x (M, K) int8 contiguous; xs (M,) fp32 per-row activation scales;
// w (K, N) int8, or (K/2, N) packed int4 (w4 = 1); scales (N,) fp32; out
// (M, N) bf16; ws (splits, M, N) int32 when splits > 1. mi: 1 (M <= 16) or
// 4 (64-row tiles). N % 16 == 0, K % 32 == 0. Returns cudaGetLastError().
int fa_quant_matmul_a8(const void* x, const void* xs, const void* w, const void* scales,
                       void* out, void* ws, int M, int N, int K, int w4, int mi, int splits,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 16 || K % 32 || splits < 1 || (mi != 1 && mi != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w4)
    return mi == 1 ? launch_a8<true, 1>(x, xs, w, scales, out, ws, M, N, K, splits, s)
                   : launch_a8<true, 4>(x, xs, w, scales, out, ws, M, N, K, splits, s);
  return mi == 1 ? launch_a8<false, 1>(x, xs, w, scales, out, ws, M, N, K, splits, s)
                 : launch_a8<false, 4>(x, xs, w, scales, out, ws, M, N, K, splits, s);
}

}  // extern "C"
