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
// One templated kernel over {int8, int4} x {bf16 activations, int8
// activations}, on the tensor cores: mma.sync m16n8k16 bf16 (weight-only,
// int8 -> bf16 is exact since |v| <= 127) and m16n8k32 s8 (a8).
//
// What bounds it on the H100: at decode (M = 16) every weight byte is read
// once for 2 * 16 operations, far below the card's ~295 FLOP/byte balance:
// the bound is the weight stream, bytes / 3.35 TB/s. At prefill (M = 1024)
// it is the tensor cores, 2 M K N / 989 TFLOP/s (bf16) or / 1979 (int8).
// The design:
//   - a CTA computes a BM x 64 output tile (BM = 16 for M <= 16, else 64)
//     with 4 warps of 16 columns each, walking K in tiles of 64 dequantized
//     rows through a 4-stage cp.async ring (zero-filled past M, N and K, so
//     ragged edges are masked in the kernel and every shape runs here);
//   - each stage's raw weight tile is converted once in shared memory:
//     to bf16 rows for ldmatrix.trans (weight-only), or transposed to
//     (n, k) int8 with a 4x4 byte transpose in registers (a8), so that both
//     feed standard mma fragments;
//   - when the output tiles alone leave SMs idle (small M), the wrapper
//     splits the K walk across CTAs; each split writes its partial sums
//     (fp32, or int32 for a8, which stays exact) to a workspace and a second
//     pass adds them in a fixed order and applies the scales, so results
//     are reproducible run to run.
// Needs N % 16 == 0 and K % 32 == 0 (16-byte copies); the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 128;
constexpr int BN = 64;
constexpr int BK = 64;  // dequantized K rows per stage
constexpr int STAGES = 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ uint32_t bf16x2_of(int lo, int hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 bytes -> four bf16 values (exact), as two 32-bit words.
__device__ __forceinline__ uint2 bytes_to_bf16(uint32_t w) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
  return make_uint2(bf16x2_of(b[0], b[1]), bf16x2_of(b[2], b[3]));
}

template <bool W4, bool A8, int MI>
struct Tile {
  static constexpr int BM = 16 * MI;
  // Shared-memory row strides in bytes, padded so ldmatrix rows of one
  // 8x8 matrix fall in distinct banks.
  static constexpr int XROW = A8 ? 64 + 16 : 2 * 64 + 16;
  static constexpr int WRAW_ROWS = W4 ? BK / 2 : BK;  // stored rows per stage
  static constexpr int WRAW = WRAW_ROWS * BN;
  static constexpr int CROW = A8 ? BK + 16 : 2 * BN + 16;  // converted tile
  static constexpr int CONV = A8 ? BN * CROW : BK * CROW;
  static constexpr int SMEM = STAGES * (BM * XROW + WRAW) + CONV;
};

template <bool W4, bool A8, int MI>
__global__ void __launch_bounds__(NTHREADS)
quant_matmul_kernel(const void* __restrict__ x, const float* __restrict__ xs,
                    const int8_t* __restrict__ w, const float* __restrict__ scales,
                    bf16* __restrict__ out, void* __restrict__ ws, int M, int N,
                    int K, int k_tiles_per_split) {
  using T = Tile<W4, A8, MI>;
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
  const int xbytes = A8 ? 1 : 2;
  const uint8_t* xb = static_cast<const uint8_t*>(x);

  auto load_stage = [&](int stage, int t) {
    // x tile: BM rows x 64 K columns (int4: 32 from each half of K).
    constexpr int XCH = A8 ? 4 : 8;  // 16-byte chunks per row
    constexpr int ECH = 16 / (A8 ? 1 : 2);  // elements per chunk
    uint8_t* xd = xs_s + stage * T::BM * T::XROW;
    for (int c = tid; c < T::BM * XCH; c += NTHREADS) {
      const int r = c / XCH, ch = c % XCH;
      int gcol;
      bool valid;
      if constexpr (W4) {
        const int half = ch / (XCH / 2), within = (ch % (XCH / 2)) * ECH;
        const int p = t * T::WRAW_ROWS + within;
        gcol = half * (K / 2) + p;
        valid = p < K / 2;
      } else {
        gcol = t * BK + ch * ECH;
        valid = gcol < K;
      }
      valid = valid && row0 + r < M;
      const uint8_t* src = valid ? xb + ((long long)(row0 + r) * K + gcol) * xbytes : xb;
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

  // Raw stage -> the converted tile the mma fragments read.
  auto convert = [&](int stage) {
    const uint32_t* raw = reinterpret_cast<const uint32_t*>(raw_s + stage * T::WRAW);
    if constexpr (A8) {
      // (k, n) int8 -> (n, k) int8, 4x4 byte blocks: 16 x 16 blocks.
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
    } else {
      // (k, n) int8 -> (k, n) bf16.
      for (int c = tid; c < T::WRAW_ROWS * (BN / 4); c += NTHREADS) {
        const int r = c / (BN / 4), wc = c % (BN / 4);
        const uint32_t v = raw[c];
        if constexpr (W4) {
          *reinterpret_cast<uint2*>(conv_s + r * T::CROW + wc * 8) = bytes_to_bf16(nibbles(v, false));
          *reinterpret_cast<uint2*>(conv_s + (r + BK / 2) * T::CROW + wc * 8) =
              bytes_to_bf16(nibbles(v, true));
        } else {
          *reinterpret_cast<uint2*>(conv_s + r * T::CROW + wc * 8) = bytes_to_bf16(v);
        }
      }
    }
  };

  using acc_t = std::conditional_t<A8, int, float>;
  acc_t acc[MI][2][4];
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
    if constexpr (A8) {
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
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, conv_s + (kk * 16 + (lane & 15)) * T::CROW +
                                 (warp * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          uint32_t a[4];
          ldmatrix_x4(a, xt + (mi * 16 + (lane & 15)) * T::XROW + (kk * 16 + (lane >> 4) * 8) * 2);
          mma_bf16(acc[mi][0], a, b[0], b[1]);
          mma_bf16(acc[mi][1], a, b[2], b[3]);
        }
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
        const acc_t c0 = acc[mi][ni][2 * h], c1 = acc[mi][ni][2 * h + 1];
        if (split) {
          acc_t* p = static_cast<acc_t*>(ws) + (long long)blockIdx.z * M * N + at;
          p[0] = c0;
          p[1] = c1;
        } else {
          float v0, v1;
          if constexpr (A8) {
            v0 = static_cast<float>(c0) * xs[row] * scales[col];
            v1 = static_cast<float>(c1) * xs[row] * scales[col + 1];
          } else {
            v0 = static_cast<float>(c0) * scales[col];
            v1 = static_cast<float>(c1) * scales[col + 1];
          }
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

template <bool W4, bool A8, int MI>
int launch(const void* x, const void* xs, const void* w, const void* scales, void* out,
           void* ws, int M, int N, int K, int splits, cudaStream_t stream) {
  using T = Tile<W4, A8, MI>;
  auto kernel = quant_matmul_kernel<W4, A8, MI>;
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
      x, static_cast<const float*>(xs), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<bf16*>(out), ws, M, N, K, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long mn = (long long)M * N;
  quant_matmul_finalize<A8><<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
      ws, static_cast<const float*>(xs), static_cast<const float*>(scales),
      static_cast<bf16*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

template <bool W4, bool A8>
int launch_mi(int mi, const void* x, const void* xs, const void* w, const void* scales,
              void* out, void* ws, int M, int N, int K, int splits, cudaStream_t s) {
  if (mi == 1) return launch<W4, A8, 1>(x, xs, w, scales, out, ws, M, N, K, splits, s);
  if (mi == 4) return launch<W4, A8, 4>(x, xs, w, scales, out, ws, M, N, K, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K) bf16 (a8 = 0) or int8 (a8 = 1), contiguous; xs (M,) fp32 per-row
// activation scales (a8 only); w (K, N) int8, or (K/2, N) packed int4
// (w4 = 1); scales (N,) fp32; out (M, N) bf16; ws (splits, M, N) fp32
// (int32 for a8) when splits > 1. mi: 1 (M <= 16) or 4 (64-row tiles).
// N % 16 == 0, K % 32 == 0. Returns cudaGetLastError().
int fa_quant_matmul(const void* x, const void* xs, const void* w, const void* scales,
                    void* out, void* ws, int M, int N, int K, int w4, int a8, int mi,
                    int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 16 || K % 32 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (w4 && a8) return launch_mi<true, true>(mi, x, xs, w, scales, out, ws, M, N, K, splits, s);
  if (w4) return launch_mi<true, false>(mi, x, xs, w, scales, out, ws, M, N, K, splits, s);
  if (a8) return launch_mi<false, true>(mi, x, xs, w, scales, out, ws, M, N, K, splits, s);
  return launch_mi<false, false>(mi, x, xs, w, scales, out, ws, M, N, K, splits, s);
}

}  // extern "C"
