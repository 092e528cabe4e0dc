// Flash-attention forward (FA2) for Hopper, bf16, d_head 128.
//
// Replaces the TPU kernel flash_attention_from_scratch_tpu/ops/flash_forward.py
// _grid_kernel (and, through the causal early exit below, the row-band
// dispatch ops/causal_decomp.py causal_forward_banded, which only calls that
// kernel once per band). Same function: softmax(scale * Q K^T) V with an fp32
// online softmax in the exp2 domain, P cast to bf16 before PV, causal masks
// with a q_offset, a sliding window, a Gemma-2 softcap, per-head attention
// sinks merged at finalisation, GQA, and an optional natural-log LSE.
//
// What bounds it on the H100: at the prompt lengths it serves (256..4096 rows,
// 32 heads) attention is far above the card's ~295 FLOP/byte balance point, so
// the bound is tensor-core operations (989 TFLOP/s bf16). This first version
// uses mma.sync m16n8k16 (the Ampere-style warp-level tensor-core path), which
// cannot reach Hopper's wgmma rate; its design keeps the tensor cores fed as
// far as that path allows:
//   - one CTA per (64 Q rows, Q head, batch), 4 warps of 16 rows each; the
//     heaviest causal tiles are scheduled first;
//   - Q, K and V tiles of 64 x 128 bf16 in shared memory, rows padded to 272
//     bytes so ldmatrix reads are free of bank conflicts; K/V double-buffered
//     with cp.async so the next tile streams in during this tile's math;
//   - S and O accumulate in fp32 registers; P never leaves registers (the S
//     accumulator fragments are the A operand of the PV product);
//   - causal walks stop at the diagonal tile and windowed walks start at the
//     first visible tile, so masked tiles cost nothing; interior tiles skip
//     the mask arithmetic.
// A wgmma + TMA producer/consumer version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;        // head width
constexpr int BQ = 64;        // Q rows per CTA
constexpr int BK = 64;        // keys per KV tile
constexpr int NWARPS = 4;     // 16 Q rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;    // padded shared-memory row, in elements
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_VALUE = -1e30f;  // finite, as in the JAX kernel

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;          // (batch, heads, seq_q) or null
  const float* sinks;  // (heads,) or null
  long long q_sb, q_sh, q_ss;  // strides in elements; d is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads, group, seq_q, seq_kv;
  int causal, q_offset, window;
  float scale, softcap;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy a 64 x 128 tile (row stride in elements) into padded shared memory.
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g,
                                          long long row_stride, int tid) {
#pragma unroll
  for (int i = 0; i < (BK * D / 8) / NTHREADS; ++i) {
    int c = tid + i * NTHREADS;
    int r = c >> 4, col = (c & 15) * 8;
    cp_async16(smem + r * LDS + col, g + r * row_stride + col);
  }
}

__global__ void __launch_bounds__(NTHREADS)
flash_forward_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + BQ * LDS;   // 2 stages
  bf16* v_s = k_s + 2 * BK * LDS;  // 2 stages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = q_tile * BQ;

  const bf16* q_g = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const bf16* k_g = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* v_g = p.v + b * p.v_sb + hk * p.v_sh;

  // Visible KV tiles [first, last]: the causal walk ends at the diagonal,
  // a window starts it at the first tile any row of this Q tile can see.
  const int q_min = p.q_offset + q0, q_max = q_min + BQ - 1;
  int first = 0, last = p.seq_kv / BK - 1;
  if (p.causal) {
    last = min(last, q_max / BK);
    if (p.window) first = max(0, q_min - p.window + 1) / BK;
  }

  load_tile(q_s, q_g, p.q_ss, tid);
  if (first <= last) {
    load_tile(k_s, k_g + (long long)first * BK * p.k_ss, p.k_ss, tid);
    load_tile(v_s, v_g + (long long)first * BK * p.v_ss, p.v_ss, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // This warp's 16 Q rows as mma A fragments, one per 16-wide d step.
  uint32_t qa[D / 16][4];
  {
    const int m = lane >> 3;
    const bf16* base = q_s + (warp * 16 + (m & 1) * 8 + (lane & 7)) * LDS + (m >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qa[kk], base + kk * 16);
  }

  float o_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  const float c_log2 = p.scale * LOG2E;
  const int row0 = p.q_offset + q0 + warp * 16 + g;  // global position of row g

  for (int j = first; j <= last; ++j) {
    const int stage = (j - first) & 1;
    if (j + 1 <= last) {
      const int nxt = stage ^ 1;
      load_tile(k_s + nxt * BK * LDS, k_g + (long long)(j + 1) * BK * p.k_ss, p.k_ss, tid);
      load_tile(v_s + nxt * BK * LDS, v_g + (long long)(j + 1) * BK * p.v_ss, p.v_ss, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed; tile j + 1 may be in flight
    __syncthreads();

    const bf16* ks = k_s + stage * BK * LDS;
    const bf16* vs = v_s + stage * BK * LDS;

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      const bf16* kb = ks + (n * 8 + (lane & 7)) * LDS + (lane >> 3) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kb + kk * 16);
        mma_bf16(s[n], qa[kk], kf[0], kf[1]);
        mma_bf16(s[n], qa[kk + 1], kf[2], kf[3]);
      }
    }

    // Scale (and softcap) into the log2 domain; mask edge tiles.
    const int kv0 = j * BK;
    const bool edge = p.causal &&
        (kv0 + BK - 1 > q_min || (p.window && kv0 <= q_max - p.window));
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if (p.softcap > 0.f) {
          x = tanhf(x * p.scale / p.softcap) * (p.softcap * LOG2E);
        } else {
          x *= c_log2;
        }
        if (edge) {
          const int qpos = row0 + (e >> 1) * 8;
          const int kpos = kv0 + n * 8 + 2 * t + (e & 1);
          const bool keep = kpos <= qpos && (!p.window || qpos - kpos < p.window);
          if (!keep) x = MASK_VALUE;
        }
        s[n][e] = x;
      }
    }

    // Online softmax: row max over the quad that shares each row.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - m_run[e >> 1]);
        s[n][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o_acc[n][0] *= alpha[0];
      o_acc[n][1] *= alpha[0];
      o_acc[n][2] *= alpha[1];
      o_acc[n][3] *= alpha[1];
    }

    // O += P V: the S fragments of key steps 2kk, 2kk+1 are P's A fragment.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int m = lane >> 3;
      const bf16* vb = vs + (kk * 16 + (m & 1) * 8 + (lane & 7)) * LDS + (m >> 1) * 8;
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vb + n * 8);
        mma_bf16(o_acc[n], pa, vf[0], vf[1]);
        mma_bf16(o_acc[n + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

  // Finalise: full row sums, sink merge, normalise, write O and LSE.
  const float z = p.sinks ? p.sinks[h] * LOG2E : -INFINITY;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    float m = m_run[r];
    float scale_o = 1.f;
    if (p.sinks) {
      const float m_tot = fmaxf(m, z);
      scale_o = exp2f(m - m_tot);
      l = l * scale_o + exp2f(z - m_tot);
      m = m_tot;
    }
    const float inv = l > 0.f ? scale_o / l : 0.f;
    const int row = q0 + warp * 16 + g + r * 8;
    bf16* o_row = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(o_row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o_acc[n][2 * r] * inv, o_acc[n][2 * r + 1] * inv);
    }
    if (p.lse && t == 0) {
      p.lse[((long long)b * p.heads + h) * p.seq_q + row] =
          l > 0.f ? (m + log2f(l)) / LOG2E : -INFINITY;
    }
  }
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (b, heads, seq_q, 128), k/v (b, kv_heads, seq_kv, 128), o like q: bf16 with
// the given element strides (d contiguous, rows 16-byte aligned). lse is
// (b, heads, seq_q) fp32 contiguous or null; sinks (heads,) fp32 or null.
// seq_q and seq_kv are multiples of 64. Returns cudaGetLastError().
int fa_flash_forward(const void* q, const void* k, const void* v, void* o,
                     void* lse, const void* sinks,
                     long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss,
                     long long o_sb, long long o_sh, long long o_ss,
                     int batch, int heads, int kv_heads, int seq_q, int seq_kv,
                     int causal, int q_offset, int window, float scale,
                     float softcap, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.sinks = static_cast<const float*>(sinks);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
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
  const int smem = (BQ + 4 * BK) * LDS * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(seq_q / BQ, heads, batch);
  flash_forward_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
