// Shared pieces of the hand-written flash-attention forward kernels for
// Hopper, d_head 128: the PTX wrappers, the visible K/V tile range of a Q
// tile, and the FA2 forward's work on one 64-key tile (S = Q K^T on bf16
// mma.sync m16n8k16 with fp32 sums, scale or softcap into the exp2 domain,
// causal and window masks, the online softmax, O += P V with P cast to
// bf16) and its finalisation (optional sink, output scale, natural-log LSE).
//
// Layout shared by every includer: one CTA per (64 Q rows, Q head, batch),
// 4 warps of 16 rows; tiles in shared memory as padded bf16 rows (LDS
// elements apart, so ldmatrix reads are free of bank conflicts). Included by
// flash_forward_fori.cu (K11) and flash_quant.cu (K10); K1 (flash_forward.cu)
// holds the same math in its own source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;        // head width
constexpr int BQ = 64;        // Q rows per CTA
constexpr int BK = 64;        // keys per bf16 KV tile
constexpr int NWARPS = 4;     // 16 Q rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;    // padded shared-memory row, in bf16 elements
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASK_VALUE = -1e30f;  // finite, as in the JAX kernels

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
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

// Visible KV tiles [first, last] (bk keys each) of the Q tile whose first
// row sits at position q_min: a causal walk ends at the diagonal tile, a
// window starts it at the first tile any row of the Q tile can see.
__device__ __forceinline__ void kv_tiles(int causal, int window, int q_min, int seq_kv,
                                         int bk, int& first, int& last) {
  first = 0;
  last = seq_kv / bk - 1;
  if (causal) {
    last = min(last, (q_min + BQ - 1) / bk);
    if (window) first = max(0, q_min - window + 1) / bk;
  }
}

// Whether the bk-key tile at kv0 holds a key that some row of the Q tile at
// q_min may not see (so its scores need the per-element mask).
__device__ __forceinline__ bool tile_needs_mask(int causal, int window, int q_min, int kv0,
                                                int bk) {
  return causal && (kv0 + bk - 1 > q_min || (window && kv0 <= q_min + BQ - 1 - window));
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return kpos <= qpos && (!window || qpos - kpos < window);
}

// This warp's 16 rows of a bf16 Q tile as mma A fragments, one per 16-wide d
// step.
__device__ __forceinline__ void load_q_fragments(uint32_t (&qa)[D / 16][4], const bf16* q_s,
                                                 int warp, int lane) {
  const int m = lane >> 3;
  const bf16* base = q_s + (warp * 16 + (m & 1) * 8 + (lane & 7)) * LDS + (m >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qa[kk], base + kk * 16);
}

// What a thread holds of its warp's 16 rows: rows g and g + 8 of the O
// accumulator (its mma C fragments), their running max in the log2 domain
// and its partial row sums.
struct RowState {
  float o[D / 8][4];
  float m[2];
  float l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
};

// One BK-key tile of the forward for this warp's 16 rows: ks and vs are the
// tile's K and V rows (bf16, LDS apart), kv0 its first key's position, q_min
// the position of the CTA's first Q row. score_scale multiplies Q K^T (a
// softcap, when > 0, applies after it, as tanh(x / cap) * cap).
__device__ __forceinline__ void attend_tile(RowState& st, const uint32_t (&qa)[D / 16][4],
                                            const bf16* ks, const bf16* vs, int warp,
                                            int lane, int kv0, int causal, int q_min,
                                            int window, float score_scale, float softcap) {
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q_min + warp * 16 + g;  // position of row g

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

  // Scale (and softcap) into the log2 domain, then mask edge tiles; each
  // behind one branch a tile, so a tile without a cap or a mask does no
  // per-score work for them.
  if (softcap > 0.f) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = tanhf(s[n][e] * score_scale / softcap) * (softcap * LOG2E);
  } else {
    const float c_log2 = score_scale * LOG2E;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= c_log2;
  }
  if (tile_needs_mask(causal, window, q_min, kv0, BK)) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!visible(row0 + (e >> 1) * 8, kv0 + n * 8 + 2 * t + (e & 1), window))
          s[n][e] = MASK_VALUE;
      }
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
    const float m_new = fmaxf(st.m[r], mx);
    alpha[r] = exp2f(st.m[r] - m_new);
    st.m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2f(s[n][e] - st.m[e >> 1]);
      s[n][e] = pe;
      rs[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + rs[r];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
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
      mma_bf16(st.o[n], pa, vf[0], vf[1]);
      mma_bf16(st.o[n + 1], pa, vf[2], vf[3]);
    }
  }
}

// Finalise this warp's 16 rows: full row sums over the quad, an optional
// sink (its logit in the log2 domain, -INFINITY for none) merged into the
// softmax, then O = acc / l * out_scale as bf16 into o (the (batch, head)
// base, rows o_ss elements apart, row q0 first) and, where lse is not null,
// the natural-log LSE of each row into lse[row].
__device__ __forceinline__ void store_rows(const RowState& st, int warp, int lane, int q0,
                                           bf16* o, long long o_ss, float out_scale,
                                           float sink_log2, float* lse) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = st.l[r];
    l += __shfl_xor_sync(0xffffffff, l, 1);
    l += __shfl_xor_sync(0xffffffff, l, 2);
    float m = st.m[r];
    float scale_o = 1.f;
    if (sink_log2 != -INFINITY) {
      const float m_tot = fmaxf(m, sink_log2);
      scale_o = exp2f(m - m_tot);
      l = l * scale_o + exp2f(sink_log2 - m_tot);
      m = m_tot;
    }
    const float inv = l > 0.f ? scale_o * out_scale / l : 0.f;
    const int row = q0 + warp * 16 + g + r * 8;
    bf16* o_row = o + row * o_ss;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(o_row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(st.o[n][2 * r] * inv, st.o[n][2 * r + 1] * inv);
    }
    if (lse && t == 0) lse[row] = l > 0.f ? (m + log2f(l)) / LOG2E : -INFINITY;
  }
}

}  // namespace
