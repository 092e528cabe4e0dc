// Paged decode attention for Hopper: one query token per sequence over a
// paged KV cache, bf16, d_head 128, dense pages.
//
// Replaces the TPU kernels flash_attention_from_scratch_tpu/ops/
// paged_attention.py _full_kernel (whole window per sequence) and _loop_kernel
// (online softmax per page). Both compute the same function; on Hopper it is
// one kernel. Each Q head h = hk * group + g attends the pages of KV head hk:
// softmax(scale * q K^T) V over tokens [start, length), with start =
// max(length - window, 0) under a sliding window, a Gemma-2 softcap on the
// scaled scores, and zeros for a length-0 row.
//
// What bounds it on the H100: each step reads every cached K/V byte once and
// does 4 FLOPs per byte pair, far below the card's ~295 FLOP/byte balance
// point, so the bound is memory: K/V bytes / 3.35 TB/s. The design:
//   - one CTA per (sequence, KV head); the group's Q rows stay in registers,
//     so each K/V row is read from memory once for the whole group;
//   - a K or V row of 128 bf16 is 16 lanes x 16 bytes: each half-warp owns
//     one token at a time and each warp keeps 8 tokens (4 per half) of loads
//     in flight before it does any math;
//   - an fp32 online softmax per half-warp, merged across the CTA through
//     shared memory at the end;
//   - pages past the length (page-table padding -1) and below the window are
//     never read, so V rows that were never written cannot reach the sum.
// With one CTA per (sequence, KV head), a batch of 8 at 8 KV heads fills 64 of
// the 132 SMs; splitting the KV walk across CTAs (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int U = 4;  // tokens per half-warp per iteration
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int G>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
                    const bf16* __restrict__ v_pages, const int* __restrict__ lengths,
                    const int* __restrict__ page_tables, bf16* __restrict__ out,
                    int heads, int num_pages, int page_size, int pages_per_seq,
                    float scale, float softcap, int window) {
  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][D];

  const int b = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane >> 4, hl = lane & 15;
  const int len = lengths[b];
  const int start = window ? max(len - window, 0) : 0;

  // Q rows of this KV head's group: lane hl holds dims [8*hl, 8*hl + 8).
  float qf[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + ((long long)b * heads + hk * G + gi) * D + hl * 8);
    unpack8(raw, qf[gi]);
  }
  float m_run[G], l_run[G], acc[G][8];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m_run[gi] = -INFINITY;
    l_run[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[gi][i] = 0.f;
  }

  const int* pt = page_tables + (long long)b * pages_per_seq;
  const long long head_rows = (long long)hk * num_pages * page_size;
  const float c_log2 = scale * LOG2E;

  // Warp w covers tokens [c0, c0 + 2U): half 0 the first U, half 1 the next.
  // Both halves run the same iterations, so the shuffles below never diverge.
  for (int c0 = start + warp * 2 * U; c0 < len; c0 += NWARPS * 2 * U) {
    uint4 kr[U], vr[U];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tok = c0 + half * U + u;
      valid[u] = tok < len;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (valid[u]) {
        const int page = pt[tok / page_size];
        const long long off = (head_rows + (long long)page * page_size + tok % page_size) * D + hl * 8;
        kr[u] = *reinterpret_cast<const uint4*>(k_pages + off);
        vr[u] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
    float sc[G][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(kr[u], kf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qf[gi][i], kf[i], dot);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffff, dot, off);
        float x = softcap > 0.f ? tanhf(dot * scale / softcap) * (softcap * LOG2E)
                                : dot * c_log2;
        sc[gi][u] = valid[u] ? x : -INFINITY;
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float mx = sc[gi][0];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[gi][u]);
      const float m_new = fmaxf(m_run[gi], mx);
      if (m_new == -INFINITY) continue;  // no valid token yet for this half
      const float alpha = exp2f(m_run[gi] - m_new);
      m_run[gi] = m_new;
      l_run[gi] *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[gi][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!valid[u]) continue;
        const float pe = exp2f(sc[gi][u] - m_new);
        l_run[gi] += pe;
        float vf[8];
        unpack8(vr[u], vf);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[gi][i] = fmaf(pe, vf[i], acc[gi][i]);
      }
    }
  }

  // Merge the two halves of the warp, then the warps through shared memory.
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const float m_o = __shfl_xor_sync(0xffffffff, m_run[gi], 16);
    const float l_o = __shfl_xor_sync(0xffffffff, l_run[gi], 16);
    const float m_tot = fmaxf(m_run[gi], m_o);
    const float a = m_tot == -INFINITY ? 0.f : exp2f(m_run[gi] - m_tot);
    const float ao = m_tot == -INFINITY ? 0.f : exp2f(m_o - m_tot);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float acc_o = __shfl_xor_sync(0xffffffff, acc[gi][i], 16);
      acc[gi][i] = acc[gi][i] * a + acc_o * ao;
    }
    if (lane == 0) {
      sm_m[warp][gi] = m_tot;
      sm_l[warp][gi] = l_run[gi] * a + l_o * ao;
    }
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sm_acc[warp][gi][hl * 8 + i] = acc[gi][i];
    }
  }
  __syncthreads();

  for (int idx = tid; idx < G * D; idx += NTHREADS) {
    const int gi = idx / D, col = idx % D;
    float m_tot = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m_tot = fmaxf(m_tot, sm_m[w][gi]);
    float l = 0.f, o = 0.f;
    if (m_tot != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float wt = exp2f(sm_m[w][gi] - m_tot);
        l += sm_l[w][gi] * wt;
        o += sm_acc[w][gi][col] * wt;
      }
    }
    out[((long long)b * heads + hk * G + gi) * D + col] =
        __float2bfloat16(l > 0.f ? o / l : 0.f);
  }
}

template <int G>
int launch(const void* q, const void* kp, const void* vp, const void* lengths,
           const void* pt, void* out, int batch, int heads, int kv_heads,
           int num_pages, int page_size, int pages_per_seq, float scale,
           float softcap, int window, cudaStream_t stream) {
  dim3 grid(batch, kv_heads);
  paged_decode_kernel<G><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(lengths),
      static_cast<const int*>(pt), static_cast<bf16*>(out), heads, num_pages,
      page_size, pages_per_seq, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (batch, heads, 128) bf16 contiguous; k/v pages (kv_heads, num_pages,
// page_size, 128) bf16 contiguous; lengths (batch,) int32; page_tables
// (batch, pages_per_seq) int32, -1 padded; out like q. heads / kv_heads must
// be 1, 2, 4 or 8. Returns cudaGetLastError().
int fa_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                    const void* lengths, const void* page_tables, void* out,
                    int batch, int heads, int kv_heads, int num_pages,
                    int page_size, int pages_per_seq, float scale,
                    float softcap, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (heads / kv_heads) {
    case 1: return launch<1>(q, k_pages, v_pages, lengths, page_tables, out, batch, heads,
                             kv_heads, num_pages, page_size, pages_per_seq, scale, softcap,
                             window, s);
    case 2: return launch<2>(q, k_pages, v_pages, lengths, page_tables, out, batch, heads,
                             kv_heads, num_pages, page_size, pages_per_seq, scale, softcap,
                             window, s);
    case 4: return launch<4>(q, k_pages, v_pages, lengths, page_tables, out, batch, heads,
                             kv_heads, num_pages, page_size, pages_per_seq, scale, softcap,
                             window, s);
    case 8: return launch<8>(q, k_pages, v_pages, lengths, page_tables, out, batch, heads,
                             kv_heads, num_pages, page_size, pages_per_seq, scale, softcap,
                             window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
