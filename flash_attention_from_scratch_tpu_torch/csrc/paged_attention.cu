// Paged decode attention for Hopper: 1..t query tokens per sequence over a
// paged KV cache, bf16 queries, d_head 128; pages dense bf16, int8, fp8
// (e4m3) or int4 packed along the tokens of a page; optionally int8
// compute on int8 pages.
//
// Replaces the TPU kernels flash_attention_from_scratch_tpu/ops/
// paged_attention.py _full_kernel (whole window per sequence) and _loop_kernel
// (online softmax per page). Both compute the same function; on Hopper it is
// one kernel. The rows of KV head hk are its group's Q heads times the t
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
// |q|, 1e-12) * (1/127); S is the exact int32 dot q_i8 . k_i8 (__dp4a over a
// lane's 8 bytes, then the half-warp's integer shuffle sum) times s_q *
// scale * log2(e) * the page's K scale; P = exp2(S - m) is rounded at the
// constant scale 127 against the running max m of the half-warp that rounds
// it (never above the row's final max, so the rounding error of a weight is
// at most what rounding against the final max gives); each product of an
// int8 P and an int8 V value is exact, scaled by the page's V scale / 127
// and summed in fp32; the denominator sums the unrounded P.
//
// What bounds it on the H100: each call reads every cached K/V byte of the
// window once and does 4 FLOPs per byte pair and row, far below the card's
// ~295 FLOP/byte balance point, so the bound is memory: K/V bytes / 3.35
// TB/s. The design:
//   - one CTA per (sequence, KV head, block of RB rows); a block's Q rows
//     stay in registers, so each K/V row is read once for the RB rows. With
//     more than 8 rows (group x tokens: Llama-3-8B's group 4 at t = 4 gives
//     16), the blocks are separate CTAs (gridDim.z) that read the same
//     pages at about the same time, mostly from L2: K/V is read from the
//     memory system once per 8-row block, the verify call's cost above the
//     single-token bound;
//   - a K or V row is split over 16 lanes, 8 values each (16 bytes of bf16,
//     8 of int8/fp8, 8 nibble-bytes of int4): each half-warp owns one token
//     at a time and each warp keeps 8 tokens (4 per half) of loads in flight
//     before it does any math; the upcast to fp32 happens in registers;
//   - an fp32 online softmax per half-warp and row, merged across the CTA
//     through shared memory at the end;
//   - pages past the length (page-table padding -1) and below the lowest
//     window start of the rows are never read, so slots that were never
//     written (an fp8 byte there can be a NaN pattern) cannot reach the sum:
//     the TPU kernel's select on V rows.
// With one CTA per (sequence, KV head, row block), a batch of 8 at 8 KV heads
// and one block fills 64 of the 132 SMs; splitting the KV walk across CTAs
// (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int U = 4;  // tokens per half-warp per iteration
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Page formats (the wrapper's mode argument); INT8C: int8 pages, int8 compute.
constexpr int DENSE = 0, INT8 = 1, FP8 = 2, INT4 = 3, INT8C = 4;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// 8 stored values of one row (raw.x, raw.y) -> fp32. int4: the low or
// high nibble of each byte, sign-extended.
template <int MODE>
__device__ __forceinline__ void unpack8q(const uint4& raw, bool hi, float (&f)[8]) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (MODE == INT8) {
      f[i] = static_cast<float>(static_cast<int8_t>(b[i]));
    } else if constexpr (MODE == FP8) {
      __nv_fp8_e4m3 v;
      v.__x = b[i];
      f[i] = static_cast<float>(v);
    } else {
      const int nib = hi ? (b[i] >> 4) : (b[i] & 0xF);
      f[i] = static_cast<float>((nib ^ 8) - 8);
    }
  }
}

template <int MODE>
__device__ __forceinline__ void unpack_row(const uint4& raw, bool hi, float (&f)[8]) {
  if constexpr (MODE == DENSE) {
    unpack8(raw, f);
  } else {
    unpack8q<MODE>(raw, hi, f);
  }
}

// Half-warp sums: lanes 0-15 and 16-31 each reduce over their own 16.
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ int half_sum(int x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

template <int RB, int MODE>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const bf16* __restrict__ q, const void* __restrict__ k_pages,
                    const void* __restrict__ v_pages, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ lengths,
                    const int* __restrict__ page_tables, bf16* __restrict__ out,
                    int kv_heads, int num_pages, int page_size, int pages_per_seq,
                    int q_tokens, int rows_total, float scale, float softcap, int window) {
  constexpr bool I8C = MODE == INT8C;
  constexpr int STORE = I8C ? INT8 : MODE;  // how the pages are stored
  __shared__ float sm_m[NWARPS][RB];
  __shared__ float sm_l[NWARPS][RB];
  __shared__ float sm_acc[NWARPS][RB][D];

  const int b = blockIdx.x, hk = blockIdx.y, r0 = blockIdx.z * RB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = lane >> 4, hl = lane & 15;
  const int len = lengths[b];
  // The lowest window start of all t tokens: tokens below it are never read.
  const int start = window ? max(len - (q_tokens - 1) - window, 0) : 0;
  const long long row_base = ((long long)b * kv_heads + hk) * rows_total;
  const float c_log2 = scale * LOG2E;
  const float cap_log2 = softcap * LOG2E;

  // Row ri of the block is row r0 + ri = g * t + j of this KV head: it sees
  // tokens [lim[ri] - win, lim[ri]) (tokens are >= 0, so no clamp at 0).
  // Rows past rows_total see none.
  const int win = window > 0 ? window : (1 << 30);
  int lim[RB];
#pragma unroll
  for (int ri = 0; ri < RB; ++ri) {
    const int r = r0 + ri;
    lim[ri] = r < rows_total ? len - (q_tokens - 1) + r % q_tokens : 0;
  }

  // Q rows: lane hl holds dims [8*hl, 8*hl + 8); fp32, or for int8 compute
  // the row's 8 int8 values packed in two words and s_q * scale * log2(e).
  float qf[I8C ? 1 : RB][8];
  int2 qi[I8C ? RB : 1];
  float qsc[I8C ? RB : 1];
#pragma unroll
  for (int ri = 0; ri < RB; ++ri) {
    const int r = r0 + ri;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < rows_total) {
      raw = *reinterpret_cast<const uint4*>(q + (row_base + r) * D + hl * 8);
    }
    if constexpr (I8C) {
      float f[8];
      unpack8(raw, f);
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
      const float s_q = fmaxf(amax, 1e-12f) * (1.0f / 127.0f);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int v = __float2int_rn(__fdiv_rn(f[i], s_q));
        w[i / 4] |= (static_cast<uint32_t>(v) & 0xFFu) << (8 * (i % 4));
      }
      qi[ri] = make_int2(static_cast<int>(w[0]), static_cast<int>(w[1]));
      qsc[ri] = s_q * c_log2;
    } else {
      unpack8(raw, qf[ri]);
    }
  }
  float m_run[RB], l_run[RB], acc[RB][8];
#pragma unroll
  for (int ri = 0; ri < RB; ++ri) {
    m_run[ri] = -INFINITY;
    l_run[ri] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[ri][i] = 0.f;
  }

  const int* pt = page_tables + (long long)b * pages_per_seq;
  // Stored rows of a page: int4 packs two tokens per row.
  const int rows = STORE == INT4 ? page_size / 2 : page_size;
  const long long head_rows = (long long)hk * num_pages * rows;
  const int elem_bytes = STORE == DENSE ? 2 : 1;
  const uint8_t* kb = static_cast<const uint8_t*>(k_pages);
  const uint8_t* vb = static_cast<const uint8_t*>(v_pages);

  // Warp w covers tokens [c0, c0 + 2U): half 0 the first U, half 1 the next.
  // Both halves run the same iterations, so the shuffles below never diverge.
  for (int c0 = start + warp * 2 * U; c0 < len; c0 += NWARPS * 2 * U) {
    uint4 kr[U], vr[U];
    bool valid[U], hi[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tok = c0 + half * U + u;
      valid[u] = tok < len;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      ksc[u] = vsc[u] = 1.f;
      hi[u] = false;
      if (valid[u]) {
        const int page = pt[tok / page_size];
        const int slot = tok % page_size;
        hi[u] = STORE == INT4 && slot >= rows;
        const long long off =
            ((head_rows + (long long)page * rows + (hi[u] ? slot - rows : slot)) * D + hl * 8) *
            elem_bytes;
        if constexpr (STORE == DENSE) {
          kr[u] = *reinterpret_cast<const uint4*>(kb + off);
          vr[u] = *reinterpret_cast<const uint4*>(vb + off);
        } else {
          const uint2 k2 = *reinterpret_cast<const uint2*>(kb + off);
          const uint2 v2 = *reinterpret_cast<const uint2*>(vb + off);
          kr[u] = make_uint4(k2.x, k2.y, 0, 0);
          vr[u] = make_uint4(v2.x, v2.y, 0, 0);
          ksc[u] = k_scales[(long long)hk * num_pages + page];
          vsc[u] = v_scales[(long long)hk * num_pages + page];
        }
      }
    }
    float sc[RB][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tok = c0 + half * U + u;
      float kf[8];
      if constexpr (!I8C) unpack_row<STORE>(kr[u], hi[u], kf);
#pragma unroll
      for (int ri = 0; ri < RB; ++ri) {
        float x;
        if constexpr (I8C) {
          int dot = __dp4a(static_cast<int>(kr[u].x), qi[ri].x, 0);
          dot = half_sum(__dp4a(static_cast<int>(kr[u].y), qi[ri].y, dot));
          x = static_cast<float>(dot) * qsc[ri] * ksc[u];  // log2 domain
          if (softcap > 0.f) x = tanhf(x / cap_log2) * cap_log2;
        } else {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) dot = fmaf(qf[ri][i], kf[i], dot);
          dot = half_sum(dot) * ksc[u];
          x = softcap > 0.f ? tanhf(dot * scale / softcap) * cap_log2 : dot * c_log2;
        }
        sc[ri][u] = valid[u] && tok < lim[ri] && tok >= lim[ri] - win ? x : -INFINITY;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!valid[u]) continue;
      float vf[8];
      unpack_row<STORE>(vr[u], hi[u], vf);
      const float vs = I8C ? vsc[u] * (1.0f / 127.0f) : vsc[u];
#pragma unroll
      for (int ri = 0; ri < RB; ++ri) {
        // Rescale row ri to this batch's max once, at its first token.
        if (u == 0) {
          float mx = sc[ri][0];
#pragma unroll
          for (int w = 1; w < U; ++w) mx = fmaxf(mx, sc[ri][w]);
          const float m_new = fmaxf(m_run[ri], mx);
          if (m_new != -INFINITY) {
            const float alpha = exp2f(m_run[ri] - m_new);
            m_run[ri] = m_new;
            l_run[ri] *= alpha;
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[ri][i] *= alpha;
          }
        }
        if (sc[ri][u] == -INFINITY) continue;
        const float pe = exp2f(sc[ri][u] - m_run[ri]);
        l_run[ri] += pe;
        if constexpr (I8C) {
          const float p8 = rintf(pe * 127.f);  // exact integer 0..127
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[ri][i] = fmaf(p8 * vf[i], vs, acc[ri][i]);
        } else {
          const float pv = pe * vs;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[ri][i] = fmaf(pv, vf[i], acc[ri][i]);
        }
      }
    }
  }

  // Merge the two halves of the warp, then the warps through shared memory.
#pragma unroll
  for (int ri = 0; ri < RB; ++ri) {
    const float m_o = __shfl_xor_sync(FULL, m_run[ri], 16);
    const float l_o = __shfl_xor_sync(FULL, l_run[ri], 16);
    const float m_tot = fmaxf(m_run[ri], m_o);
    const float a = m_tot == -INFINITY ? 0.f : exp2f(m_run[ri] - m_tot);
    const float ao = m_tot == -INFINITY ? 0.f : exp2f(m_o - m_tot);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float acc_o = __shfl_xor_sync(FULL, acc[ri][i], 16);
      acc[ri][i] = acc[ri][i] * a + acc_o * ao;
    }
    if (lane == 0) {
      sm_m[warp][ri] = m_tot;
      sm_l[warp][ri] = l_run[ri] * a + l_o * ao;
    }
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) sm_acc[warp][ri][hl * 8 + i] = acc[ri][i];
    }
  }
  __syncthreads();

  for (int idx = tid; idx < RB * D; idx += NTHREADS) {
    const int ri = idx / D, col = idx % D;
    if (r0 + ri >= rows_total) continue;
    float m_tot = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m_tot = fmaxf(m_tot, sm_m[w][ri]);
    float l = 0.f, o = 0.f;
    if (m_tot != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float wt = exp2f(sm_m[w][ri] - m_tot);
        l += sm_l[w][ri] * wt;
        o += sm_acc[w][ri][col] * wt;
      }
    }
    out[(row_base + r0 + ri) * D + col] = __float2bfloat16(l > 0.f ? o / l : 0.f);
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *lengths, *pt;
  void* out;
  int batch, kv_heads, num_pages, page_size, pages_per_seq, q_tokens, rows;
  float scale, softcap;
  int window;
  cudaStream_t stream;
};

template <int RB, int MODE>
int launch(const Args& a) {
  dim3 grid(a.batch, a.kv_heads, (a.rows + RB - 1) / RB);
  paged_decode_kernel<RB, MODE><<<grid, NTHREADS, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), a.kp, a.vp, static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.lengths),
      static_cast<const int*>(a.pt), static_cast<bf16*>(a.out), a.kv_heads,
      a.num_pages, a.page_size, a.pages_per_seq, a.q_tokens, a.rows, a.scale,
      a.softcap, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <int RB>
int launch_mode(int mode, const Args& a) {
  switch (mode) {
    case DENSE: return launch<RB, DENSE>(a);
    case INT8: return launch<RB, INT8>(a);
    case FP8: return launch<RB, FP8>(a);
    case INT4: return launch<RB, INT4>(a);
    case INT8C: return launch<RB, INT8C>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (batch, heads, q_tokens, 128) bf16 contiguous (q_tokens 1: (batch,
// heads, 128)); k/v pages (kv_heads, num_pages, rows, 128) contiguous: bf16
// (mode 0), int8 (1, and 4 = int8 compute), fp8 e4m3 (2), or int4 packed
// along tokens (3, rows = page_size / 2); k/v scales (kv_heads, num_pages)
// fp32 (read for modes 1-4); lengths (batch,) int32, the q tokens included;
// page_tables (batch, pages_per_seq) int32, -1 padded; out like q. Any
// heads divisible by kv_heads and any q_tokens >= 1: the (heads / kv_heads)
// x q_tokens rows of a KV head go in blocks of up to 8 rows, one CTA each.
// Returns cudaGetLastError().
int fa_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                    const void* k_scales, const void* v_scales,
                    const void* lengths, const void* page_tables, void* out,
                    int batch, int heads, int kv_heads, int num_pages,
                    int page_size, int pages_per_seq, int q_tokens, float scale,
                    float softcap, int window, int mode, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads || q_tokens < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = heads / kv_heads * q_tokens;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, lengths, page_tables, out,
               batch, kv_heads, num_pages, page_size, pages_per_seq, q_tokens, rows,
               scale, softcap, window, static_cast<cudaStream_t>(stream)};
  if (rows > 4) return launch_mode<8>(mode, a);
  if (rows > 2) return launch_mode<4>(mode, a);
  if (rows > 1) return launch_mode<2>(mode, a);
  return launch_mode<1>(mode, a);
}

}  // extern "C"
