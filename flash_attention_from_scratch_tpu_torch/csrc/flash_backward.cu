// Flash-attention backward (FA2) for Hopper, bf16, d_head 128.
//
// Replaces the TPU kernels of flash_attention_from_scratch_tpu/ops/
// flash_backward.py: _fused_kernel (K2, entry fa_flash_backward_fused) and
// the split pair _dkv_kernel / _dq_kernel (K3, entries fa_flash_backward_dkv
// and fa_flash_backward_dq). Same function: from the saved forward output's
// row statistics (LSE, natural log) and D = rowsum(dO * O), which the caller
// computes, each (Q tile, KV tile) pair recomputes
//   P^T  = exp2(S^T * scale * log2e - lse * log2e)   (S^T = K Q^T, fp32)
//   dP^T = V dO^T
//   dS^T = P^T * (dP^T - D) * [1 - tanh^2] * scale    (softcap slope)
// and accumulates dV += P^T dO, dK += dS^T Q, dQ += dS K, with P and dS*scale
// rounded to bf16 before their products, as the TPU kernels do. Causal masks
// with a q_offset and a sliding window zero P; tiles no row can see are
// skipped. GQA is summed in-kernel: a KV tile's CTA walks every Q head of its
// group. Sinks need nothing here: the forward's LSE already holds their term.
//
// What bounds it on the H100: five tile products per (Q, KV) pair, about 2.5x
// the forward's operations, at the training shapes (2048 rows, 32 heads) far
// above the card's ~295 FLOP/byte balance point, so the bound is tensor-core
// operations (989 TFLOP/s bf16). This first version uses mma.sync m16n8k16
// (not Hopper's full-rate wgmma). Its design:
//   - dK/dV kernel (fused and split): one CTA per (64 KV rows, KV head,
//     batch), 4 warps of 16 KV rows each. The TPU kernel carries whole-
//     sequence dK/dV scratch across a sequential grid; here blocks run in
//     parallel, so each CTA owns one KV tile and keeps its dK and dV in fp32
//     registers (64 + 64 a thread) while it loops over the visible Q tiles of
//     every head of the group. The VMEM limit that picks fused vs split on
//     the TPU has no counterpart.
//   - Work happens in transposed score space, as on the TPU: a warp's S^T
//     fragments are re-packed in registers as the A operand of P^T dO and
//     dS^T Q, so P never leaves registers; Q, dO and K feed the B operands
//     through ldmatrix(.trans) from shared memory.
//   - Fused dQ: dS^T goes to shared memory, each warp reads back 16 Q rows of
//     dS (ldmatrix.trans) and multiplies them by the K tile, and the partial
//     dQ goes by fp32 atomicAdd into a zeroed (b, h, s_q, d) workspace. That
//     replaces the TPU kernel's sequential-grid dQ scratch. The order of the
//     additions changes from run to run, so dQ is not bitwise reproducible.
//   - Split dQ (K3): one CTA per (64 Q rows, Q head, batch) walks the visible
//     KV tiles and sums dQ in registers: deterministic, at the cost of
//     recomputing S and dP a second time.
//   - Shared-memory rows are padded (272 and 144 bytes) so ldmatrix reads are
//     free of bank conflicts; the tiles walked in the inner loop (Q/dO/LSE/D,
//     or K/V) are double-buffered with cp.async.
// A wgmma + TMA version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;        // head width
constexpr int BQ = 64;        // Q rows per tile
constexpr int BK = 64;        // KV rows per tile
constexpr int NWARPS = 4;     // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;    // padded row of a Q/dO/K/V tile, in elements
constexpr int LDT = BQ + 8;   // padded row of the dS^T tile (KV rows x Q cols)
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;   // (batch, heads, seq_q), natural log
  const float* dsum;  // (batch, heads, seq_q), D = rowsum(dO * O)
  float* dq_acc;      // fused: (batch, heads, seq_q, D) fp32, zeroed
  bf16* dq;           // split dQ kernel: (batch, heads, seq_q, D)
  bf16* dk;           // (batch, kv_heads, seq_kv, D)
  bf16* dv;
  long long q_sb, q_sh, q_ss;  // input strides in elements; d is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;  // of dO
  int heads, kv_heads, group, seq_q, seq_kv;
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

// The A fragment of k-step kk from accumulator fragments x[n][4] of a 16-row
// warp tile (n = 8-column block): columns 16kk..16kk+15 as bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (*x)[4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
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

// 16 Q or KV rows x 64 columns of a warp: acc[n] += A(16 x 128) B^T, with A
// the warp's rows of tile a (row-major, padded) and B the 64 rows of tile b.
__device__ __forceinline__ void rows_times_tile_t(float (&acc)[8][4], const bf16* a,
                                                  const bf16* b, int row0, int lane) {
  const int m = lane >> 3;
  const bf16* ab = a + (row0 + (m & 1) * 8 + (lane & 7)) * LDS + (m >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; kk += 2) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, ab + kk * 16);
    ldmatrix_x4(a1, ab + (kk + 1) * 16);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (n * 8 + (lane & 7)) * LDS + (lane >> 3) * 8 + kk * 16);
      mma_bf16(acc[n], a0, bf[0], bf[1]);
      mma_bf16(acc[n], a1, bf[2], bf[3]);
    }
  }
}

// acc[n] (16 x 128) += A (16 x 64, A fragments a[kk]) * tile (64 x 128):
// the tile's rows are the contraction axis (ldmatrix.trans).
__device__ __forceinline__ void frag_times_tile(float (&acc)[D / 8][4],
                                                const uint32_t (&a)[4],
                                                const bf16* tile, int kk, int lane) {
  const int m = lane >> 3;
  const bf16* tb = tile + (kk * 16 + (m & 1) * 8 + (lane & 7)) * LDS + (m >> 1) * 8;
#pragma unroll
  for (int n = 0; n < D / 8; n += 2) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, tb + n * 8);
    mma_bf16(acc[n], a, bf[0], bf[1]);
    mma_bf16(acc[n + 1], a, bf[2], bf[3]);
  }
}

__device__ __forceinline__ bool keep(const Params& p, int qpos, int kpos) {
  return kpos <= qpos && (!p.window || qpos - kpos < p.window);
}

// Does any (q, kv) pair of Q rows [q_min, q_min + BQ) x KV rows [kv0, kv0 + BK)
// fall outside the mask? (Tiles with none skip the mask arithmetic.)
__device__ __forceinline__ bool edge_tile(const Params& p, int q_min, int kv0) {
  const int q_max = q_min + BQ - 1;
  return p.causal && (kv0 + BK - 1 > q_min || (p.window && kv0 <= q_max - p.window));
}

// P (or P^T) and dS * scale (or dS^T) of one score element, in place:
// x holds the raw score on entry and P on exit, dp holds dP and then dS*scale.
__device__ __forceinline__ void grad_element(const Params& p, float& x, float& dp,
                                             float lse2, float dsum, bool visible) {
  float pe, slope = 1.f;
  if (p.softcap > 0.f) {
    const float th = tanhf(x * p.scale / p.softcap);
    slope = 1.f - th * th;
    pe = exp2f(th * (p.softcap * LOG2E) - lse2);
  } else {
    pe = exp2f(x * (p.scale * LOG2E) - lse2);
  }
  if (!visible) pe = 0.f;
  x = pe;
  dp = pe * (dp - dsum) * slope * p.scale;
}

// dK/dV for one (KV tile, KV head, batch); with kDQ also the dQ partials.
template <bool kDQ>
__global__ void __launch_bounds__(NTHREADS)
flash_backward_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BK * LDS;
  bf16* q_s = v_s + BK * LDS;        // 2 stages
  bf16* do_s = q_s + 2 * BQ * LDS;   // 2 stages
  bf16* ds_s = do_s + 2 * BQ * LDS;  // dS^T, BK x LDT (fused only)
  float* lse_s = reinterpret_cast<float*>(ds_s + BK * LDT);  // 2 stages
  float* dsum_s = lse_s + 2 * BQ;                             // 2 stages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  // The tile index is the slowest grid axis, so blocks start in tile order:
  // low KV tiles see the most causal rows and start first.
  const int kv0 = blockIdx.z * BK;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int kvw = warp * 16;        // this warp's KV rows within the tile

  // Visible Q tiles [qf, ql]: causal rows from the diagonal on, clipped by
  // the window (the TPU kernel's _block_visible).
  int qf = 0, ql = p.seq_q / BQ - 1;
  if (p.causal) {
    const int lo = kv0 - p.q_offset - (BQ - 1);
    if (lo > 0) qf = (lo + BQ - 1) / BQ;
    if (p.window) {
      const int hi = kv0 + BK - 2 + p.window - p.q_offset;
      ql = hi < 0 ? -1 : min(ql, hi / BQ);
    }
  }
  const int nq = ql >= qf ? ql - qf + 1 : 0;
  const int n_iter = nq * p.group;  // (head of the group, Q tile) pairs

  auto load_pair = [&](int it, int stage) {
    const int h = hk * p.group + it / nq;
    const int q0 = (qf + it % nq) * BQ;
    load_tile(q_s + stage * BQ * LDS, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss,
              p.q_ss, tid);
    load_tile(do_s + stage * BQ * LDS,
              p.dout + b * p.o_sb + h * p.o_sh + q0 * p.o_ss, p.o_ss, tid);
    const long long row = ((long long)b * p.heads + h) * p.seq_q + q0;
    if (tid < BQ / 4) {
      cp_async16(lse_s + stage * BQ + tid * 4, p.lse + row + tid * 4);
    } else if (tid < BQ / 2) {
      const int c = (tid - BQ / 4) * 4;
      cp_async16(dsum_s + stage * BQ + c, p.dsum + row + c);
    }
  };

  load_tile(k_s, p.k + b * p.k_sb + hk * p.k_sh + kv0 * p.k_ss, p.k_ss, tid);
  load_tile(v_s, p.v + b * p.v_sb + hk * p.v_sh + kv0 * p.v_ss, p.v_ss, tid);
  if (n_iter > 0) load_pair(0, 0);
  cp_async_commit();

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) load_pair(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this pair's tiles have landed; the next may be in flight
    __syncthreads();

    const int h = hk * p.group + it / nq;
    const int q0 = (qf + it % nq) * BQ;
    const bf16* qs = q_s + stage * BQ * LDS;
    const bf16* dos = do_s + stage * BQ * LDS;
    const float* lse_t = lse_s + stage * BQ;
    const float* dsum_t = dsum_s + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 KV rows x 64 Q columns.
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    rows_times_tile_t(st, k_s, qs, kvw, lane);
    rows_times_tile_t(dpt, v_s, dos, kvw, lane);

    // P^T and dS^T * scale; element e sits at KV row g + (e >> 1) * 8 and
    // Q column n * 8 + 2t + (e & 1).
    const int q_min = p.q_offset + q0;
    const bool edge = edge_tile(p, q_min, kv0);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const bool vis = !edge || keep(p, q_min + col, kv0 + kvw + g + (e >> 1) * 8);
        grad_element(p, st[n][e], dpt[n][e], lse_t[col] * LOG2E, dsum_t[col], vis);
      }
    }

    // dV += P^T dO and dK += dS^T Q, contracting the 64 Q rows.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pack_a(pa, st, kk);
      pack_a(da, dpt, kk);
      frag_times_tile(dv_acc, pa, dos, kk, lane);
      frag_times_tile(dk_acc, da, qs, kk, lane);
    }

    if (kDQ) {
      // dS^T to shared memory, then each warp takes 16 Q rows of dS.
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<uint32_t*>(ds_s + (kvw + g + r * 8) * LDT + n * 8 + 2 * t) =
              pack_bf16(dpt[n][2 * r], dpt[n][2 * r + 1]);
        }
      }
      __syncthreads();
      const int qw = warp * 16, m = lane >> 3;
      float* dq_g = p.dq_acc + (((long long)b * p.heads + h) * p.seq_q + q0 + qw) * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float acc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t a[4];  // dS rows qw.., KV columns 16kk..: dS^T read transposed
          ldmatrix_x4_trans(a, ds_s + (kk * 16 + (m >> 1) * 8 + (lane & 7)) * LDT
                                   + qw + (m & 1) * 8);
          const bf16* kb = k_s + (kk * 16 + (m & 1) * 8 + (lane & 7)) * LDS
                           + (m >> 1) * 8 + half * (D / 2);
#pragma unroll
          for (int n = 0; n < 8; n += 2) {
            uint32_t kf[4];
            ldmatrix_x4_trans(kf, kb + n * 8);
            mma_bf16(acc[n], a, kf[0], kf[1]);
            mma_bf16(acc[n + 1], a, kf[2], kf[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float* dst = dq_g + (g + r * 8) * D + half * (D / 2) + n * 8 + 2 * t;
            atomicAdd(dst, acc[n][2 * r]);
            atomicAdd(dst + 1, acc[n][2 * r + 1]);
          }
        }
      }
    }
    __syncthreads();  // this stage (and the dS^T tile) is refilled next
  }
  cp_async_wait<0>();

  // dK and dV of this warp's 16 KV rows, cast to bf16.
  const long long out_row = ((long long)b * p.kv_heads + hk) * p.seq_kv + kv0 + kvw;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* dk_row = p.dk + (out_row + g + r * 8) * D;
    bf16* dv_row = p.dv + (out_row + g + r * 8) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk_row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// dQ for one (Q tile, Q head, batch), summed in registers over the KV tiles.
__global__ void __launch_bounds__(NTHREADS)
flash_backward_dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BQ * LDS;
  bf16* k_s = do_s + BQ * LDS;     // 2 stages
  bf16* v_s = k_s + 2 * BK * LDS;  // 2 stages

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_tile = gridDim.z - 1 - blockIdx.z;  // heaviest causal tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / p.group;
  const int q0 = q_tile * BQ, qw = warp * 16;

  const bf16* k_g = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* v_g = p.v + b * p.v_sb + hk * p.v_sh;

  // Visible KV tiles [first, last], as in the forward kernel.
  const int q_min = p.q_offset + q0;
  int first = 0, last = p.seq_kv / BK - 1;
  if (p.causal) {
    last = min(last, (q_min + BQ - 1) / BK);
    if (p.window) first = max(0, q_min - p.window + 1) / BK;
  }

  load_tile(q_s, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss, p.q_ss, tid);
  load_tile(do_s, p.dout + b * p.o_sb + h * p.o_sh + q0 * p.o_ss, p.o_ss, tid);
  if (first <= last) {
    load_tile(k_s, k_g + (long long)first * BK * p.k_ss, p.k_ss, tid);
    load_tile(v_s, v_g + (long long)first * BK * p.v_ss, p.v_ss, tid);
  }
  cp_async_commit();

  // Row statistics of this thread's rows g and g + 8.
  const long long row = ((long long)b * p.heads + h) * p.seq_q + q0 + qw + g;
  const float lse2[2] = {p.lse[row] * LOG2E, p.lse[row + 8] * LOG2E};
  const float dsum[2] = {p.dsum[row], p.dsum[row + 8]};
  const int row0 = q_min + qw + g;  // global position of row g

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int j = first; j <= last; ++j) {
    const int stage = (j - first) & 1;
    if (j + 1 <= last) {
      const int nxt = stage ^ 1;
      load_tile(k_s + nxt * BK * LDS, k_g + (long long)(j + 1) * BK * p.k_ss, p.k_ss, tid);
      load_tile(v_s + nxt * BK * LDS, v_g + (long long)(j + 1) * BK * p.v_ss, p.v_ss, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* ks = k_s + stage * BK * LDS;
    const bf16* vs = v_s + stage * BK * LDS;

    // S = Q K^T and dP = dO V^T: this warp's 16 Q rows x 64 keys.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    rows_times_tile_t(s, q_s, ks, qw, lane);
    rows_times_tile_t(dp, do_s, vs, qw, lane);

    const int kv0 = j * BK;
    const bool edge = edge_tile(p, q_min, kv0);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool vis = !edge || keep(p, row0 + r * 8, kv0 + n * 8 + 2 * t + (e & 1));
        grad_element(p, s[n][e], dp[n][e], lse2[r], dsum[r], vis);
      }
    }

    // dQ += dS K, contracting the 64 keys.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      pack_a(da, dp, kk);
      frag_times_tile(dq_acc, da, ks, kk, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* dq_row = p.dq + (row + r * 8) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dq_row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dq_acc[n][2 * r], dq_acc[n][2 * r + 1]);
    }
  }
}

constexpr int DKV_SMEM = (2 * BK + 4 * BQ) * LDS * static_cast<int>(sizeof(bf16)) +
                         BK * LDT * static_cast<int>(sizeof(bf16)) +
                         4 * BQ * static_cast<int>(sizeof(float));
constexpr int DQ_SMEM = (2 * BQ + 4 * BK) * LDS * static_cast<int>(sizeof(bf16));

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dsum, void* dq, void* dk, void* dv,
                   const long long* s, int heads, int kv_heads, int seq_q,
                   int seq_kv, int causal, int q_offset, int window, float scale,
                   float softcap) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dsum = static_cast<const float*>(dsum);
  p.dq_acc = static_cast<float*>(dq);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_sb = s[0]; p.q_sh = s[1]; p.q_ss = s[2];
  p.k_sb = s[3]; p.k_sh = s[4]; p.k_ss = s[5];
  p.v_sb = s[6]; p.v_sh = s[7]; p.v_ss = s[8];
  p.o_sb = s[9]; p.o_sh = s[10]; p.o_ss = s[11];
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.group = heads / kv_heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.causal = causal;
  p.q_offset = q_offset;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  return p;
}

template <bool kDQ>
int launch_dkv(const Params& p, int batch, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_backward_dkv_kernel<kDQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DKV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.kv_heads, batch, p.seq_kv / BK);
  flash_backward_dkv_kernel<kDQ>
      <<<grid, NTHREADS, DKV_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Common arguments of the three entry points. q, dout (b, heads, seq_q, 128)
// and k, v (b, kv_heads, seq_kv, 128) are bf16 with the given element strides
// (d contiguous, rows 16-byte aligned); lse and dsum are (b, heads, seq_q)
// fp32 contiguous. Outputs are contiguous. seq_q and seq_kv are multiples of
// 64. Each returns cudaGetLastError() after its launch.
#define FA_BWD_ARGS                                                              \
  const void *q, const void *k, const void *v, const void *dout,                 \
      const void *lse, const void *dsum, void *dq, void *dk, void *dv,          \
      long long q_sb, long long q_sh, long long q_ss, long long k_sb,            \
      long long k_sh, long long k_ss, long long v_sb, long long v_sh,            \
      long long v_ss, long long o_sb, long long o_sh, long long o_ss, int batch, \
      int heads, int kv_heads, int seq_q, int seq_kv, int causal, int q_offset,  \
      int window, float scale, float softcap, void *stream

#define FA_BWD_PARAMS                                                            \
  const long long s[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,                   \
                           v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};                  \
  const Params p = make_params(q, k, v, dout, lse, dsum, dq, dk, dv, s, heads,   \
                               kv_heads, seq_q, seq_kv, causal, q_offset,       \
                               window, scale, softcap)

// K2: dK, dV (bf16) and dQ added into dq, a zeroed fp32 workspace.
int fa_flash_backward_fused(FA_BWD_ARGS) {
  FA_BWD_PARAMS;
  return launch_dkv<true>(p, batch, stream);
}

// K3, first half: dK and dV only (dq is unused).
int fa_flash_backward_dkv(FA_BWD_ARGS) {
  FA_BWD_PARAMS;
  return launch_dkv<false>(p, batch, stream);
}

// K3, second half: dQ (bf16) into dq (dk and dv are unused).
int fa_flash_backward_dq(FA_BWD_ARGS) {
  FA_BWD_PARAMS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_backward_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(heads, batch, seq_q / BQ);
  flash_backward_dq_kernel<<<grid, NTHREADS, DQ_SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
