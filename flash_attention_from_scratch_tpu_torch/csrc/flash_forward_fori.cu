// Flash-attention forward with a K/V copy ring, for Hopper, bf16 (fp16: the
// libraries flash_forward_fori_f16.cu and flash_forward_fori_d256_f16.cu,
// this source built with FA_F16), d_head 128 or 256.
//
// Replaces the TPU kernel flash_attention_from_scratch_tpu/ops/flash_forward.py
// _fori_kernel (KernelConfig(kv_loop=KVLoop.FORI)): the function of K1
// (csrc/flash_forward.cu) -- softmax(scale * Q K^T) V with an fp32 online
// softmax in the exp2 domain, P cast to the inputs' type (act_t) before PV,
// causal masks with a q_offset, a sliding window, a Gemma-2 softcap,
// per-head attention sinks merged at finalisation, GQA and an optional
// natural-log LSE -- with the
// K/V copies driven by the kernel through a ring of num_kv_buffers slots, as
// the TPU kernel drives its make_async_copy DMAs and their semaphores.
//
// The CTA is flash_wgmma.cuh's: one producer warpgroup and two consumer
// warpgroups of 64 Q rows, 128 Q rows of one (Q head, batch) per CTA,
// heaviest causal tiles first. One producer thread issues every copy as a
// TMA box of 64 bf16 columns (128-byte swizzle) from tensor maps over the
// (b, h, s, d) views, encoded per call from the pointers and strides: the
// Q tile once, then the K and V tiles of each visible KV tile into the
// ring, each slot's bytes completing on its full mbarrier; it refills a
// slot once every consumer warp has arrived on its empty mbarrier.
// At NB = 1 the producer issues a tile only after the consumers have
// released the one before (the ladder's synchronous rung); deeper rings
// keep NB tiles in flight. Only the visible tiles [first, last] are
// copied: a causal walk ends at the diagonal tile and a window starts it at
// the first tile a row of the CTA can see (the TPU kernel's early exit).
// The consumers run the tile math of flash_wgmma.cuh on wgmma.
//
// What bounds it on the H100: tensor-core operations at prompt lengths
// (989 TFLOP/s bf16). Shared memory: the Q tile (32 KB) and NB slots of
// BK keys (K and V: 64 KB at BK 128), so BK is 128 at NB 1-3 (96, 160,
// 224 KB) and 64 at NB 4 (160 KB); one CTA per SM.
//
// Head width 256 (Gemma-2) is the same kernel at HD = 256, built as a
// library of its own (flash_forward_fori_d256.cu; FORI_HD below), so that
// the d-128 kernels compile as they did alone. Its 64 x 256 fp32 O is 128
// registers a consumer thread, which no CTA of more than 8 warps can hold
// beside S and P (they get at most 168), so its CTA is CtaShape<256>: one
// producer and ONE consumer warpgroup (256 threads, up to 255 registers a
// thread) of 64 Q rows, as K1's GridTile<256>. Every d-256 tile has four
// 64-column boxes: the Q tile is 32 KB and a K+V slot of 64 keys 64 KB, so
// depths 1-3 take 64-key slots (97, 161, 225 KB with the slack) and depth
// 4, whose four 64-key slots (288 KB) do not fit, takes 32-key slots (161
// KB), halving its slot as d 128 does at depth 4. S = Q K^T is m64n64 (or
// m64n32 at depth 4), O += P V two m64n128 products a k step over V's
// column halves.

#include "flash_wgmma.cuh"

namespace {

// The launch geometry of ring depth NB at head width HD
// (ops/flash_forward.py::fori_plan mirrors it).
template <int NB, int HD>
struct ForiTile : CtaShape<HD> {
  // Keys per slot: halved at depth 4, and halved again at d 256.
  static constexpr int BK = (NB == 4 ? 64 : 128) / (HD / 128);
  static constexpr int Q_BYTES = bf16_tile_bytes(CtaShape<HD>::BQ, HD);
  static constexpr int SLOT = 2 * bf16_tile_bytes(BK, HD);  // the K tile, then the V tile
  static constexpr int SMEM = Q_BYTES + NB * SLOT + ALIGN_SLACK;
  static_assert(SMEM <= SMEM_LIMIT, "the ring does not fit a CTA's shared memory");
};

struct Params {
  act_t* o;
  float* lse;          // (batch, heads, seq_q) or null
  const float* sinks;  // (heads,) or null
  long long o_sb, o_sh, o_ss;  // element strides; d is contiguous
  int heads, group, seq_q, seq_kv;
  int causal, q_offset, window;
  float scale, softcap;
};

template <int NB, int HD>
__global__ void __launch_bounds__(ForiTile<NB, HD>::THREADS, 1)
flash_forward_fori_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using T = ForiTile<NB, HD>;
  constexpr int BK = T::BK, BQ = T::BQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[NB], empty[NB];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* ring = q_s + T::Q_BYTES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = q_tile * BQ;
  const int q_min = p.q_offset + q0;  // position of the tile's first row
  int first, last;
  cta_tiles(p.causal, p.window, q_min, min(BQ, p.seq_q - q0), p.seq_kv, BK, first, last);
  const int n = max(last - first + 1, 0);

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < NB; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::ARRIVALS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every copy
    if (tid == 0) {
      mbar_arrive_expect_tx(&q_full, T::Q_BYTES);
#pragma unroll
      for (int bx = 0; bx < T::BOXES; ++bx)
        tma_load_4d(q_s + bx * bf16_box_bytes(BQ), &tm_q, bx * BOX_COLS, q0, h, b, &q_full);
      for (int i = 0; i < n; ++i) {
        const int s = i % NB;
        if (i >= NB) mbar_wait(&empty[s], (i / NB - 1) & 1);
        uint8_t* slot = ring + s * T::SLOT;
        const int kv0 = (first + i) * BK;
        mbar_arrive_expect_tx(&full[s], T::SLOT);
        uint8_t* vs = slot + bf16_tile_bytes(BK, HD);
#pragma unroll
        for (int bx = 0; bx < T::BOXES; ++bx)
          tma_load_4d(slot + bx * bf16_box_bytes(BK), &tm_k, bx * BOX_COLS, kv0, hk, b, &full[s]);
#pragma unroll
        for (int bx = 0; bx < T::BOXES; ++bx)
          tma_load_4d(vs + bx * bf16_box_bytes(BK), &tm_v, bx * BOX_COLS, kv0, hk, b, &full[s]);
      }
    }
    return;
  }

  const int cw = wg - 1;  // consumer warpgroup 0 (or 1 at d 128)
  const int r0 = q0 + cw * WG_ROWS;
  const RowGroup rg{p.q_offset + r0, min(max(p.seq_q - r0, 0), WG_ROWS)};
  RowStateT<HD> st;
  st.init();
  mbar_wait(&q_full, 0);
  consume_bf16<BK, NB>(st, rg, full, empty, ring, T::SLOT,
                       smem_addr(q_s) + cw * WG_ROWS * 128, bf16_box_bytes(BQ), first, n,
                       TileMath{p.causal, p.window, p.seq_kv, p.scale, p.softcap});

  // Finalise: sink merge, normalise, write O and LSE.
  const int lane = tid & 31;
  store_rows(st, r0 + ((tid >> 5) & 3) * 16 + (lane >> 2), p.seq_q,
             p.o + b * p.o_sb + h * p.o_sh, p.o_ss, 1.f,
             p.sinks ? p.sinks[h] * LOG2E : -INFINITY,
             p.lse ? p.lse + ((long long)b * p.heads + h) * p.seq_q : nullptr);
}

template <int NB, int HD>
int launch(const void* q, const void* k, const void* v, const Params& p, int batch,
           int kv_heads, const long long (&qs)[3], const long long (&ks)[3],
           const long long (&vs)[3], cudaStream_t stream) {
  using T = ForiTile<NB, HD>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bhsd(&tm_q, ACT_TMAP, q, batch, p.heads, p.seq_q, HD,
                   qs[0] * 2, qs[1] * 2, qs[2] * 2, T::BQ, BOX_COLS, true) ||
      !encode_bhsd(&tm_k, ACT_TMAP, k, batch, kv_heads, p.seq_kv, HD,
                   ks[0] * 2, ks[1] * 2, ks[2] * 2, T::BK, BOX_COLS, true) ||
      !encode_bhsd(&tm_v, ACT_TMAP, v, batch, kv_heads, p.seq_kv, HD,
                   vs[0] * 2, vs[1] * 2, vs[2] * 2, T::BK, BOX_COLS, true))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_forward_fori_kernel<NB, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.seq_q + T::BQ - 1) / T::BQ, p.heads, batch);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The head width this library is built for: 128 here, 256 in
// flash_forward_fori_d256.cu, which defines it and includes this file. Each
// width is a library of its own, so that nvcc optimizes the helpers the two
// share for one width at a time (the d-128 kernels compile as they did
// alone; the backward's d-128 kernel gained registers when both widths
// shared a file: flash_backward.cu).
#ifndef FORI_HD
#define FORI_HD 128
#endif

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1's interface (fa_flash_forward in flash_forward.cu) plus the ring depth:
// q (b, heads, seq_q, d_head), k/v (b, kv_heads, seq_kv, d_head), o like q,
// d_head FORI_HD: act_t with the given element strides (d contiguous, strides
// multiples of 8 elements, base 16-byte aligned). lse is (b, heads, seq_q)
// fp32 contiguous or null; sinks (heads,) fp32 or null. seq_q and seq_kv
// are multiples of 64; num_kv_buffers 1..4. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another head width or depth or when a tensor
// map cannot be encoded.
int fa_flash_forward_fori(const void* q, const void* k, const void* v, void* o,
                          void* lse, const void* sinks,
                          long long q_sb, long long q_sh, long long q_ss,
                          long long k_sb, long long k_sh, long long k_ss,
                          long long v_sb, long long v_sh, long long v_ss,
                          long long o_sb, long long o_sh, long long o_ss,
                          int batch, int heads, int kv_heads, int seq_q, int seq_kv,
                          int causal, int q_offset, int window, float scale,
                          float softcap, int d_head, int num_kv_buffers, void* stream) {
  if (d_head != FORI_HD) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.o = static_cast<act_t*>(o);
  p.lse = static_cast<float*>(lse);
  p.sinks = static_cast<const float*>(sinks);
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
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                  vs[3] = {v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_kv_buffers) {
    case 1: return launch<1, FORI_HD>(q, k, v, p, batch, kv_heads, qs, ks, vs, s);
    case 2: return launch<2, FORI_HD>(q, k, v, p, batch, kv_heads, qs, ks, vs, s);
    case 3: return launch<3, FORI_HD>(q, k, v, p, batch, kv_heads, qs, ks, vs, s);
    case 4: return launch<4, FORI_HD>(q, k, v, p, batch, kv_heads, qs, ks, vs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
