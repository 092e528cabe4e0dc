// Flash-attention forward with a K/V copy ring, for Hopper, bf16, d_head 128.
//
// Replaces the TPU kernel flash_attention_from_scratch_tpu/ops/flash_forward.py
// _fori_kernel (KernelConfig(kv_loop=KVLoop.FORI)): the function of K1
// (csrc/flash_forward.cu) -- softmax(scale * Q K^T) V with an fp32 online
// softmax in the exp2 domain, P cast to bf16 before PV, causal masks with a
// q_offset, a sliding window, a Gemma-2 softcap, per-head attention sinks
// merged at finalisation, GQA and an optional natural-log LSE -- with the
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
// slot once all eight consumer warps have arrived on its empty mbarrier.
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

#include "flash_wgmma.cuh"

namespace {

// The launch geometry of ring depth NB (ops/flash_forward.py::fori_plan
// mirrors it).
template <int NB>
struct ForiTile {
  static constexpr int BK = NB == 4 ? 64 : 128;    // keys per slot
  static constexpr int Q_BYTES = bf16_tile_bytes(BQ);
  static constexpr int SLOT = 2 * bf16_tile_bytes(BK);  // the K tile, then the V tile
  static constexpr int SMEM = Q_BYTES + NB * SLOT + ALIGN_SLACK;
  static_assert(SMEM <= SMEM_LIMIT, "the ring does not fit a CTA's shared memory");
};

struct Params {
  bf16* o;
  float* lse;          // (batch, heads, seq_q) or null
  const float* sinks;  // (heads,) or null
  long long o_sb, o_sh, o_ss;  // element strides; d is contiguous
  int heads, group, seq_q, seq_kv;
  int causal, q_offset, window;
  float scale, softcap;
};

template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
flash_forward_fori_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using T = ForiTile<NB>;
  constexpr int BK = T::BK;
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
      mbar_init(&empty[s], CONSUMER_ARRIVALS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every copy
    if (tid == 0) {
      mbar_arrive_expect_tx(&q_full, T::Q_BYTES);
      tma_load_4d(q_s, &tm_q, 0, q0, h, b, &q_full);
      tma_load_4d(q_s + bf16_box_bytes(BQ), &tm_q, BOX_COLS, q0, h, b, &q_full);
      for (int i = 0; i < n; ++i) {
        const int s = i % NB;
        if (i >= NB) mbar_wait(&empty[s], (i / NB - 1) & 1);
        uint8_t* slot = ring + s * T::SLOT;
        const int kv0 = (first + i) * BK;
        mbar_arrive_expect_tx(&full[s], T::SLOT);
        tma_load_4d(slot, &tm_k, 0, kv0, hk, b, &full[s]);
        tma_load_4d(slot + bf16_box_bytes(BK), &tm_k, BOX_COLS, kv0, hk, b, &full[s]);
        uint8_t* vs = slot + bf16_tile_bytes(BK);
        tma_load_4d(vs, &tm_v, 0, kv0, hk, b, &full[s]);
        tma_load_4d(vs + bf16_box_bytes(BK), &tm_v, BOX_COLS, kv0, hk, b, &full[s]);
      }
    }
    return;
  }

  const int cw = wg - 1;  // consumer warpgroup 0 or 1
  const int r0 = q0 + cw * WG_ROWS;
  const RowGroup rg{p.q_offset + r0, min(max(p.seq_q - r0, 0), WG_ROWS)};
  RowState st;
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

template <int NB>
int launch(const CUtensorMap& tm_q, const void* k, const void* v, const Params& p,
           int batch, int kv_heads, const long long (&ks)[3], const long long (&vs)[3],
           cudaStream_t stream) {
  using T = ForiTile<NB>;
  CUtensorMap tm_k, tm_v;
  if (!encode_bhsd(&tm_k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, batch, kv_heads, p.seq_kv, D,
                   ks[0] * 2, ks[1] * 2, ks[2] * 2, T::BK, BOX_COLS, true) ||
      !encode_bhsd(&tm_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, batch, kv_heads, p.seq_kv, D,
                   vs[0] * 2, vs[1] * 2, vs[2] * 2, T::BK, BOX_COLS, true))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_forward_fori_kernel<NB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.seq_q + BQ - 1) / BQ, p.heads, batch);
  kernel<<<grid, THREADS, T::SMEM, stream>>>(tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1's interface (fa_flash_forward in flash_forward.cu) plus the ring depth:
// q (b, heads, seq_q, 128), k/v (b, kv_heads, seq_kv, 128), o like q: bf16
// with the given element strides (d contiguous, strides multiples of 8
// elements, base 16-byte aligned). lse is (b, heads, seq_q) fp32
// contiguous or null; sinks (heads,) fp32 or null. seq_q and seq_kv are
// multiples of 64; num_kv_buffers 1..4. Returns cudaGetLastError(), or
// cudaErrorInvalidValue when a tensor map cannot be encoded.
int fa_flash_forward_fori(const void* q, const void* k, const void* v, void* o,
                          void* lse, const void* sinks,
                          long long q_sb, long long q_sh, long long q_ss,
                          long long k_sb, long long k_sh, long long k_ss,
                          long long v_sb, long long v_sh, long long v_ss,
                          long long o_sb, long long o_sh, long long o_ss,
                          int batch, int heads, int kv_heads, int seq_q, int seq_kv,
                          int causal, int q_offset, int window, float scale,
                          float softcap, int num_kv_buffers, void* stream) {
  Params p;
  p.o = static_cast<bf16*>(o);
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
  CUtensorMap tm_q;
  if (!encode_bhsd(&tm_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, batch, heads, seq_q, D,
                   q_sb * 2, q_sh * 2, q_ss * 2, BQ, BOX_COLS, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ks[3] = {k_sb, k_sh, k_ss}, vs[3] = {v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_kv_buffers) {
    case 1: return launch<1>(tm_q, k, v, p, batch, kv_heads, ks, vs, s);
    case 2: return launch<2>(tm_q, k, v, p, batch, kv_heads, ks, vs, s);
    case 3: return launch<3>(tm_q, k, v, p, batch, kv_heads, ks, vs, s);
    case 4: return launch<4>(tm_q, k, v, p, batch, kv_heads, ks, vs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
