// Flash-attention forward for Hopper, bf16 (fp16: the library
// flash_forward_f16.cu, this source built with FA_F16), d_head 128 or 256:
// K1, persistent, on the wgmma + TMA main loop of flash_wgmma.cuh.
//
// Replaces the TPU kernel flash_attention_from_scratch_tpu/ops/flash_forward.py
// _grid_kernel (and, through the causal early exit below, the row-band
// dispatch ops/causal_decomp.py causal_forward_banded, which only calls that
// kernel once per band). Same function: softmax(scale * Q K^T) V with an fp32
// online softmax in the exp2 domain, P cast to the inputs' type before PV
// (act_t, hopper.cuh: bf16 or fp16, as the JAX kernel's cast_p_to_dtype),
// causal masks with a q_offset, a sliding window, a Gemma-2 softcap,
// per-head attention sinks merged at finalisation, GQA, and an optional
// natural-log LSE. fp16 has bf16's bytes and wgmma shapes and the same
// 989 TFLOP/s peak, so everything below holds for both types.
//
// What bounds it on the H100: at the prompt lengths it serves (256..4096 rows,
// 32 heads) attention is far above the card's ~295 FLOP/byte balance point, so
// the bound is tensor-core operations (989 TFLOP/s bf16). The design:
//   - the CTA, the tile math and the finalisation are flash_wgmma.cuh's: one
//     producer warpgroup, two consumer warpgroups of 64 Q rows (128 Q rows
//     a work item), S = Q K^T and O += P V on wgmma, Q/K/V by TMA from 4-D
//     tensor maps over the (b, h, s, d) views (strided views as they are;
//     rows past seq read as zeros), through a ring of 2 slots of 128 keys
//     (K11's measured best depth; the TPU grid kernel's automatic
//     double-buffered pipeline);
//   - persistent: at most one CTA per SM. The work items are the (Q tile,
//     head, batch) triples, under the causal mask heaviest Q tile first
//     (the last Q tile sees the most keys), heads before batch so that
//     neighbouring items share their GQA K/V; without it (equal items) Q
//     tiles first, so that the CTAs at work share one head's K/V in L2;
//     CTA c of G takes, in round r, item r G + c on even
//     rounds and r G + G - 1 - c on odd ones (a snake, no counter to reset:
//     a CTA's load is at most the largest item plus the mean, as each
//     round's items weigh no more than the last round's);
//   - Q is double-buffered: the producer loads the next item's Q tile and
//     its first K/V tiles while the consumers finish the current item, so one
//     item's epilogue overlaps the next one's loads. The K/V ring runs on
//     through the items (one ring position per tile);
//   - causal walks stop at the diagonal tile and windowed walks start at the
//     first visible tile (cta_tiles), so masked tiles are never loaded;
//   - head width 256 (Gemma-2-2B/9B) is its own instantiation of the same
//     kernel, GridTile<256>: the 64 x 256 fp32 O accumulator is 128
//     registers a thread, which no CTA of more than 8 warps can hold beside
//     S and P (they get at most 168), and a 128-row Q tile and a 128-key
//     slot are 64 KB and 128 KB. So its CTA is one producer warpgroup and
//     ONE consumer warpgroup (256 threads, up to 255 registers a thread) of
//     64 Q rows, with 64-key slots (S = Q K^T on m64n64, O += P V as two
//     m64n128 products a k step over V's column halves), a single Q tile
//     and 3 slots (225 KB of shared memory). The producer loads the next
//     item's Q tile once the consumer has released the current one, while
//     the consumer finalises. Every tile of d 256 has four 64-column boxes.
// ops/flash_forward.py::grid_plan mirrors the launch.

#include <algorithm>

#include "flash_wgmma.cuh"

namespace {

// The launch geometry per head width (ops/flash_forward.py::grid_plan
// mirrors it).
template <int HD>
struct GridTile {
  static_assert(HD == 128 || HD == 256, "K1 takes head widths 128 and 256");
  static constexpr int CONSUMERS = HD == 128 ? 2 : 1;  // consumer warpgroups of 64 Q rows
  static constexpr int NB = HD == 128 ? 2 : 3;         // K/V ring slots
  static constexpr int BK = HD == 128 ? 128 : 64;      // keys per slot
  static constexpr int Q_BUFS = HD == 128 ? 2 : 1;     // Q tiles: the current item's (and the next)
  static constexpr int BQ = CONSUMERS * WG_ROWS;       // Q rows of a work item
  static constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
  static constexpr int ARRIVALS = CONSUMERS * 4;       // one per consumer warp
  static constexpr int BOXES = HD / BOX_COLS;          // 64-column boxes of a tile
  static constexpr int Q_BYTES = bf16_tile_bytes(BQ, HD);
  static constexpr int SLOT = 2 * bf16_tile_bytes(BK, HD);  // the K tile, then the V tile
  static constexpr int SMEM = Q_BUFS * Q_BYTES + NB * SLOT + ALIGN_SLACK;
  static_assert(SMEM <= SMEM_LIMIT, "the ring does not fit a CTA's shared memory");
};

struct Params {
  act_t* o;
  float* lse;          // (batch, heads, seq_q) or null
  const float* sinks;  // (heads,) or null
  long long o_sb, o_sh, o_ss;  // element strides; d is contiguous
  int batch, heads, group, seq_q, seq_kv;
  int causal, q_offset, window;
  float scale, softcap;
  int q_tiles, items;  // Q tiles of BQ rows; q_tiles * heads * batch items
};

// Work item w. Causal: Q tile (heaviest first), then head, then batch.
// Otherwise every item weighs the same, and items run Q tile first, then
// head, then batch, so that the CTAs at work share their K/V in L2 (the
// causal order runs one Q tile of every (batch, head) at once).
struct Item {
  int q_tile, h, b;
};

__device__ __forceinline__ Item item_at(const Params& p, int w) {
  if (!p.causal) {
    const int hb = w / p.q_tiles;
    return Item{w - hb * p.q_tiles, hb % p.heads, hb / p.heads};
  }
  const int per_tile = p.heads * p.batch;
  const int r = w / per_tile, hb = w - r * per_tile;
  return Item{p.q_tiles - 1 - r, hb % p.heads, hb / p.heads};
}

// The item CTA c of G takes in round k (>= p.items: none).
__device__ __forceinline__ int item_index(int k, int c, int G) {
  return k * G + ((k & 1) ? G - 1 - c : c);
}

// An item's visible KV tiles (bk keys each): n of them from `first`.
__device__ __forceinline__ void item_tiles(const Params& p, const Item& it, int bq, int bk,
                                           int& first, int& n) {
  const int q0 = it.q_tile * bq;
  int last;
  cta_tiles(p.causal, p.window, p.q_offset + q0, min(bq, p.seq_q - q0), p.seq_kv, bk, first,
            last);
  n = max(last - first + 1, 0);
}

template <int HD>
__global__ void __launch_bounds__(GridTile<HD>::THREADS, 1)
flash_forward_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using T = GridTile<HD>;
  constexpr int BK = T::BK, NB = T::NB, QB = T::Q_BUFS, BQ = T::BQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full[QB], q_empty[QB], full[NB], empty[NB];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* ring = q_s + QB * T::Q_BYTES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int c = blockIdx.x, G = gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < QB; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], T::ARRIVALS);
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::ARRIVALS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every copy
    if (tid == 0) {
      int pos = 0;  // ring position of the next K/V tile
      for (int k = 0;; ++k) {
        const int w = item_index(k, c, G);
        if (w >= p.items) break;
        const Item it = item_at(p, w);
        const int hk = it.h / p.group, q0 = it.q_tile * BQ;
        const int qb = k % QB;
        if (k >= QB) mbar_wait(&q_empty[qb], (k / QB - 1) & 1);
        uint8_t* qs = q_s + qb * T::Q_BYTES;
        mbar_arrive_expect_tx(&q_full[qb], T::Q_BYTES);
#pragma unroll
        for (int bx = 0; bx < T::BOXES; ++bx)
          tma_load_4d(qs + bx * bf16_box_bytes(BQ), &tm_q, bx * BOX_COLS, q0, it.h, it.b,
                      &q_full[qb]);
        int first, n;
        item_tiles(p, it, BQ, BK, first, n);
        for (int i = 0; i < n; ++i, ++pos) {
          const int s = pos % NB;
          if (pos >= NB) mbar_wait(&empty[s], (pos / NB - 1) & 1);
          uint8_t* slot = ring + s * T::SLOT;
          const int kv0 = (first + i) * BK;
          mbar_arrive_expect_tx(&full[s], T::SLOT);
          uint8_t* vs = slot + bf16_tile_bytes(BK, HD);
#pragma unroll
          for (int bx = 0; bx < T::BOXES; ++bx)
            tma_load_4d(slot + bx * bf16_box_bytes(BK), &tm_k, bx * BOX_COLS, kv0, hk, it.b,
                        &full[s]);
#pragma unroll
          for (int bx = 0; bx < T::BOXES; ++bx)
            tma_load_4d(vs + bx * bf16_box_bytes(BK), &tm_v, bx * BOX_COLS, kv0, hk, it.b,
                        &full[s]);
        }
      }
    }
    return;
  }

  int pos = 0;  // ring position of the item's first K/V tile
  for (int k = 0;; ++k) {
    const int w = item_index(k, c, G);
    if (w >= p.items) break;
    int first, n;
    const int qb = k % QB;
    {
      const Item it = item_at(p, w);
      item_tiles(p, it, BQ, BK, first, n);
      const int r0 = it.q_tile * BQ + (wg - 1) * WG_ROWS;
      const RowGroup rg{p.q_offset + r0, min(max(p.seq_q - r0, 0), WG_ROWS)};
      RowStateT<HD> st;
      st.init();
      mbar_wait(&q_full[qb], (k / QB) & 1);
      consume_bf16<BK, NB>(st, rg, full, empty, ring, T::SLOT,
                           smem_addr(q_s + qb * T::Q_BYTES) + (wg - 1) * WG_ROWS * 128,
                           bf16_box_bytes(BQ), first, n,
                           TileMath{p.causal, p.window, p.seq_kv, p.scale, p.softcap}, pos);
      // Every product that read this Q tile has completed: release it.
      if ((tid & 31) == 0) mbar_arrive(&q_empty[qb]);

      // Finalise: sink merge, normalise, write O and LSE. The item is
      // decoded again from an opaque copy of k, so that nothing of it stays
      // in a register across the walk (the consumer's registers are full).
      int k2;
      asm volatile("mov.b32 %0, %1;\n" : "=r"(k2) : "r"(k));
      const Item fin = item_at(p, item_index(k2, c, G));
      store_rows(st, fin.q_tile * BQ + (wg - 1) * WG_ROWS + ((tid >> 5) & 3) * 16 +
                         ((tid & 31) >> 2),
                 p.seq_q, p.o + fin.b * p.o_sb + fin.h * p.o_sh, p.o_ss, 1.f,
                 p.sinks ? p.sinks[fin.h] * LOG2E : -INFINITY,
                 p.lse ? p.lse + ((long long)fin.b * p.heads + fin.h) * p.seq_q : nullptr);
    }
    pos += n;
  }
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// The launch at head width HD (ctas as in fa_flash_forward_ctas).
template <int HD>
int launch(Params& p, const void* q, const void* k, const void* v, long long q_sb,
           long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
           long long v_sb, long long v_sh, long long v_ss, int kv_heads, int ctas,
           cudaStream_t stream) {
  using T = GridTile<HD>;
  p.q_tiles = (p.seq_q + T::BQ - 1) / T::BQ;
  const long long items = (long long)p.q_tiles * p.heads * p.batch;
  if (items <= 0 || items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<int>(items);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bhsd(&tm_q, ACT_TMAP, q, p.batch, p.heads, p.seq_q, HD,
                   q_sb * 2, q_sh * 2, q_ss * 2, T::BQ, BOX_COLS, true) ||
      !encode_bhsd(&tm_k, ACT_TMAP, k, p.batch, kv_heads, p.seq_kv, HD,
                   k_sb * 2, k_sh * 2, k_ss * 2, T::BK, BOX_COLS, true) ||
      !encode_bhsd(&tm_v, ACT_TMAP, v, p.batch, kv_heads, p.seq_kv, HD,
                   v_sb * 2, v_sh * 2, v_ss * 2, T::BK, BOX_COLS, true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_forward_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = ctas > 0 ? std::min(ctas, p.items) : p.items;
  flash_forward_kernel<HD><<<grid, T::THREADS, T::SMEM, stream>>>(tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fa_flash_forward with the number of CTAs given: ctas <= 0 launches one CTA
// per work item (a plain grid, the hardware's own schedule), else
// min(ctas, items) persistent CTAs.
int fa_flash_forward_ctas(const void* q, const void* k, const void* v, void* o,
                          void* lse, const void* sinks,
                          long long q_sb, long long q_sh, long long q_ss,
                          long long k_sb, long long k_sh, long long k_ss,
                          long long v_sb, long long v_sh, long long v_ss,
                          long long o_sb, long long o_sh, long long o_ss,
                          int batch, int heads, int kv_heads, int seq_q, int seq_kv,
                          int causal, int q_offset, int window, float scale,
                          float softcap, int d_head, int ctas, void* stream) {
  Params p;
  p.o = static_cast<act_t*>(o);
  p.lse = static_cast<float*>(lse);
  p.sinks = static_cast<const float*>(sinks);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.batch = batch;
  p.heads = heads;
  p.group = heads / kv_heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.causal = causal;
  p.q_offset = q_offset;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_head == 128)
    return launch<128>(p, q, k, v, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                       kv_heads, ctas, s);
  if (d_head == 256)
    return launch<256>(p, q, k, v, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                       kv_heads, ctas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q (b, heads, seq_q, d_head), k/v (b, kv_heads, seq_kv, d_head), o like q,
// d_head 128 or 256: act_t with the given element strides (d contiguous,
// strides multiples of 8 elements, base 16-byte aligned). lse is (b, heads,
// seq_q) fp32 contiguous or null; sinks (heads,) fp32 or null. seq_q and
// seq_kv are multiples of 64. One persistent CTA per SM (fewer when there
// are fewer work items). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another head width or when a tensor map cannot
// be encoded.
int fa_flash_forward(const void* q, const void* k, const void* v, void* o,
                     void* lse, const void* sinks,
                     long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss,
                     long long o_sb, long long o_sh, long long o_ss,
                     int batch, int heads, int kv_heads, int seq_q, int seq_kv,
                     int causal, int q_offset, int window, float scale,
                     float softcap, int d_head, void* stream) {
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  return fa_flash_forward_ctas(q, k, v, o, lse, sinks, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                               v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, batch, heads, kv_heads,
                               seq_q, seq_kv, causal, q_offset, window, scale, softcap, d_head,
                               sms, stream);
}

}  // extern "C"
