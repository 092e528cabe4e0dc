// Flash-attention forward with a hand-driven K/V copy ring, for Hopper, bf16,
// d_head 128.
//
// Replaces the TPU kernel flash_attention_from_scratch_tpu/ops/flash_forward.py
// _fori_kernel (KernelConfig(kv_loop=KVLoop.FORI)): the function of K1
// (csrc/flash_forward.cu) -- softmax(scale * Q K^T) V with an fp32 online
// softmax in the exp2 domain, P cast to bf16 before PV, causal masks with a
// q_offset, a sliding window, a Gemma-2 softcap, per-head attention sinks
// merged at finalisation, GQA and an optional natural-log LSE -- but the
// kernel drives its own K/V copies, as the TPU kernel drives its
// make_async_copy DMAs and their semaphores:
//   - a ring of NB slots (NB = num_kv_buffers, 1..4, one instantiation each)
//     in shared memory, each slot one 64-row K tile and one 64-row V tile;
//   - each tile row (256 bytes) is one cp.async.bulk copy into a padded
//     shared row (272 bytes, so ldmatrix reads are free of bank conflicts),
//     issued by one thread each; every copy completes its bytes on the
//     slot's mbarrier, whose expected count thread 0 sets (the DMA
//     semaphore of the TPU kernel);
//   - NB = 1 issues a tile's copies and waits on them before its math (the
//     optimization ladder's synchronous 1_base rung); NB >= 2 keeps NB - 1
//     tiles in flight ahead of the one in use (the TPU kernel issues one
//     ahead at every depth >= 2);
//   - only the visible KV tiles [first, last] are copied: a causal walk ends
//     at the diagonal tile, a window starts it at the first tile any row of
//     the Q tile can see (the TPU kernel's true early exit).
// The math of a tile is K1's, from flash_tile.cuh: one CTA per (64 Q rows, Q
// head, batch), 4 warps of 16 rows, mma.sync m16n8k16 with fp32
// accumulation, P kept in registers.
//
// What bounds it on the H100: as K1, tensor-core operations at prompt lengths
// (989 TFLOP/s bf16), which mma.sync cannot reach. Deeper rings cost shared
// memory: 52 KB (NB 1), 87 KB (NB 2), 122 KB (NB 3), 157 KB (NB 4) per CTA,
// so NB >= 3 leaves one CTA per SM where NB <= 2 fits two.

#include "flash_tile.cuh"

namespace {

constexpr int ROW_BYTES = D * static_cast<int>(sizeof(bf16));

static_assert(NTHREADS == 2 * BK, "one thread issues each K and each V row copy");

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

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transaction count of the current phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Order this thread's earlier shared-memory accesses before later
// async-proxy (bulk copy) writes to the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One bulk copy global -> shared whose bytes complete on `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

template <int NB>
__global__ void __launch_bounds__(NTHREADS)
flash_forward_fori_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[NB];  // one per ring slot
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = q_s + BQ * LDS;  // slot s: K tile, then V tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = q_tile * BQ;
  const int q_min = p.q_offset + q0;  // position of the tile's first row

  const bf16* q_g = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const bf16* k_g = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* v_g = p.v + b * p.v_sb + hk * p.v_sh;

  int first, last;
  kv_tiles(p.causal, p.window, q_min, p.seq_kv, BK, first, last);
  const int n_steps = max(last - first + 1, 0);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NB; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // Step `step` of the walk (KV tile first + step) into its slot, whose
  // rows are the K tile's 64 then the V tile's 64: thread 0 arms the slot's
  // barrier for the tile's bytes, then thread i copies slot row i.
  auto issue = [&](int step) {
    const int slot = step % NB;
    const long long kv = static_cast<long long>(first + step) * BK + (tid & (BK - 1));
    const bf16* src = tid < BK ? k_g + kv * p.k_ss : v_g + kv * p.v_ss;
    fence_proxy_async();
    if (tid == 0) mbar_arrive_expect_tx(&bars[slot], 2 * BK * ROW_BYTES);
    bulk_copy(ring + (slot * 2 * BK + tid) * LDS, src, ROW_BYTES, &bars[slot]);
  };

  // The Q tile through cp.async; the first NB - 1 K/V tiles through the ring.
#pragma unroll
  for (int i = 0; i < (BQ * D / 8) / NTHREADS; ++i) {
    const int c = tid + i * NTHREADS;
    const int r = c >> 4, col = (c & 15) * 8;
    cp_async16(q_s + r * LDS + col, q_g + r * p.q_ss + col);
  }
  cp_async_commit();
  for (int s = 0; s < NB - 1 && s < n_steps; ++s) issue(s);
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[D / 16][4];
  load_q_fragments(qa, q_s, warp, lane);
  RowState st;
  st.init();

  for (int step = 0; step < n_steps; ++step) {
    // The slot this copy fills was last read in step - 1, which every
    // thread finished before the __syncthreads() that ended it.
    if (NB == 1) {
      issue(step);
    } else if (step + NB - 1 < n_steps) {
      issue(step + NB - 1);
    }
    const int slot = step % NB;
    mbar_wait(&bars[slot], (step / NB) & 1);

    const bf16* ks = ring + slot * 2 * BK * LDS;
    attend_tile(st, qa, ks, ks + BK * LDS, warp, lane, (first + step) * BK, p.causal, q_min,
                p.window, p.scale, p.softcap);
    __syncthreads();  // every thread is done with this slot before it is refilled
  }

  // Finalise: sink merge, normalise, write O and LSE.
  store_rows(st, warp, lane, q0, p.o + b * p.o_sb + h * p.o_sh, p.o_ss, 1.f,
             p.sinks ? p.sinks[h] * LOG2E : -INFINITY,
             p.lse ? p.lse + ((long long)b * p.heads + h) * p.seq_q : nullptr);
}

template <int NB>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int smem = (BQ + NB * 2 * BK) * LDS * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_forward_fori_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.seq_q / BQ, p.heads, batch);
  flash_forward_fori_kernel<NB><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1's interface (fa_flash_forward in flash_forward.cu) plus the ring depth:
// q (b, heads, seq_q, 128), k/v (b, kv_heads, seq_kv, 128), o like q: bf16
// with the given element strides (d contiguous, rows 16-byte aligned). lse
// is (b, heads, seq_q) fp32 contiguous or null; sinks (heads,) fp32 or null.
// seq_q and seq_kv are multiples of 64; num_kv_buffers 1..4. Returns
// cudaGetLastError().
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_kv_buffers) {
    case 1: return launch<1>(p, batch, s);
    case 2: return launch<2>(p, batch, s);
    case 3: return launch<3>(p, batch, s);
    case 4: return launch<4>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
