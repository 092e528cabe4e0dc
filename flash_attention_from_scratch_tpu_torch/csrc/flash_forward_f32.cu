// Flash-attention forward for Hopper in fp32, d_head 128 or 256: K1 for
// fp32 q, k, v, a library of its own on the fp32 main loop of
// flash_f32.cuh (exact products by 3xTF32 on mma.sync, P kept in fp32).
//
// Replaces, for fp32, the TPU kernel
// flash_attention_from_scratch_tpu/ops/flash_forward.py _grid_kernel, which
// runs its products at Precision.HIGHEST in fp32 (_mm_precision) and keeps
// P in fp32 (cast_p_to_dtype): the same function as flash_forward.cu's bf16
// and fp16 kernels, with the same C entry, so the wrapper's arguments are
// one (ops/flash_forward.py::_ARGTYPES).
//
// What bounds it: the products at 165 TFLOP/s (the H100's 495 TFLOP/s of
// dense TF32, three products each; flash_f32.cuh). The design is the simple
// one that meets the fp32 rule: one CTA a (Q tile, head, batch) item, not
// persistent (the ctas argument is accepted and unused), heaviest causal Q
// tiles first, through a ring of 2 slots. mma.sync's latency wants warps:
// the CTA is the most consumer warps that keep 255 registers a thread, 7
// of 16 Q rows (112 rows) at d 128 over 32-key slots (121 KB of shared
// memory), against 4 at d 256 over 16-key slots (129 KB; a warp's 16 x 256
// fp32 O is 128 registers a thread). Timed on an H100 at b 4, s 4,096, 7
// warps ran faster than 4 and than 8 (8 consumer warps get 168 registers
// and spill), and 16-key slots at d 256 faster than 32-key ones.
// ops/flash_forward.py::grid_plan mirrors it (GRID_TILES_F32).

#include "flash_f32.cuh"

namespace {

// The launch geometry per head width (ops/flash_forward.py::GRID_TILES_F32).
template <int HD>
struct GridTileF32 {
  static constexpr int WARPS = HD == 128 ? 7 : 4;  // consumer warps of 16 Q rows
  static constexpr int NB = 2;                     // K/V ring slots
  static constexpr int BK = HD == 128 ? 32 : 16;   // keys per slot
};

template <int HD>
int launch(const void* q, const void* k, const void* v, const F32Params& p, int batch,
           int kv_heads, const long long (&qs)[3], const long long (&ks)[3],
           const long long (&vs)[3], cudaStream_t stream) {
  using T = GridTileF32<HD>;
  return launch_f32<T::NB, HD, T::WARPS, T::BK>(q, k, v, p, batch, kv_heads, qs, ks, vs,
                                                stream);
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// flash_forward.cu's fa_flash_forward_ctas for fp32: q (b, heads, seq_q,
// d_head), k/v (b, kv_heads, seq_kv, d_head), o like q, d_head 128 or 256,
// fp32 with the given element strides (d contiguous, strides multiples of 4
// elements, base 16-byte aligned). lse is (b, heads, seq_q) fp32 contiguous
// or null; sinks (heads,) fp32 or null. seq_q and seq_kv are multiples of
// 64. One CTA per work item whatever `ctas` says. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another head width or
// when a tensor map cannot be encoded.
int fa_flash_forward_ctas(const void* q, const void* k, const void* v, void* o,
                          void* lse, const void* sinks,
                          long long q_sb, long long q_sh, long long q_ss,
                          long long k_sb, long long k_sh, long long k_ss,
                          long long v_sb, long long v_sh, long long v_ss,
                          long long o_sb, long long o_sh, long long o_ss,
                          int batch, int heads, int kv_heads, int seq_q, int seq_kv,
                          int causal, int q_offset, int window, float scale,
                          float softcap, int d_head, int ctas, void* stream) {
  (void)ctas;
  const F32Params p = f32_params(o, lse, sinks, o_sb, o_sh, o_ss, heads, kv_heads, seq_q,
                                 seq_kv, causal, q_offset, window, scale, softcap);
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                  vs[3] = {v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_head == 128) return launch<128>(q, k, v, p, batch, kv_heads, qs, ks, vs, s);
  if (d_head == 256) return launch<256>(q, k, v, p, batch, kv_heads, qs, ks, vs, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
