// Flash-attention forward with a K/V copy ring for Hopper in fp32, d_head
// 128 (256: flash_forward_fori_d256_f32.cu, this source at FORI_HD 256, a
// library of its own): K11 for fp32 q, k, v on the fp32 main loop of
// flash_f32.cuh (exact products by 3xTF32 on mma.sync, P kept in fp32).
//
// Replaces, for fp32, the TPU kernel
// flash_attention_from_scratch_tpu/ops/flash_forward.py _fori_kernel
// (KernelConfig(kv_loop=KVLoop.FORI), products at Precision.HIGHEST): K1's
// function with the K/V copies driven through a ring of num_kv_buffers
// slots (1-4, a template parameter of the main loop, as K1's fp32 ring
// depth is), each slot waited on and released in order, and only the
// visible tiles copied (the TPU kernel's causal early exit). The C entry is
// flash_forward_fori.cu's.
//
// What bounds it: the products at 165 TFLOP/s (495 TFLOP/s of dense TF32,
// three products each). A CTA is 4 consumer warps (64 Q rows) and the
// producer warp; a slot holds 32 keys at d 128 and 16 at d 256, so that
// every depth fits a block: 65, 97, 129 and 161 KB of shared memory at d
// 128, 97, 129, 161 and 193 KB at d 256. ops/flash_forward.py::fori_plan
// mirrors it (FORI_TILES_F32).

#include "flash_f32.cuh"

// The head width this library is built for: 128 here, 256 in
// flash_forward_fori_d256_f32.cu, which defines it and includes this file.
#ifndef FORI_HD
#define FORI_HD 128
#endif

namespace {

constexpr int FORI_WARPS = 4;                     // consumer warps of 16 Q rows
constexpr int FORI_BK = FORI_HD == 128 ? 32 : 16;  // keys per slot

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// flash_forward_fori.cu's fa_flash_forward_fori for fp32: q (b, heads,
// seq_q, d_head), k/v (b, kv_heads, seq_kv, d_head), o like q, d_head
// FORI_HD, fp32 with the given element strides (d contiguous, strides
// multiples of 4 elements, base 16-byte aligned). lse is (b, heads, seq_q)
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
  const F32Params p = f32_params(o, lse, sinks, o_sb, o_sh, o_ss, heads, kv_heads, seq_q,
                                 seq_kv, causal, q_offset, window, scale, softcap);
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                  vs[3] = {v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_kv_buffers) {
    case 1: return launch_f32<1, FORI_HD, FORI_WARPS, FORI_BK>(q, k, v, p, batch, kv_heads, qs, ks, vs, s);
    case 2: return launch_f32<2, FORI_HD, FORI_WARPS, FORI_BK>(q, k, v, p, batch, kv_heads, qs, ks, vs, s);
    case 3: return launch_f32<3, FORI_HD, FORI_WARPS, FORI_BK>(q, k, v, p, batch, kv_heads, qs, ks, vs, s);
    case 4: return launch_f32<4, FORI_HD, FORI_WARPS, FORI_BK>(q, k, v, p, batch, kv_heads, qs, ks, vs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
