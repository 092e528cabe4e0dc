// K2 and K3 for fp16 q, k, v, dO: flash_backward.cu's kernels with act_t =
// fp16 (FA_F16, hopper.cuh: fp16 tensor maps and wgmma, P^T and dS^T * scale
// rounded to fp16 before their products, dQ, dK and dV stored as fp16), as a
// library of its own, so that the bf16 library is compiled as it was.
// Replaces, for fp16, the TPU kernels flash_backward.cu replaces
// (flash_attention_from_scratch_tpu/ops/flash_backward.py _fused_kernel,
// _dkv_kernel and _dq_kernel); the design is described in that file's header.

#define FA_F16 1
#include "flash_backward.cu"
