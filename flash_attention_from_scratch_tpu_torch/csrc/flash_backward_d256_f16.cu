// K2 and K3 for fp16 q, k, v, dO at head width 256: flash_backward.cu's
// kernels at d 256 (BACKWARD_HD) with act_t = fp16 (FA_F16, hopper.cuh), as
// a library of its own. Replaces, for fp16 at that width, the TPU kernels
// flash_backward.cu replaces (flash_attention_from_scratch_tpu/ops/
// flash_backward.py _fused_kernel, _dkv_kernel and _dq_kernel); the design is
// described in that file's header.

#define FA_F16 1
#define BACKWARD_HD 256
#include "flash_backward.cu"
