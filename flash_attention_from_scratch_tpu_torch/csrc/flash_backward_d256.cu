// K2 and K3 at head width 256: flash_backward.cu's kernels instantiated at
// d 256, as a library of their own (why: the note above BACKWARD_HD there).
// Replaces, at that width, the TPU kernels flash_backward.cu replaces
// (flash_attention_from_scratch_tpu/ops/flash_backward.py _fused_kernel,
// _dkv_kernel and _dq_kernel); the design at d 256 is described in that
// file's header.

#define BACKWARD_HD 256
#include "flash_backward.cu"
