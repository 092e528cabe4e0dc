// K11 for fp32 q, k, v at head width 256: flash_forward_fori_f32.cu's
// kernels at d 256 (FORI_HD), as a library of its own, as the bf16 and fp16
// widths are. Replaces, for fp32 at that width, the TPU kernel
// flash_forward_fori_f32.cu replaces
// (flash_attention_from_scratch_tpu/ops/flash_forward.py _fori_kernel); the
// design is described in that file's header and in flash_f32.cuh.

#define FORI_HD 256
#include "flash_forward_fori_f32.cu"
