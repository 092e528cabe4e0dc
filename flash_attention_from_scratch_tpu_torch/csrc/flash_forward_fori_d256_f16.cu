// K11 for fp16 q, k, v at head width 256: flash_forward_fori.cu's kernels
// at d 256 (FORI_HD) with act_t = fp16 (FA_F16, hopper.cuh), as a library
// of its own. Replaces, for fp16 at that width, the TPU kernel
// flash_forward_fori.cu replaces
// (flash_attention_from_scratch_tpu/ops/flash_forward.py _fori_kernel); the
// design is described in that file's header.

#define FA_F16 1
#define FORI_HD 256
#include "flash_forward_fori.cu"
