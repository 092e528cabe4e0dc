// K1 for fp16 q, k, v: flash_forward.cu's kernel with act_t = fp16 (FA_F16,
// hopper.cuh: fp16 tensor maps and wgmma, P rounded to fp16 before P V, O
// stored as fp16), as a library of its own, so that the bf16 library is
// compiled as it was. Replaces, for fp16, the TPU kernel flash_forward.cu
// replaces (flash_attention_from_scratch_tpu/ops/flash_forward.py
// _grid_kernel); the design is described in that file's header.

#define FA_F16 1
#include "flash_forward.cu"
