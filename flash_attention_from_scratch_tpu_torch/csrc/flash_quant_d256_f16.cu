// K10 in fp16 at head width 256: flash_quant.cu's kernels at d 256
// (QUANT_HD) with act_t = fp16 (FA_F16, hopper.cuh), as a library of its
// own. Replaces, for an fp16 compute type at that width, the TPU kernel
// flash_quant.cu replaces (flash_attention_from_scratch_tpu/ops/
// flash_quant.py _quant_kernel and _attend_i8); the design is described in
// that file's header.

#define FA_F16 1
#define QUANT_HD 256
#include "flash_quant.cu"
