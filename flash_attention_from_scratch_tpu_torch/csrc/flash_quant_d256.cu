// K10 at head width 256: flash_quant.cu's kernels instantiated at d 256, as
// a library of their own (why: the note above QUANT_HD there). Replaces, at
// that width, the TPU kernel flash_quant.cu replaces
// (flash_attention_from_scratch_tpu/ops/flash_quant.py _quant_kernel and
// _attend_i8); the design at d 256 is described in that file's header.

#define QUANT_HD 256
#include "flash_quant.cu"
