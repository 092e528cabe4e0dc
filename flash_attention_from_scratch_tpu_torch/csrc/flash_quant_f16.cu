// K10 in fp16: flash_quant.cu's kernels with act_t = fp16 (FA_F16,
// hopper.cuh: a dense fp16 Q by fp16 tensor maps; K/V, and a quantized Q,
// converted exactly into fp16 slots; fp16 wgmma; P rounded to fp16 before
// P V; the output stored as fp16), as a library of its own, so that the bf16
// library is compiled as it was. Replaces, for an fp16 compute type, the TPU
// kernel flash_quant.cu replaces (flash_attention_from_scratch_tpu/ops/
// flash_quant.py _quant_kernel and _attend_i8); the design is described in
// that file's header.

#define FA_F16 1
#include "flash_quant.cu"
