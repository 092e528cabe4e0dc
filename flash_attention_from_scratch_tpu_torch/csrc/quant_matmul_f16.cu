// K6-K9 for fp16 activations: quant_matmul.cu's kernels with act_t = fp16
// (FA_F16, hopper.cuh: fp16 x by TMA, the weight dequantized to fp16 for
// fp16 wgmma, quantize_rows_kernel reading fp16 rows, fp16 out), as a
// library of its own, so that the bf16 library is compiled as it was.
// Replaces, for fp16 x, the TPU kernels quant_matmul.cu replaces
// (flash_attention_from_scratch_tpu/ops/quant_matmul.py _qmm_kernel_int8,
// _qmm_kernel_int8_nlast, _qmm_kernel_int4, _qmm_kernel_int8_a8 and
// _qmm_kernel_int4_a8); the design is described in that file's header.

#define FA_F16 1
#include "quant_matmul.cu"
