// K4/K5 for fp16 queries and dense fp16 pages: paged_attention.cu's kernels
// with act_t = fp16 (FA_F16, hopper.cuh), as a library of its own, so that
// the bf16 library is compiled as it was. Replaces, for fp16, the TPU
// kernels paged_attention.cu replaces
// (flash_attention_from_scratch_tpu/ops/paged_attention.py _full_kernel and
// _loop_kernel); the design is described in that file's header.

#define FA_F16 1
#include "paged_attention.cu"
