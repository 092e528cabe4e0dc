// K11 at head width 256: flash_forward_fori.cu's kernel instantiated at
// d 256, as a library of its own (why: the note above FORI_HD there).
// Replaces, at that width, the TPU kernel flash_forward_fori.cu replaces
// (flash_attention_from_scratch_tpu/ops/flash_forward.py _fori_kernel); the
// design at d 256 is described in that file's header.

#define FORI_HD 256
#include "flash_forward_fori.cu"
