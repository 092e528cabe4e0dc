"""PyTorch + CUDA port of flash_attention_from_scratch_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/``, ``models/``, ``serving/``,
``utils/``, ``csrc/``). Each TPU kernel on the ported path is a CUDA kernel
written for ``sm_90a`` beside a plain PyTorch version of the same function:
a wrapper launches the kernel for a CUDA tensor and runs the plain version
only for a CPU tensor. Entry points default to ``device="cuda"`` and raise
when no card is present.
"""

from .models.decode import (
    PagedKVCache, decode_step, greedy_token, init_cache, prefill,
    spec_accept_sample, verify_step,
)
from .models.llama import (
    LLAMA3_8B, LLAMA31_8B, MISTRAL_7B, LlamaConfig, forward, init_params,
    init_quantized_params, loss_fn, params_from_jax, quantize_params,
)
from .models.train import make_optimizer, make_train_step
from .ops.autodiff import flash_attention
from .ops.configs import (
    DType, KernelConfig, KVLoop, calc_causal_attn_flop, calc_self_attn_flop,
)
from .ops.flash_backward import flash_backward
from .ops.flash_forward import flash_forward, flash_forward_with_lse
from .ops.flash_quant import flash_forward_quantized
from .ops.paged_attention import paged_decode_attention
from .ops.quant import (
    KVQuantMode, QTensor, dequantize, quantize_kv, quantize_kv_pages,
    unpack_int4, unpack_int4_halves,
)
from .ops.quant_matmul import (
    QuantizedWeight, concat_weights, quant_matmul, quantize_activations,
    quantize_weight,
)
from .ops.reference import reference_attention, reference_pair
from .serving.generate import GenerationServer
from .serving.runtime import Batch, PagedEngine
from .utils.testing import adaptive_tolerance_check, error_stats, make_qkv

__all__ = [
    "DType", "KernelConfig", "KVLoop", "calc_self_attn_flop",
    "calc_causal_attn_flop", "reference_attention", "reference_pair",
    "flash_forward", "flash_forward_with_lse", "flash_forward_quantized",
    "flash_backward",
    "flash_attention", "paged_decode_attention",
    "KVQuantMode", "QTensor", "quantize_kv", "quantize_kv_pages",
    "unpack_int4_halves", "unpack_int4", "dequantize",
    "QuantizedWeight", "quantize_weight", "concat_weights",
    "quantize_activations", "quant_matmul",
    "LlamaConfig", "LLAMA3_8B", "LLAMA31_8B", "MISTRAL_7B", "init_params",
    "params_from_jax", "quantize_params", "init_quantized_params",
    "forward", "loss_fn", "make_optimizer",
    "make_train_step",
    "PagedKVCache", "init_cache", "prefill", "decode_step", "verify_step",
    "spec_accept_sample", "greedy_token",
    "PagedEngine", "Batch", "GenerationServer",
    "adaptive_tolerance_check", "error_stats", "make_qkv",
]
