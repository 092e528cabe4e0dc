"""PyTorch + CUDA port of flash_attention_from_scratch_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/``, ``models/``, ``serving/``,
``utils/``, ``csrc/``). Each TPU kernel on the ported path is a CUDA kernel
written for ``sm_90a`` beside a plain PyTorch version of the same function:
a wrapper launches the kernel for a CUDA tensor and runs the plain version
only for a CPU tensor. Entry points default to ``device="cuda"`` and raise
when no card is present.

As in the JAX package, ``forward`` is the attention forward
(``flash_forward``); the model's forward is ``models.llama.forward``.
"""

from .models.decode import (
    PagedKVCache, decode_loop, decode_step, greedy_token, init_cache, prefill,
    prefill_chunked, row_keys, sample_noise, sample_token, spec_accept_sample,
    verify_step,
)
from .models.llama import (
    LLAMA3_8B, LLAMA31_8B, MISTRAL_7B, LlamaConfig, fuse_projections,
    init_params, init_quantized_params, loss_fn, params_from_jax,
    quantize_params,
)
from .models.convert import (
    config_from_hf, config_from_hf_gemma2, from_hf_gemma2, from_hf_llama,
    load_hf_checkpoint, read_safetensors,
)
from .models.lora import (
    LORA_KEYS, from_peft_state_dicts, init_lora_adapters, lora_delta, lora_from_jax,
    merged_params,
)
from .models.moe import MoEConfig, init_moe_params, moe_forward, moe_loss_fn
from .models.step_graphs import StepGraphs
from .models.train import make_optimizer, make_train_step
from .ops.autodiff import flash_attention
from .ops.causal_decomp import band_count, causal_forward_banded
from .ops.configs import (
    DType, KernelConfig, KVLoop, calc_arithmetic_intensity, calc_causal_attn_flop,
    calc_self_attn_flop, calc_tile_softmax_flop, calc_total_flop,
    get_autotuning_kernel_configs, get_kernel_configs, get_kernel_progression_configs,
    get_kernels_to_build, parse_short_form, should_autotune_config,
)
from .dispatch import chain_runtime, forward_timed, sync_overhead
from .entry import entry
from .ops.flash_backward import (
    flash_backward, fused_backward_fits, make_flash_backward, make_flash_backward_fused,
)
from .ops.flash_forward import flash_forward, flash_forward_with_lse, make_flash_forward
from .ops.flash_forward import flash_forward as forward
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
from .ops.reference import block_flash_attention, reference_attention, reference_pair
from .serving.generate import GenerationServer
from .serving.runtime import Batch, PagedEngine
from .utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .utils.testing import adaptive_tolerance_check, error_stats, generate_qkv, make_qkv

__all__ = [
    "DType", "KernelConfig", "KVLoop", "calc_self_attn_flop",
    "calc_causal_attn_flop", "calc_total_flop", "calc_tile_softmax_flop",
    "calc_arithmetic_intensity", "parse_short_form", "should_autotune_config",
    "get_autotuning_kernel_configs", "get_kernel_configs",
    "get_kernel_progression_configs", "get_kernels_to_build",
    "reference_attention", "reference_pair", "block_flash_attention",
    "flash_forward", "flash_forward_with_lse", "flash_forward_quantized",
    "make_flash_forward", "band_count", "causal_forward_banded",
    "flash_backward", "make_flash_backward", "make_flash_backward_fused",
    "fused_backward_fits", "forward_timed", "sync_overhead", "chain_runtime", "entry",
    "flash_attention", "paged_decode_attention",
    "KVQuantMode", "QTensor", "quantize_kv", "quantize_kv_pages",
    "unpack_int4_halves", "unpack_int4", "dequantize",
    "QuantizedWeight", "quantize_weight", "concat_weights",
    "quantize_activations", "quant_matmul",
    "LlamaConfig", "LLAMA3_8B", "LLAMA31_8B", "MISTRAL_7B", "init_params",
    "params_from_jax", "quantize_params", "init_quantized_params",
    "fuse_projections", "forward", "loss_fn", "make_optimizer",
    "make_train_step",
    "PagedKVCache", "init_cache", "prefill", "prefill_chunked", "decode_step",
    "verify_step", "decode_loop", "spec_accept_sample", "greedy_token",
    "sample_token", "sample_noise", "row_keys", "StepGraphs",
    "LORA_KEYS", "init_lora_adapters", "lora_delta", "from_peft_state_dicts",
    "lora_from_jax", "merged_params",
    "MoEConfig", "init_moe_params", "moe_forward", "moe_loss_fn",
    "from_hf_llama", "from_hf_gemma2", "config_from_hf", "config_from_hf_gemma2",
    "load_hf_checkpoint", "read_safetensors",
    "save_checkpoint", "restore_checkpoint", "latest_step",
    "PagedEngine", "Batch", "GenerationServer",
    "adaptive_tolerance_check", "error_stats", "make_qkv", "generate_qkv",
]
