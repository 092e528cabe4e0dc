#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check, serve, train, measure.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases: (1) print the card's name and power limit; (2) build every kernel
from ``flash_attention_from_scratch_tpu_torch/csrc`` with nvcc for sm_90a,
in parallel; (3) hold each kernel against its plain PyTorch version on the
card, in bf16, by the adaptive tolerance rule in each sequence or 64-row
band on its own: the flash forward (K1), paged decode (K4/K5: its split
kernel and merge, at one split and at the plan's count) on dense, int8,
fp8 and int4 pages, the quantized matmuls (K6-K9) at every weight
shape of Llama-3-8B at 16, 32, 64 and 1024 rows and K6/K7 at 1000 (K8/K9
also within one bf16 ulp of the plain int32 path, and their activation
quantization kernel bit-equal to the plain quantization), and the flash
backward, fused (K2) and split
(K3), each also at the training run's shape and strided layout and on
ragged tiles, rerun to hold dK/dV (and K3's dQ) bit for bit, plus
autograd with sinks against autograd of the reference, and the samplers
against the CPU (``sampler_case``: the noise source's integers bit for bit,
``sample_token`` token for token, 20,000 draws by their frequencies); (4) serve
Llama-3-8B at full width and depth (random bf16 weights from a seed)
through ``GenerationServer``, whose every decode and verify step is a
CUDA-graph replay (``models/step_graphs.py``; a warm-up run of short
prompts captures the graphs first): 8 requests, 32 greedy tokens each,
with the launch counts of K1, K4/K5 and its merge checked (counted on
replay) and two requests teacher-forced through the full-recompute
``forward``; hold a replayed step against the eager step on two copies of
the cache, bit for bit (``graph_case``: t = 1 and 4 here, runs A and B at
t = 1 below); (5) profile a few decode steps of every serving run (device
time by kernel, host calls, the card's busy share), serve again on the
same weights with speculative decoding (``spec_k=3``: prompts that repeat
a 37-token phrase, drafts by prompt lookup, verify steps on the
multi-token K4/K5; ``serve_spec`` line), then on the same weights fused
(``fuse_projections``) with ``chunk=8`` (greedy decode loops, one graph
each) and ``prefill_chunk_tokens=1024`` (``serve_chunk`` line: K1 per
prefill chunk, every request teacher-forced), then sampled (``serve_sample``:
temperature 0.8, top-k 50, the pick inside the graphs, at chunk 1 and 8,
whose tokens must be equal, two requests' tokens in the top 50 of their
full-recompute logits; greedy and sampled chunk-8 runs in turns), then
with the prefix cache (``serve_prefix``: 8 requests sharing a published
2,048-token prefix, 256 pages claimed, K1 counted per suffix chunk,
prefill and TTFT in turns with and without the cache), and hold
``prefill_chunked`` to ``prefill`` on a 4000-token prompt against the
model in fp32 (``prefill_chunked_case``), then serve with 4 LoRA adapters
of rank 16 (``serve_lora``: the 8 prompts on adapters -1, 0, 1, 2, 3, 0, 1,
-1, at chunk 1 and 8, whose tokens must be equal, every adapter row
teacher-forced through ``forward`` on its adapter's merged weights within
0.1 of the row max and the base rows on the base weights, an adapter row
serving other tokens than the server without adapters, a LoRA step and
loop replayed against the eager ones, the adapters' kernels a class of
their own in the profile, chunk 8 with and without adapters in turns),
then serve Mixtral-8x7B's widths at 8 layers (``serve_moe``: random bf16
weights, the 8 prompts, 32 greedy tokens, chunk 1 and 8, the routing
inside the decode and loop graphs, launch counts checked, two requests
teacher-forced as the JAX MoE test does it within 0.25, a MoE step
replayed equal to the eager one, the experts a class of their own in the
profile, and a dropless server (capacity factor 4.0) whose every request
is teacher-forced through ``moe_forward`` within 0.05), train those
widths at 2 layers (``train_moe``: 3 AdamW steps on ``moe_loss_fn``,
falling losses, a router gradient, K1 and K3 counted) and round-trip its
state through ``utils/checkpoint.py`` (the step after restore bit for bit
the step without it), and convert HF-named state dicts (``convert``:
Llama-3-8B's widths at 4 layers back bit for bit, int8-converted serving
equal to ``quantize_params`` serving (K6), bf16 shards the script writes
read back by ``load_hf_checkpoint``; Gemma-2-27B's widths at 4 layers
served past their 4,096 window, every request teacher-forced through
``forward`` within 0.05), then serve Gemma-2-9B at full width and depth
(``serve_gemma2_9b``: head width 256, 42 layers, random bf16 weights
converted by ``from_hf_gemma2``, 8 requests of 200-5,000 tokens, 32 greedy
tokens, K1 and K4/K5 at d 256 counted, every request teacher-forced, a
replayed step bit-equal to the eager one, 4 decode steps profiled; then
int8 weights and KV pages at 8 layers within 0.25 row standard
deviations); (6) train
Llama-3-8B at full width and 8 layers (AdamW, batch 2 x 2048 tokens) for 3
steps with the default backward (the split K3, the faster), checking the
loss falls and the launch counts, profile one more step, then take one
step on the fused backward (K2), with its counts checked, the loss after
it falling, and K2 and K3 held against the plain backward on every
layer's recorded attention inputs; then train Gemma-2-9B at full width
and head width 256 (``train_gemma2_9b``: 8 of its 42 layers, random bf16
weights converted by ``from_hf_gemma2``, batch 1 x 8,192 tokens, 3 AdamW
steps with checkpointed layers on K3 at d 256, one on K2, the same
checks, K2/K3 held to the plain backward on a sliding and a global
layer's recorded inputs); (7) serve quantized
Llama-3-8B at full width (``init_quantized_params`` from a seed), runs A-D
of ``QUANT_RUNS``: A int8 weights (K6) and int8 KV, B W4A8 (K9) and int8
KV, both at full depth with 16 requests of 1024 tokens; C W8A8 (K8) and
fp8 KV, D int4 weights (K7) and int4 KV, both at 4 layers with 4 requests;
**E** run A with int8-compute attention (``attn_int8``) and **F** int8
KV, ``attn_int8`` and ``spec_k=3`` at 4 layers with 4 requests; each checks
every token, finite logits, each kernel's launch count and two requests
teacher-forced through ``forward``, each run's decode steps are profiled,
and run A's and run B's replayed step is held to the eager one; then run
A at 4 layers with 2 LoRA adapters at chunk 8 (``serve_lora_quant``:
LoRA over the int8 base inside the loop graphs, teacher-forced on each
adapter's merged weights as run A is held); (8) drive the attention
bench tools, the path of quantized prefill attention (K10) and of the
K/V-ring forward (K11):
``tools/bench_quant.py`` at its default shapes with its numerics check,
its launches counted, then ``tools/bench_attention.py``'s ``main`` with the
JAX tool's options (``phase_bench_attention_options``: ``--kernels`` with
d-256 short forms of K11 and K1 at 16/8 heads and the SDPA baseline, the
same with ``--grad``, ``--fori --causal --host-timing``, ``--kernels
prog`` (K1, and K11 at depths 1 and 2); each run's rows and launches
checked), then hold K10 (every variant; s 2048 and 4096) and K11
(depth 2, and at d 256 as ``--kernels`` runs it) against their plain
versions on the tools' own inputs at those shapes, and run the
serving bench tools each in its own process (``tools/bench_decode.py`` at
Llama-3-8B, int8 weights and KV, per step and ``--scan``;
``tools/bench_serving.py`` at its defaults and with the prefix cache),
reading back their JSON lines, and call ``entry()``'s forward and
``forward_timed`` once (``entry``); (9) time each kernel at its path's shapes beside its bound, its
plain version and the library call, with K6-K9's registers and spills
from the build (K1 also launched as a plain grid, with its registers and
spills; K4/K5 by CUDA-graph replay, as the card runs it faster than the
host enqueues it, with its split count and its merge's share, also per
page format, with t = 4 query tokens at the speculative run's first
verify step and with int8 compute at run E's step, each beside the
single-token call; K10 per
variant and K11 per ring depth at b 4, s 4096, with their registers
and spills from the build; K2 and K3 at four shapes, as the whole call
and as their kernels' device time, with their registers and spills).
Phase (3) also holds
the row-band forward (``KernelConfig(decompose=True)``: one K1 launch a
512-row band) to the plain monolithic version at b 1, 32/8 heads, s 4096
and 8192 causal, a window of 1024, q 2048 at q_offset 2048 and with sinks
(its LSE too), each timed against one monolithic K1 call by CUDA-graph
replay (``banded_case``), and
K4/K5's multi-token q (t = 2, 4, 8 on every page format, with a window and
a softcap) and int8 compute (t = 1 and 4) per (sequence, token), K11
at ring depths 1-4 on every K1 case, and K10 for every variant (int8
compute, int8/fp8/int4 K/V, bf16/int8/fp8 Q), non-causal and causal, with
windows, a softcap and strided Q, against its plain version, and head
width 256 (``phase_d256_cases``, Gemma-2-9B's 16/8 heads): K1 and K11
at ring depths 1-4 on five cases (the 5,120-row prefill with the window or
globally, a q_offset chunk with every option, full, ragged), K10 on every
variant (full and causal at s 2048, Gemma-2's 5,120-token prefill with its
window and softcap, strided Q) and K4/K5 on every page format and
int8 compute at t = 1 and 4 with the window and the softcap, and K2 and
K3 on seven backward cases (causal, full, q_offset, a window starting
mid-tile, softcap 50, ragged, strided) with their rerun equalities; K1 and
K4/K5 at d 256 are timed at ``serve_gemma2_9b``'s shapes
(``time_flash_d256``, ``time_paged_d256``), K2 and K3 at
``train_gemma2_9b``'s (``time_backward_d256``), K10 per variant and K11
per depth at b 4, s 4096, 16/8 heads (``time_quant_fori_d256``; the
``*_d256`` entries of the ``kernels`` line). (10) the parallel layer
(``parallel/``), its ranks processes on this card over gloo, named here
(NCCL refuses two ranks on one card; every tensor
that crosses ranks goes through pinned host memory, counted as staged
bytes; no time of these phases is a multi-card speed): ``ring``, ring
attention over 4 ranks at Llama-3-8B attention widths (b 1, 32/8 heads, s
16,384, 4,096 a rank), causal, non-causal, a 4,096 window and sinks,
forward and backward, each rank's K1/K2/K3 launches its ``launch_plan``,
held per 64-row band against single-rank ``flash_attention`` and the plain
fp32 version; ``train_parallel``, Llama-3-8B's width at 2 layers, 3 AdamW
steps on one rank, an sp 2 and a tp 2 mesh, losses within 0.01 of one
rank's and the first step's gradients within 5 % of its norm on every
leaf; ``serve_tp``, the serve phase's model at 8 layers and its requests
at tp 2 (and run A's int8 weights and KV at 4 layers), every rank the same
tokens, each first difference from the single card a near-tie;
``bench_ring``, the ring's compute side against one K1 call (a
subprocess); ``moe_ep``, expert parallelism over 4 ranks at Mixtral-8x7B
widths (an fp32 ``_moe_mlp`` layer and a 2-layer bf16 ``moe_loss_fn``
against one rank); ``pipeline``, GPipe over 4 ranks at Llama-3-8B width
(4 layers, 4 microbatches; loss and first-step gradients against
``loss_fn`` on one rank, launches against the plan); ``serve_tp_lora``,
LoRA prefill, decode and verify steps under tp 2 against one rank;
``scaling_report``, the tool as a subprocess at tp 1/2/4; ``dryrun``,
``entry.dryrun_multichip(4)``; then the kernels at the shard shapes
(``time_shards``). (11) Before the parallel layer, the banded backward
(``phase_banded_backward_cases``: K2 at its prefix shapes, 1,024 rows
against 1,024-3,072 keys without the mask, and ``flash_backward(...,
bands=4)`` at b 2, 32/8 heads, s 4,096, causal, each held to the plain
version per 64-row band, the banded call also to the monolithic K3 call,
with its 7 K2 launches counted; timed against the monolithic K2 and K3
calls at s 4,096, 8,192 and 16,384 by ``time_banded_backward``) and the
kernel tools (``phase_kernel_tools``: ``bench_ladder``, ``bench_sweep``,
``bench_backward`` with and without ``--causal``, ``bench_train`` at
Llama-3-8B's widths and 8 layers, ``autotune``, ``sanity_check``,
``debug_steps``, ``profile_trace`` and ``quant_trace``, each through its
``main`` with its launches counted, its rows checked). (12) Then the
counterparts of the JAX package's last five tools and its ``bench`` line
(``phase_port_tools``): ``mosaic_dump --check`` against the committed SASS
baselines, ``check_races`` eager and under ``compute-sanitizer`` (a
sanitizer that refuses the card at the tool's probe is reported as refused,
never as a pass; any error or hazard it reports fails), the ``bench`` line,
``onchip_checklist``, ``tune_bands`` at s 8,192 and ``tune_short_seq`` at s
512 and 1,024. (13) Every shape the JAX kernels take (after the kernel
cases): K6-K9 at (K, N) of (4,096, 32,002), (4,000, 4,100), (4,004,
4,100) and (4,096, 40) and m 1 to 1,024 (``phase_qmm_any_shape_cases``;
K8/K9 and ``quantize_rows`` bit for bit, no call copying the weight), K4/K5
at pages of 1-200 tokens in every store and int8 compute, d 128 and 256, t
1 and 4 (``phase_paged_any_size_cases``), each call on NaN-poisoned
memory; after the quantized runs, OpenHermes-2.5-Mistral-7B's widths
(32,002-word head) served quantized (``phase_serve_openhermes``: R1 int8
weights at 32 layers with dense pages of 1 token, R2 W4A8 at 4 layers with
int8 pages of 96 and decode loops), each held as the quantized runs are;
timed in the ``kernels`` line (``time_lm_head_32002``,
``time_paged_page_sizes``). (14) fp16, every kernel from its fp16 library
(``csrc/*_f16.cu``): after the kernel cases each fp16 kernel against its
plain version in fp16 (``phase_fp16_cases``: K1, K11, K4/K5, K6-K9;
``phase_fp16_backward_cases``: K2 and K3 at d 128 and 256 on every mask,
non-square past keys, the training shape and ``bands=2``;
``phase_fp16_quant_cases``: K10 in every variant at d 128 and 256, and a
quantized Q of fp32 ``orig_dtype`` refused); Llama-3-8B served in fp16
(``serve_fp16``, ``serve_fp16_quant``), Gemma-2-9B served in fp16; after
``train``, ``train_fp16`` (the same run with the model in fp16, SGD) and,
after ``train_gemma2_9b``, ``train_gemma2_9b_fp16``; ``bench_attention
--dtype f16`` with and without ``--grad``; the ``*_f16`` entries of the
``kernels`` line with the bf16 entries' ms beside theirs. (15) fp32, K1
and K11 from their fp32 libraries (``csrc/flash_forward_f32.cu``,
``flash_forward_fori_f32.cu``, ``flash_forward_fori_d256_f32.cu``: the fp32
main loop of ``csrc/flash_f32.cuh``, 3xTF32 products, P in fp32): after the
fp16 kernel cases K1 and K11 at depths 1-4 on FP32_FLASH_CASES
(``phase_fp32_cases``: d 128 and 256, every mask, sinks, GQA, a q_offset, s
64 and 2,048, NaN-poisoned memory), each held by
``utils/testing.py::fp32_tolerance_check`` (its error from the exact
answer, the plain version in fp64, at most twice the plain fp32 version's,
fp32's floors; the floors alone reported beside it, the exact answer's
too); after the fp16 serve phases ``prefill_fp32``: Llama-3-8B in fp32 at
full width and depth, then Gemma-2-9B in fp32 at full width and 8 layers,
over the serve phases' prompts (finite logits, K1 one launch a layer and
prompt, the longest prompt's first and last layers' recorded inputs held by
that rule, ``prefill_chunked`` within 1e-3 of ``prefill``'s row max);
``bench_attention --dtype f32`` on K1's and K11's d-128 and d-256 forms
with SDPA's fp32 baseline (its memory-efficient backend) and
``sanity_check --dtype f32``; the ``*_f32`` entries of the ``kernels``
line. Prints ``serve``, ``profile``, ``serve_spec``, ``serve_chunk``, ``serve_sample``,
``serve_prefix``, ``serve_lora``, ``serve_moe``, ``train_moe``, ``convert``,
``serve_gemma2_9b``, ``train``, ``train_fp16``, ``train_gemma2_9b``,
``train_gemma2_9b_fp16``, ``fp16_cases``, ``fp16_backward_cases``,
``fp16_quant_cases``, ``fp32_cases``, ``prefill_fp32``,
``serve_quant``, ``serve_lora_quant``, ``bench_quant``,
``bench_attention``, ``bench_decode``, ``bench_serving``, ``ring``,
``train_parallel``, ``serve_tp_bf16``, ``serve_tp_int8``, ``bench_ring``,
``moe_ep``, ``pipeline``, ``serve_tp_lora``, ``scaling_report``, ``dryrun``
(and a line per rank), ``banded_backward``, ``kernel_tools``, ``port_tools``, ``phase_s``
(each phase's wall time) and ``kernels`` JSON lines and, last, one JSON object
with ``"ok": true``. Any failure raises, so the exit code is not 0.
Without a CUDA device it exits with code 2 before it does anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import sys
import time

import numpy as np
import torch

# Without the package beside this script, fail here, before printing anything.
from flash_attention_from_scratch_tpu_torch.dispatch import median_runtime, sync
from flash_attention_from_scratch_tpu_torch.tools import bench_attention, bench_quant
from flash_attention_from_scratch_tpu_torch.tools.bench_train import train_flops

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores and HBM3 bandwidth. The bound of a kernel is the larger of its
# operations over the first and its bytes over the second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FLASH_CASE_SEQS = (512, 2048, 4096)
HEADS, KV_HEADS, D = 32, 8, 128
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 2048, 3
SPEC_K = 3  # the speculative runs' draft length: verify calls at t = 4
PAGED_TOKENS = (2, 4, 8)  # multi-token q cases: t = spec_k + 1 for spec_k 1, 3, 7


def _time_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Median milliseconds per call (``dispatch.median_runtime``)."""
    return 1e3 * median_runtime(fn, warmup=warmup, iters=iters)


def _graph_ms(fn, calls: int = 20, iters: int = 5) -> float:
    """Median milliseconds per call of ``fn`` on the card, with the host out
    of the way: ``calls`` calls captured in one CUDA graph, replayed between
    two CUDA events. For kernels that the card runs faster than the host
    enqueues their wrapper's calls, where ``_time_ms`` times the host."""
    fn()  # allocations, builds and one-time set-up happen outside the graph
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return sorted(times)[iters // 2]


def _attn_ops(seq: int, heads: int, batch: int, causal: bool, window: int = 0,
              d: int = D) -> int:
    """Tensor-core operations of an attention forward: the two tile
    products, S = Q K^T and P V, 2 * d each per visible (q, kv) pair. The
    softmax's elementwise work runs on the CUDA cores beside them."""
    if not causal:
        pairs = seq * seq
    elif window and window < seq:
        pairs = window * seq - window * (window - 1) // 2
    else:
        pairs = seq * (seq + 1) // 2
    return 4 * d * pairs * heads * batch


def phase_device() -> str:
    from flash_attention_from_scratch_tpu_torch.utils.chip import device_kind

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = device_kind()
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return smi


def _ptxas_by_kernel(log: str) -> dict:
    """{mangled kernel name: its registers and spills} from ``nvcc
    -Xptxas=-v`` output."""
    found, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            found[name] = []
        elif name and ("registers" in line or "spill" in line):
            found[name].append(line.split(":", 1)[-1].strip())
    return {n: "; ".join(v) for n, v in found.items()}


def phase_build() -> dict:
    """Build every source; returns {source: compiler output}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(["flash_forward.cu", "paged_attention.cu",
                         "flash_backward.cu", "flash_backward_d256.cu", "quant_matmul.cu",
                         "flash_quant.cu", "flash_quant_d256.cu", "flash_forward_fori.cu",
                         "flash_forward_fori_d256.cu", "paged_runtime.cpp",
                         # the fp16 libraries
                         "flash_forward_f16.cu", "flash_forward_fori_f16.cu",
                         "flash_forward_fori_d256_f16.cu", "paged_attention_f16.cu",
                         "quant_matmul_f16.cu", "flash_backward_f16.cu",
                         "flash_backward_d256_f16.cu", "flash_quant_f16.cu",
                         "flash_quant_d256_f16.cu",
                         # the fp32 libraries (K1, K11)
                         "flash_forward_f32.cu", "flash_forward_fori_f32.cu",
                         "flash_forward_fori_d256_f32.cu"])
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"build {name}: {line.strip()}", flush=True)
            elif "entry function" in line:  # the template arguments name it
                print(f"build {name}: {line.strip()[:150]}", flush=True)
    print(f"build: {sorted(logs)} in {secs:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    return logs


def _as_model_rows(x, strided):
    """x (b, h, s, d); with ``strided``, the same values laid out as the
    model hands them to the kernels: a transposed view of contiguous
    (b, s, h, d) rows."""
    return x.transpose(1, 2).contiguous().transpose(1, 2) if strided else x


def _cuda_qkv(sq, skv, seed, batch=1, strided=False, heads=HEADS, kv_heads=KV_HEADS, d=D,
              dtype=torch.bfloat16):
    from flash_attention_from_scratch_tpu_torch.utils.testing import make_qkv

    q, k, v = make_qkv(batch, heads, sq, d, kv_heads=kv_heads, seq_kv=skv,
                       seed=seed)
    return [_as_model_rows(torch.from_numpy(x).to("cuda", dtype), strided)
            for x in (q, k, v)]


def _cuda_normal(shape, seed, strided=False, dtype=torch.bfloat16):
    return _as_model_rows(torch.from_numpy(np.random.default_rng(
        seed).standard_normal(shape).astype(np.float32)).to("cuda", dtype), strided)


def _timing_normal(shape, seed, dtype=torch.bfloat16):
    """Standard-normal values drawn on the card from ``seed``: the timing
    functions' inputs (numpy's draw of a b 4, 32-head, s 4,096 Q, K and V
    takes about 2 s on the host; the card's, milliseconds)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _timing_qkv(sq, skv, seed, batch=1, heads=HEADS, kv_heads=KV_HEADS, d=D,
                dtype=torch.bfloat16):
    """``_cuda_qkv``'s shapes, drawn on the card (``_timing_normal``)."""
    return [_timing_normal((batch, h, s, d), seed + i, dtype)
            for i, (h, s) in enumerate(((heads, sq), (kv_heads, skv), (kv_heads, skv)))]


# The training run's attention: causal, b 2, 32/8 heads, s 2048, with q,
# k, v and dO as transposed views (``_as_model_rows``).
TRAIN_CASE = (f"train shape b{TRAIN_BATCH} s{TRAIN_SEQ} strided", TRAIN_SEQ,
              TRAIN_SEQ, dict(causal=True), dict(batch=TRAIN_BATCH, strided=True))


FLASH_CASES = [(f"{kind} s{s}", s, s, kw, {})
               for s in FLASH_CASE_SEQS
               for kind, kw in (("causal", dict(causal=True)), ("full", {}))] + [
    ("q_offset 512 s512/1024", 512, 1024, dict(causal=True, q_offset=512), {}),
    ("window 512 s2048", 2048, 2048, dict(causal=True, window=512), {}),
    ("softcap 50 s1024", 1024, 1024, dict(causal=True, attn_softcap=50.0), {}),
    ("sinks s1024", 1024, 1024, dict(causal=True), dict(sinks=True)),
    # Ragged for K11's 128-row Q tiles and 128-key slots: the last Q tile's
    # second warpgroup past seq_q, the last KV tile half zero-filled.
    ("ragged s192/320 q_offset 128 window 70", 192, 320,
     dict(causal=True, q_offset=128, window=70), {}),
    TRAIN_CASE,
] + [
    # Every call of chunked prefill with a prefix (``prefill_chunked``,
    # 1024-token chunks, the tail padded to 128 rows) on SERVE_PROMPT_LENS.
    (f"chunk q_offset {o} s{sq}/{o + sq}", sq, o + sq, dict(causal=True, q_offset=o), {})
    for o, sq in ((1024, 512), (1024, 1024), (2048, 512), (2048, 1024), (3072, 1024))
] + [
    # The prefix cache's suffix chunks (``serve_prefix``: 128-token chunks
    # at q_offset 2048-2944 after the 2,048 shared tokens, and one chunk of
    # the tail padded to 128 rows at prefill_chunk_tokens=1024; the
    # bench_serving tool's 128-token prefix: one chunk at q_offset 128).
    (f"prefix q_offset {o} s{sq}/{o + sq}", sq, o + sq, dict(causal=True, q_offset=o), {})
    for o, sq in ((2048, 128), (2944, 128), (2048, 384), (2048, 896), (128, 128))
]
FORI_DEPTHS = (1, 2, 3, 4)  # K11 ring depths the cases and timings cover


def _flash_cases(loops: dict) -> dict:
    """Each forward kernel of ``loops`` ({label: KernelConfig fields that
    pick it}) vs the plain version on every case of FLASH_CASES, by the
    tolerance rule in each (batch, head, 64-row band); each call must
    launch its kernel once. Returns {label: (max |kernel - plain|, worst
    err/bound)}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig, KVLoop
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL, KERNEL_FORI, flash_forward_plain, flash_forward_with_lse)

    worst = {label: (0.0, 0.0) for label in loops}
    for i, (name, sq, skv, kw, extra) in enumerate(FLASH_CASES):
        q, k, v = _cuda_qkv(sq, skv, seed=i, batch=extra.get("batch", 1),
                            strided=extra.get("strided", False))
        sinks = (torch.from_numpy(np.random.default_rng(100 + i).standard_normal(
            HEADS).astype(np.float32) * 2).cuda() if extra.get("sinks") else None)
        base = KernelConfig(**kw)
        ref16, _ = flash_forward_plain(q, k, v, base, sinks)
        ref32, lse32 = flash_forward_plain(q.float(), k.float(), v.float(),
                                           _fp32(base), sinks)
        for label, loop in loops.items():
            cfg = dataclasses.replace(base, **loop)
            kernel = KERNEL_FORI if cfg.kv_loop == KVLoop.FORI else KERNEL
            before = _build.launch_counts[kernel]
            out, lse = flash_forward_with_lse(q, k, v, cfg, sinks=sinks)
            sync()
            launched = _build.launch_counts[kernel] - before
            lse_err = float((lse - lse32).abs().max())
            got = _hold(f"{label} {name}", out, ref16, ref32, launched,
                        good=lse_err <= 1e-3, note=f", lse err {lse_err:.3e}")
            worst[label] = tuple(map(max, worst[label], got))
        del q, k, v, ref16, ref32
    return worst


def phase_flash_cases() -> tuple[float, float]:
    """K1 vs its plain version: every case passes the tolerance rule.
    Returns (max |kernel - plain|, worst err/bound)."""
    return _flash_cases({"flash_forward": {}})["flash_forward"]


def phase_fori_cases() -> tuple[float, float]:
    """K11 at every ring depth (1-4) on K1's cases, by the same rule.
    Returns (max |kernel - plain|, worst err/bound) over the depths."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KVLoop

    worst = _flash_cases({f"flash_forward_fori nb{n}": dict(
        kv_loop=KVLoop.FORI, num_kv_buffers=n) for n in FORI_DEPTHS})
    return tuple(max(w[i] for w in worst.values()) for i in (0, 1))


# The row-band forward's cases (banded_case): b 1, 32/8 heads; (label, seq_q,
# options; ``sinks`` adds per-head sinks).
BANDED_CASES = (("causal s4096", 4096, {}), ("causal s8192", 8192, {}),
                ("window 1024 s4096", 4096, dict(window=1024)),
                ("q_offset 2048 s2048/4096", 2048, dict(q_offset=2048)),
                ("sinks s4096", 4096, dict(sinks=True)))


def _plain_by_heads(q, k, v, cfg, sinks, group: int = 8):
    """The plain forward (out, lse) 8 query heads (and their KV heads) at a
    time: 32 heads' fp32 scores at s 8192 would take 8.6 GB at once."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import flash_forward_plain

    ratio = q.shape[1] // k.shape[1]
    parts = [flash_forward_plain(q[:, h:h + group], k[:, h // ratio:(h + group) // ratio],
                                 v[:, h // ratio:(h + group) // ratio], cfg,
                                 None if sinks is None else sinks[h:h + group])
             for h in range(0, q.shape[1], group)]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


def banded_case() -> list:
    """``flash_forward_with_lse`` with ``KernelConfig(decompose=True)`` (the
    row-band dispatch over K1) on the card at BANDED_CASES: one K1 launch a
    band (band_count's 512-row bands), the output by the tolerance rule in
    each (batch, head, 64-row band) against the plain monolithic version in
    bf16 and fp32, the LSE within 1e-3 (with the sinks folded in after the
    bands). Times the banded call against one monolithic K1 call on the
    same inputs by CUDA-graph replay, in turns (banded, monolithic,
    monolithic, banded); beside them the bound of the monolithic call's
    work. The default stays the monolithic call."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.causal_decomp import band_count
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL, flash_forward_with_lse)
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        row_bands, sliced_tolerance_check)

    lines = []
    for i, (label, sq, kw) in enumerate(BANDED_CASES):
        kw = dict(kw)
        with_sinks = kw.pop("sinks", False)
        cfg = KernelConfig(causal=True, decompose=True, **kw)
        mono = dataclasses.replace(cfg, decompose=False)
        skv = sq + cfg.q_offset
        q, k, v = _cuda_qkv(skv, skv, seed=200 + i)
        q = q[:, :, cfg.q_offset:].contiguous()
        sinks = (torch.linspace(-2, 2, HEADS, device="cuda") if with_sinks else None)
        before = _build.launch_counts[KERNEL]
        out, lse = flash_forward_with_lse(q, k, v, cfg, sinks=sinks)
        sync()
        launches = _build.launch_counts[KERNEL] - before
        ref16, _ = _plain_by_heads(q, k, v, mono, sinks)
        ref32, lse32 = _plain_by_heads(q.float(), k.float(), v.float(), _fp32(mono), sinks)
        ok, ratio, where = sliced_tolerance_check(
            row_bands(out), row_bands(ref16), row_bands(ref32), lead=3)
        lse_err = float((lse - lse32).abs().max())
        del ref16, ref32, lse32
        run = {"banded": lambda: flash_forward_with_lse(q, k, v, cfg, sinks=sinks),
               "monolithic": lambda: flash_forward_with_lse(q, k, v, mono, sinks=sinks)}
        turns = [(name, _graph_ms(run[name], calls=5))
                 for name in ("banded", "monolithic", "monolithic", "banded")]
        pos = np.arange(cfg.q_offset, skv)
        pairs = int(np.minimum(pos + 1, cfg.window or skv).sum())
        nbytes = 2 * (2 * sq * HEADS * D + 2 * skv * KV_HEADS * D) + 4 * sq * HEADS
        line = {"case": label, "bands": band_count(sq), "k1_launches": launches,
                "worst_err_bound": ratio, "worst_at": where, "lse_err": lse_err,
                "ms_turns": turns,
                "banded_ms": min(t for n, t in turns if n == "banded"),
                "monolithic_ms": min(t for n, t in turns if n == "monolithic"),
                "bound_ms": 1e3 * max(4 * D * pairs * HEADS / PEAK_BF16_FLOPS,
                                      nbytes / PEAK_BYTES_PER_S)}
        print(f"banded_case: {json.dumps(line)}", flush=True)
        if not (ok and launches == band_count(sq) and lse_err <= 1e-3
                and bool(torch.isfinite(out).all())):
            raise AssertionError(f"banded_case {label}: the banded forward disagrees with the "
                                 f"plain version or launched K1 {launches} times")
        lines.append(line)
        del q, k, v, out, lse
    torch.cuda.empty_cache()
    return lines


def phase_entry() -> dict:
    """``entry()``'s function (the 2-layer model's forward) once on the card,
    finite logits of its shape; ``forward_timed`` on ``generate_qkv``'s
    benchmark shape at s 2048 (b 16, 16 heads, causal) returns a positive
    time."""
    from flash_attention_from_scratch_tpu_torch.dispatch import forward_timed
    from flash_attention_from_scratch_tpu_torch.entry import entry
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.utils.testing import generate_qkv

    fn, args = entry()
    logits = fn(*args)
    sync()
    q, k, v = generate_qkv(2048)
    out, secs = forward_timed(q, k, v, KernelConfig(causal=True))
    line = {"logits_shape": list(logits.shape), "finite": bool(torch.isfinite(logits).all()),
            "forward_timed_ms": 1e3 * secs, "forward_timed_shape": list(q.shape),
            "out_finite": bool(torch.isfinite(out).all())}
    print(f"entry: {json.dumps(line)}", flush=True)
    if not (line["finite"] and line["out_finite"] and tuple(logits.shape) == (2, 256, 512)
            and secs > 0):
        raise AssertionError(f"entry: {line}")
    return line


def _fp32(cfg):
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType

    return dataclasses.replace(cfg, dtype=DType.FP32)


BACKWARD_CASES = (
    ("causal s512", 512, 512, dict(causal=True), {}),
    ("causal s2048", 2048, 2048, dict(causal=True), {}),
    ("full s1024", 1024, 1024, dict(), {}),
    ("q_offset 512 s512/1024", 512, 1024, dict(causal=True, q_offset=512), {}),
    ("window 512 s2048", 2048, 2048, dict(causal=True, window=512), {}),
    ("softcap 50 s1024", 1024, 1024, dict(causal=True, attn_softcap=50.0), {}),
    # Ragged against 128-row tiles (192 and 320 are odd multiples of 64),
    # with a window that starts mid-tile.
    ("ragged s192/320 q_offset 128 window 70", 192, 320,
     dict(causal=True, q_offset=128, window=70), {}),
    TRAIN_CASE,
)


def _check_grads(what, got, ref16, ref32):
    """dq by (batch, head, 64-row band), dk/dv by (batch, kv_head, band):
    the sliced rule on each. Returns (max |kernel - plain|, worst ratio)."""
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        row_bands, sliced_tolerance_check)

    err = ratio_max = 0.0
    for name, g, r16, r32 in zip(("dq", "dk", "dv"), got, ref16, ref32):
        ok, ratio, where = sliced_tolerance_check(
            row_bands(g), row_bands(r16), row_bands(r32), lead=3)
        if not ok or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} {name}: err/bound {ratio:.3f} in "
                                 f"(batch, head, band) {where}")
        err = max(err, float((g.float() - r16.float()).abs().max()))
        ratio_max = max(ratio_max, ratio)
    return err, ratio_max


def _hold_backward_cases(cases, label: str = "", heads: int = HEADS,
                         kv_heads: int = KV_HEADS, d: int = D,
                         dtype=torch.bfloat16) -> dict:
    """K2 and K3 vs their plain version on ``cases`` (``BACKWARD_CASES``'
    form, at ``heads``/``kv_heads`` heads of width ``d``, in ``dtype``:
    the kernels of that type's library, gradients in it), on K1's O and
    LSE, each called twice: the sliced rule on each gradient
    (``_check_grads``), dK and dV bit for bit equal on the rerun in both
    modes and dQ too in K3's, each kernel launched once a call. Returns
    {mode: (max |kernel - plain|, worst err/bound)}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED, flash_backward, flash_backward_plain)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward_with_lse)

    names = {"fused": (KERNEL_FUSED,), "split": (KERNEL_DKV, KERNEL_DQ)}
    worst = {"fused": (0.0, 0.0), "split": (0.0, 0.0)}
    for i, (name, sq, skv, kw, extra) in enumerate(cases):
        layout = dict(strided=extra.get("strided", False), dtype=dtype)
        q, k, v = _cuda_qkv(sq, skv, seed=200 + i, batch=extra.get("batch", 1),
                            heads=heads, kv_heads=kv_heads, d=d, **layout)
        do = _cuda_normal(q.shape, seed=300 + i, **layout)
        cfg = KernelConfig(d_head=d, dtype=DType.from_torch(dtype), **kw)
        o, lse = flash_forward_with_lse(q, k, v, cfg)
        ref16 = flash_backward_plain(q, k, v, o, lse, do, cfg)
        ref32 = flash_backward_plain(q.float(), k.float(), v.float(), o.float(),
                                     lse, do.float(), _fp32(cfg))
        for mode in ("fused", "split"):
            before = {n: _build.launch_counts[n] for n in names[mode]}
            got = flash_backward(q, k, v, o, lse, do, cfg, fused=mode == "fused")
            again = flash_backward(q, k, v, o, lse, do, cfg, fused=mode == "fused")
            sync()
            launched = {n: _build.launch_counts[n] - before[n] for n in names[mode]}
            what = f"flash_backward {label}{mode} {name}"
            err, ratio = _check_grads(what, got, ref16, ref32)
            # dK/dV sum in a fixed order in both; dQ only in the split pair.
            same = [torch.equal(a, b) for a, b in zip(got, again)]
            if not all(same[1:]) or (mode == "split" and not same[0]):
                raise AssertionError(f"{what}: a rerun differs (dq, dk, dv equal: {same})")
            if set(launched.values()) != {2} or {g.dtype for g in got} != {dtype}:
                raise AssertionError(f"{what}: two calls launched {launched}, gradients in "
                                     f"{[g.dtype for g in got]}")
            worst[mode] = tuple(map(max, worst[mode], (err, ratio)))
            print(f"{what}: max|kernel-plain| {err:.3e}, worst err/bound {ratio:.3f}, "
                  f"rerun dq equal {same[0]} ok", flush=True)
        del q, k, v, do, o, lse, ref16, ref32, got, again
    torch.cuda.empty_cache()
    return worst


def phase_backward_cases() -> dict:
    """K2 and K3 vs their plain version on BACKWARD_CASES
    (``_hold_backward_cases``); then autograd through ``flash_attention``
    with sinks vs autograd of the reference. Returns {kernel: max |kernel -
    plain|}."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import KERNEL_FUSED

    worst = _hold_backward_cases(BACKWARD_CASES)
    _backward_sinks_case()
    return {KERNEL_FUSED: worst["fused"][0], "split": worst["split"][0]}


def _backward_sinks_case() -> None:
    """flash_attention with sinks (causal, s 1024) through autograd vs
    autograd of reference_attention in bf16 and fp32. d(sink) per head
    within the JAX package's rule: 2x the bf16-vs-fp32 baseline, or 2% of
    the gradient's scale (D is rebuilt from the saved bf16 O, which the
    reference never rounds)."""
    from flash_attention_from_scratch_tpu_torch.ops.autodiff import flash_attention
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.reference import (
        reference_attention)

    q, k, v = _cuda_qkv(1024, 1024, seed=400)
    do = _cuda_normal(q.shape, seed=401)
    sinks = torch.from_numpy(np.random.default_rng(402).standard_normal(
        HEADS).astype(np.float32)).cuda()

    def grads(fn, dtype):
        leaves = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        z = sinks.clone().requires_grad_()
        return torch.autograd.grad(fn(*leaves, z), (*leaves, z), do.to(dtype))

    got = grads(lambda q, k, v, z: flash_attention(
        q, k, v, KernelConfig(causal=True), z), torch.bfloat16)
    sync()
    refs = [grads(lambda q, k, v, z: reference_attention(
        q, k, v, causal=True, q_offset=0, sinks=z), dt)
        for dt in (torch.bfloat16, torch.float32)]
    err, ratio = _check_grads("flash_attention sinks", got[:3], refs[0][:3],
                              refs[1][:3])
    z_err = (got[3] - refs[0][3]).abs()
    z_bound = torch.maximum(2 * (refs[0][3] - refs[1][3]).abs(),
                            0.02 * refs[1][3].abs().max().expand(HEADS))
    ok = bool((z_err <= z_bound).all())
    print(f"flash_attention sinks s1024: max|kernel-ref| {err:.3e}, worst "
          f"err/bound {ratio:.3f}; d(sinks) worst err/bound "
          f"{float((z_err / z_bound).max()):.3f} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("flash_attention sink gradient disagrees")


def make_paged_pool(lengths, page_size, num_pages, seed, pages_per_seq,
                    device="cuda", kv_heads=KV_HEADS, d=D, dtype=torch.bfloat16):
    """A page pool in ``dtype`` (bf16 by default) holding each sequence's K/V
    under shuffled page ids (``kv_heads`` heads of width ``d``).

    Pages no sequence owns, and each last page's slots past the length, hold
    NaN: the kernel must never read them. Returns (k_pages, v_pages,
    lengths, page_tables) on ``device``.
    """
    rng = np.random.default_rng(seed)
    need = [-(-n // page_size) for n in lengths]
    if sum(need) > num_pages:
        raise ValueError("pool too small")
    perm = rng.permutation(num_pages)
    k = np.full((kv_heads, num_pages, page_size, d), np.nan, np.float32)
    v = np.full_like(k, np.nan)
    tables = -np.ones((len(lengths), pages_per_seq), np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        for i in range(need[b]):
            page = perm[nxt]
            nxt += 1
            tables[b, i] = page
            rows = min(page_size, n - i * page_size)
            k[:, page, :rows] = rng.standard_normal((kv_heads, rows, d))
            v[:, page, :rows] = rng.standard_normal((kv_heads, rows, d))
    to = dict(device=device)
    return (torch.from_numpy(k).to(dtype=dtype, **to),
            torch.from_numpy(v).to(dtype=dtype, **to),
            torch.tensor(lengths, dtype=torch.int32, **to),
            torch.from_numpy(tables).to(**to))


# K4/K5's split counts in the kernel cases: 1 (no merge) and the plan's (0).
PAGED_SPLITS = (1, 0)


def phase_paged_cases() -> float:
    """K4/K5 vs its plain version on a ragged, shuffled, NaN-poisoned pool,
    at split counts 1 and the plan's."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        sliced_tolerance_check)

    lengths = [1, 17, 64, 65, 1000, 0, 2047, 3001, 4000]
    kp, vp, lens, tables = make_paged_pool(lengths, 64, 320, seed=7,
                                           pages_per_seq=64)
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((len(lengths), HEADS, D)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    worst = 0.0
    for name, kw in (("dense", {}), ("window 1000", dict(window=1000)),
                     ("softcap 30", dict(softcap=30.0))):
        scale = D ** -0.5
        ref16 = paged_decode_attention_plain(q, kp, vp, lens, tables,
                                             scale=scale, **kw)
        ref32 = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                             lens, tables, scale=scale, **kw)
        for splits in PAGED_SPLITS:
            out = paged_decode_attention(q, kp, vp, lens, tables, splits=splits, **kw)
            sync()
            # The rule for each sequence on its own.
            ok, ratio, where = sliced_tolerance_check(out, ref16, ref32, lead=1)
            zero_row = float(out[lengths.index(0)].float().abs().max())
            err = float((out.float() - ref16.float()).abs().max())
            worst = max(worst, err)
            good = ok and zero_row == 0.0 and bool(torch.isfinite(out).all())
            print(f"paged_decode_attention {name} splits {splits or 'plan'}: "
                  f"max|kernel-plain| {err:.3e}, worst err/bound {ratio:.3f} at length "
                  f"{lengths[where[0]]}, length-0 row {zero_row} "
                  f"{'ok' if good else 'FAIL'}", flush=True)
            if not good:
                raise AssertionError(
                    f"paged_decode_attention {name} disagrees with its plain version")
    return worst


SERVE_PROMPT_LENS = (200, 513, 1024, 1500, 2048, 2500, 3000, 4000)
SERVE_NEW_TOKENS = 32
SERVE_PAGE_SIZE, SERVE_PAGES, SERVE_PAGES_PER_SEQ = 64, 257, 64
TEACHER_FORCED = (513, 2048)  # prompt lengths checked against forward()
SLACK = 0.05  # a served token's logit may sit this far below the row max


def _teacher_forced_gaps(params, cfg, prompt, generated, forward=None):
    """Teacher-force ``generated`` through the full-recompute ``forward``
    (``models.llama.forward`` by default): per served token, the row max
    minus the served token's logit, and each row's standard deviation over
    the vocabulary."""
    from flash_attention_from_scratch_tpu_torch.models.llama import forward as llama_forward

    toks = list(prompt) + list(generated[:-1])
    pad = len(toks) + (-len(toks)) % 64
    arr = torch.zeros((1, pad), dtype=torch.int64, device="cuda")
    arr[0, :len(toks)] = torch.tensor(toks, device="cuda")
    logits = (forward or llama_forward)(params, arr, cfg)[0]
    rows = logits[len(prompt) - 1:len(prompt) - 1 + len(generated)]
    if not torch.isfinite(rows).all():
        raise AssertionError("non-finite logits in the full-recompute forward")
    gen = torch.tensor(generated, device="cuda")
    gaps = rows.max(-1).values - rows.gather(1, gen[:, None])[:, 0]
    return gaps, rows.std(-1)


def _teacher_forced_check(params, cfg, prompt, generated):
    """Each served token must be a top-scoring choice of the full-recompute
    model: its logit within SLACK of the row max (random bf16 weights tie
    within an ulp, so exact argmax equality is too strict)."""
    gaps, _ = _teacher_forced_gaps(params, cfg, prompt, generated)
    worst = float(gaps.max())
    if worst > SLACK:
        raise AssertionError(f"served token {int(gaps.argmax())} of a "
                             f"{len(prompt)}-token prompt is {worst} below the max")
    return worst


def _warm_graphs(server, vocab: int, new_tokens: int) -> float:
    """Serve ``max_batch`` short prompts with the main run's budget, so that
    the server captures every decode graph the main run replays (the JAX
    server compiles its steps at first use just so); returns the wall
    seconds. Not part of the main path: the counts are set to 0 after."""
    rng = np.random.default_rng(99)
    t = time.perf_counter()
    for i in range(server.max_batch):
        server.submit(-1 - i, rng.integers(0, vocab, 64).tolist(), new_tokens)
    while server.has_work:
        server.step()
    sync()
    return time.perf_counter() - t


# GenerationServer.stats() counters that accumulate over a server's life.
RUN_COUNTERS = ("steps", "decode_steps", "decode_loops", "verify_steps", "decode_tokens",
                "prefill_tokens", "preemptions", "spec_proposed", "spec_accepted",
                "prefix_hit_pages")


def _drive(server, prompts, new_tokens: int, adapters=None) -> dict:
    """Serve ``prompts`` to the end (request ``sid`` on LoRA adapter
    ``adapters[sid]``, default -1), the launch counts set to 0 just before
    and read just after. Every logit the server picks from must be finite:
    the non-finite ones are summed on the card and read once at the end
    (those the host-side pick sees, the prefill's, by wrapping
    ``generate``'s ``pick_keyed``; those the graphs pick from on the card,
    every decode step, verify step and loop, by the server's graphs).
    Steps that prefill count as prefill time, the others as decode time."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.serving import generate

    nonfinite = torch.zeros((), dtype=torch.int64, device="cuda")
    plain = {name: getattr(generate, name) for name in ("pick_keyed",)}

    def checked(fn):
        def pick(logits, *args, **kw):
            nonfinite.add_((~torch.isfinite(logits)).sum())
            return fn(logits, *args, **kw)
        return pick

    for name, fn in plain.items():  # the host-side pick: prefill
        setattr(generate, name, checked(fn))
    graphs = server.graphs  # None under a mesh: every pick is host-side
    graph_nonfinite = graphs.nonfinite_logits() if graphs else 0
    replays = graphs.replays if graphs else 0
    stats0 = server.stats()
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()  # counts start at 0 just before the main path
    t_start = time.perf_counter()
    for sid, prompt in prompts.items():
        server.submit(sid, prompt, new_tokens, adapter=(adapters or {}).get(sid, -1))
    prefill_s = decode_s = 0.0
    decode_tokens = 0
    try:
        while server.has_work:
            before = server.stats()
            t = time.perf_counter()
            server.step()  # ends in a device-to-host copy of the tokens
            dt = time.perf_counter() - t
            after = server.stats()
            if after["prefill_tokens"] > before["prefill_tokens"]:
                prefill_s += dt
            else:
                decode_s += dt
                decode_tokens += after["decode_tokens"] - before["decode_tokens"]
    finally:
        for name, fn in plain.items():
            setattr(generate, name, fn)
    sync()
    wall = time.perf_counter() - t_start
    counts = dict(_build.launch_counts)  # read just after the main path
    stats = server.stats()  # the counters of this run alone
    for key in RUN_COUNTERS:
        stats[key] -= stats0[key]
    stats["spec_acceptance_rate"] = (stats["spec_accepted"] / stats["spec_proposed"]
                                     if stats["spec_proposed"] else 0.0)
    return {"prefill_s": prefill_s, "decode_s": decode_s, "stats": stats,
            "decode_tokens": decode_tokens, "wall_s": wall, "counts": counts,
            "nonfinite": int(nonfinite) + (graphs.nonfinite_logits() if graphs else 0)
            - graph_nonfinite,
            "replays": (graphs.replays if graphs else 0) - replays,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _clone_cache(cache):
    return dataclasses.replace(
        cache, k_pages=[p.clone() for p in cache.k_pages],
        v_pages=[p.clone() for p in cache.v_pages],
        k_scales=[p.clone() for p in cache.k_scales],
        v_scales=[p.clone() for p in cache.v_scales])


def _same_bits(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def graph_case(label, server, lengths, t: int) -> dict:
    """Two replayed steps (``StepGraphs.verify_step``) and two eager
    ``_step``s on two copies of the server's cache: each sequence's own
    pages, t new tokens at the end of ``lengths``, then t more at the end
    of ``lengths + t``. The first call captures (a side-stream warm-up that
    runs the eager step on the replayed copy, the capture, the replay); the
    second, on new tokens and lengths, only replays, so a page it fails to
    write or a length, position or plan frozen at capture shows. Logits of
    both calls, every page and every scale must be equal bit for bit (so
    the greedy tokens are too); prints the largest logit difference either
    way."""
    from flash_attention_from_scratch_tpu_torch.models.decode import _step
    from flash_attention_from_scratch_tpu_torch.models.step_graphs import StepGraphs

    cfg, ps = server.cfg, server.page_size
    batch = len(lengths)
    need = [-(-(n + t) // ps) for n in lengths]  # pages up to the second call's tokens
    per = max(need)
    if batch * per >= server.cache.num_pages or per > server.pages_per_seq:
        raise ValueError(f"graph case {label}: {batch} x {per} pages do not fit")
    tables = torch.full((batch, server.pages_per_seq), -1, dtype=torch.int32)
    for b, n in enumerate(need):
        tables[b, :n] = torch.arange(b * per, b * per + n)
    eager, replayed = _clone_cache(server.cache), _clone_cache(server.cache)
    graphs = StepGraphs(server.params, cfg, replayed, attn_int8=server.attn_int8)
    calls = []
    for call in range(2):
        tokens = torch.from_numpy(np.random.default_rng(7 + call).integers(
            0, cfg.vocab_size, (batch, t)))
        lens = torch.tensor(lengths, dtype=torch.int32) + call * t
        got = graphs.verify_step(tokens, lens, tables).clone()
        want, _ = _step(server.params, tokens.cuda(), cfg, eager, lens.cuda(),
                        tables.cuda(), None, None, server.attn_int8)
        calls.append({"max_logit_diff": float((got - want).abs().max()),
                      "logits_bitwise": _same_bits(got, want),
                      "tokens_equal": torch.equal(got.argmax(-1), want.argmax(-1))})
    pools = {name: all(_same_bits(a, b) for a, b in zip(getattr(replayed, name),
                                                         getattr(eager, name)))
             for name in ("k_pages", "v_pages", "k_scales", "v_scales")}
    line = {"case": label, "batch": batch, "t": t, "cache": server.cache.mode,
            "attn_int8": server.attn_int8, "captures": graphs.graphs,
            "replays": graphs.replays,
            "max_logit_diff": max(c["max_logit_diff"] for c in calls),
            "logits_bitwise": all(c["logits_bitwise"] for c in calls),
            "tokens_equal": all(c["tokens_equal"] for c in calls),
            "calls": calls, "pages_bitwise": pools}
    print(f"graph_case: {json.dumps(line)}", flush=True)
    del graphs, eager, replayed
    if (line["captures"], line["replays"]) != (1, 2):
        raise AssertionError(f"graph case {label}: {line['captures']} captures, "
                             f"{line['replays']} replays, not 1 and 2")
    if not (line["logits_bitwise"] and line["tokens_equal"] and all(pools.values())):
        raise AssertionError(f"graph case {label}: the replayed step differs from the "
                             "eager one")
    return line


def _graph_fields(server, run: dict, prof: dict) -> dict:
    """What a serve line says of the compiled step: captures, replays in
    the main run, host calls and the card's busy share a decode step in the
    profiled window (``device_busy_share``, one window's device time over
    its wall time). ``device_ms_profiled_over_counted_wall_ms`` is a ratio
    across two windows: the profiled window's device ms a step over the
    counted run's wall ms a step (the profiler's tracing slows the host, so
    the counted run's own share is not measured)."""
    steps = run["stats"]["decode_steps"] + run["stats"]["verify_steps"]
    wall_ms = 1e3 * run["decode_s"] / steps if steps else float("nan")
    return {"graphs": server.graphs.graphs, "replays": run["replays"],
            "host_calls_per_step": prof["host_calls_per_step"],
            "device_busy_share": prof["device_busy_share"],
            "decode_wall_ms_per_step": wall_ms,
            "device_ms_profiled_over_counted_wall_ms": prof["device_ms_per_step"] / wall_ms}


def _with_merges(want: dict, max_batch: int, pages_per_seq: int, page_size: int,
                 mode: str = "dense", i8c: bool = False, spec_k: int = 0,
                 kv_heads: int = KV_HEADS, group: int = HEADS // KV_HEADS,
                 d_head: int = D) -> dict:
    """``want`` (launches by kernel) plus the merge kernel's: one per K4/K5
    call where the plan at the server's padded batch (which every step
    has; the plan is a function of the shapes only) splits the walk, none
    where it takes one split (R1's 1-token pages: 2,032 table tokens).
    ``kv_heads``, ``group`` (Q heads a KV head) and ``d_head``: the
    model's, Llama-3-8B's by default."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        KERNEL_MERGE, MODE_INT8C, MODES, kernel_name, plan)
    from flash_attention_from_scratch_tpu_torch.utils.device import sm_count

    calls = 0
    for t in {1, spec_k + 1}:
        n = want.get(kernel_name(t, i8c), 0)
        if not n:
            continue
        p = plan(max_batch, kv_heads, group * t, pages_per_seq, page_size,
                 MODE_INT8C if i8c else MODES[mode][0], sm_count(torch.device("cuda")),
                 d_head=d_head)
        calls += n if p.splits > 1 else 0
    return {**want, KERNEL_MERGE: calls} if calls else want


def phase_serve(smi: str, dtype=torch.bfloat16) -> dict:
    """Serve LLAMA3_8B at full width and depth in ``dtype`` (bf16; fp16:
    ``serve_fp16``, ``LlamaConfig.dtype`` FP16, so K1, K4/K5 and the
    cache run in fp16); check counts and tokens."""
    from flash_attention_from_scratch_tpu_torch import (
        LLAMA3_8B, GenerationServer, init_params)
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP

    cfg = dataclasses.replace(LLAMA3_8B, dtype=DType.from_torch(dtype))
    name = "serve" if dtype == torch.bfloat16 else f"serve_{_dname(dtype)}"
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    server = GenerationServer(params, cfg, num_pages=SERVE_PAGES,
                              page_size=SERVE_PAGE_SIZE, max_batch=8,
                              pages_per_seq=SERVE_PAGES_PER_SEQ)
    sync()
    dtypes = {p.dtype for p in param_leaves(params)} | {server.cache.k_pages[0].dtype}
    print(f"{name}: LLAMA3_8B params {sum(p.numel() for p in param_leaves(params)) / 1e9:.2f} "
          f"B, KV pool {server.cache.nbytes() / 1e9:.2f} GB, set-up "
          f"{time.perf_counter() - t0:.1f} s, types {sorted(map(str, dtypes))}", flush=True)
    if dtypes != {dtype}:
        raise AssertionError(f"{name}: weights and pages in {dtypes}, not {dtype}")

    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(SERVE_PROMPT_LENS)}
    capture_s = _warm_graphs(server, cfg.vocab_size, SERVE_NEW_TOKENS)
    run = _drive(server, prompts, SERVE_NEW_TOKENS)
    prefill_s, decode_s = run["prefill_s"], run["decode_s"]
    decode_tokens, wall = run["decode_tokens"], run["wall_s"]
    nonfinite = run["nonfinite"]
    counts = run["counts"]
    stats = run["stats"]

    got = {sid: server.seqs[sid].generated for sid in prompts}
    if any(len(g) != SERVE_NEW_TOKENS for g in got.values()):
        raise AssertionError(f"token counts {[len(g) for g in got.values()]}")
    if int(nonfinite) != 0:
        raise AssertionError(f"{int(nonfinite)} non-finite logits while serving")
    if stats["preemptions"] != 0:
        raise AssertionError(f"{stats['preemptions']} preemptions")
    want = _with_merges({K1: cfg.n_layers * len(prompts),
                         KP: cfg.n_layers * stats["decode_steps"]}, 8,
                        SERVE_PAGES_PER_SEQ, SERVE_PAGE_SIZE)
    print(f"{name}: launches {counts}; expected {want} ({cfg.n_layers} layers x "
          f"{len(prompts)} prompts, {stats['decode_steps']} decode steps)", flush=True)
    if counts != want:
        raise AssertionError("a kernel of the main path ran the wrong number of times")

    for n in TEACHER_FORCED:
        sid = SERVE_PROMPT_LENS.index(n)
        gap = _teacher_forced_check(params, cfg, prompts[sid], got[sid])
        print(f"{name}: teacher-forced prompt {n}: {len(got[sid])} tokens, worst gap "
              f"{gap:.4f} <= {SLACK} ok", flush=True)

    cases = [graph_case(f"{_dname(dtype)} t{t}", server,
                        [min(n, 2000) + t for n in SERVE_PROMPT_LENS], t) for t in (1, 4)]
    prof = phase_profile(server, prompts, run=_dname(dtype))
    ttft = sorted(st.first_t - st.submit_t for sid, st in server.seqs.items()
                  if sid in prompts)
    serve = {
        "model": "LLAMA3_8B", "dtype": _dname(dtype), "layers": cfg.n_layers,
        "requests": len(prompts),
        "prompt_tokens": stats["prefill_tokens"],
        "new_tokens_per_request": SERVE_NEW_TOKENS,
        "prefill_tok_s": stats["prefill_tokens"] / prefill_s,
        "decode_tok_s": decode_tokens / decode_s,
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
        "wall_s": wall, "steps": stats["steps"],
        "decode_steps": stats["decode_steps"],
        "peak_mem_gb": run["peak_mem_gb"], **_graph_fields(server, run, prof),
        "warm_up_s": capture_s, "graph_cases": cases,
        "launches": counts, "gpu": smi,
    }
    print(json.dumps({name: serve}), flush=True)
    return {"server": server, "prompts": prompts, "counts": counts, "line": serve}


def phase_profile(server, prompts, steps: int = 4, run: str = "bf16", split=None,
                  adapters=None) -> dict:
    """Where a full-width decode step's time goes, from torch.profiler.

    Serves the same prompts again (after the counted main-path run; request
    ``sid`` on adapter ``adapters[sid]``) and traces ``steps`` server steps
    after the prefills (each a decode or verify step, or with ``chunk`` a
    decode loop of ``chunk`` steps): device time by kernel and host calls
    (graph replays, kernel launches, copies) per model step, and the
    device's busy share of the wall time; ``split`` moves shares of named
    kernels to a class of their own (``_profile``). Prints the ``profile``
    line and returns it.
    """
    for sid, prompt in prompts.items():
        server.submit(1000 + sid, prompt, steps * server.chunk + 1,
                      adapter=(adapters or {}).get(sid, -1))
    server.step()  # the prefills
    before = server.stats()
    prof = _profile(lambda: [server.step() for _ in range(steps)], top=8, split=split)
    after = server.stats()
    n = sum(after[k] - before[k] for k in ("decode_steps", "verify_steps"))
    while server.has_work:
        server.step()
    line = {
        "run": run, "server_steps": steps, "model_steps": n,
        "wall_ms_per_step": prof["wall_ms"] / n,
        "device_ms_per_step": prof["device_ms"] / n,
        "device_busy_share": prof["device_busy_share"],
        "launches_per_step": prof["launches"] / n,
        "host_calls_per_step": prof["host_calls"] / n,
        "host_calls_by_kind_per_step": {k: c / n for k, c in prof["host_calls_by_kind"].items()},
        "device_ms_per_step_by_class": {
            k: ms / n for k, ms in prof["device_ms_by_class"].items()},
        "top_kernels_ms_per_step": {
            k: ms / n for k, ms in prof["top_kernels_ms"].items()},
    }
    print(json.dumps({"profile": line}), flush=True)
    return line


SPEC_PHRASE = 37  # tokens of the phrase a speculative run's prompts repeat


def _phrase_prompts(lengths, vocab: int, seed: int) -> dict:
    """One prompt per length, each a random 37-token phrase repeated up to
    that length, so prompt lookup finds drafts."""
    rng = np.random.default_rng(seed)
    prompts = {}
    for i, n in enumerate(lengths):
        phrase = rng.integers(0, vocab, SPEC_PHRASE).tolist()
        prompts[i] = (phrase * (n // SPEC_PHRASE + 1))[:n]
    return prompts


def _spec_line(stats, run) -> dict:
    """The speculative counters of a run, and its tokens per verify step."""
    verify = stats["verify_steps"]
    return {"verify_steps": verify, "decode_steps": stats["decode_steps"],
            "spec_proposed": stats["spec_proposed"], "spec_accepted": stats["spec_accepted"],
            "spec_acceptance_rate": stats["spec_acceptance_rate"],
            "tokens_per_verify_step": (run["decode_tokens"] / verify) if verify else None}


def phase_serve_spec(params, smi: str) -> dict:
    """Speculative serving of LLAMA3_8B at full width (SERVE_CUT_LAYERS
    layers) on phase (4)'s bf16 parameters: spec_k = 3, 8 requests of phrase-repeating
    prompts at SERVE_PROMPT_LENS, 32 greedy tokens each. Checks the token
    counts, finite logits, that drafts were proposed, the launch counts
    (K1 per prefill, the multi-token K4/K5 per verify step and layer, the
    single-token one per plain decode step) and two requests teacher-forced
    through ``forward``. The acceptance rate of a random-weight model is
    reported, not asserted."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, GenerationServer
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        KERNEL as KP, KERNEL_MULTI)

    params, cfg = _first_layers(params, LLAMA3_8B, SERVE_CUT_LAYERS)
    server = GenerationServer(params, cfg, num_pages=SERVE_PAGES,
                              page_size=SERVE_PAGE_SIZE, max_batch=8,
                              pages_per_seq=SERVE_PAGES_PER_SEQ, spec_k=SPEC_K)
    prompts = _phrase_prompts(SERVE_PROMPT_LENS, cfg.vocab_size, seed=1)
    capture_s = _warm_graphs(server, cfg.vocab_size, SERVE_NEW_TOKENS)
    run = _drive(server, prompts, SERVE_NEW_TOKENS)
    counts, stats = run["counts"], run["stats"]
    got = {sid: server.seqs[sid].generated for sid in prompts}
    if any(len(g) != SERVE_NEW_TOKENS for g in got.values()):
        raise AssertionError(f"serve_spec: token counts {[len(g) for g in got.values()]}")
    if run["nonfinite"] or stats["preemptions"]:
        raise AssertionError(f"serve_spec: {run['nonfinite']} non-finite logits, "
                             f"{stats['preemptions']} preemptions")
    if stats["verify_steps"] == 0 or stats["spec_proposed"] == 0:
        raise AssertionError(f"serve_spec: nothing was speculated: {stats}")
    want = {K1: cfg.n_layers * len(prompts),
            KERNEL_MULTI: cfg.n_layers * stats["verify_steps"]}
    if stats["decode_steps"]:
        want[KP] = cfg.n_layers * stats["decode_steps"]
    want = _with_merges(want, 8, SERVE_PAGES_PER_SEQ, SERVE_PAGE_SIZE, spec_k=SPEC_K)
    print(f"serve_spec: launches {counts}; expected {want} ({cfg.n_layers} layers x "
          f"{stats['verify_steps']} verify + {stats['decode_steps']} decode steps)",
          flush=True)
    if counts != want:
        raise AssertionError("serve_spec: a kernel of the path ran the wrong number of times")
    for n in TEACHER_FORCED:
        sid = SERVE_PROMPT_LENS.index(n)
        gap = _teacher_forced_check(params, cfg, prompts[sid], got[sid])
        print(f"serve_spec: teacher-forced prompt {n}: {len(got[sid])} tokens, worst gap "
              f"{gap:.4f} <= {SLACK} ok", flush=True)
    prof = phase_profile(server, prompts, run="spec")
    line = {
        "model": "LLAMA3_8B", "layers": cfg.n_layers, "requests": len(prompts),
        "spec_k": SPEC_K, "prompt_tokens": sum(map(len, prompts.values())),
        "new_tokens_per_request": SERVE_NEW_TOKENS,
        "decode_tok_s": run["decode_tokens"] / run["decode_s"],
        "prefill_tok_s": stats["prefill_tokens"] / run["prefill_s"],
        "wall_s": run["wall_s"], **_spec_line(stats, run),
        "peak_mem_gb": run["peak_mem_gb"], **_graph_fields(server, run, prof),
        "warm_up_s": capture_s, "launches": counts, "gpu": smi,
    }
    print(json.dumps({"serve_spec": line}), flush=True)
    return {"counts": counts, "verify_lengths": [n + 1 + SPEC_K for n in SERVE_PROMPT_LENS]}


CHUNK, PREFILL_CHUNK = 8, 1024  # serve_chunk: decode loop length, prefill chunk
# serve_spec, serve_chunk (since PR 24), serve_sample, serve_prefix and
# serve_lora run the bf16 model's first SERVE_CUT_LAYERS layers (the same
# weights): the smoke's time limit. The bf16 and fp16 serve runs keep all 32.
SERVE_CUT_LAYERS = 8


def _first_layers(params, cfg, n: int):
    """The model cut to its first ``n`` layers: the same tensors, no copy."""
    return {**params, "layers": params["layers"][:n]}, dataclasses.replace(cfg, n_layers=n)


def _fuse_in_place(params) -> None:
    """``fuse_projections`` one layer at a time, each unfused layer dropped
    as soon as its fused one exists: 16 GB of bf16 weights never sit on the
    card twice."""
    from flash_attention_from_scratch_tpu_torch import fuse_projections

    for i, layer in enumerate(params["layers"]):
        params["layers"][i] = fuse_projections({"layers": [layer]})["layers"][0]
    del layer
    torch.cuda.empty_cache()


def phase_serve_chunk(params, smi: str) -> dict:
    """LLAMA3_8B at full width (SERVE_CUT_LAYERS layers) on fused projections
    (``fuse_projections`` of phase (4)'s weights), served as the JAX
    package's serving bench runs it: ``chunk=8`` (greedy decode loops,
    each one CUDA graph) and ``prefill_chunk_tokens=1024`` at page 64, the
    8 prompts of SERVE_PROMPT_LENS, 32 greedy tokens each. Checks the token
    counts, finite logits, K1's launches (32 per prefill chunk), K4/K5's
    and its merge's (counted on replay: one per layer and model step),
    and every request teacher-forced through ``forward``."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, GenerationServer
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP

    params, cfg = _first_layers(params, LLAMA3_8B, SERVE_CUT_LAYERS)
    server = GenerationServer(params, cfg, num_pages=SERVE_PAGES,
                              page_size=SERVE_PAGE_SIZE, max_batch=8,
                              pages_per_seq=SERVE_PAGES_PER_SEQ, chunk=CHUNK,
                              prefill_chunk_tokens=PREFILL_CHUNK)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(SERVE_PROMPT_LENS)}
    capture_s = _warm_graphs(server, cfg.vocab_size, SERVE_NEW_TOKENS)
    run = _drive(server, prompts, SERVE_NEW_TOKENS)
    counts, stats = run["counts"], run["stats"]
    got = {sid: server.seqs[sid].generated for sid in prompts}
    if any(len(g) != SERVE_NEW_TOKENS for g in got.values()):
        raise AssertionError(f"serve_chunk: token counts {[len(g) for g in got.values()]}")
    if run["nonfinite"] or stats["preemptions"]:
        raise AssertionError(f"serve_chunk: {run['nonfinite']} non-finite logits, "
                             f"{stats['preemptions']} preemptions")
    if stats["decode_loops"] == 0:
        raise AssertionError(f"serve_chunk: no decode loop ran: {stats}")
    chunks = sum(-(-n // PREFILL_CHUNK) for n in SERVE_PROMPT_LENS)
    want = _with_merges({K1: cfg.n_layers * chunks,
                         KP: cfg.n_layers * stats["decode_steps"]}, 8,
                        SERVE_PAGES_PER_SEQ, SERVE_PAGE_SIZE)
    print(f"serve_chunk: launches {counts}; expected {want} ({cfg.n_layers} layers x "
          f"{chunks} prefill chunks, {stats['decode_steps']} decode steps in "
          f"{stats['decode_loops']} loops)", flush=True)
    if counts != want:
        raise AssertionError("serve_chunk: a kernel of the path ran the wrong number of times")
    worst = 0.0
    for sid, prompt in prompts.items():
        worst = max(worst, _teacher_forced_check(params, cfg, prompt, got[sid]))
    print(f"serve_chunk: teacher-forced every request: worst gap {worst:.4f} <= {SLACK} ok",
          flush=True)
    prof = phase_profile(server, prompts, run="chunk")
    ttft = sorted(server.seqs[sid].first_t - server.seqs[sid].submit_t for sid in prompts)
    line = {
        "model": "LLAMA3_8B", "layers": cfg.n_layers, "fused": True,
        "requests": len(prompts), "chunk": CHUNK, "prefill_chunk_tokens": PREFILL_CHUNK,
        "page_size": SERVE_PAGE_SIZE, "prompt_tokens": stats["prefill_tokens"],
        "new_tokens_per_request": SERVE_NEW_TOKENS,
        "prefill_tok_s": stats["prefill_tokens"] / run["prefill_s"],
        "decode_tok_s": run["decode_tokens"] / run["decode_s"],
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
        "wall_s": run["wall_s"], "decode_steps": stats["decode_steps"],
        "decode_loops": stats["decode_loops"], "prefill_chunks": chunks,
        "teacher_forced_worst_gap": worst, "peak_mem_gb": run["peak_mem_gb"],
        **_graph_fields(server, run, prof), "warm_up_s": capture_s,
        "launches": counts, "gpu": smi,
    }
    print(json.dumps({"serve_chunk": line}), flush=True)
    return {"counts": counts}


class _Fp32Reference:
    """The model in fp32 on its bf16 weights, for a reference: every
    projection as an fp32 product, the attention by the plain version in
    fp32, the embedding rows in fp32 (``models.llama``'s ``_mm`` and
    ``flash_forward``, ``models.decode``'s ``_embed``, replaced inside the
    ``with``). Use with an fp32 ``LlamaConfig`` (fp32 pages)."""

    def __enter__(self):
        from flash_attention_from_scratch_tpu_torch.models import decode, llama
        from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
            flash_forward_plain)

        self.saved = (llama._mm, llama.flash_forward, decode._embed)
        llama._mm = lambda x, w: x.float() @ w.float()
        llama.flash_forward = lambda q, k, v, cfg, sinks=None: flash_forward_plain(
            q, k, v, cfg, sinks)[0]
        decode._embed = lambda params, tokens, cfg: params["embed"][tokens].float()
        return self

    def __exit__(self, *exc):
        from flash_attention_from_scratch_tpu_torch.models import decode, llama

        llama._mm, llama.flash_forward, decode._embed = self.saved


PREFILL_CASE_LEN = 4000


def prefill_chunked_case(params) -> dict:
    """One 4000-token prompt at full width and depth, dense cache at page
    64: ``prefill_chunked`` (1024-token chunks, K1 with q_offset over
    [prefix | chunk]) against ``prefill`` (one K1 call a layer), the
    reference the same model in fp32 (``_Fp32Reference``): the logits by
    the adaptive rule, every layer's K and V pages by it in each 64-row
    band (page) on its own."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, DType
    from flash_attention_from_scratch_tpu_torch.models.decode import (
        init_cache, prefill, prefill_chunked)
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        adaptive_tolerance_check, sliced_tolerance_check)

    cfg = LLAMA3_8B
    n_pages = -(-PREFILL_CASE_LEN // SERVE_PAGE_SIZE)
    toks = torch.zeros((1, PREFILL_CASE_LEN + (-PREFILL_CASE_LEN) % 128), dtype=torch.long)
    toks[0, :PREFILL_CASE_LEN] = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, PREFILL_CASE_LEN))
    toks, table = toks.cuda(), torch.arange(n_pages, dtype=torch.int32, device="cuda")
    out = {}
    for name, fn, c in (("chunked", prefill_chunked, cfg), ("one_shot", prefill, cfg),
                        ("fp32", prefill, dataclasses.replace(cfg, dtype=DType.FP32))):
        kw = dict(chunk_tokens=PREFILL_CHUNK) if fn is prefill_chunked else {}
        cache = init_cache(c, n_pages, SERVE_PAGE_SIZE)
        with _Fp32Reference() if name == "fp32" else contextlib.nullcontext():
            logits, cache = fn(params, toks, c, cache, table,
                               prompt_len=PREFILL_CASE_LEN, **kw)
        pages = torch.stack([torch.stack(p) for p in (cache.k_pages, cache.v_pages)])
        out[name] = (logits, pages)  # pages (2, layers, kvh, pages, 64, d)
        del cache
    ok, err, bound = adaptive_tolerance_check(out["chunked"][0], out["one_shot"][0],
                                              out["fp32"][0])
    pages_ok, ratio, where = sliced_tolerance_check(
        *(out[k][1].flatten(0, 1) for k in ("chunked", "one_shot", "fp32")), lead=3)
    line = {"prompt": PREFILL_CASE_LEN, "chunk_tokens": PREFILL_CHUNK,
            "logit_err": err, "logit_bound": bound,
            "logit_max_diff": float((out["chunked"][0] - out["one_shot"][0]).abs().max()),
            "pages_worst_err_bound": ratio, "pages_worst_at": where}
    print(f"prefill_chunked_case: {json.dumps(line)}", flush=True)
    if not (ok and pages_ok):
        raise AssertionError("prefill_chunked disagrees with prefill beyond the rule")
    return line


SAMPLE_VOCAB, SAMPLE_BATCH = 128256, 16  # sampler_case: Llama-3's vocabulary
SAMPLE_DRAWS, SAMPLE_FREQ_BOUND = 20_000, 0.015
TEMPERATURE, TOP_K = 0.8, 50  # serve_sample


def sampler_case() -> dict:
    """The samplers on the card against the CPU: the noise source's
    integers for a (16 x 128,256) block in each of its three streams bit
    for bit, ``sample_token`` on the same logits (ties included) and noise
    token for token (greedy, temperature 0.8 with top-50 and without), and
    20,000 sampled draws of a fixed 16-token distribution within 0.015 of
    each softmax probability. Times one batch-16 sampled pick (noise, top-k
    filter, argmax) and the greedy argmax by CUDA events."""
    from flash_attention_from_scratch_tpu_torch.models.decode import (
        STREAM_SAMPLE, noise_bits, row_keys, sample_noise, sample_token)

    keys = row_keys(0, torch.arange(SAMPLE_BATCH) - 3)
    pos = torch.arange(SAMPLE_BATCH) * 5
    for stream in (0, 1, 2):
        want = noise_bits(keys, pos, stream, SAMPLE_VOCAB)
        got = noise_bits(keys.cuda(), pos.cuda(), stream, SAMPLE_VOCAB)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"sampler_case: stream {stream}'s bits differ on the card")
    logits = torch.from_numpy(np.round(np.random.default_rng(11).standard_normal(
        (SAMPLE_BATCH, SAMPLE_VOCAB)).astype(np.float32) * 8) / 8)
    _, gumbel = sample_noise(keys, pos, STREAM_SAMPLE, SAMPLE_VOCAB)
    for temperature, top_k in ((0.0, 0), (TEMPERATURE, TOP_K), (TEMPERATURE, 0)):
        want = sample_token(logits, gumbel, temperature, top_k)
        got = sample_token(logits.cuda(), gumbel.cuda(), temperature, top_k)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"sampler_case: sample_token differs on the card at "
                                 f"temperature {temperature}, top_k {top_k}")
    small = torch.from_numpy(np.random.default_rng(12).standard_normal(16).astype(
        np.float32)).cuda()
    _, g = sample_noise(row_keys(1, torch.zeros(SAMPLE_DRAWS, dtype=torch.int64)).cuda(),
                        torch.arange(SAMPLE_DRAWS, device="cuda"), STREAM_SAMPLE, 16)
    toks = sample_token(small.expand(SAMPLE_DRAWS, 16), g, 1.0, 0)
    freq = torch.bincount(toks, minlength=16).double() / SAMPLE_DRAWS
    worst = float((freq - torch.softmax(small.double(), -1)).abs().max())
    if worst >= SAMPLE_FREQ_BOUND:
        raise AssertionError(f"sampler_case: a frequency is {worst} from its probability")
    lg, kc, pc = logits.cuda(), keys.cuda(), pos.cuda()
    pick_ms = 1e3 * median_runtime(lambda: sample_token(
        lg, sample_noise(kc, pc, STREAM_SAMPLE, SAMPLE_VOCAB)[1], TEMPERATURE, TOP_K))
    noise_ms = 1e3 * median_runtime(lambda: sample_noise(kc, pc, STREAM_SAMPLE, SAMPLE_VOCAB))
    line = {"batch": SAMPLE_BATCH, "vocab": SAMPLE_VOCAB, "bits_bitwise": True,
            "sample_token_equal": True, "draws": SAMPLE_DRAWS,
            "worst_freq_err": worst, "freq_bound": SAMPLE_FREQ_BOUND,
            "sampled_pick_ms": pick_ms, "noise_ms": noise_ms,
            "greedy_pick_ms": 1e3 * median_runtime(lambda: lg.argmax(-1))}
    print(f"sampler_case: {json.dumps(line)}", flush=True)
    return line


def _teacher_forced_topk(params, cfg, prompt, generated, sid: int) -> tuple[float, float]:
    """Holds the sampled tokens of sequence ``sid`` (seed 0, TEMPERATURE,
    TOP_K) to its full-recompute logits. Returns (the worst k-th largest
    logit minus the token's logit, the worst row max of the sampling score
    minus the token's score), the score being what the server's pick
    maximizes: ``top_k_filter(logits) / TEMPERATURE`` plus the Gumbels of
    (row_keys(0, sid), position i) for token i. The first may reach SLACK
    and the second SLACK / TEMPERATURE (the served and recomputed bf16
    logits differ in their last bits; a tie at the k-th value is 0): a
    server that drew with another temperature, key or position, or
    greedily, fails the second."""
    from flash_attention_from_scratch_tpu_torch.models.decode import (
        STREAM_SAMPLE, row_keys, sample_noise, top_k_filter)
    from flash_attention_from_scratch_tpu_torch.models.llama import forward

    toks = list(prompt) + list(generated[:-1])
    arr = torch.zeros((1, len(toks) + (-len(toks)) % 64), dtype=torch.int64, device="cuda")
    arr[0, :len(toks)] = torch.tensor(toks, device="cuda")
    rows = forward(params, arr, cfg)[0][len(prompt) - 1:len(prompt) - 1 + len(generated)]
    if not torch.isfinite(rows).all():
        raise AssertionError("non-finite logits in the full-recompute forward")
    rows = rows.float()
    gen = torch.tensor(generated, device="cuda")[:, None]
    kth = torch.topk(rows, TOP_K, dim=-1).values[:, -1]
    got = rows.gather(1, gen)[:, 0]
    n = len(generated)
    _, gumbel = sample_noise(row_keys(0, torch.full((n,), sid)).cuda(),
                             torch.arange(n, device="cuda"), STREAM_SAMPLE, cfg.vocab_size)
    best = (top_k_filter(rows, TOP_K) / TEMPERATURE + gumbel).max(-1).values
    served = (rows / TEMPERATURE + gumbel).gather(1, gen)[:, 0]
    return float((kth - got).max()), float((best - served).max())


def _serve_run(label, server, prompts, smi, extra=None, adapters=None) -> dict:
    """One counted serving run (``_drive``) and its line's common fields."""
    run = _drive(server, prompts, SERVE_NEW_TOKENS, adapters)
    stats = run["stats"]
    got = {sid: list(server.seqs[sid].generated) for sid in prompts}
    if any(len(g) != SERVE_NEW_TOKENS for g in got.values()):
        raise AssertionError(f"{label}: token counts {[len(g) for g in got.values()]}")
    if run["nonfinite"] or stats["preemptions"]:
        raise AssertionError(f"{label}: {run['nonfinite']} non-finite logits, "
                             f"{stats['preemptions']} preemptions")
    ttft = sorted(server.seqs[sid].first_t - server.seqs[sid].submit_t for sid in prompts)
    for sid in prompts:
        del server.seqs[sid]  # the next run reuses the ids
    return {"run": run, "tokens": got, "line": {
        "decode_tok_s": (run["decode_tokens"] / run["decode_s"]) if run["decode_s"] else None,
        "prefill_tok_s": stats["prefill_tokens"] / run["prefill_s"],
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
        "wall_s": run["wall_s"], "decode_steps": stats["decode_steps"],
        "decode_loops": stats["decode_loops"], "replays": run["replays"],
        "prefix_hit_pages": stats["prefix_hit_pages"], **(extra or {}), "gpu": smi}}


def phase_serve_sample(params, smi: str) -> dict:
    """Sampled serving of LLAMA3_8B at full width (SERVE_CUT_LAYERS layers) on the fused
    weights of ``serve_chunk``: the 8 prompts of SERVE_PROMPT_LENS, 32
    tokens each at temperature 0.8, top-k 50, seed 0, whole-prompt prefill,
    served at chunk 1 (a sampled decode graph a step, the pick inside) and
    at chunk 8 (sampled loop graphs). Checks that the two give the same
    tokens, no non-finite logit, the launch counts of K1 and K4/K5 (and its
    merge) in each, and that every token of two requests lies in the top
    50 of its full-recompute logits and is the best-scoring draw of its
    key and position there (``_teacher_forced_topk``). Then times chunk 8
    greedy against sampled, alternated (sampled, greedy, sampled, greedy;
    the first sampled run is the checked one; its tokens must differ from
    the greedy turn's), and profiles a sampled step and loop."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, GenerationServer
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP

    params, cfg = _first_layers(params, LLAMA3_8B, SERVE_CUT_LAYERS)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(SERVE_PROMPT_LENS)}

    def server(chunk, temperature):
        s = GenerationServer(params, cfg, num_pages=SERVE_PAGES, page_size=SERVE_PAGE_SIZE,
                             max_batch=8, pages_per_seq=SERVE_PAGES_PER_SEQ, chunk=chunk,
                             temperature=temperature, top_k=TOP_K, seed=0)
        return s, _warm_graphs(s, cfg.vocab_size, SERVE_NEW_TOKENS)

    lines, tokens, counts = {}, {}, {}
    for chunk in (1, CHUNK):
        s, warm = server(chunk, TEMPERATURE)
        out = _serve_run(f"serve_sample chunk {chunk}", s, prompts, smi,
                         {"chunk": chunk, "warm_up_s": warm})
        stats = out["run"]["stats"]
        want = _with_merges({K1: cfg.n_layers * len(prompts),
                             KP: cfg.n_layers * stats["decode_steps"]}, 8,
                            SERVE_PAGES_PER_SEQ, SERVE_PAGE_SIZE)
        counts[chunk] = out["run"]["counts"]
        print(f"serve_sample: chunk {chunk} launches {counts[chunk]}; expected {want}",
              flush=True)
        if counts[chunk] != want:
            raise AssertionError(f"serve_sample chunk {chunk}: a kernel of the path ran "
                                 "the wrong number of times")
        if chunk == CHUNK and stats["decode_loops"] == 0:
            raise AssertionError("serve_sample: no sampled decode loop ran")
        tokens[chunk] = out["tokens"]
        prof = phase_profile(s, prompts, run=f"sample chunk {chunk}")
        lines[chunk] = {**out["line"], **_graph_fields(s, out["run"], prof),
                        "device_ms_per_step_by_class": prof["device_ms_per_step_by_class"]}
        if chunk == CHUNK:
            sampled8 = s
        else:
            del s
    if tokens[1] != tokens[CHUNK]:
        diff = [sid for sid in prompts if tokens[1][sid] != tokens[CHUNK][sid]]
        raise AssertionError(f"serve_sample: chunk 1 and chunk {CHUNK} differ for {diff}")
    worst = score_worst = 0.0
    for n in TEACHER_FORCED:
        sid = SERVE_PROMPT_LENS.index(n)
        gap, score_gap = _teacher_forced_topk(params, cfg, prompts[sid], tokens[1][sid], sid)
        worst, score_worst = max(worst, gap), max(score_worst, score_gap)
    print(f"serve_sample: teacher-forced top-{TOP_K}: worst gap below the k-th logit "
          f"{worst:.4f} <= {SLACK}; worst score below the row's best "
          f"{score_worst:.4f} <= {SLACK / TEMPERATURE}", flush=True)
    if worst > SLACK:
        raise AssertionError(f"serve_sample: a token lies {worst} below its top {TOP_K}")
    if score_worst > SLACK / TEMPERATURE:
        raise AssertionError(f"serve_sample: a token's sampling score lies {score_worst} "
                             "below its row's best: not the draw of its key and position")
    greedy8, _ = server(CHUNK, 0.0)
    turns, greedy_tokens = [], None
    for name, s in (("greedy", greedy8), ("sampled", sampled8), ("greedy", greedy8)):
        out = _serve_run(f"serve_sample {name} turn", s, prompts, smi)
        turns.append((name, out["line"]["decode_tok_s"]))
        if name == "greedy" and greedy_tokens is None:
            greedy_tokens = out["tokens"]
    del greedy8, sampled8
    differ = sum(a != b for sid in prompts
                 for a, b in zip(tokens[CHUNK][sid], greedy_tokens[sid]))
    print(f"serve_sample: {differ} of {len(prompts) * SERVE_NEW_TOKENS} sampled tokens "
          "differ from the greedy turn's", flush=True)
    if differ == 0:
        raise AssertionError("serve_sample: the sampled server served the greedy tokens")
    line = {"model": "LLAMA3_8B", "layers": cfg.n_layers, "fused": True,
            "requests": len(prompts), "temperature": TEMPERATURE, "top_k": TOP_K,
            "seed": 0, "new_tokens_per_request": SERVE_NEW_TOKENS,
            "tokens_equal_chunk_1_8": True, "teacher_forced_topk_worst_gap": worst,
            "teacher_forced_score_worst_gap": score_worst,
            "score_gap_bound": SLACK / TEMPERATURE, "tokens_differing_from_greedy": differ,
            "runs": {str(c): l for c, l in lines.items()},
            "chunk8_decode_tok_s_turns": [("sampled", lines[CHUNK]["decode_tok_s"])] + turns,
            "launches": counts[1], "launches_chunk8": counts[CHUNK], "gpu": smi}
    print(json.dumps({"serve_sample": line}), flush=True)
    return {"counts": counts}


PREFIX_SHARED, PREFIX_TAILS = 2048, (256, 1024, 384, 896, 512, 768, 640, 300)


def phase_serve_prefix(params, smi: str) -> dict:
    """The prefix cache at full width (SERVE_CUT_LAYERS layers; bf16, the
    fused weights): one request publishes a 2,048-token prefix (32 pages of
    64), then 8 requests share it with distinct 256-1,024-token tails, 32
    greedy tokens each. Checks 8 x 32 = 256 pages claimed (the pool evicts
    nothing), K1's launches (one a layer and suffix chunk of 128 tokens
    actually computed; K4/K5 and its merge a layer and decode step) and two requests
    teacher-forced through ``forward``. Then times prefill tokens/s and
    TTFT without the cache, with it, and with it at
    ``prefill_chunk_tokens=1024`` (one suffix chunk a request), on new
    tails each run (the shared prefix alone is published for them): one
    untimed run of each server that has not yet prefilled such prompts,
    then in turns without, with, with 1024, with 1024, with, without."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, GenerationServer
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP

    params, cfg = _first_layers(params, LLAMA3_8B, SERVE_CUT_LAYERS)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, PREFIX_SHARED).tolist()
    publisher = shared + rng.integers(0, cfg.vocab_size, 100).tolist()

    def new_prompts():  # the same tail lengths, new tokens
        return {i: shared + rng.integers(0, cfg.vocab_size, n).tolist()
                for i, n in enumerate(PREFIX_TAILS)}

    servers = {}
    for name, kw in (("none", {}), ("cache", dict(prefix_cache=True)),
                     ("cache_1024", dict(prefix_cache=True, prefill_chunk_tokens=1024))):
        s = GenerationServer(params, cfg, num_pages=SERVE_PAGES, page_size=SERVE_PAGE_SIZE,
                             max_batch=8, pages_per_seq=SERVE_PAGES_PER_SEQ, **kw)
        warm = _warm_graphs(s, cfg.vocab_size, SERVE_NEW_TOKENS)
        s.submit(-100, publisher, 1)
        while s.has_work:  # prefilled and published before the counted run
            s.step()
        servers[name] = (s, warm)
    s, warm = servers["cache"]
    prompts = new_prompts()
    out = _serve_run("serve_prefix", s, prompts, smi, {"cache": True, "warm_up_s": warm})
    stats, counts = out["run"]["stats"], out["run"]["counts"]
    hits = stats["prefix_hit_pages"]
    pages = PREFIX_SHARED // SERVE_PAGE_SIZE
    if hits != len(prompts) * pages:
        raise AssertionError(f"serve_prefix: {hits} pages claimed, not "
                             f"{len(prompts)} x {pages}")
    chunk = s._pc_chunk
    suffix_chunks = sum(-(-n // chunk) for n in PREFIX_TAILS)
    want = _with_merges({K1: cfg.n_layers * suffix_chunks,
                         KP: cfg.n_layers * stats["decode_steps"]}, 8,
                        SERVE_PAGES_PER_SEQ, SERVE_PAGE_SIZE)
    print(f"serve_prefix: launches {counts}; expected {want} ({cfg.n_layers} layers x "
          f"{suffix_chunks} suffix chunks of {chunk} tokens)", flush=True)
    if counts != want:
        raise AssertionError("serve_prefix: a kernel of the path ran the wrong number of times")
    worst = max(_teacher_forced_check(params, cfg, prompts[sid], out["tokens"][sid])
                for sid in (0, 1))
    print(f"serve_prefix: teacher-forced two requests: worst gap {worst:.4f} <= {SLACK} ok",
          flush=True)
    turns = []
    for name in ("none", "cache_1024", "none", "cache", "cache_1024", "cache_1024",
                 "cache", "none"):
        r = _serve_run("serve_prefix turn", servers[name][0], new_prompts(), smi)["line"]
        if r["prefix_hit_pages"] != (len(prompts) * pages if name != "none" else 0):
            raise AssertionError(f"serve_prefix: a turn claimed {r['prefix_hit_pages']} pages")
        turns.append({"server": name, "prefill_tok_s": r["prefill_tok_s"],
                      "ttft_p50_s": r["ttft_p50_s"], "prefix_hit_pages": r["prefix_hit_pages"]})
    del servers, s
    line = {"model": "LLAMA3_8B", "layers": cfg.n_layers, "fused": True,
            "shared_prefix": PREFIX_SHARED, "tails": list(PREFIX_TAILS),
            "page_size": SERVE_PAGE_SIZE, "suffix_chunk_tokens": chunk,
            "prefix_hit_pages": hits, "suffix_chunks": suffix_chunks,
            "teacher_forced_worst_gap": worst, **out["line"],
            "untimed_first_runs": turns[:2], "turns": turns[2:],
            "launches": counts}
    print(json.dumps({"serve_prefix": line}), flush=True)
    return {"counts": counts}


LORA_ADAPTERS, LORA_RANK, LORA_SCALE = 4, 16, 0.3
LORA_IDS = (-1, 0, 1, 2, 3, 0, 1, -1)  # the adapter of each SERVE_PROMPT_LENS request
LORA_SLACK = 0.1  # an adapter row's bound against its merged weights (tests/test_lora.py)
LORA_CLASS = "LoRA gathers and products"


def _lora_stack(cfg, n: int, seed: int = 0):
    """``n`` adapters of rank 16 on every attention projection, B drawn
    non-zero (``zero_b=False``), both factors scaled by 0.3 as the JAX
    package's LoRA test scales them."""
    from flash_attention_from_scratch_tpu_torch import init_lora_adapters

    lora = init_lora_adapters(cfg, n, LORA_RANK, torch.Generator(device="cuda").manual_seed(seed),
                              zero_b=False)
    lora["layers"] = [{k: (a * LORA_SCALE, b * LORA_SCALE) for k, (a, b) in layer.items()}
                      for layer in lora["layers"]]
    return lora


def _lora_gaps(params, cfg, lora, prompts, tokens, adapters, by_std: bool) -> dict:
    """Each request's served tokens teacher-forced through ``forward`` on
    its adapter's merged weights (``merged_params``: W + alpha A_i B_i, one
    adapter at a time) or, for adapter -1, on the base weights. Returns
    {adapter: worst gap}, the gap below the row max in logits or, with
    ``by_std``, in row standard deviations."""
    from flash_attention_from_scratch_tpu_torch.models.lora import merged_params

    worst = {}
    for a in sorted(set(adapters.values())):
        model = params if a < 0 else merged_params(params, lora, a)
        for sid in (s for s, x in adapters.items() if x == a):
            gaps, std = _teacher_forced_gaps(model, cfg, prompts[sid], tokens[sid])
            worst[a] = max(worst.get(a, 0.0), float((gaps / std if by_std else gaps).max()))
        del model
        torch.cuda.empty_cache()
    return worst


def _kernel_counts(fn):
    """Launches by kernel name of one call of ``fn``, from torch.profiler."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return collections.Counter({
        e.key: e.count for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)})


def _split_by_counts(with_fn, without_fn, label: str) -> dict:
    """{kernel name: (label, share)} for ``_profile``'s split: a kernel
    launched n times by one call of ``with_fn`` and n_base times by one of
    ``without_fn`` (each profiled once after a call outside the window) is
    ``label``'s for a share (n - n_base) / n of its time."""
    counts = {}
    for name, fn in (("with", with_fn), ("without", without_fn)):
        fn()  # one-time set-up outside the window
        counts[name] = _kernel_counts(fn)
    return {k: (label, (n - counts["without"][k]) / n) for k, n in counts["with"].items()
            if n > counts["without"][k]}


def _lora_split(params, cfg, lora) -> dict:
    """Which kernels of a LoRA decode step are the adapters': one eager
    decode step of 8 rows (adapters LORA_IDS) with ``lora`` and one without,
    on the same inputs and a small cache, each profiled. A kernel name
    launched n_lora times with and n_base times without is the adapters'
    for a share (n_lora - n_base) / n_lora of its time ({name: (LORA_CLASS,
    share)}, for ``_profile``'s split): the gathers and the two skinny
    products of every adapted projection, and whatever they share a kernel
    with. Eager and replayed steps launch the same kernels."""
    from flash_attention_from_scratch_tpu_torch.models.decode import decode_step, init_cache

    batch = len(LORA_IDS)
    cache = init_cache(cfg, batch + 1, SERVE_PAGE_SIZE)
    tables = torch.arange(batch, dtype=torch.int32, device="cuda")[:, None]
    tokens = torch.arange(batch, device="cuda")
    lengths = torch.full((batch,), 10, dtype=torch.int32, device="cuda")
    ids = torch.tensor(LORA_IDS, device="cuda")

    def step(**kw):
        decode_step(params, tokens, cfg, cache, lengths, tables, **kw)

    return _split_by_counts(lambda: step(lora=lora, adapter_ids=ids), step, LORA_CLASS)


def lora_graph_case(label, server, lengths) -> dict:
    """With the server's adapters: a greedy decode step by ``pick_step``
    replay (t = 1) and a loop of CHUNK steps by replay, against the eager
    ``_step`` with ``pick_keyed`` and ``decode_loop`` on two copies of the
    server's cache, two calls each, the second of each (only a replay) on
    other adapter ids, tokens and lengths. The tokens must be equal and
    every page and scale bit for bit."""
    from flash_attention_from_scratch_tpu_torch.models.decode import (
        _step, decode_loop, pick_keyed)
    from flash_attention_from_scratch_tpu_torch.models.step_graphs import StepGraphs

    cfg, ps = server.cfg, server.page_size
    batch = len(lengths)
    need = [-(-(n + 2 + 2 * CHUNK) // ps) for n in lengths]
    per = max(need)
    if batch * per >= server.cache.num_pages or per > server.pages_per_seq:
        raise ValueError(f"lora graph case {label}: {batch} x {per} pages do not fit")
    tables = torch.full((batch, server.pages_per_seq), -1, dtype=torch.int32)
    for b, n in enumerate(need):
        tables[b, :n] = torch.arange(b * per, b * per + n)
    eager, replayed = _clone_cache(server.cache), _clone_cache(server.cache)
    graphs = StepGraphs(server.params, cfg, replayed, attn_int8=server.attn_int8,
                        lora=server.lora)
    zeros = torch.zeros(batch, dtype=torch.int64)
    id_calls = (list(LORA_IDS[:batch]), [(i % (LORA_ADAPTERS + 1)) - 1 for i in range(batch)][::-1])
    rng = np.random.default_rng(17)
    equal = []
    for call, ids in enumerate(id_calls):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, 1)))
        lens = torch.tensor(lengths, dtype=torch.int32) + call + 1
        got, n_emit = graphs.pick_step(tokens, lens, tables, zeros, zeros, zeros,
                                       torch.tensor(ids))
        logits, _ = _step(server.params, tokens.cuda(), cfg, eager, lens.cuda(), tables.cuda(),
                          server.lora, None, server.attn_int8, torch.tensor(ids).cuda())
        want, want_n = pick_keyed(logits, tokens[:, 1:].cuda(), zeros.cuda(), zeros.cuda(),
                                  zeros.cuda(), 0.0, 0)
        equal.append(torch.equal(got, want) and torch.equal(n_emit, want_n))
    for call, ids in enumerate(id_calls):
        first = torch.from_numpy(rng.integers(0, cfg.vocab_size, batch))
        lens = torch.tensor(lengths, dtype=torch.int32) + 2 + call * CHUNK
        got, _ = graphs.decode_loop(first, lens, tables, CHUNK, adapter_ids=torch.tensor(ids))
        want, _, _ = decode_loop(server.params, first.cuda(), cfg, eager, lens.cuda(),
                                 tables.cuda(), CHUNK, lora=server.lora,
                                 adapter_ids=torch.tensor(ids).cuda())
        equal.append(torch.equal(got, want))
    pools = {name: all(_same_bits(a, b) for a, b in zip(getattr(replayed, name),
                                                         getattr(eager, name)))
             for name in ("k_pages", "v_pages", "k_scales", "v_scales")}
    line = {"case": label, "batch": batch, "loop_steps": CHUNK, "adapter_ids": id_calls,
            "captures": graphs.graphs, "replays": graphs.replays,
            "tokens_equal": {"pick_step": equal[:2], "loop": equal[2:]}, "pages_bitwise": pools}
    print(f"graph_case: {json.dumps(line)}", flush=True)
    del graphs, eager, replayed
    if (line["captures"], line["replays"]) != (2, 4):
        raise AssertionError(f"lora graph case {label}: {line['captures']} captures, "
                             f"{line['replays']} replays, not 2 and 4")
    if not (all(equal) and all(pools.values())):
        raise AssertionError(f"lora graph case {label}: a replayed LoRA step differs from "
                             "the eager one")
    return line


def phase_serve_lora(params, smi: str) -> dict:
    """Multi-LoRA serving of LLAMA3_8B at full width (SERVE_CUT_LAYERS layers) on the fused
    weights: 4 adapters of rank 16 (``_lora_stack``, seed 0), the 8
    prompts of SERVE_PROMPT_LENS on adapters LORA_IDS (two on the base
    model), 32 greedy tokens each at page 64, served at chunk 1 (a LoRA
    decode graph a step, the ids a static input) and at chunk 8 (LoRA loop
    graphs). Checks: the launch counts of K1 and K4/K5 (and its merge) in
    each run, no non-finite logit, equal tokens at chunk 1 and 8, every
    adapter row teacher-forced through ``forward`` on its adapter's merged
    weights within LORA_SLACK of the row max and every base row on the base
    weights within SLACK, at least one adapter row serving other tokens
    than the server without adapters, and the replayed LoRA step and loop
    equal to the eager ones (``lora_graph_case``). Profiles 4 decode steps
    at chunk 1 and 8 with the adapters' kernels in a class of their own
    (``_lora_split``), and times chunk 8 with and without the adapters in
    alternated turns (lora, base, lora, base; the first lora run is the
    checked one)."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, GenerationServer
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP

    params, cfg = _first_layers(params, LLAMA3_8B, SERVE_CUT_LAYERS)
    lora = _lora_stack(cfg, LORA_ADAPTERS)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(SERVE_PROMPT_LENS)}
    adapters = dict(enumerate(LORA_IDS))
    split = _lora_split(params, cfg, lora)

    def server(chunk, with_lora=True):
        s = GenerationServer(params, cfg, num_pages=SERVE_PAGES, page_size=SERVE_PAGE_SIZE,
                             max_batch=8, pages_per_seq=SERVE_PAGES_PER_SEQ, chunk=chunk,
                             lora=lora if with_lora else None)
        return s, _warm_graphs(s, cfg.vocab_size, SERVE_NEW_TOKENS)

    lines, tokens, counts = {}, {}, {}
    for chunk in (1, CHUNK):
        s, warm = server(chunk)
        out = _serve_run(f"serve_lora chunk {chunk}", s, prompts, smi,
                         {"chunk": chunk, "warm_up_s": warm}, adapters)
        stats = out["run"]["stats"]
        want = _with_merges({K1: cfg.n_layers * len(prompts),
                             KP: cfg.n_layers * stats["decode_steps"]}, 8,
                            SERVE_PAGES_PER_SEQ, SERVE_PAGE_SIZE)
        counts[chunk] = out["run"]["counts"]
        print(f"serve_lora: chunk {chunk} launches {counts[chunk]}; expected {want}",
              flush=True)
        if counts[chunk] != want:
            raise AssertionError(f"serve_lora chunk {chunk}: a kernel of the path ran the "
                                 "wrong number of times")
        if chunk == CHUNK and stats["decode_loops"] == 0:
            raise AssertionError("serve_lora: no LoRA decode loop ran")
        tokens[chunk] = out["tokens"]
        prof = phase_profile(s, prompts, run=f"lora chunk {chunk}", split=split,
                             adapters=adapters)
        lines[chunk] = {**out["line"], **_graph_fields(s, out["run"], prof),
                        "launches_per_step": prof["launches_per_step"],
                        "device_ms_per_step_by_class": prof["device_ms_per_step_by_class"]}
        if chunk == 1:
            case = lora_graph_case("lora bf16 t1 and loop", s,
                                   [min(n, 2000) + 1 for n in SERVE_PROMPT_LENS])
            del s
        else:
            lora8 = s
    if tokens[1] != tokens[CHUNK]:
        diff = [sid for sid in prompts if tokens[1][sid] != tokens[CHUNK][sid]]
        raise AssertionError(f"serve_lora: chunk 1 and chunk {CHUNK} differ for {diff}")
    worst = _lora_gaps(params, cfg, lora, prompts, tokens[1], adapters, by_std=False)
    print(f"serve_lora: teacher-forced on merged weights, worst gap by adapter {worst}; "
          f"bounds {LORA_SLACK} (adapters), {SLACK} (base)", flush=True)
    if any(g > (SLACK if a < 0 else LORA_SLACK) for a, g in worst.items()):
        raise AssertionError(f"serve_lora: a served token lies too far below its "
                             f"merged-weight row max: {worst}")
    base8, warm = server(CHUNK, with_lora=False)
    turns, base_tokens = [("lora", lines[CHUNK]["decode_tok_s"])], None
    for name, s in (("base", base8), ("lora", lora8), ("base", base8)):
        out = _serve_run(f"serve_lora {name} turn", s, prompts, smi,
                         adapters=adapters if name == "lora" else None)
        turns.append((name, out["line"]["decode_tok_s"]))
        if name == "base" and base_tokens is None:
            base_tokens = out["tokens"]
    del base8, lora8
    differ = [sid for sid, a in adapters.items() if a >= 0 and tokens[1][sid] != base_tokens[sid]]
    same_base = all(tokens[1][sid] == base_tokens[sid] for sid, a in adapters.items() if a < 0)
    print(f"serve_lora: {len(differ)} of {sum(a >= 0 for a in LORA_IDS)} adapter rows serve "
          f"other tokens than the server without adapters; base rows equal its tokens: "
          f"{same_base}", flush=True)
    if not differ:
        raise AssertionError("serve_lora: every adapter row served the base model's tokens")
    rates = {name: [r for n, r in turns if n == name] for name in ("lora", "base")}
    line = {"model": "LLAMA3_8B", "layers": cfg.n_layers, "fused": True,
            "requests": len(prompts), "adapters": LORA_ADAPTERS, "rank": LORA_RANK,
            "adapter_ids": list(LORA_IDS), "new_tokens_per_request": SERVE_NEW_TOKENS,
            "page_size": SERVE_PAGE_SIZE, "tokens_equal_chunk_1_8": True,
            "teacher_forced_worst_gap_by_adapter": {str(a): g for a, g in worst.items()},
            "adapter_rows_differing_from_base_server": differ,
            "base_rows_equal_base_server": same_base,
            "runs": {str(c): l for c, l in lines.items()},
            "chunk8_decode_tok_s_turns": turns,
            "chunk8_lora_over_base_decode_tok_s": (min(rates["lora"]) / max(rates["base"]),
                                                   max(rates["lora"]) / min(rates["base"])),
            "lora_split_kernels": {k: v[1] for k, v in split.items()},
            "graph_case": case, "launches": counts[1], "launches_chunk8": counts[CHUNK],
            "gpu": smi}
    print(json.dumps({"serve_lora": line}), flush=True)
    return {"counts": counts}


# Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1 config.json);
# the serving phase cuts the depth to 8 layers (23.7 GB of bf16 weights; 32
# layers would be ~93 GB), training to 1 (the smoke's time limit: its
# checkpoint round trip writes and reads the whole state).
MOE_LAYERS, MOE_TRAIN_LAYERS = 8, 1
MOE_CLASS = "experts (router, dispatch, FFN, combine)"
# A route that differs between the server and the recompute must be a
# near-tie: the recompute's gates of the experts kept apart within this
# (probability) of each other.
ROUTE_MARGIN = 0.02
DROPLESS_PROMPT_LENS = (100, 200, 300, 400, 513, 700, 900, 1024)


def _mixtral(n_layers: int, **extra):
    from flash_attention_from_scratch_tpu_torch.models.moe import MoEConfig

    return MoEConfig(vocab_size=32000, dim=4096, n_layers=n_layers, n_heads=32,
                     n_kv_heads=8, d_head=128, hidden_dim=14336, rope_theta=1e6,
                     norm_eps=1e-5, n_experts=8, expert_top_k=2, router_aux_weight=0.02,
                     **extra)


def _moe_logits(params, arr, cfg):
    from flash_attention_from_scratch_tpu_torch.models.moe import moe_forward

    return moe_forward(params, arr, cfg)[0]


@contextlib.contextmanager
def _recorded_routes():
    """Within the block, every ``models.moe._route`` call (eager only: a graph
    replay runs no Python) appends (gates (T, E) fp32, kept routes (T, E)
    bool: the experts that took the row in a slot) to the yielded list."""
    from flash_attention_from_scratch_tpu_torch.models import moe

    real, log = moe._route, []

    def recording(cfg, gates, capacity):
        dispatch, combine, aux = real(cfg, gates, capacity)
        log.append((gates.detach().float(), dispatch.sum(-1) > 0))
        return dispatch, combine, aux

    moe._route = recording
    try:
        yield log
    finally:
        moe._route = real


def _routing_check(params, cfg, prompts, tokens) -> dict:
    """The served tokens against ``moe_forward``, route by route.

    Replays the server's computation eagerly (each prompt prefilled padded
    to 128, then decode steps of all requests in one batch of the server's
    shapes, fed the served tokens), which gives the served tokens again
    (checked), recording each row's routes at every layer; then
    teacher-forces every request through ``moe_forward``, recording its
    routes. A request's first route that differs between a decode row and
    the recompute (in step, then layer order) has inputs that agree up to
    bf16 rounding (8 rows against T in the products before it, K4/K5
    against K1), so the router must have sat on a near-tie there: its
    margin, the recompute's gate gap between the experts the two sides kept
    apart, must be within ROUTE_MARGIN. Every later difference follows from
    it (a row routed elsewhere has another hidden state, and later rows
    attend to it). A served token whose upstream rows all routed alike must
    lie within SLACK of the recompute's row max; the tokens from a
    request's first difference on are reported. Returns the counts, worst
    gaps and first margins."""
    from flash_attention_from_scratch_tpu_torch.models import decode

    batch, ps = len(prompts), SERVE_PAGE_SIZE
    sids = sorted(prompts)
    per = max(-(-(len(prompts[s]) + len(tokens[s])) // ps) for s in sids)
    if batch * per > SERVE_PAGES:
        raise ValueError(f"routing check: {batch} x {per} pages do not fit")
    cache = decode.init_cache(cfg, SERVE_PAGES, ps)
    tables = torch.full((batch, SERVE_PAGES_PER_SEQ), -1, dtype=torch.int32, device="cuda")
    for b in range(batch):
        tables[b, :per] = torch.arange(b * per, (b + 1) * per, device="cuda")
    steps = len(tokens[sids[0]]) - 1
    decode_routes = []  # [step][layer] -> (gates (batch, E), kept)
    with torch.no_grad():
        for b, sid in enumerate(sids):
            p = prompts[sid]
            arr = torch.zeros((1, len(p) + (-len(p)) % 128), dtype=torch.int64, device="cuda")
            arr[0, :len(p)] = torch.tensor(p, device="cuda")
            decode.prefill(params, arr, cfg, cache, tables[b], prompt_len=len(p))
        lengths = torch.tensor([len(prompts[s]) for s in sids], dtype=torch.int32,
                               device="cuda")
        replayed = True
        for i in range(steps):
            toks = torch.tensor([tokens[s][i] for s in sids], device="cuda")
            with _recorded_routes() as log:
                logits, _ = decode.decode_step(params, toks, cfg, cache, lengths + i + 1, tables)
            decode_routes.append(log)
            replayed &= logits.argmax(-1).tolist() == [tokens[s][i + 1] for s in sids]
    if not replayed:
        raise AssertionError("routing check: the eager replay of the decode steps picks "
                             "other tokens than the server")
    agreed_gap, diverged_gap, margins, diverged_tokens, divergences = 0.0, 0.0, [], 0, 0
    for b, sid in enumerate(sids):
        p, g = prompts[sid], tokens[sid]
        with _recorded_routes() as log:
            gaps, _ = _teacher_forced_gaps(params, cfg, p, g, _moe_logits)
        first = len(g)
        for i in range(steps):  # decode step i: the row of g[i] at position len(p) + i
            row = len(p) + i
            for layer, (gates, kept) in enumerate(log):
                if torch.equal(kept[row], decode_routes[i][layer][1][b]):
                    continue
                divergences += 1
                if first == len(g):  # the request's first: its inputs agreed
                    apart = kept[row] ^ decode_routes[i][layer][1][b]
                    margins.append(float(gates[row][apart].max() - gates[row][apart].min()))
                    first = i + 1
        agreed_gap = max([agreed_gap] + gaps[:first].tolist())
        diverged_gap = max([diverged_gap] + gaps[first:].tolist())
        diverged_tokens += len(g) - first
    return {"agreed_worst_gap": agreed_gap, "diverged_worst_gap": diverged_gap,
            "tokens": sum(len(t) for t in tokens.values()), "diverged_tokens": diverged_tokens,
            "divergences": divergences, "requests_diverging": len(margins),
            "largest_first_margin": max(margins, default=0.0), "first_margins": margins}


def _recompute_gaps(params, cfg, prompt, generated) -> list:
    """The JAX MoE test's teacher forcing: each served token against
    ``moe_forward`` on the prompt and the tokens before it, padded to 128
    as the server pads a prompt (one recompute a token). Returns the gaps
    below the row max."""
    gaps, toks = [], list(prompt)
    for g in generated:
        arr = torch.zeros((1, len(toks) + (-len(toks)) % 128), dtype=torch.int64,
                          device="cuda")
        arr[0, :len(toks)] = torch.tensor(toks, device="cuda")
        row = _moe_logits(params, arr, cfg)[0, len(toks) - 1]
        if not torch.isfinite(row).all():
            raise AssertionError("non-finite logits in the MoE recompute")
        gaps.append(float(row.max() - row[g]))
        toks.append(g)
    return gaps


def _expert_split(params, cfg) -> dict:
    """Which kernels of a MoE decode step are the experts' (routing,
    dispatch, the expert FFN and combine): one eager decode step of 8 rows
    on a small cache with the experts and one with the MoE MLP replaced by
    zeros (``models/decode.py::_mlp``), by their launch counts."""
    from flash_attention_from_scratch_tpu_torch.models import decode

    batch = 8
    cache = decode.init_cache(cfg, batch + 1, SERVE_PAGE_SIZE)
    tables = torch.arange(batch, dtype=torch.int32, device="cuda")[:, None]
    tokens = torch.arange(batch, device="cuda")
    lengths = torch.full((batch,), 10, dtype=torch.int32, device="cuda")

    def step():
        decode.decode_step(params, tokens, cfg, cache, lengths, tables)

    def without_experts():
        real = decode._mlp
        decode._mlp = lambda layer, h, cfg: torch.zeros_like(h)
        try:
            step()
        finally:
            decode._mlp = real

    return _split_by_counts(step, without_experts, MOE_CLASS)


def _expert_bytes(cfg) -> int:
    """Bytes of every layer's expert weights: what a dense-dispatch decode
    step reads whatever the batch (every expert runs on its slots)."""
    return cfg.n_layers * 3 * cfg.n_experts * cfg.dim * cfg.hidden_dim * 2


def phase_serve_moe(smi: str) -> dict:
    """Serve Mixtral-8x7B's widths at MOE_LAYERS layers (random bf16
    weights, seed 0): the 8 prompts of SERVE_PROMPT_LENS, 32 greedy tokens
    each at page 64, at chunk 1 and at chunk 8 (the routing inside the
    decode and loop graphs; each decode step routes its whole padded batch
    of 8 rows: 8 slots an expert, nothing dropped). Checks: the launch
    counts of K1 and K4/K5 (and its merge), no non-finite logit, every
    request's first token (the prefill's pick) within SLACK of the JAX MoE
    test's recompute (``moe_forward`` on the prompt padded to 128: the same
    rows under the same capacity), a MoE decode and verify step replayed
    equal to the eager ones (``graph_case``). That recompute of every token
    of the two TEACHER_FORCED requests is reported beside the layers at
    which it drops a served row's route; whether chunk 1 and 8 serve equal
    tokens is reported, not forced. Profiles 4 decode steps at each chunk
    with the experts a class of their own (``_expert_split``). Then a second
    server with capacity_factor = n_experts / top_k = 4.0 (C >= T: dropless,
    as Mixtral itself routes) serves 8 prompts of at most 1,024 tokens,
    held to ``moe_forward`` route by route (``_routing_check``)."""
    from flash_attention_from_scratch_tpu_torch import GenerationServer, init_moe_params
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP

    cfg = _mixtral(MOE_LAYERS)
    t0 = time.perf_counter()
    params = init_moe_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in param_leaves(params))
    print(f"serve_moe: Mixtral-8x7B widths x {cfg.n_layers} layers, params "
          f"{n_params / 1e9:.2f} B, set-up {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(SERVE_PROMPT_LENS)}
    split = _expert_split(params, cfg)

    def serve(label, server_cfg, chunk, prompts):
        s = GenerationServer(params, server_cfg, num_pages=SERVE_PAGES,
                             page_size=SERVE_PAGE_SIZE, max_batch=8,
                             pages_per_seq=SERVE_PAGES_PER_SEQ, chunk=chunk)
        warm = _warm_graphs(s, cfg.vocab_size, SERVE_NEW_TOKENS)
        out = _serve_run(label, s, prompts, smi, {"chunk": chunk, "warm_up_s": warm})
        stats = out["run"]["stats"]
        want = _with_merges({K1: cfg.n_layers * len(prompts),
                             KP: cfg.n_layers * stats["decode_steps"]}, 8,
                            SERVE_PAGES_PER_SEQ, SERVE_PAGE_SIZE)
        print(f"{label}: launches {out['run']['counts']}; expected {want}", flush=True)
        if out["run"]["counts"] != want:
            raise AssertionError(f"{label}: a kernel of the path ran the wrong number "
                                 "of times")
        return s, out

    lines, tokens, counts = {}, {}, {}
    for chunk in (1, CHUNK):
        s, out = serve(f"serve_moe chunk {chunk}", cfg, chunk, prompts)
        if chunk == CHUNK and out["run"]["stats"]["decode_loops"] == 0:
            raise AssertionError("serve_moe: no MoE decode loop ran")
        tokens[chunk], counts[chunk] = out["tokens"], out["run"]["counts"]
        prof = phase_profile(s, prompts, run=f"moe chunk {chunk}", split=split)
        lines[chunk] = {**out["line"], **_graph_fields(s, out["run"], prof),
                        "launches_per_step": prof["launches_per_step"],
                        "device_ms_per_step": prof["device_ms_per_step"],
                        "device_ms_per_step_by_class": prof["device_ms_per_step_by_class"]}
        if chunk == 1:
            cases = [graph_case(f"moe t{t}", s, [min(n, 2000) + t for n in SERVE_PROMPT_LENS],
                                t) for t in (1, 4)]
        del s
    differ = [sid for sid in prompts if tokens[1][sid] != tokens[CHUNK][sid]]
    print(f"serve_moe: chunk 1 and chunk {CHUNK} tokens equal: {not differ} "
          f"(differing requests {differ})", flush=True)

    # The default capacity: each request's first token (the prefill's pick)
    # is the recompute's at the same padded length and capacity; later
    # tokens, recomputed as the JAX MoE test does, route their own rows
    # under a capacity the decode step (8 rows, 8 slots an expert) never hit.
    first_gap = max(_recompute_gaps(params, cfg, prompts[sid], tokens[1][sid][:1])[0]
                    for sid in prompts)
    recomputed = {}
    for n in TEACHER_FORCED:
        sid = SERVE_PROMPT_LENS.index(n)
        with _recorded_routes() as log:
            gaps = _recompute_gaps(params, cfg, prompts[sid], tokens[1][sid])
        # The served row of each recompute is its last real row.
        rows = [len(prompts[sid]) + i - 1 for i in range(len(tokens[1][sid]))]
        dropped = [sum(int((kept[row].sum() < cfg.expert_top_k)) for _, kept in
                       log[i * cfg.n_layers:(i + 1) * cfg.n_layers])
                   for i, row in enumerate(rows)]
        recomputed[n] = {"gaps": gaps, "served_rows_with_a_dropped_route": sum(
            d > 0 for d in dropped), "layers_dropping_by_token": dropped}
    print(f"serve_moe: first tokens within {first_gap} of the recompute (bound {SLACK}); "
          f"the JAX test's recompute of every token: {json.dumps(recomputed)}", flush=True)
    if first_gap > SLACK:
        raise AssertionError(f"serve_moe: a prefill's token lies {first_gap} below the "
                             "recompute's row max")

    dropless_cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.expert_top_k)
    short = {i: rng.integers(0, cfg.vocab_size, n).tolist()
             for i, n in enumerate(DROPLESS_PROMPT_LENS)}
    s, out = serve("serve_moe dropless", dropless_cfg, 1, short)
    del s
    routing = _routing_check(params, dropless_cfg, short, out["tokens"])
    print(f"serve_moe dropless: {json.dumps(routing)}; bounds {SLACK} where the routes "
          f"agree, margins {ROUTE_MARGIN}", flush=True)
    if routing["agreed_worst_gap"] > SLACK:
        raise AssertionError(f"serve_moe dropless: a served token lies "
                             f"{routing['agreed_worst_gap']} below the recompute's row max "
                             "with every route alike")
    if routing["largest_first_margin"] > ROUTE_MARGIN:
        raise AssertionError(f"serve_moe dropless: a request's first differing route has "
                             f"a gate margin of {routing['largest_first_margin']}, not a "
                             "near-tie")
    bound_ms = 1e3 * _expert_bytes(cfg) / PEAK_BYTES_PER_S
    line = {"model": "Mixtral-8x7B widths", "layers": cfg.n_layers, "params": n_params,
            "requests": len(prompts), "new_tokens_per_request": SERVE_NEW_TOKENS,
            "page_size": SERVE_PAGE_SIZE, "capacity_factor": cfg.capacity_factor,
            "tokens_equal_chunk_1_8": not differ, "requests_differing_chunk_1_8": differ,
            "first_token_worst_gap": first_gap,
            "jax_test_recompute": {str(k): v for k, v in recomputed.items()},
            "dropless": {**out["line"], "capacity_factor": dropless_cfg.capacity_factor,
                         "prompt_lens": list(DROPLESS_PROMPT_LENS), "routing": routing},
            "runs": {str(c): l for c, l in lines.items()},
            "expert_weight_gb": _expert_bytes(cfg) / 1e9,
            "expert_bytes_bound_ms_per_step": bound_ms,
            "expert_split_kernels": {k[:80]: v[1] for k, v in split.items()},
            "graph_cases": cases, "launches": counts[1], "launches_chunk8": counts[CHUNK],
            "launches_dropless": out["run"]["counts"], "gpu": smi}
    print(json.dumps({"serve_moe": line}), flush=True)
    return {"counts": {**{str(c): n for c, n in counts.items()},
                       "dropless": out["run"]["counts"]}}


def phase_train_moe(smi: str, ckpt_dir: str) -> dict:
    """Train Mixtral-8x7B's widths at MOE_TRAIN_LAYERS layers: batch 2 x
    2048 tokens, TRAIN_STEPS AdamW steps (``make_optimizer``) on
    ``moe_loss_fn`` through autograd (the attention backward K3, the
    default). Checks finite, falling losses, a non-zero router gradient and
    the launch counts of K1 and K3. Then the checkpoint round trip: save
    {"params", "opt"} under ``ckpt_dir``, take one more step, restore, take
    that step again: the loss and every parameter must equal the first
    time's bit for bit. Returns the launch counts of the counted steps."""
    from flash_attention_from_scratch_tpu_torch import (
        init_moe_params, make_optimizer, moe_loss_fn)
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED, fused_choice)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    cfg = _mixtral(MOE_TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = init_moe_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = make_optimizer(params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).to("cuda")

    def step():
        opt.zero_grad(set_to_none=True)
        loss = moe_loss_fn(params, tokens, cfg)
        loss.backward()
        opt.step()
        return float(loss.detach())

    sync()
    n_params = sum(p.numel() for p in param_leaves(params))
    print(f"train_moe: Mixtral-8x7B widths x {cfg.n_layers} layers, params "
          f"{n_params / 1e9:.3f} B, set-up {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()  # counts start at 0 just before the main path
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses.append(step())
        sync()
        step_s.append(time.perf_counter() - t)
    counts = dict(_build.launch_counts)  # read just after the main path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fused = fused_choice(causal=True)
    bwd = (KERNEL_FUSED,) if fused else (KERNEL_DKV, KERNEL_DQ)
    want = {n: TRAIN_STEPS * cfg.n_layers if n in (K1,) + bwd else 0
            for n in (K1, KERNEL_FUSED, KERNEL_DKV, KERNEL_DQ)}
    router_grad = max(float(layer["router"].grad.abs().max()) for layer in params["layers"])
    print(f"train_moe: losses {losses}, step s {[round(x, 4) for x in step_s]}, "
          f"launches {counts}; expected {want}; router grad max {router_grad}", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_moe: losses {losses} are not finite and falling")
    if any(counts.get(n, 0) != c for n, c in want.items()):
        raise AssertionError("train_moe: a kernel of the path ran the wrong number of times")
    if not router_grad > 0:
        raise AssertionError("train_moe: the router got no gradient")

    # The checkpoint round trip of this state.
    t = time.perf_counter()
    save_checkpoint(ckpt_dir, {"params": params, "opt": opt.state_dict()}, TRAIN_STEPS)
    save_s = time.perf_counter() - t
    loss_a = step()
    after = [p.detach().clone() for p in param_leaves(params)]
    opt.zero_grad(set_to_none=True)
    t = time.perf_counter()
    restored = restore_checkpoint(ckpt_dir, {"params": params, "opt": opt.state_dict()})
    with torch.no_grad():
        for p, r in zip(param_leaves(params), param_leaves(restored["params"])):
            p.copy_(r)
    opt.load_state_dict(restored["opt"])
    del restored
    sync()
    restore_s = time.perf_counter() - t
    loss_b = step()
    same = all(torch.equal(a, p.detach()) for a, p in zip(after, param_leaves(params)))
    ckpt = {"loss_without": loss_a, "loss_after_restore": loss_b, "params_bitwise": same,
            "state_gb": (n_params * 2 * 3) / 1e9, "save_s": save_s, "restore_s": restore_s}
    print(f"checkpoint: {json.dumps(ckpt)}", flush=True)
    if loss_a != loss_b or not same:
        raise AssertionError("checkpoint: the step after restore differs from the step "
                             "without the round trip")
    step_ms = 1e3 * float(np.median(step_s[1:]))
    print(json.dumps({"train_moe": {
        "model": "Mixtral-8x7B widths", "layers": cfg.n_layers, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "backward": "fused" if fused else "split", "losses": losses,
        "router_grad_max": router_grad, "step_ms": step_ms,
        "step_ms_all": [1e3 * x for x in step_s],
        "train_tok_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
        "peak_mem_gb": peak_gb, "launches": counts, "checkpoint": ckpt, "gpu": smi}}),
        flush=True)
    return {"counts": counts}


def _write_safetensors(path: str, tensors: dict) -> None:
    """``tensors`` as one ``.safetensors`` file (the format that
    ``models/convert.py::read_safetensors`` reads): an 8-byte little-endian
    header length, the JSON header padded to 8 bytes, then the bytes."""
    names = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())


def _hf_llama_state_dict(params, cfg) -> dict:
    """The HF names and (out, in) layouts of a Llama parameter tree."""
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"].T.contiguous()}
    names = {"attn_norm": "input_layernorm", "wq": "self_attn.q_proj",
             "wk": "self_attn.k_proj", "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "mlp_norm": "post_attention_layernorm", "w_gate": "mlp.gate_proj",
             "w_up": "mlp.up_proj", "w_down": "mlp.down_proj"}
    for i, layer in enumerate(params["layers"]):
        for k, name in names.items():
            w = layer[k]
            sd[f"model.layers.{i}.{name}.weight"] = w if w.dim() == 1 else w.T.contiguous()
    return sd


# Gemma-2-27B's widths (google/gemma-2-27b config.json), cut to 4 layers.
GEMMA2_27B_HF = dict(vocab_size=256000, hidden_size=4608, num_hidden_layers=4,
                     num_attention_heads=32, num_key_value_heads=16, head_dim=128,
                     intermediate_size=36864, rope_theta=10000.0, rms_norm_eps=1e-6,
                     query_pre_attn_scalar=144, sliding_window=4096,
                     attn_logit_softcapping=50.0, final_logit_softcapping=30.0)
GEMMA2_PROMPT_LENS = (5000, 300, 700, 1200)
CONVERT_NEW_TOKENS = 16  # tokens a request in the convert phase's serving runs


def _gemma2_state_dict(hf, gen, embed_std: float | None = None,
                       final_norm: float = 0.0) -> dict:
    """A random Gemma-2 state dict with HF's names and (out, in) layouts on
    the card, bf16: projections normal / sqrt(in), the embedding normal x
    ``embed_std`` (default 1 / sqrt(hidden); the model scales it by
    sqrt(hidden)), norm weights normal x 0.1 (Gemma scales by 1 + weight),
    the final norm's plus ``final_norm``."""
    d, hd = hf["hidden_size"], hf["head_dim"]
    q, kv, h = hf["num_attention_heads"] * hd, hf["num_key_value_heads"] * hd, \
        hf["intermediate_size"]

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    sd = {"model.embed_tokens.weight": normal((hf["vocab_size"], d), embed_std or d ** -0.5),
          "model.norm.weight": (normal((d,), 0.1).float() + final_norm).to(torch.bfloat16)}
    for i in range(hf["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (q, d)), ("self_attn.k_proj", (kv, d)),
                            ("self_attn.v_proj", (kv, d)), ("self_attn.o_proj", (d, q)),
                            ("mlp.gate_proj", (h, d)), ("mlp.up_proj", (h, d)),
                            ("mlp.down_proj", (d, h))):
            sd[pre + name + ".weight"] = normal(shape, shape[1] ** -0.5)
        for name in ("input_layernorm", "post_attention_layernorm",
                     "pre_feedforward_layernorm", "post_feedforward_layernorm"):
            sd[pre + name + ".weight"] = normal((d,), 0.1)
    return sd


def phase_convert(smi: str, ckpt_dir: str) -> dict:
    """The HF converters on the card, no download: (1) Llama-3-8B's widths at
    4 layers as an HF-named state dict (``model.`` prefix, (out, in)
    layouts, an untied lm_head): ``from_hf_llama`` gives the tensors back
    bit for bit, and ``from_hf_llama(quantize="int8")`` serves 4 requests
    (16 tokens each) with the tokens of a server on ``quantize_params`` of
    the original weights (K6); ``load_hf_checkpoint`` on bf16 shards the
    script writes at 2 layers (two shards and a config.json, under
    ``ckpt_dir``) gives the same tensors. (2) Gemma-2-27B's widths at 4
    layers (``GEMMA2_27B_HF``; tied embedding) through ``from_hf_gemma2``
    served with one 5,000-token prompt past its 4,096 window and 3 short
    ones, 16 tokens each: K1 and K4/K5 with the window and the softcaps,
    launch counts checked, every request teacher-forced through ``forward``
    within SLACK."""
    import types

    from flash_attention_from_scratch_tpu_torch import (
        LLAMA3_8B, GenerationServer, from_hf_gemma2, from_hf_llama, init_params,
        load_hf_checkpoint, quantize_params)
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS

    t0 = time.perf_counter()
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=4)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    sd = _hf_llama_state_dict(params, cfg)
    conv, conv_cfg = from_hf_llama(sd, cfg)
    bitwise = conv_cfg == cfg and all(
        torch.equal(a, b) for a, b in zip(param_leaves(conv), param_leaves(params)))
    del conv
    rng = np.random.default_rng(3)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate((300, 700, 1000, 1500))}
    served = {}
    for name, weights in (("converted", from_hf_llama(sd, cfg, quantize="int8")[0]),
                          ("quantize_params", quantize_params(params, "int8"))):
        s = GenerationServer(weights, cfg, num_pages=4 * 32 + 2, page_size=SERVE_PAGE_SIZE,
                             max_batch=4, pages_per_seq=32)
        run = _drive(s, prompts, CONVERT_NEW_TOKENS)
        served[name] = ({sid: s.seqs[sid].generated for sid in prompts}, run)
        del s, weights
    run = served["converted"][1]
    q_counts, steps = run["counts"], run["stats"]["decode_steps"]
    # Every projection and the lm_head run K6: 7 x layers + 1 calls a model call.
    want = _with_merges({K1: cfg.n_layers * len(prompts), KP: cfg.n_layers * steps,
                         KERNELS[("int8", False)]: (7 * cfg.n_layers + 1)
                         * (len(prompts) + steps)}, 4, 32, SERVE_PAGE_SIZE)
    if q_counts != want or run["nonfinite"]:
        raise AssertionError(f"convert: int8 serving launches {q_counts}, expected {want}; "
                             f"{run['nonfinite']} non-finite logits")
    same_tokens = served["converted"][0] == served["quantize_params"][0]

    # bf16 shards at 2 layers, read back by load_hf_checkpoint.
    os.makedirs(ckpt_dir, exist_ok=True)
    two = {k: v for k, v in sd.items() if not k.startswith("model.layers.")
           or int(k.split(".")[2]) < 2}
    names = sorted(two)
    for i in range(2):
        _write_safetensors(os.path.join(ckpt_dir, f"model-{i + 1:05d}-of-00002.safetensors"),
                           {k: two[k] for k in names[i::2]})
    hf_json = {"vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
               "num_hidden_layers": 2, "num_attention_heads": cfg.n_heads,
               "num_key_value_heads": cfg.n_kv_heads, "intermediate_size": cfg.hidden_dim,
               "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps}
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(hf_json, f)
    t = time.perf_counter()
    loaded, loaded_cfg = load_hf_checkpoint(ckpt_dir)
    load_s = time.perf_counter() - t
    want = dict(params, layers=params["layers"][:2])
    shards_bitwise = loaded_cfg == dataclasses.replace(cfg, n_layers=2) and all(
        torch.equal(a, b) for a, b in zip(param_leaves(loaded), param_leaves(want)))
    del loaded, want, sd, two, params
    for name in os.listdir(ckpt_dir):
        os.remove(os.path.join(ckpt_dir, name))
    torch.cuda.empty_cache()
    llama_line = {"model": "Llama-3-8B widths", "layers": cfg.n_layers,
                  "tensors_bitwise": bitwise, "int8_tokens_equal": same_tokens,
                  "int8_launches": q_counts, "shards_bitwise": shards_bitwise,
                  "shard_layers": 2, "load_hf_checkpoint_s": load_s}
    print(f"convert llama: {json.dumps(llama_line)}", flush=True)
    if not (bitwise and same_tokens and shards_bitwise):
        raise AssertionError(f"convert llama: {llama_line}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    hf = GEMMA2_27B_HF
    sd = _gemma2_state_dict(hf, gen)
    model = types.SimpleNamespace(config=types.SimpleNamespace(**hf), state_dict=lambda: sd)
    gparams, gcfg = from_hf_gemma2(model, dtype=torch.bfloat16)
    del sd, model
    rng = np.random.default_rng(4)
    prompts = {i: rng.integers(0, gcfg.vocab_size, n).tolist()
               for i, n in enumerate(GEMMA2_PROMPT_LENS)}
    per_seq = -(-(max(GEMMA2_PROMPT_LENS) + CONVERT_NEW_TOKENS) // SERVE_PAGE_SIZE)
    s = GenerationServer(gparams, gcfg, num_pages=len(prompts) * per_seq + 2,
                         page_size=SERVE_PAGE_SIZE, max_batch=len(prompts),
                         pages_per_seq=per_seq)
    run = _drive(s, prompts, CONVERT_NEW_TOKENS)
    got = {sid: s.seqs[sid].generated for sid in prompts}
    if run["nonfinite"] or any(len(g) != CONVERT_NEW_TOKENS for g in got.values()):
        raise AssertionError(f"convert gemma2: {run['nonfinite']} non-finite logits, "
                             f"token counts {[len(g) for g in got.values()]}")
    stats = run["stats"]
    want = _with_merges({K1: gcfg.n_layers * len(prompts),
                         KP: gcfg.n_layers * stats["decode_steps"]}, len(prompts),
                        per_seq, SERVE_PAGE_SIZE, kv_heads=gcfg.n_kv_heads,
                        group=gcfg.n_heads // gcfg.n_kv_heads)
    if run["counts"] != want:
        raise AssertionError(f"convert gemma2: launches {run['counts']}, expected {want}")
    worst = max(float(_teacher_forced_gaps(gparams, gcfg, prompts[sid], got[sid])[0].max())
                for sid in prompts)
    gemma_line = {"model": "Gemma-2-27B widths", "layers": gcfg.n_layers,
                  "window_pattern": list(gcfg.window_pattern),
                  "softcaps": [gcfg.attn_softcap, gcfg.final_softcap],
                  "prompt_lens": list(GEMMA2_PROMPT_LENS),
                  "decode_tok_s": (run["decode_tokens"] / run["decode_s"]
                                   if run["decode_s"] else None),
                  "decode_steps": stats["decode_steps"], "launches": run["counts"],
                  "teacher_forced_worst_gap": worst}
    print(f"convert gemma2: {json.dumps(gemma_line)}", flush=True)
    if worst > SLACK:
        raise AssertionError(f"convert gemma2: a served token lies {worst} below the "
                             "full-recompute row max")
    print(json.dumps({"convert": {"llama": llama_line, "gemma2": gemma_line,
                                  "s": time.perf_counter() - t0, "gpu": smi}}), flush=True)
    return {"int8": q_counts, "gemma2": run["counts"]}


G9_INT8_LAYERS = 8  # the int8 run's depth: int8 weights (K6) and int8 KV pages


def _g9_server(params, cfg, mode: str = "dense"):
    """A server for G9_PROMPT_LENS at page SERVE_PAGE_SIZE: each request's
    pages for its prompt and SERVE_NEW_TOKENS, a few pages of admission
    headroom and the scratch page. Returns (server, pages a sequence)."""
    from flash_attention_from_scratch_tpu_torch import GenerationServer

    per_seq = -(-(max(G9_PROMPT_LENS) + SERVE_NEW_TOKENS) // SERVE_PAGE_SIZE)
    need = sum(-(-(n + SERVE_NEW_TOKENS) // SERVE_PAGE_SIZE) for n in G9_PROMPT_LENS)
    server = GenerationServer(params, cfg, num_pages=need + 8, page_size=SERVE_PAGE_SIZE,
                              max_batch=len(G9_PROMPT_LENS), pages_per_seq=per_seq,
                              mode=mode)
    return server, per_seq


def phase_serve_gemma2_9b(smi: str) -> dict:
    """Gemma-2-9B at full width and depth (``GEMMA2_9B_HF``: 42 layers, head
    width 256; random bf16 weights from a seed, built on the card as an
    HF-named state dict and converted by ``from_hf_gemma2``, as ``convert``
    does): 8 requests of G9_PROMPT_LENS (one past the 4,096 window), 32
    greedy tokens each, page 64, every decode step a graph replay (4 more
    profiled: the ``profile`` line). K1 runs
    at d 256 for every prompt's prefill (windowed and global layers,
    softcap 50), K4/K5 at d 256 in the decode graphs. Gates: finite logits;
    every request's tokens teacher-forced through ``forward`` within SLACK
    of the row max; K1 42 x 8 launches and K4/K5 42 x decode steps, each
    with its merge; a replayed step equal to the eager one bit for bit
    (``graph_case``). Then the int8 run: the first G9_INT8_LAYERS layers
    with int8 weights (K6, ``quantize_params``) and int8 KV pages on the
    same prompts, launches checked, two requests (one past the window)
    within QUANT_SLACK_STD row standard deviations of ``forward`` on the
    same weights (run A's rule). Returns {"counts", "int8_counts"}."""
    import types

    from flash_attention_from_scratch_tpu_torch import from_hf_gemma2, quantize_params
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS

    t0 = time.perf_counter()
    hf = GEMMA2_9B_HF
    # The tied head's logit of the current token is sqrt(hidden) |e|^2 over
    # the residual's RMS: at the usual embedding scale (1 / sqrt(hidden))
    # and 42 layers it sits ~6.5 above a row of unit spread, so every served
    # token would repeat its input whatever the attention computes. A tenth
    # of that scale, with the final norm's weight at ~10 to keep the
    # logits' unit spread, leaves the current token ~0.65 ahead: the served
    # tokens then follow the attention.
    sd = _gemma2_state_dict(hf, torch.Generator(device="cuda").manual_seed(0),
                            embed_std=0.1 * hf["hidden_size"] ** -0.5, final_norm=9.0)
    model = types.SimpleNamespace(config=types.SimpleNamespace(**hf), state_dict=lambda: sd)
    params, cfg = from_hf_gemma2(model, dtype=torch.bfloat16)
    del sd, model
    torch.cuda.empty_cache()
    server, per_seq = _g9_server(params, cfg)
    sync()
    weight_gb, kv_gb = _param_bytes(params) / 1e9, server.cache.nbytes() / 1e9
    setup_s = time.perf_counter() - t0
    print(f"serve_gemma2_9b: {cfg.n_layers} layers, d_head {cfg.d_head}, weights "
          f"{weight_gb:.2f} GB (the tied lm_head a copy), KV pool {kv_gb:.2f} GB, set-up "
          f"{setup_s:.1f} s", flush=True)
    rng = np.random.default_rng(5)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(G9_PROMPT_LENS)}
    capture_s = _warm_graphs(server, cfg.vocab_size, SERVE_NEW_TOKENS)
    served = _serve_run("serve_gemma2_9b", server, prompts, smi)
    run, tokens = served["run"], served["tokens"]
    stats = run["stats"]
    group = cfg.n_heads // cfg.n_kv_heads
    want = _with_merges({K1: cfg.n_layers * len(prompts),
                         KP: cfg.n_layers * stats["decode_steps"]}, len(prompts), per_seq,
                        SERVE_PAGE_SIZE, kv_heads=cfg.n_kv_heads, group=group,
                        d_head=cfg.d_head)
    print(f"serve_gemma2_9b: launches {run['counts']}; expected {want} ({cfg.n_layers} "
          f"layers x {len(prompts)} prompts, {stats['decode_steps']} decode steps)",
          flush=True)
    if run["counts"] != want:
        raise AssertionError("serve_gemma2_9b: a kernel of the path ran the wrong number "
                             "of times")
    gaps = [float(_teacher_forced_gaps(params, cfg, prompts[sid], tokens[sid])[0].max())
            for sid in prompts]
    # A served token equal to the token it was computed from (the prompt's
    # last, then the previous served one): a model whose logits ignore the
    # attention repeats its input every step.
    repeats = sum(t == ([prompts[sid][-1]] + tokens[sid])[i]
                  for sid in prompts for i, t in enumerate(tokens[sid]))
    distinct = [len(set(tokens[sid])) for sid in prompts]
    print(f"serve_gemma2_9b: teacher-forced worst gap per request {gaps} (limit {SLACK}); "
          f"{repeats} of {len(prompts) * SERVE_NEW_TOKENS} tokens repeat their input, "
          f"distinct tokens per request {distinct}", flush=True)
    if max(gaps) > SLACK:
        raise AssertionError(f"serve_gemma2_9b: a served token lies {max(gaps)} below the "
                             "full-recompute row max")
    if repeats * 2 > len(prompts) * SERVE_NEW_TOKENS:
        raise AssertionError(f"serve_gemma2_9b: {repeats} served tokens repeat their input: "
                             "the random model's logits do not depend on the attention")
    case = graph_case("gemma2-9b t1", server, [min(n, 1500) + 1 for n in G9_PROMPT_LENS], 1)
    prof = phase_profile(server, prompts, run="gemma2_9b")
    line = {"model": "Gemma-2-9B", "layers": cfg.n_layers, "d_head": cfg.d_head,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "window_pattern": list(cfg.window_pattern),
            "softcaps": [cfg.attn_softcap, cfg.final_softcap],
            "prompt_lens": list(G9_PROMPT_LENS), "requests": len(prompts),
            "new_tokens_per_request": SERVE_NEW_TOKENS, "page_size": SERVE_PAGE_SIZE,
            **served["line"], "teacher_forced_worst_gap": max(gaps),
            "repeated_input_tokens": repeats, "distinct_tokens": distinct,
            "weight_gb": weight_gb, "kv_cache_gb": kv_gb, "peak_mem_gb": run["peak_mem_gb"],
            "set_up_s": setup_s, "warm_up_s": capture_s, "graph_case": case,
            **_graph_fields(server, run, prof), "launches": run["counts"]}
    del server
    torch.cuda.empty_cache()

    qcfg = dataclasses.replace(cfg, n_layers=G9_INT8_LAYERS)
    qparams = quantize_params(dict(params, layers=params["layers"][:G9_INT8_LAYERS]), "int8")
    del params
    torch.cuda.empty_cache()
    qserver, _ = _g9_server(qparams, qcfg, mode="int8")
    _warm_graphs(qserver, qcfg.vocab_size, SERVE_NEW_TOKENS)
    qserved = _serve_run("serve_gemma2_9b int8", qserver, prompts, smi)
    qrun, qtokens = qserved["run"], qserved["tokens"]
    steps = qrun["stats"]["decode_steps"]
    qwant = _with_merges({KERNELS[("int8", False)]: (7 * qcfg.n_layers + 1)
                          * (len(prompts) + steps),
                          K1: qcfg.n_layers * len(prompts), KP: qcfg.n_layers * steps},
                         len(prompts), per_seq, SERVE_PAGE_SIZE, "int8",
                         kv_heads=qcfg.n_kv_heads, group=group, d_head=qcfg.d_head)
    if qrun["counts"] != qwant:
        raise AssertionError(f"serve_gemma2_9b int8: launches {qrun['counts']}, expected "
                             f"{qwant}")
    rel = {}
    for sid in (1, len(prompts) - 1):
        g, std = _teacher_forced_gaps(qparams, qcfg, prompts[sid], qtokens[sid])
        rel[G9_PROMPT_LENS[sid]] = float((g / std).max())
    print(f"serve_gemma2_9b int8: teacher-forced worst gap in row std {rel} (limit "
          f"{QUANT_SLACK_STD})", flush=True)
    if max(rel.values()) > QUANT_SLACK_STD:
        raise AssertionError("serve_gemma2_9b int8: a served token sits "
                             f"{max(rel.values())} row std below the recompute's max")
    line["int8"] = {"layers": qcfg.n_layers, "weights": "int8 (K6)", "kv": "int8",
                    **qserved["line"], "teacher_forced_worst_gap_std": rel,
                    "weight_gb": _param_bytes(qparams) / 1e9,
                    "kv_cache_gb": qserver.cache.nbytes() / 1e9,
                    "launches": qrun["counts"]}
    del qserver, qparams
    torch.cuda.empty_cache()
    line["s"] = time.perf_counter() - t0
    print(json.dumps({"serve_gemma2_9b": line}), flush=True)
    return {"counts": run["counts"], "int8_counts": qrun["counts"]}


def phase_serve_lora_quant(smi: str) -> dict:
    """LoRA over a quantized base inside the graphs: run A's recipe (int8
    weights on K6, int8 KV pages at page 128, 16 requests of 1,024 tokens)
    at 4 layers with 2 adapters (adapters -1, 0, 1 in turn), chunk 8.
    Checks K6's, K1's and K4/K5's launch counts, every token and finite
    logits, and one request of each adapter teacher-forced through
    ``forward`` on that adapter's merged weights (the adapted projections
    dequantized, W + alpha A_i B_i; the others quantized) or on the base
    model, within QUANT_SLACK_STD row standard deviations of the row max,
    as run A is held."""
    from flash_attention_from_scratch_tpu_torch import (
        LLAMA3_8B, GenerationServer, init_quantized_params)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import kernel_name
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS

    spec = dict(QUANT_RUNS["A"], layers=4)
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=spec["layers"])
    kernel = KERNELS[(spec["wmode"], False)]
    params = init_quantized_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   spec["wmode"], act=spec["act"])
    lora = _lora_stack(cfg, 2, seed=1)
    pages_per_seq = -(-(QUANT_PROMPT + QUANT_NEW) // QUANT_PAGE)
    server = GenerationServer(params, cfg, num_pages=spec["requests"] * pages_per_seq + 2,
                              page_size=QUANT_PAGE, max_batch=spec["requests"],
                              pages_per_seq=pages_per_seq, mode=spec["kv"], chunk=CHUNK,
                              lora=lora)
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab_size, QUANT_PROMPT).tolist()
               for i in range(spec["requests"])}
    adapters = {sid: sid % 3 - 1 for sid in prompts}
    capture_s = _warm_graphs(server, cfg.vocab_size, QUANT_NEW)
    run = _drive(server, prompts, QUANT_NEW, adapters)
    counts, stats = run["counts"], run["stats"]
    got = {sid: server.seqs[sid].generated for sid in prompts}
    if any(len(g) != QUANT_NEW for g in got.values()):
        raise AssertionError(f"serve_lora_quant: token counts {[len(g) for g in got.values()]}")
    if run["nonfinite"] or stats["preemptions"] or not stats["decode_loops"]:
        raise AssertionError(f"serve_lora_quant: {run['nonfinite']} non-finite logits, "
                             f"{stats['preemptions']} preemptions, "
                             f"{stats['decode_loops']} decode loops")
    want = _with_merges({kernel: (7 * cfg.n_layers + 1) * (len(prompts) + stats["decode_steps"]),
                         K1: cfg.n_layers * len(prompts),
                         kernel_name(1, False): cfg.n_layers * stats["decode_steps"]},
                        spec["requests"], pages_per_seq, QUANT_PAGE, spec["kv"])
    print(f"serve_lora_quant: launches {counts}; expected {want}", flush=True)
    if counts != want:
        raise AssertionError("serve_lora_quant: a kernel of the path ran the wrong number "
                             "of times")
    checked = {sid: adapters[sid] for sid in (0, 1, 2)}
    worst = _lora_gaps(params, cfg, lora, prompts, got, checked, by_std=True)
    print(f"serve_lora_quant: teacher-forced, worst gap by adapter {worst} row std, limit "
          f"{QUANT_SLACK_STD}", flush=True)
    if max(worst.values()) > QUANT_SLACK_STD:
        raise AssertionError(f"serve_lora_quant: a served token sits too far below its "
                             f"merged-weight row max: {worst}")
    prof = phase_profile(server, prompts, run="lora quant A", adapters=adapters)
    line = {"run": "A + LoRA", **spec, "adapters": 2, "rank": LORA_RANK, "chunk": CHUNK,
            "prompt_tokens": QUANT_PROMPT, "new_tokens_per_request": QUANT_NEW,
            "page_size": QUANT_PAGE, "decode_tok_s": run["decode_tokens"] / run["decode_s"],
            "prefill_tok_s": stats["prefill_tokens"] / run["prefill_s"],
            "decode_steps": stats["decode_steps"], "decode_loops": stats["decode_loops"],
            **_graph_fields(server, run, prof), "warm_up_s": capture_s,
            "teacher_forced_worst_gap_std_by_adapter": {str(a): g for a, g in worst.items()},
            "launches": counts, "gpu": smi}
    print(json.dumps({"serve_lora_quant": line}), flush=True)
    return {"kernel": kernel, "counts": counts}


SERVING_TOOLS = (
    ("bench_decode", ("--model", "8b", "--weights", "int8", "--kv", "int8")),
    ("bench_decode", ("--model", "8b", "--weights", "int8", "--kv", "int8", "--scan")),
    ("bench_serving", ("--model", "8b")),
    ("bench_serving", ("--model", "8b", "--prefix-cache", "--shared-prefix", "128",
                       "--requests", "16")),
)
# The keys of the JAX tools' result lines, which the port's tools print.
TOOL_KEYS = {
    "bench_decode": ("metric", "value", "unit", "ms_per_step", "batch", "context",
                     "tokens_per_s_per_seq", "hbm_roofline_tokens_per_s",
                     "pct_of_roofline", "hbm_bound_ms", "mxu_bound_ms",
                     "binding_constraint", "pct_of_bound", "param_gb", "cache_gb", "device"),
    "bench_serving": ("metric", "value", "unit", "requests", "prompt_len", "new_tokens",
                      "chunk", "spec_k", "spec_proposed", "spec_accepted",
                      "prefix_hits_pages", "max_batch", "scheduler_steps", "preemptions",
                      "wall_s", "ttft_ms_p50", "ttft_ms_p99", "tpot_ms_p50",
                      "tpot_ms_p99", "total_new_tokens", "device"),
}


def phase_serving_tools(smi: str) -> list:
    """The port's serving bench tools as a user runs them, each in its own
    process (``python -m flash_attention_from_scratch_tpu_torch.tools...``,
    from this checkout): bench_decode at the JAX package's north-star
    decode shape (8b, int8 weights, int8 KV, batch 16, context 1024) per
    step and with --scan, bench_serving at its defaults and with the prefix
    cache over a 128-token shared prefix. Each must exit 0 and print a JSON
    line with the JAX tool's keys (the prefix run with pages claimed)."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    results = []
    for tool, args in SERVING_TOOLS:
        torch.cuda.empty_cache()
        cmd = [sys.executable, "-m", f"flash_attention_from_scratch_tpu_torch.tools.{tool}",
               *args]
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
        took = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"{tool} {' '.join(args)} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        missing = [k for k in TOOL_KEYS[tool] if k not in line]
        if missing or not line["value"] > 0:
            raise AssertionError(f"{tool} {' '.join(args)}: missing {missing} in {line}")
        if "--prefix-cache" in args and not line["prefix_hits_pages"] > 0:
            raise AssertionError(f"bench_serving --prefix-cache claimed no page: {line}")
        print(json.dumps({tool: {"args": " ".join(args), "process_s": took, **line,
                                 "gpu": smi}}), flush=True)
        results.append(line)
    return results


# Kernel classes of a profile, by substrings of the kernel's name; the rest
# is elementwise work, reductions and copies.
KERNEL_CLASSES = (
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass")),
    ("quantized matmul (K6-K9)", ("quant_matmul_",)),
    ("activation quantization (K8/K9)", ("quantize_rows",)),
    ("flash forward (K1)", ("flash_forward_kernel", "flash_f32_kernel")),
    ("flash backward (K2/K3)", ("flash_backward_",)),
    ("paged decode (K4/K5)", ("paged_decode_kernel", "paged_decode_merge_kernel")),
    ("optimizer (foreach: AdamW, SGD)", ("multi_tensor_apply",)),
)


# CUDA calls the host makes to put work on the card, as torch.profiler
# records them: a graph replay, a kernel launch (PyTorch's or a ctypes
# wrapper's), a copy or a fill.
HOST_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
              "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
              "cudaMemsetAsync")


def _kernel_class(name: str) -> str:
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "elementwise, reductions, copies"


def _profile(fn, top: int = 10, split=None) -> dict:
    """Device time by kernel and the device's busy share over one call of
    ``fn``, from torch.profiler. GPU ranges of user annotations (such as
    the optimizer's step) span kernels and are left out of the sums.
    ``split`` ({kernel name: (class, share)}) puts that share of a kernel's
    time in that class, the rest in its own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms > 1.01 * wall_ms:
        raise AssertionError(f"profile: {busy_ms} ms of kernels in {wall_ms} ms")
    host = {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key in HOST_CALLS}
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    by_class: dict = {}
    for e in kernels:
        ms = e.self_device_time_total / 1e3
        label, share = (split or {}).get(e.key, (None, 0.0))
        if share:
            by_class[label] = by_class.get(label, 0.0) + share * ms
        own = _kernel_class(e.key)
        by_class[own] = by_class.get(own, 0.0) + (1.0 - share) * ms
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "launches": sum(e.count for e in kernels), "device_ms_by_class": by_class,
            "host_calls": sum(host.values()), "host_calls_by_kind": host,
            "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                               for e in ranked}}

def _check_model_backward(seen, what: str = "train", layers=None,
                          by_heads: bool = False) -> dict:
    """K2 and K3 against the plain backward on each layer's attention
    inputs as a training step handed them over (strided q/k/v/dO, the
    model's activations; ``seen`` in the backward's order, the last layer
    first; ``layers``: the layers to check, all by default; ``by_heads``:
    the plain version one KV head at a time). dO is first scaled by a power
    of two to a max of about 1: the gradients scale exactly with it, and
    the rule's 1e-6 floor would otherwise pass gradients this small (a
    mean loss over 4096 tokens) whatever they were. Returns {mode: worst
    err/bound}."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        flash_backward, flash_backward_plain)

    plain = _plain_backward_by_heads if by_heads else flash_backward_plain
    worst = {"fused": 0.0, "split": 0.0}
    checked = []
    for i, (*tensors, cfg) in enumerate(seen):
        layer = len(seen) - 1 - i  # the backward runs the last layer first
        if layers is not None and layer not in layers:
            continue
        q, k, v, o, lse, do = (t.detach() for t in tensors)
        do = do * 2.0 ** -math.floor(math.log2(float(do.abs().max())))
        ref16 = plain(q, k, v, o, lse, do, cfg)
        ref32 = plain(q.float(), k.float(), v.float(), o.float(), lse, do.float(), _fp32(cfg))
        for mode in ("fused", "split"):
            got = flash_backward(q, k, v, o, lse, do, cfg, fused=mode == "fused")
            _, ratio = _check_grads(f"{what} layer {layer} {mode}", got, ref16, ref32)
            worst[mode] = max(worst[mode], ratio)
        checked.append(f"{layer} (window {cfg.window})")
        del ref16, ref32, got
    print(f"{what}: K2 and K3 vs plain on layers {checked}' recorded attention inputs, "
          f"worst err/bound {worst} ok", flush=True)
    return worst


def _train_and_check(label: str, cfg, params, tokens, steps: int, remat: bool = False,
                     layers=None, by_heads: bool = False, lr: float = 3e-4,
                     optimizer=None) -> tuple[dict, dict]:
    """Train ``params`` on one batch of ``tokens``: ``steps`` optimizer
    steps (``optimizer(params)``, by default ``make_optimizer(params,
    lr=lr)``: AdamW) with the default backward (``fused_choice``: K3),
    launch counts (K1 and the backward's kernels once a layer a step; K1
    twice with ``remat``), a falling loss and finite gradients checked; one
    more step profiled; then one step on the other backward (K2: autograd's
    ``flash_backward`` called with ``fused=True``), with its counts, its
    gradients and the loss after it checked and K2/K3 held against the
    plain backward on its recorded attention inputs
    (``_check_model_backward`` on ``layers``). Returns (the line's fields,
    {backward: launch counts})."""
    from flash_attention_from_scratch_tpu_torch import loss_fn, make_optimizer, make_train_step
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
    from flash_attention_from_scratch_tpu_torch.ops import _build, autodiff
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED, fused_choice)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1

    kernels = {True: (KERNEL_FUSED,), False: (KERNEL_DKV, KERNEL_DQ)}
    default = fused_choice(causal=True)  # the model's attention is causal

    def expected(fused, n):
        return {K1: n * cfg.n_layers * (2 if remat else 1),
                **{k: n * cfg.n_layers if k in kernels[fused] else 0
                   for k in (KERNEL_FUSED, KERNEL_DKV, KERNEL_DQ)}}

    def nonfinite_grads(what):
        bad = sum(int(p.grad is not None and not bool(torch.isfinite(p.grad).all()))
                  for p in param_leaves(params))
        if bad:
            raise AssertionError(f"{label}: {bad} gradients with non-finite values ({what})")

    opt = (optimizer or (lambda p: make_optimizer(p, lr=lr)))(params)
    opt_name = type(opt).__name__
    step = make_train_step(cfg, opt, remat=remat)
    batch, seq = tokens.shape[0], tokens.shape[1] - 1
    n_params = sum(p.numel() for p in param_leaves(params))
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()  # counts start at 0 just before the main path
    losses, step_s = [], []
    for i in range(steps):
        t = time.perf_counter()
        losses.append(float(step(params, tokens)))
        sync()
        step_s.append(time.perf_counter() - t)
        with torch.no_grad():
            nonfinite_grads(f"step {i}")
    counts = dict(_build.launch_counts)  # read just after the main path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = expected(default, steps)
    print(f"{label}: losses {losses}, step s {[round(x, 4) for x in step_s]}, "
          f"launches {counts}; expected {want}, peak {peak_gb:.1f} GB", flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: training losses {losses} are not finite and falling")
    if any(counts.get(n, 0) != c for n, c in want.items()):
        raise AssertionError(f"{label}: a kernel of the training path ran the wrong number "
                             "of times")

    prof = _profile(lambda: step(params, tokens))

    # One step on the other backward, keeping each layer's attention-backward
    # inputs.
    seen = []
    real_backward = autodiff.flash_backward

    def recording(*args, **kw):
        seen.append(args)
        return real_backward(*args, **kw, fused=not default)

    autodiff.flash_backward = recording
    _build.launch_counts.clear()
    t = time.perf_counter()
    try:
        other_loss = float(step(params, tokens))
        sync()
    finally:
        autodiff.flash_backward = real_backward
    other_s = time.perf_counter() - t
    other_counts = dict(_build.launch_counts)
    with torch.no_grad():
        nonfinite_grads("the other backward's step")
        after_loss = float(loss_fn(params, tokens, cfg))
    other = "fused" if not default else "split"
    want = expected(not default, 1)
    print(f"{label} {other}: loss {other_loss}, then {after_loss}; step s {other_s:.4f}, "
          f"launches {other_counts}; expected {want}", flush=True)
    if not np.isfinite(after_loss) or not after_loss < other_loss < losses[0]:
        raise AssertionError(f"{label}: {other}-backward losses {losses[0]}, {other_loss}, "
                             f"{after_loss} are not finite and falling")
    if any(other_counts.get(n, 0) != c for n, c in want.items()):
        raise AssertionError(f"{label}: a kernel of the {other} training step ran the wrong "
                             "number of times")
    del opt, step
    for p in param_leaves(params):
        p.grad = None
    torch.cuda.empty_cache()
    model_err = _check_model_backward(seen, label, layers, by_heads)
    del seen

    step_ms = 1e3 * float(np.median(step_s[1:]))
    flops = train_flops(cfg, batch, seq)
    fields = {
        "layers": cfg.n_layers, "params": n_params, "batch": batch, "seq": seq,
        "steps": steps, "optimizer": opt_name, "lr": lr, "remat": remat,
        "dtype": _dname(cfg.dtype.torch_dtype), "backward": "fused" if default else "split",
        "losses": losses, "step_ms": step_ms, "step_ms_all": [1e3 * x for x in step_s],
        "train_tok_s": batch * seq / (step_ms / 1e3),
        "model_tflop_s": flops / (step_ms / 1e3) / 1e12,
        "model_tflop_per_step": flops / 1e12,
        "peak_mem_gb": peak_gb, "launches": counts,
        f"{other}_step_ms": 1e3 * other_s, f"{other}_launches": other_counts,
        f"{other}_loss": other_loss, f"loss_after_{other}": after_loss,
        "layers_backward_worst_err_bound": model_err, "profile": prof}
    return fields, {"fused" if default else "split": counts, other: other_counts}


def _sgd(lr: float):
    """An optimizer factory for ``_train_and_check``: plain SGD (no momentum,
    no second moment: the counterpart of ``optax.sgd``) over every leaf,
    marked as requiring grad; fp16 trains with it (``make_optimizer``'s
    AdamW raises on fp16 leaves: its eps and second moment underflow)."""
    def make(params):
        from flash_attention_from_scratch_tpu_torch.models.train import param_leaves

        leaves = list(param_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        return torch.optim.SGD(leaves, lr=lr)

    return make


# fp16 training (train_fp16, train_gemma2_9b_fp16): SGD, the trainer's
# optimizer for fp16 (see _sgd), at these learning rates. No loss scaling,
# as in the JAX package's step: a gradient below fp16's smallest subnormal
# (6e-8; most of the softmax terms of a mean over 4,096 tokens) flushes to
# 0, and the targets' terms (-1 / tokens) carry the step. Picked on the
# H100 from 5 steps at each of 0.1, 0.3, 1, 3 and 10: Llama-3-8B's loss on
# its one batch fell at every step up to lr 1 (at 3 it rose on the fifth,
# at 10 on the third); Gemma-2-9B's fell at every step at 0.1 and 0.3 and
# rose on the third step at 1 and 3.
FP16_TRAIN_LR = 1.0
FP16_G9_TRAIN_LR = 0.3


def phase_train(smi: str, dtype=torch.bfloat16) -> dict:
    """Train LLAMA3_8B at full width, 8 layers, batch 2 x 2048, in ``dtype``
    (``_train_and_check``: 3 steps on K3, one profiled, one on K2, K2/K3
    held to the plain backward on every layer's recorded inputs): bf16
    (``train``) with AdamW at lr 3e-4; fp16 (``train_fp16``: the model, its
    activations and K1, K2 and K3 in fp16, from their fp16 libraries) with
    SGD at FP16_TRAIN_LR. Returns the launch counts of both runs, by
    backward, under "rate" the run's train tokens/s, model TFLOP/s and ms a
    step, and under "line" its line's fields."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, init_params
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType

    label = "train" if dtype == torch.bfloat16 else f"train_{_dname(dtype)}"
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=TRAIN_LAYERS, dtype=DType.from_torch(dtype))
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).to("cuda")
    sync()
    print(f"{label}: LLAMA3_8B x {TRAIN_LAYERS} layers in {_dname(dtype)}, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    fp16 = dtype == FP16
    fields, counts = _train_and_check(
        label, cfg, params, tokens, TRAIN_STEPS, lr=FP16_TRAIN_LR if fp16 else 3e-4,
        optimizer=_sgd(FP16_TRAIN_LR) if fp16 else None)
    print(json.dumps({label: {"model": "LLAMA3_8B", **fields, "gpu": smi}}), flush=True)
    del params
    torch.cuda.empty_cache()
    return {**counts, "line": fields,
            "rate": {k: fields[k] for k in ("train_tok_s", "model_tflop_s", "step_ms")}}


# Gemma-2-9B trained at full width (train_gemma2_9b): 8 of its 42 layers
# (4 sliding, 4 global, as in the model), batch 1 x 8,192 tokens (its
# context: the sliding layers' backward masks keys 4,096 back), 3 AdamW
# steps. The 8 layers' weights, gradients and AdamW moments in bf16 take
# ~27 GB (3.4 B parameters: the tied head is a copy), the fp32 logits of
# 8,192 x 256,000 8.4 GB a tensor; all 42 layers would be ~74 GB before
# activations. Without remat a step peaked at 74.5 GB on the H100, so each
# layer is checkpointed (K1 then runs twice a layer a step). The learning
# rate is a fine-tuning one: at 3e-4 the random model's loss on its one
# batch rose on alternate steps.
G9_TRAIN_LAYERS, G9_TRAIN_SEQ, G9_TRAIN_STEPS = 8, 8192, 3
G9_TRAIN_REMAT, G9_TRAIN_LR = True, 1e-4


def phase_train_gemma2_9b(smi: str, dtype=torch.bfloat16) -> dict:
    """Train Gemma-2-9B at full width (``GEMMA2_9B_HF`` cut to
    G9_TRAIN_LAYERS layers; random weights from a seed, built as an
    HF-named state dict and converted by ``from_hf_gemma2`` to ``dtype``,
    as ``serve_gemma2_9b`` builds them) on one batch of G9_TRAIN_SEQ tokens:
    ``_train_and_check`` at d 256 (K1, K3, then K2), K2 and K3 held to the
    plain backward (one KV head at a time) on the last two layers' recorded
    inputs, one sliding and one global. bf16 (``train_gemma2_9b``) with
    AdamW at G9_TRAIN_LR; fp16 (``train_gemma2_9b_fp16``) with SGD at
    FP16_G9_TRAIN_LR. Returns the launch counts of both runs, by backward,
    and under "line" the line's fields."""
    import types

    from flash_attention_from_scratch_tpu_torch import from_hf_gemma2

    label = "train_gemma2_9b" + ("" if dtype == torch.bfloat16 else f"_{_dname(dtype)}")
    t0 = time.perf_counter()
    hf = dict(GEMMA2_9B_HF, num_hidden_layers=G9_TRAIN_LAYERS)
    sd = _gemma2_state_dict(hf, torch.Generator(device="cuda").manual_seed(1))
    model = types.SimpleNamespace(config=types.SimpleNamespace(**hf), state_dict=lambda: sd)
    params, cfg = from_hf_gemma2(model, dtype=dtype)
    del sd, model
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, G9_TRAIN_SEQ + 1))).to("cuda")
    layers = (cfg.n_layers - 2, cfg.n_layers - 1)
    if sorted(cfg.layer_window(i) > 0 for i in layers) != [False, True]:
        raise AssertionError(f"{label}: layers {layers} are not one sliding and one global")
    if cfg.dtype.torch_dtype != dtype:
        raise AssertionError(f"{label}: the converted model is {cfg.dtype}")
    sync()
    setup_s = time.perf_counter() - t0
    print(f"{label}: {cfg.n_layers} layers, d_head {cfg.d_head}, windows "
          f"{[cfg.layer_window(i) for i in range(cfg.n_layers)]}, set-up {setup_s:.1f} s",
          flush=True)
    fp16 = dtype == FP16
    fields, counts = _train_and_check(
        label, cfg, params, tokens, G9_TRAIN_STEPS, remat=G9_TRAIN_REMAT, layers=layers,
        by_heads=True, lr=FP16_G9_TRAIN_LR if fp16 else G9_TRAIN_LR,
        optimizer=_sgd(FP16_G9_TRAIN_LR) if fp16 else None)
    del params
    torch.cuda.empty_cache()
    print(json.dumps({label: {
        "model": "Gemma-2-9B", "d_head": cfg.d_head, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "window_pattern": list(cfg.window_pattern),
        "softcaps": [cfg.attn_softcap, cfg.final_softcap], **fields,
        "layers_checked": list(layers), "set_up_s": setup_s,
        "s": time.perf_counter() - t0, "gpu": smi}}), flush=True)
    return {**counts, "line": fields}


def _dname(dtype) -> str:
    """A type's name in a line: bf16, fp16 or fp32."""
    return {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}[dtype]


def _peak_ops(dtype) -> float:
    """The tensor cores' peak for the attention products in ``dtype``: 989
    TFLOP/s for bf16 and fp16, three TF32 products' worth (165) for fp32."""
    return PEAK_FP32_PRODUCTS if dtype == torch.float32 else PEAK_BF16_FLOPS


def _library_attention(q, k, v, causal: bool):
    """PyTorch's one fused call for the same attention, as a function to
    time: SDPA with GQA; in fp32 on its memory-efficient backend, K and V
    repeated to Q's heads first (flash attention takes no fp32)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if q.dtype != torch.float32:
        return lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    k, v = (x.repeat_interleave(q.shape[1] // x.shape[1], 1) for x in (k, v))

    def efficient():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return sdpa(q, k, v, is_causal=causal)

    return efficient


def _padded(n: int) -> int:
    from flash_attention_from_scratch_tpu_torch.serving.generate import (
        PROMPT_QUANTUM)

    return n + (-n) % PROMPT_QUANTUM


def time_flash(ptxas: dict | None = None, dtype=torch.bfloat16) -> dict:
    """K1 at the serving run's prefill shapes: one layer, all 8 prompts, in
    ``dtype`` (bf16 or fp16: the same bytes and peak, so the same bound;
    fp32: 4-byte elements and the 3xTF32 peak, ``_peak_ops``; the library
    call ``_library_attention`` in that type); beside it (``grid_ms``, 16-bit
    only: fp32's K1 is a plain grid) the same kernel launched as a plain
    grid, one CTA per work item, in place of its persistent CTAs.
    ``ptxas``: the build's registers and spills of the library's kernel."""
    from flash_attention_from_scratch_tpu_torch.ops import flash_forward as ff
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward, flash_forward_plain)

    cfg = KernelConfig(causal=True, dtype=DType.from_torch(dtype))
    fp32 = dtype == torch.float32
    ms = grid_ms = plain_ms = lib_ms = bound_ms = 0.0
    for i, n in enumerate(SERVE_PROMPT_LENS):
        s = _padded(n)
        q, k, v = _cuda_qkv(s, s, seed=50 + i, dtype=dtype)
        ms += _time_ms(lambda: flash_forward(q, k, v, cfg))
        if not fp32:
            grid_ms += _time_ms(lambda: ff._launch(q, k, v, cfg, None, False, ctas=0))
        lib_ms += _time_ms(_library_attention(q, k, v, True))
        plain_ms += _time_ms(lambda: flash_forward_plain(q, k, v, cfg), iters=3,
                             warmup=1)
        ops = _attn_ops(s, HEADS, 1, causal=True)
        nbytes = q.element_size() * (2 * s * HEADS * D + 2 * s * KV_HEADS * D)  # q, o, k, v
        bound_ms += 1e3 * max(ops / _peak_ops(dtype), nbytes / PEAK_BYTES_PER_S)
        del q, k, v
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": "operations",
            **({} if fp32 else {"grid_ms": grid_ms}),
            "ptxas": _kernel_ptxas(ptxas or {}, ("flash_f32_kernel" if fp32
                                                 else "flash_forward_kernel",)),
            "shape": "sum over the 8 padded prompts "
                     f"{[_padded(n) for n in SERVE_PROMPT_LENS]}: causal, "
                     f"b 1, {HEADS}/{KV_HEADS} heads, d {D}, {_dname(dtype)} (one layer)"}


def _time_merge(q, kp, lens, tables) -> tuple[int, float]:
    """The plan's split count for a dense single-token call, and the merge
    kernel's time alone at that count (on a workspace the split kernel
    filled)."""
    from flash_attention_from_scratch_tpu_torch.ops import paged_attention as pa
    from flash_attention_from_scratch_tpu_torch.utils.device import sm_count

    batch, heads, d = q.shape
    kv_heads = kp.shape[0]
    rows = heads // kv_heads
    p = pa.plan(batch, kv_heads, rows, tables.shape[1], kp.shape[2], 0,
                sm_count(q.device), d_head=d)
    if p.splits == 1:
        return 1, 0.0
    ws_o = torch.zeros((batch * kv_heads, p.splits, rows, d), device="cuda")
    ws_ml = torch.zeros((batch * kv_heads, p.splits, rows, 2), device="cuda")
    out = torch.empty_like(q)
    lib = pa._lib()
    # The stream is read at each call: _graph_ms captures the calls on a
    # stream of its own.
    merge = lambda: lib.fa_paged_decode_merge(  # noqa: E731
        ws_o.data_ptr(), ws_ml.data_ptr(), out.data_ptr(), batch, heads, kv_heads, 1,
        p.splits, d, torch.cuda.current_stream().cuda_stream)
    return p.splits, _graph_ms(merge)


def time_paged(dtype=torch.bfloat16) -> dict:
    """K4/K5 at the serving run's first decode step: 8 sequences (q and the
    dense pages in ``dtype``, bf16 or fp16); the
    whole call (split kernel and merge; ``_graph_ms``, as the card runs it
    faster than the host enqueues it: ``eager_call_ms`` is the back-to-back
    eager call), the plan's split count, the merge kernel's time alone and
    its share of the call, and the call at one split (no merge)."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    lengths = [n + 1 for n in SERVE_PROMPT_LENS]
    kp, vp, lens, tables = make_paged_pool(
        lengths, SERVE_PAGE_SIZE, SERVE_PAGES, seed=60,
        pages_per_seq=SERVE_PAGES_PER_SEQ, dtype=dtype)
    q = torch.from_numpy(np.random.default_rng(61).standard_normal(
        (len(lengths), HEADS, D)).astype(np.float32)).to("cuda", dtype)
    ms = _graph_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables))
    call_ms = _time_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables))
    one_split_ms = _graph_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables,
                                                            splits=1))
    splits, merge_ms = _time_merge(q, kp, lens, tables)
    plain_ms = _time_ms(lambda: paged_decode_attention_plain(
        q, kp, vp, lens, tables, scale=D ** -0.5), iters=3, warmup=1)
    nbytes = sum(lengths) * KV_HEADS * D * 2 * 2 + 2 * q.numel() * 2
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
            "splits": splits, "merge_ms": merge_ms, "merge_share": merge_ms / ms,
            "one_split_ms": one_split_ms, "eager_call_ms": call_ms,
            "shape": f"first decode step: lengths {lengths}, page {SERVE_PAGE_SIZE}, "
                     f"{HEADS}/{KV_HEADS} heads, d {D}, {_dname(dtype)} (one layer)"}


def time_flash_d256(ptxas: dict | None = None, dtype=torch.bfloat16) -> dict:
    """K1 at head width 256 in ``dtype``, at ``serve_gemma2_9b``'s prefill shapes: one
    global layer (causal, softcap 50) over the 8 padded prompts, b 1, 16/8
    heads; beside it a sliding layer (window 4,096) and the same kernel as
    a plain grid (16-bit only). Bound: the two products' operations at the
    type's rate (``_peak_ops``; or the bytes, the larger); the library call
    is SDPA (causal, GQA; ``_library_attention``), which has no softcap.
    ``ptxas``: the build's registers and spills of the library's kernels."""
    from flash_attention_from_scratch_tpu_torch.ops import flash_forward as ff
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig

    cfg = KernelConfig(d_head=G9_D, causal=True, attn_softcap=G9_SOFTCAP,
                       dtype=DType.from_torch(dtype))
    local = dataclasses.replace(cfg, window=G9_WINDOW)
    nocap = dataclasses.replace(cfg, attn_softcap=0.0)
    fp32 = dtype == torch.float32
    ms = window_ms = nocap_ms = grid_ms = plain_ms = lib_ms = bound_ms = window_bound_ms = 0.0
    for i, n in enumerate(G9_PROMPT_LENS):
        s = _padded(n)
        q, k, v = _cuda_qkv(s, s, seed=250 + i, heads=G9_HEADS, kv_heads=G9_KV_HEADS, d=G9_D,
                            dtype=dtype)
        ms += _time_ms(lambda: ff.flash_forward(q, k, v, cfg))
        window_ms += _time_ms(lambda: ff.flash_forward(q, k, v, local))
        nocap_ms += _time_ms(lambda: ff.flash_forward(q, k, v, nocap))
        if not fp32:
            grid_ms += _time_ms(lambda: ff._launch(q, k, v, cfg, None, False, ctas=0))
        lib_ms += _time_ms(_library_attention(q, k, v, True))
        plain_ms += _time_ms(lambda: ff.flash_forward_plain(q, k, v, cfg), iters=3, warmup=1)
        nbytes = q.element_size() * (2 * s * G9_HEADS * G9_D + 2 * s * G9_KV_HEADS * G9_D)
        for window in (0, G9_WINDOW):
            ops = _attn_ops(s, G9_HEADS, 1, causal=True, window=window, d=G9_D)
            b = 1e3 * max(ops / _peak_ops(dtype), nbytes / PEAK_BYTES_PER_S)
            bound_ms += 0 if window else b
            window_bound_ms += b if window else 0
        del q, k, v
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "window_ms": window_ms,
            "window_bound_ms": window_bound_ms, "no_softcap_ms": nocap_ms,
            **({} if fp32 else {"grid_ms": grid_ms}),
            "ptxas": _kernel_ptxas(ptxas or {}, ("flash_f32_kernel" if fp32
                                                 else "flash_forward_kernel",)),
            "shape": "sum over the 8 padded prompts "
                     f"{[_padded(n) for n in G9_PROMPT_LENS]}: causal, softcap "
                     f"{G9_SOFTCAP:g} (window_ms: window {G9_WINDOW}), b 1, "
                     f"{G9_HEADS}/{G9_KV_HEADS} heads, d {G9_D}, {_dname(dtype)} (one layer); "
                     "library: SDPA causal without a softcap"}


def time_paged_d256(ptxas: dict | None = None, dtype=torch.bfloat16) -> dict:
    """K4/K5 at head width 256 (q and pages in ``dtype``), at ``serve_gemma2_9b``'s first decode step
    (8 sequences of G9_PROMPT_LENS + 1 tokens, 16/8 heads, page 64, dense
    bf16): a global layer's call (softcap 50) by CUDA-graph replay, a
    sliding layer's (window 4,096, which reads only the window's pages),
    the call at one split, the plan's split count and the merge's time
    alone. Bound: the K/V bytes the call needs (each token of the window
    once) and q and out, over the HBM rate. ``ptxas``: the build's
    registers and spills of ``paged_attention.cu``'s kernels."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    lengths = [n + 1 for n in G9_PROMPT_LENS]
    per_seq = -(-max(lengths) // SERVE_PAGE_SIZE)
    kp, vp, lens, tables = make_paged_pool(
        lengths, SERVE_PAGE_SIZE, len(lengths) * per_seq, seed=260, pages_per_seq=per_seq,
        kv_heads=G9_KV_HEADS, d=G9_D, dtype=dtype)
    q = torch.from_numpy(np.random.default_rng(261).standard_normal(
        (len(lengths), G9_HEADS, G9_D)).astype(np.float32)).to("cuda", dtype)
    full, local = dict(softcap=G9_SOFTCAP), dict(softcap=G9_SOFTCAP, window=G9_WINDOW)
    ms = _graph_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables, **full))
    window_ms = _graph_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables, **local))
    one_split_ms = _graph_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables,
                                                            splits=1, **full))
    splits, merge_ms = _time_merge(q, kp, lens, tables)
    plain_ms = _time_ms(lambda: paged_decode_attention_plain(
        q, kp, vp, lens, tables, scale=G9_D ** -0.5, **full), iters=3, warmup=1)
    qo_bytes = 2 * q.numel() * 2
    per_token = G9_KV_HEADS * G9_D * 2 * 2  # K and V, bf16
    nbytes = sum(lengths) * per_token + qo_bytes
    window_bytes = sum(min(n, G9_WINDOW) for n in lengths) * per_token + qo_bytes
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
            "window_ms": window_ms, "window_bound_ms": 1e3 * window_bytes / PEAK_BYTES_PER_S,
            "splits": splits, "merge_ms": merge_ms, "merge_share": merge_ms / ms,
            "one_split_ms": one_split_ms,
            "ptxas": _kernel_ptxas(ptxas or {}, ("paged_decode_kernel",
                                                 "paged_decode_merge_kernel")),
            "shape": f"first decode step: lengths {lengths}, page {SERVE_PAGE_SIZE}, "
                     f"{G9_HEADS}/{G9_KV_HEADS} heads, d {G9_D}, {_dname(dtype)}, softcap "
                     f"{G9_SOFTCAP:g} (window_ms: window {G9_WINDOW}; one layer)"}


def _sdpa_backward_ms(q, k, v, do, causal: bool = True) -> float:
    """SDPA's backward on (q, k, v) with K/V repeated to q's heads: forward
    plus ``torch.autograd.grad`` minus the same forward, in ms."""
    group = q.shape[1] // k.shape[1]
    qg = q.clone().requires_grad_()
    kg = k.repeat_interleave(group, 1).requires_grad_()
    vg = v.repeat_interleave(group, 1).requires_grad_()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)

    fwd_ms = _time_ms(sdpa)
    return _time_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do)) - fwd_ms


# K2/K3's timed shapes, b 2, 32/8 heads: (label, seq, causal). The first is
# the training run's (one layer); the plain version is timed there only.
BACKWARD_TIMED = (("train", TRAIN_SEQ, True), ("causal s1024", 1024, True),
                  ("causal s4096", 4096, True), ("full s2048", 2048, False))


def time_backward(ptxas: dict | None = None) -> tuple[dict, dict]:
    """K2 and K3 at ``BACKWARD_TIMED``'s shapes: each as the whole
    ``flash_backward`` call and as its kernels' launch alone (D = rowsum(dO
    * O) computed beforehand; K2's launch still zeroes and casts its dQ
    workspace), both by CUDA events, beside SDPA's backward (K/V repeated
    to 32 heads, timed as forward + ``torch.autograd.grad`` minus the same
    forward), the bound, its share (bound / call time) and TFLOP/s (five
    tile products, 2 * d operations each per visible (q, kv) pair: S, dP,
    dV, dK, dQ). The top-level numbers are the training shape's.
    ``ptxas``: the build's registers and spills of ``flash_backward.cu``'s
    kernels. (torch.profiler dropped some of these kernels' records, and
    once all of them, so it times nothing here.)"""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops import flash_backward as fb
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward_with_lse)

    b = TRAIN_BATCH
    by_shape = {"fused": {}, "split": {}}
    common = {}
    for i, (label, s, causal) in enumerate(BACKWARD_TIMED):
        cfg = KernelConfig(causal=causal)
        q, k, v = _timing_qkv(s, s, seed=70 + 3 * i, batch=b)
        do = _timing_normal(q.shape, seed=100 + i)
        o, lse = flash_forward_with_lse(q, k, v, cfg)
        lib_ms = _sdpa_backward_ms(q, k, v, do, causal)
        flops = 5 * 2 * D * _attn_ops(s, HEADS, b, causal) // (4 * D)
        # q, o, do, dq and k, v, dk, dv in bf16, lse in fp32: each once.
        nbytes = 2 * (4 * b * HEADS * s * D + 4 * b * KV_HEADS * s * D) + 4 * b * HEADS * s
        bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
        dsum = fb._row_sums(o, do)
        for mode in ("fused", "split"):
            fused = mode == "fused"
            ms = _time_ms(lambda: fb.flash_backward(q, k, v, o, lse, do, cfg, fused=fused))
            kernel_ms = _time_ms(lambda: fb._launch(q, k, v, lse, dsum, do, cfg,
                                                    cfg.softmax_scale, fused))
            by_shape[mode][label] = {
                "ms": ms, "kernel_ms": kernel_ms,
                "library_ms": lib_ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                "tflops": flops / ms / 1e9, "kernel_tflops": flops / kernel_ms / 1e9}
        if label == "train":
            common = {"plain_ms": _time_ms(lambda: fb.flash_backward_plain(
                          q, k, v, o, lse, do, cfg), iters=3, warmup=1),
                      "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "operations",
                      "shape": (f"causal, b {b}, {HEADS}/{KV_HEADS} heads, s {s}, d {D}, "
                                "bf16 (one layer of the training run)")}
        del q, k, v, do, o, lse, dsum
    return _backward_lines(by_shape, "train", common, ptxas, D)


def _backward_lines(by_shape, top: str, common: dict, ptxas, d: int) -> tuple[dict, dict]:
    """K2's and K3's timing dicts (fused, split): the ``top`` shape's numbers
    at the top level, every shape's under ``by_shape``, and the build's
    registers and spills of their kernels at head width ``d``."""
    ptx = _kernel_ptxas(ptxas or {}, ("flash_backward_dkv_kernel", "flash_backward_dq_kernel"))
    out = []
    for mode in ("fused", "split"):
        first = by_shape[mode][top]
        out.append({"ms": first["ms"], **common, "kernel_ms": first["kernel_ms"],
                    "bound_share": first["bound_share"], "tflops": first["tflops"],
                    "by_shape": by_shape[mode],
                    "ptxas": {n: v for n, v in ptx.items()
                              if ("Lb1E" in n) == (mode == "fused") and f"Li{d}EE" in n}})
    return out[0], out[1]


def time_backward_d256(ptxas: dict | None = None) -> tuple[dict, dict]:
    """K2 and K3 at head width 256 on ``D256_BACKWARD_TIMED``: each as the
    whole ``flash_backward`` call and as its kernels' launch alone, by CUDA
    events, beside the bound (five tile products, 2 * 256 operations each
    per visible (q, kv) pair, over 989 TFLOP/s; or the bytes, the larger),
    SDPA's backward (causal, no softcap, K/V repeated to 16 heads: forward
    + ``torch.autograd.grad`` minus the same forward) and, on the first
    shape, the plain version (one KV head at a time). ``ptxas``: the build's
    registers and spills of ``flash_backward.cu``'s kernels."""
    from flash_attention_from_scratch_tpu_torch.ops import flash_backward as fb
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward_with_lse)

    s, heads, kvh, d = G9_TRAIN_SEQ, G9_HEADS, G9_KV_HEADS, G9_D
    q, k, v = _timing_qkv(s, s, seed=90, heads=heads, kv_heads=kvh, d=d)
    do = _timing_normal(q.shape, seed=93)
    lib_ms = _sdpa_backward_ms(q, k, v, do)
    # q, o, do, dq and k, v, dk, dv in bf16, lse in fp32: each once.
    nbytes = 2 * (4 * heads * s * d + 4 * kvh * s * d) + 4 * heads * s
    by_shape = {"fused": {}, "split": {}}
    common = {}
    for label, window, cap in D256_BACKWARD_TIMED:
        cfg = KernelConfig(d_head=d, causal=True, window=window, attn_softcap=cap)
        o, lse = flash_forward_with_lse(q, k, v, cfg)
        dsum = fb._row_sums(o, do)
        flops = 5 * _attn_ops(s, heads, 1, True, window, d) // 2
        bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
        for mode in ("fused", "split"):
            fused = mode == "fused"
            ms = _time_ms(lambda: fb.flash_backward(q, k, v, o, lse, do, cfg, fused=fused))
            kernel_ms = _time_ms(lambda: fb._launch(q, k, v, lse, dsum, do, cfg,
                                                    cfg.softmax_scale, fused))
            by_shape[mode][label] = {
                "ms": ms, "kernel_ms": kernel_ms, "bound_ms": bound_ms,
                "bound_share": bound_ms / ms, "tflops": flops / ms / 1e9,
                "kernel_tflops": flops / kernel_ms / 1e9}
        if not common:
            common = {"plain_ms": _time_ms(lambda: _plain_backward_by_heads(
                          q, k, v, o, lse, do, cfg), iters=2, warmup=1),
                      "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "operations",
                      "shape": (f"causal, b 1, {heads}/{kvh} heads, s {s}, d {d}, softcap "
                                f"{G9_SOFTCAP:g}, bf16 (one global layer of "
                                "train_gemma2_9b; by_shape: without the softcap and a "
                                f"{G9_WINDOW} window); library: SDPA's backward, causal, "
                                "no softcap; plain: one KV head at a time")}
        del o, lse, dsum
    del q, k, v, do
    torch.cuda.empty_cache()
    return _backward_lines(by_shape, D256_BACKWARD_TIMED[0][0], common, ptxas, d)


# ---------------------------------------------------------------------------
# Quantized serving: K6-K9 and the quantized page formats of K4/K5.

PEAK_INT8_OPS = 1979e12  # H100 SXM int8 tensor cores, dense
# Llama-3-8B's projection shapes (K, N), and each one's count per layer.
LAYER_SHAPES = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
                ("wo", 4096, 4096), ("w_gate", 4096, 14336),
                ("w_up", 4096, 14336), ("w_down", 14336, 4096))
LM_HEAD_SHAPE = (4096, 128256)
# (weight mode, activation-quantized) of K6, K7, K8, K9.
QMM_RECIPES = (("int8", False), ("int4", False), ("int8", True), ("int4", True))
# Serve runs: weights, activations, KV pages, layers, requests; E and F
# also int8-compute attention, F speculative decoding too. E runs 8 of the
# 32 layers since PR 24 (the smoke's time limit).
QUANT_RUNS = {
    "A": dict(wmode="int8", act="bf16", kv="int8", layers=32, requests=16),
    "B": dict(wmode="int4", act="int8", kv="int8", layers=32, requests=16),
    "C": dict(wmode="int8", act="int8", kv="fp8", layers=4, requests=4),
    "D": dict(wmode="int4", act="bf16", kv="int4", layers=4, requests=4),
    "E": dict(wmode="int8", act="bf16", kv="int8", layers=8, requests=16,
              attn_int8=True),
    "F": dict(wmode="int8", act="bf16", kv="int8", layers=4, requests=4,
              attn_int8=True, spec_k=SPEC_K),
}
QUANT_PROMPT, QUANT_PAGE, QUANT_NEW = 1024, 128, 32
# A served token's logit may sit this many row standard deviations below the
# full-recompute row max: the served path reads quantized K/V (and, for a8,
# quantized activations at every projection), the recompute reads K/V
# unquantized. A wrong kernel puts served tokens several row standard
# deviations below the max (the max of 128256 normal logits sits ~4.5 above
# the mean).
QUANT_SLACK_STD = 0.25


def _random_qweight(k, n, mode, act_quant, gen, dtype=torch.bfloat16):
    """init_quantized_params' recipe for one (K, N) weight of a ``dtype``
    model, with every column's scale multiplied by its own draw from [0.5,
    1.5): a kernel that applies a scale to the wrong column then disagrees
    with its plain version."""
    from flash_attention_from_scratch_tpu_torch.models.llama import (
        random_quantized_weight)

    wq = random_quantized_weight((k, n), mode, "int8" if act_quant else "bf16",
                                 gen, dtype, device="cuda")
    wq.scales.mul_(0.5 + torch.rand(n, generator=gen, device="cuda"))
    return wq


def _check_qmm(got, x, wq, act_quant):
    """The adaptive rule in each 64-row band against the plain version (cast
    to x's type, and in fp32); for a8 also the plain int32 path within one
    ulp of x's type of each value. Returns (ok, worst err/bound, worst ulps,
    max err)."""
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        quant_matmul_plain)
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        row_bands, sliced_tolerance_check)

    plain = quant_matmul_plain(x, wq, act_quant)
    ref32 = quant_matmul_plain(x, wq, act_quant, out_dtype=torch.float32)
    pad = -x.shape[0] % 64

    def bands(t):
        return row_bands(torch.nn.functional.pad(t.float(), (0, 0, 0, pad))[None], 64)

    ok, ratio, _ = sliced_tolerance_check(bands(got), bands(plain).to(x.dtype),
                                          bands(ref32), lead=2)
    err = (got.float() - plain.float()).abs()
    ulps = 0.0
    if act_quant:
        ulp = torch.exp2(torch.floor(torch.log2(plain.float().abs().clamp_min(1e-30)))
                         + math.log2(torch.finfo(x.dtype).eps))
        ulps = float((err / ulp).max())
        ok = ok and ulps <= 1.0
    return ok and bool(torch.isfinite(got).all()), ratio, ulps, float(err.max())


def _check_quantize_rows(x) -> None:
    """K8/K9's activation quantization kernel against the plain version on
    the same x: the same int8 bytes and fp32 scales, bit for bit."""
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        quantize_activations, quantize_rows)

    got_q, got_s = quantize_rows(x)
    want_q, want_s = quantize_activations(x)
    sync()
    if not (torch.equal(got_q, want_q) and torch.equal(got_s, want_s)):
        raise AssertionError(f"quantize_rows at {tuple(x.shape)}: "
                             f"{int((got_q != want_q).sum())} bytes and "
                             f"{int((got_s != want_s).sum())} scales differ from the plain "
                             "quantization")


def phase_quant_matmul_cases() -> dict:
    """K6-K9 vs their plain version at every weight shape of Llama-3-8B, at
    decode m = 16, the verify steps' m = 32, m = 64 and prefill m = 1024,
    and at m = 1000 (no tile multiple): on every shape for K6/K7, on w_down
    for K8/K9. K8/K9's activation quantization kernel (``quantize_rows``)
    is held bit-equal to the plain quantization on each of their inputs and
    at m = 1 on both K values. Returns {kernel: max |kernel - plain|}."""
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        KERNELS, quant_matmul)

    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {}
    shapes = [(k, n) for _, k, n in LAYER_SHAPES[:2]] + [
        (4096, 14336), (14336, 4096), LM_HEAD_SHAPE]
    for mode, act_quant in QMM_RECIPES:
        name = KERNELS[(mode, act_quant)]
        cases = [(m, k, n) for k, n in shapes for m in (16, 32, 64, 1024)]
        cases += ([(1000, k, n) for k, n in shapes] if not act_quant
                  else [(1000, 14336, 4096)])
        line = []
        for m, k, n in cases:
            wq = _random_qweight(k, n, mode, act_quant, gen)
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            if act_quant:
                _check_quantize_rows(x)
            got = quant_matmul(x, wq, act_quant=act_quant)
            sync()
            ok, ratio, ulps, err = _check_qmm(got, x, wq, act_quant)
            worst[name] = max(worst.get(name, 0.0), err)
            line.append(f"m{m} {k}x{n} {ratio:.3f}" + (f"/{ulps:.2f}ulp" if act_quant else ""))
            if not ok:
                raise AssertionError(f"{name} m {m} K {k} N {n}: err/bound {ratio}, "
                                     f"ulps {ulps}: disagrees with its plain version")
            del wq, x, got
        print(f"{name}: worst err/bound per case: {', '.join(line)}; max|kernel-plain| "
              f"{worst[name]:.3e} ok", flush=True)
        torch.cuda.empty_cache()
    for k in (4096, 14336):
        _check_quantize_rows(torch.randn(1, k, generator=gen, device="cuda").bfloat16())
    print("quantize_rows: bit-equal to the plain quantization on every K8/K9 case "
          "and at m 1", flush=True)
    return worst


def _quantized_pool(kp, vp, mode):
    """A bf16 pool (NaN where no sequence owns a slot) as quantized pages:
    NaN slots quantize as 0, then fp8 pages get the e4m3 NaN byte there."""
    from flash_attention_from_scratch_tpu_torch.ops.quant import quantize_kv_pages

    out = []
    for p in (kp, vp):
        vals, scales = quantize_kv_pages(torch.nan_to_num(p), mode)
        if mode == "fp8":
            vals.view(torch.uint8)[torch.isnan(p)] = 0x7F
        out += [vals, scales]
    return out


def _run_a_pool(dtype=torch.bfloat16):
    """One layer of run A's first decode step: 16 sequences of 1025 tokens,
    page 128, 32/8 heads; q and the dense pages in ``dtype``. Returns
    (lengths, k_pages, v_pages, lengths tensor, page tables, q)."""
    lengths = [QUANT_PROMPT + 1] * 16
    pages_per_seq = -(-(QUANT_PROMPT + QUANT_NEW) // QUANT_PAGE)
    kp, vp, lens, tables = make_paged_pool(lengths, QUANT_PAGE, 16 * pages_per_seq + 1,
                                           seed=62, pages_per_seq=pages_per_seq, dtype=dtype)
    q = torch.from_numpy(np.random.default_rng(63).standard_normal(
        (len(lengths), HEADS, D)).astype(np.float32)).to("cuda", dtype)
    return lengths, kp, vp, lens, tables, q


def phase_quant_paged_cases() -> float:
    """K4/K5 on int8, fp8 and int4 pages vs the plain version, with a window
    and a softcap: on the same ragged, shuffled pool as the dense cases
    (page 64), and on run A's pool at the serve runs' page size (128; int4
    pages hold 64 byte rows, so the high nibbles start at slot 64). The
    run-A window (600) starts at page 3, so whole pages lie below it."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        sliced_tolerance_check)

    lengths = [1, 17, 64, 65, 1000, 0, 2047, 3001, 4000]
    kp, vp, lens, tables = make_paged_pool(lengths, 64, 320, seed=17,
                                           pages_per_seq=64)
    q = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (len(lengths), HEADS, D)).astype(np.float32)).to("cuda", torch.bfloat16)
    pools = (("page 64", 1000, (lengths, kp, vp, lens, tables, q)),
             (f"page {QUANT_PAGE} (run A)", 600, _run_a_pool()))
    worst = 0.0
    for pool, window, (lengths, kp, vp, lens, tables, q) in pools:
        for mode in ("int8", "fp8", "int4"):
            qk, ks, qv, vs = _quantized_pool(kp, vp, mode)
            for name, kw in (("plain", {}), (f"window {window}", dict(window=window)),
                             ("softcap 30", dict(softcap=30.0))):
                kw = dict(kw, mode=mode, k_scales=ks, v_scales=vs)
                ref16 = paged_decode_attention_plain(q, qk, qv, lens, tables,
                                                     scale=D ** -0.5, **kw)
                ref32 = paged_decode_attention_plain(q.float(), qk, qv, lens, tables,
                                                     scale=D ** -0.5, **kw)
                for splits in PAGED_SPLITS:
                    out = paged_decode_attention(q, qk, qv, lens, tables, splits=splits,
                                                 **kw)
                    sync()
                    ok, ratio, where = sliced_tolerance_check(out, ref16, ref32, lead=1)
                    err = float((out.float() - ref16.float()).abs().max())
                    worst = max(worst, err)
                    good = (ok and bool(torch.isfinite(out).all()) and (
                        0 not in lengths or float(out[lengths.index(0)].abs().max()) == 0.0))
                    print(f"paged_decode_attention {pool} {mode} {name} splits "
                          f"{splits or 'plan'}: max|kernel-plain| {err:.3e}, worst "
                          f"err/bound {ratio:.3f} at length {lengths[where[0]]} "
                          f"{'ok' if good else 'FAIL'}", flush=True)
                    if not good:
                        raise AssertionError(f"paged_decode_attention {pool} {mode} {name} "
                                             "disagrees with its plain version")
    return worst


def _hold_paged(label, out, native, ref32, lengths, launched) -> tuple[float, float]:
    """The tolerance rule in each (sequence, token) on its own; finite
    values, zeros for a length-0 row, one launch. Returns (max |kernel -
    plain|, worst err/bound); raises on a failure."""
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        sliced_tolerance_check)

    def by_token(x):
        return x.transpose(1, 2) if x.ndim == 4 else x[:, None]

    ok, ratio, where = sliced_tolerance_check(by_token(out), by_token(native),
                                              by_token(ref32), lead=2)
    err = float((out.float() - native.float()).abs().max())
    good = (ok and launched == 1 and bool(torch.isfinite(out).all()) and (
        0 not in lengths or float(out[lengths.index(0)].abs().max()) == 0.0))
    print(f"{label}: max|kernel-plain| {err:.3e}, worst err/bound {ratio:.3f} at "
          f"(length, token) ({lengths[where[0]]}, {where[1]}), {launched} launch "
          f"{'ok' if good else 'FAIL'}", flush=True)
    if not good:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err, ratio


def _paged_refs(q, k, v, lens, tables, i8c, kw):
    """The references of a K4/K5 call: (native, fp32). The native one is the
    plain version on the same inputs (with int8_compute when the kernel has
    it), the fp32 one the plain version with q in fp32 (and dense pages in
    fp32), without int8_compute."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention_plain)

    native = paged_decode_attention_plain(q, k, v, lens, tables, int8_compute=i8c, **kw)
    pages32 = (k.float(), v.float()) if k.dtype in (torch.bfloat16, torch.float16) else (k, v)
    ref32 = paged_decode_attention_plain(q.float(), *pages32, lens, tables, **kw)
    return native, ref32


def _paged_kernel(q, k, v, lens, tables, i8c, kw, splits=0):
    """One K4/K5 call: (out, launches of its split kernel)."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        kernel_name, paged_decode_attention)

    name = kernel_name(q.shape[2] if q.ndim == 4 else 1, i8c)
    before = _build.launch_counts[name]
    out = paged_decode_attention(q, k, v, lens, tables, int8_compute=i8c, splits=splits,
                                 **kw)
    sync()
    return out, _build.launch_counts[name] - before


def phase_paged_multi_cases() -> tuple[float, float]:
    """K4/K5's multi-token q (t = 2, 4, 8 on dense, int8, fp8 and int4
    pages, each with a window and with a softcap) and int8_compute (int8
    pages, t = 1 and 4: plain, window, softcap) vs the plain version in
    each (sequence, token), on the ragged page-64 pool of the dense cases
    (lengths 0 to 4000) and on run A's page-128 pool, at split counts 1
    and the plan's. Returns (max |kernel - plain|, worst err/bound)."""
    lengths = [1, 17, 64, 65, 1000, 0, 2047, 3001, 4000]
    pools = (("page 64", 1000, (lengths, *make_paged_pool(lengths, 64, 320, seed=27,
                                                          pages_per_seq=64))),
             (f"page {QUANT_PAGE} (run A)", 600, _run_a_pool()[:5]))
    worst = (0.0, 0.0)
    for pool, window, (lengths, kp, vp, lens, tables) in pools:
        formats = {"dense": (kp, vp, {})}
        for mode in ("int8", "fp8", "int4"):
            qk, ks, qv, vs = _quantized_pool(kp, vp, mode)
            formats[mode] = (qk, qv, dict(mode=mode, k_scales=ks, v_scales=vs))
        options = {"plain": {}, f"window {window}": dict(window=window),
                   "softcap 30": dict(softcap=30.0)}
        cases = [(mode, t, False, opt) for mode in formats for t in PAGED_TOKENS
                 for opt in list(options)[1:]]
        cases += [("int8", t, True, opt) for t in (1, SPEC_K + 1) for opt in options]
        rng = np.random.default_rng(29)
        for mode, t, i8c, opt in cases:
            k, v, kw = formats[mode]
            shape = (len(lengths), HEADS) + ((t,) if t > 1 else ()) + (D,)
            q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
                "cuda", torch.bfloat16)
            kw = dict(kw, scale=D ** -0.5, **options[opt])
            native, ref32 = _paged_refs(q, k, v, lens, tables, i8c, kw)
            for splits in PAGED_SPLITS:
                out, launched = _paged_kernel(q, k, v, lens, tables, i8c, kw, splits)
                label = (f"paged_decode_attention {pool} {'int8c' if i8c else mode} t{t} "
                         f"{opt} splits {splits or 'plan'}")
                worst = tuple(map(max, worst, _hold_paged(label, out, native, ref32,
                                                          lengths, launched)))
        del formats
    torch.cuda.empty_cache()
    return worst


# Gemma-2-9B (google/gemma-2-9b config.json): the head-width-256 model the
# port serves on the card at full width and depth (``serve_gemma2_9b``), and
# the shapes of the d-256 kernel cases and timings: 16 Q heads, 8 KV heads
# of 256, query_pre_attn_scalar 256 (scale 256^-0.5), a 4,096 window on
# alternate layers, attention softcap 50.
GEMMA2_9B_HF = dict(vocab_size=256000, hidden_size=3584, num_hidden_layers=42,
                    num_attention_heads=16, num_key_value_heads=8, head_dim=256,
                    intermediate_size=14336, rope_theta=10000.0, rms_norm_eps=1e-6,
                    query_pre_attn_scalar=256, sliding_window=4096,
                    attn_logit_softcapping=50.0, final_logit_softcapping=30.0)
G9_HEADS, G9_KV_HEADS, G9_D = 16, 8, 256
G9_WINDOW, G9_SOFTCAP = 4096, 50.0
# The served prompts: SERVE_PROMPT_LENS with the longest past the window.
G9_PROMPT_LENS = (200, 513, 1024, 1500, 2048, 2500, 3000, 5000)

# K1's d-256 cases (phase_d256_cases): (label, seq_q, seq_kv, KernelConfig
# fields, extras), b 1, 16/8 heads: a sliding and a global layer's prefill
# of the longest served prompt (5,000 tokens padded to 5,120), a chunk at
# q_offset 4,096 with every option (window, softcap, sinks, LSE, a strided
# view), full attention, and ragged tiles.
D256_FLASH_CASES = [
    ("gemma2-9b prefill s5120 window 4096 softcap 50", 5120, 5120,
     dict(causal=True, window=G9_WINDOW, attn_softcap=G9_SOFTCAP), {}),
    ("gemma2-9b prefill s5120 global softcap 50", 5120, 5120,
     dict(causal=True, attn_softcap=G9_SOFTCAP), {}),
    ("q_offset 4096 s1024/5120 window 4096 softcap 50 sinks strided", 1024, 5120,
     dict(causal=True, q_offset=4096, window=G9_WINDOW, attn_softcap=G9_SOFTCAP),
     dict(sinks=True, strided=True)),
    ("full s1024", 1024, 1024, {}, {}),
    ("ragged s192/320 q_offset 128 window 70", 192, 320,
     dict(causal=True, q_offset=128, window=70), {}),
]


# K2/K3's d-256 cases (phase_d256_cases), BACKWARD_CASES' kinds at 16/8
# heads: causal, full, q_offset, a window of 1,000 (its first key falls
# mid-tile), softcap 50, ragged tiles, and the strided layout the model
# hands over with Gemma-2's window and softcap.
D256_BACKWARD_CASES = (
    ("causal s2048", 2048, 2048, dict(causal=True), {}),
    ("full s1024", 1024, 1024, dict(), {}),
    ("q_offset 512 s512/1024", 512, 1024, dict(causal=True, q_offset=512), {}),
    ("window 1000 s2048", 2048, 2048, dict(causal=True, window=1000), {}),
    ("softcap 50 s1024", 1024, 1024, dict(causal=True, attn_softcap=G9_SOFTCAP), {}),
    ("ragged s192/320 q_offset 128 window 70", 192, 320,
     dict(causal=True, q_offset=128, window=70), {}),
    ("strided s2048 window 1000 softcap 50", 2048, 2048,
     dict(causal=True, window=1000, attn_softcap=G9_SOFTCAP), dict(strided=True)),
)


# K2/K3's d-256 timed shapes: train_gemma2_9b's attention (b 1, 16/8 heads,
# s 8,192, causal) on a global and a sliding layer, with softcap 50 and
# without: (label, window, softcap). The first is the model's global layer.
D256_BACKWARD_TIMED = (("global softcap 50", 0, G9_SOFTCAP), ("global", 0, 0.0),
                       (f"window {G9_WINDOW} softcap 50", G9_WINDOW, G9_SOFTCAP),
                       (f"window {G9_WINDOW}", G9_WINDOW, 0.0))


def phase_d256_cases() -> dict:
    """Head width 256 at Gemma-2-9B's 16/8 heads: K1 and K11 at ring depths
    1-4 on D256_FLASH_CASES (the LSE too; each case's plain references
    computed once for all five) by the tolerance rule in each (batch, head,
    64-row band), K10 on D256_QUANT_CASES (every variant; the attention
    API a Gemma-2 user calls for prefill over a quantized cache),
    K4/K5 on a ragged, shuffled, NaN-poisoned page-64 pool (lengths 0
    to 5,000) on dense, int8, fp8 and int4 pages at t = 1 and 4 (each plain,
    with the 4,096 window and with softcap 50) and int8 compute at t = 1 and
    4, at split counts 1 and the plan's, in each (sequence, token), and K2
    and K3 on D256_BACKWARD_CASES (``_hold_backward_cases``: the rule on
    each gradient, the rerun equalities). Each call must launch its kernel
    once. Returns {"flash", "fori", "quant", "paged": (max |kernel - plain|,
    worst err/bound), "backward": {mode: (the same)}, "fori_launches",
    "quant_launches": the K11 and K10 calls made}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig, KVLoop
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL, KERNEL_FORI, flash_forward_plain, flash_forward_with_lse)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import KERNEL as KQ

    flash = fori = (0.0, 0.0)
    fori_before = _build.launch_counts[KERNEL_FORI]
    for i, (name, sq, skv, kw, extra) in enumerate(D256_FLASH_CASES):
        q, k, v = _cuda_qkv(sq, skv, seed=200 + i, strided=extra.get("strided", False),
                            heads=G9_HEADS, kv_heads=G9_KV_HEADS, d=G9_D)
        sinks = (torch.from_numpy(np.random.default_rng(210 + i).standard_normal(
            G9_HEADS).astype(np.float32) * 2).cuda() if extra.get("sinks") else None)
        cfg = KernelConfig(d_head=G9_D, **kw)
        ref16, _ = flash_forward_plain(q, k, v, cfg, sinks)
        ref32, lse32 = flash_forward_plain(q.float(), k.float(), v.float(), _fp32(cfg),
                                           sinks)
        for n in (0,) + FORI_DEPTHS:  # K1, then K11 at each depth
            run = cfg if n == 0 else dataclasses.replace(cfg, kv_loop=KVLoop.FORI,
                                                         num_kv_buffers=n)
            kernel = KERNEL if n == 0 else KERNEL_FORI
            before = _build.launch_counts[kernel]
            out, lse = flash_forward_with_lse(q, k, v, run, sinks=sinks)
            sync()
            launched = _build.launch_counts[kernel] - before
            lse_err = float((lse - lse32).abs().max())
            got = _hold(f"{kernel}{f' nb{n}' if n else ''} d256 {name}", out, ref16, ref32,
                        launched, good=lse_err <= 1e-3, note=f", lse err {lse_err:.3e}")
            if n == 0:
                flash = tuple(map(max, flash, got))
            else:
                fori = tuple(map(max, fori, got))
            del out, lse
        del q, k, v, ref16, ref32
    fori_launches = _build.launch_counts[KERNEL_FORI] - fori_before
    torch.cuda.empty_cache()

    quant = (0.0, 0.0)
    quant_before = _build.launch_counts[KQ]
    for i, (name, variant, seq, batch, kw, strided) in enumerate(D256_QUANT_CASES):
        qq, kq, vq = _quant_qkv(variant, seq, seed=230 + i, batch=batch, strided=strided,
                                heads=G9_HEADS, kv_heads=G9_KV_HEADS, d=G9_D)
        quant = tuple(map(max, quant, _flash_quant_case(
            f"d256 {name}", qq, kq, vq, KernelConfig(d_head=G9_D, **kw),
            QUANT_VARIANTS[variant][2])))
        del qq, kq, vq
    quant_launches = _build.launch_counts[KQ] - quant_before
    torch.cuda.empty_cache()

    lengths = [1, 17, 64, 65, 1000, 0, 2047, 3001, 5000]
    kp, vp, lens, tables = make_paged_pool(lengths, 64, 320, seed=37, pages_per_seq=80,
                                           kv_heads=G9_KV_HEADS, d=G9_D)
    formats = {"dense": (kp, vp, {})}
    for mode in ("int8", "fp8", "int4"):
        qk, ks, qv, vs = _quantized_pool(kp, vp, mode)
        formats[mode] = (qk, qv, dict(mode=mode, k_scales=ks, v_scales=vs))
    options = {"plain": {}, f"window {G9_WINDOW}": dict(window=G9_WINDOW),
               f"softcap {G9_SOFTCAP:g}": dict(softcap=G9_SOFTCAP)}
    cases = [(mode, t, False, opt) for mode in formats for t in (1, SPEC_K + 1)
             for opt in options]
    cases += [("int8", t, True, opt) for t in (1, SPEC_K + 1) for opt in options]
    rng = np.random.default_rng(39)
    paged = (0.0, 0.0)
    for mode, t, i8c, opt in cases:
        k, v, kw = formats[mode]
        shape = (len(lengths), G9_HEADS) + ((t,) if t > 1 else ()) + (G9_D,)
        q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        kw = dict(kw, scale=G9_D ** -0.5, **options[opt])
        native, ref32 = _paged_refs(q, k, v, lens, tables, i8c, kw)
        for splits in PAGED_SPLITS:
            out, launched = _paged_kernel(q, k, v, lens, tables, i8c, kw, splits)
            label = (f"paged_decode_attention d256 {'int8c' if i8c else mode} t{t} {opt} "
                     f"splits {splits or 'plan'}")
            paged = tuple(map(max, paged, _hold_paged(label, out, native, ref32, lengths,
                                                      launched)))
    del formats, kp, vp
    torch.cuda.empty_cache()
    backward = _hold_backward_cases(D256_BACKWARD_CASES, "d256 ", G9_HEADS, G9_KV_HEADS, G9_D)
    return {"flash": flash, "fori": fori, "quant": quant, "paged": paged,
            "backward": backward, "fori_launches": fori_launches,
            "quant_launches": quant_launches}


def _param_bytes(params) -> int:
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import QuantizedWeight

    def walk(x):
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, list):
            return sum(walk(v) for v in x)
        if isinstance(x, QuantizedWeight):
            return walk(x.values) + walk(x.scales)
        return x.numel() * x.element_size()

    return walk(params)


def phase_serve_quant(run: str, smi: str, graph_check: bool = False) -> dict:
    """One quantized serve run of LLAMA3_8B at full width (QUANT_RUNS); see
    ``_serve_quant``. A speculative run's prompts repeat a phrase."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B

    spec = QUANT_RUNS[run]
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=spec["layers"])
    if spec.get("spec_k"):
        prompts = _phrase_prompts([QUANT_PROMPT] * spec["requests"], cfg.vocab_size, 2)
    else:
        rng = np.random.default_rng(0)
        prompts = {i: rng.integers(0, cfg.vocab_size, QUANT_PROMPT).tolist()
                   for i in range(spec["requests"])}
    graph_lengths = [QUANT_PROMPT + 17] * spec["requests"] if graph_check else None
    return _serve_quant(run, "LLAMA3_8B", cfg, spec, prompts, QUANT_PAGE, smi, graph_lengths)


def _serve_quant(run: str, model: str, cfg, spec: dict, prompts: dict, page: int, smi: str,
                 graph_lengths=None) -> dict:
    """One quantized serve run: ``spec``'s weights (``wmode``, ``act``; by
    ``init_quantized_params``, the lm_head included), KV pages (``kv``, of
    ``page`` tokens), ``chunk`` (greedy decode loops), ``attn_int8`` and
    ``spec_k``; ``prompts`` ({sid: tokens}) served QUANT_NEW greedy tokens
    each after the graphs are warmed. Checks the launch counts of its
    quantized kernel, K1 and K4/K5 (and its merge; the int8-compute and
    multi-token entries where the run has them), every token and finite
    logits, and two requests teacher-forced through ``forward``; with
    ``graph_lengths`` a ``graph_case`` at those lengths (the replayed step
    equal to the eager one bit for bit). A speculative run must have
    verified drafts. Prints the ``serve_quant`` line (decode and prefill
    tokens/s, peak memory, the card) and returns the run's counts."""
    from flash_attention_from_scratch_tpu_torch import GenerationServer, init_quantized_params
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import kernel_name
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS

    i8c, spec_k = spec.get("attn_int8", False), spec.get("spec_k", 0)
    chunk = spec.get("chunk", 1)
    kernel = KERNELS[(spec["wmode"], spec["act"] == "int8")]
    t0 = time.perf_counter()
    params = init_quantized_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   spec["wmode"], act=spec["act"])
    requests = len(prompts)
    # The table holds a prompt and the larger of the run's budget and
    # phase_profile's (4 server steps of ``chunk`` tokens, and one).
    new_tokens = max(QUANT_NEW, 4 * chunk + 1)
    pages_per_seq = -(-(max(map(len, prompts.values())) + new_tokens) // page)
    # Each request's pages, one page of admission headroom (the scheduler
    # admits a prompt only with a page to spare) and the scratch page.
    server = GenerationServer(params, cfg, num_pages=requests * pages_per_seq + 2,
                              page_size=page, max_batch=requests,
                              pages_per_seq=pages_per_seq, mode=spec["kv"],
                              attn_int8=i8c, spec_k=spec_k, chunk=chunk)
    sync()
    weight_gb, kv_gb = _param_bytes(params) / 1e9, server.cache.nbytes() / 1e9
    print(f"serve {run}: {model}, {spec}, weights {weight_gb:.2f} GB, KV pool "
          f"{kv_gb:.3f} GB, set-up {time.perf_counter() - t0:.1f} s", flush=True)

    capture_s = _warm_graphs(server, cfg.vocab_size, QUANT_NEW)
    result = _drive(server, prompts, QUANT_NEW)
    counts, stats = result["counts"], result["stats"]
    got = {sid: server.seqs[sid].generated for sid in prompts}
    if any(len(g) != QUANT_NEW for g in got.values()):
        raise AssertionError(f"serve {run}: token counts {[len(g) for g in got.values()]}")
    if result["nonfinite"] or stats["preemptions"]:
        raise AssertionError(f"serve {run}: {result['nonfinite']} non-finite logits, "
                             f"{stats['preemptions']} preemptions")
    if spec_k and (stats["verify_steps"] == 0 or stats["spec_proposed"] == 0):
        raise AssertionError(f"serve {run}: nothing was speculated: {stats}")
    if chunk > 1 and stats["decode_loops"] == 0:
        raise AssertionError(f"serve {run}: no decode loop ran: {stats}")
    steps = stats["decode_steps"] + stats["verify_steps"]
    calls = len(prompts) + steps  # prefills + decode and verify steps
    want = {kernel: (7 * cfg.n_layers + 1) * calls, K1: cfg.n_layers * len(prompts)}
    for t, n in ((1, stats["decode_steps"]), (spec_k + 1, stats["verify_steps"])):
        if n:
            want[kernel_name(t, i8c)] = cfg.n_layers * n
    want = _with_merges(want, requests, pages_per_seq, page, spec["kv"], i8c, spec_k,
                        kv_heads=cfg.n_kv_heads, group=cfg.n_heads // cfg.n_kv_heads,
                        d_head=cfg.d_head)
    print(f"serve {run}: launches {counts}; expected {want} ((7 x {cfg.n_layers} + 1) "
          f"x ({len(prompts)} prefills + {stats['decode_steps']} decode + "
          f"{stats['verify_steps']} verify steps), the lm_head {cfg.dim} x "
          f"{cfg.vocab_size} once a call)", flush=True)
    if counts != want:
        raise AssertionError(f"serve {run}: a kernel of the path ran the wrong number of times")

    worst = 0.0
    for sid in list(prompts)[:2]:
        gaps, std = _teacher_forced_gaps(params, cfg, prompts[sid], got[sid])
        rel = float((gaps / std).max())
        worst = max(worst, rel)
        print(f"serve {run}: teacher-forced request {sid}: worst gap {float(gaps.max()):.4f} "
              f"= {rel:.4f} row std (row std {float(std.mean()):.3f}), limit "
              f"{QUANT_SLACK_STD}", flush=True)
        if rel > QUANT_SLACK_STD:
            raise AssertionError(f"serve {run}: a served token sits {rel} row std "
                                 "below the full-recompute max")
    cases = [graph_case(f"run {run} t1", server, graph_lengths, 1)] if graph_lengths else []
    prof = phase_profile(server, prompts, run=run)
    ttft = sorted(server.seqs[sid].first_t - server.seqs[sid].submit_t for sid in prompts)
    lens = [len(p) for p in prompts.values()]
    line = {
        "run": run, "model": model, "layers": cfg.n_layers, "vocab": cfg.vocab_size,
        **spec, "prompt_tokens": (lens[0] if len(set(lens)) == 1 else lens),
        "new_tokens_per_request": QUANT_NEW, "page_size": page,
        "prefill_tok_s": stats["prefill_tokens"] / result["prefill_s"],
        "decode_tok_s": result["decode_tokens"] / result["decode_s"],
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
        "wall_s": result["wall_s"], "decode_steps": stats["decode_steps"],
        "decode_loops": stats["decode_loops"],
        **(_spec_line(stats, result) if spec_k else {}),
        "weight_gb": weight_gb, "kv_cache_gb": kv_gb,
        "peak_mem_gb": result["peak_mem_gb"], **_graph_fields(server, result, prof),
        "warm_up_s": capture_s, "graph_cases": cases, "launches": counts,
        "teacher_forced_worst_gap_std": worst, "gpu": smi,
    }
    print(json.dumps({"serve_quant": line}), flush=True)
    return {"kernel": kernel, "launches": counts[kernel], "counts": counts}


# Every shape the JAX kernels take: K6-K9 at ragged K and N, K4/K5
# at any page size, and OpenHermes-2.5-Mistral-7B served quantized.
# teknium/OpenHermes-2.5-Mistral-7B's config.json: Mistral-7B's widths
# (dim 4096, 32 layers, 32/8 heads, d 128, hidden 14336, window 4096,
# rope_theta 10000) with two ChatML tokens added, vocab_size 32002.
OPENHERMES_VOCAB = 32002
# R1: full width and depth, int8 weights (K6, the 32,002-wide lm_head
# included), a dense cache in pages of 1 token (SGLang's default page
# size), chunk 1. R2: 4 layers, W4A8 (K9), int8 pages of 96 tokens, chunk 8.
OPENHERMES_RUNS = {
    "R1": dict(wmode="int8", act="bf16", kv="dense", layers=32, page=1, chunk=1),
    "R2": dict(wmode="int4", act="int8", kv="int8", layers=4, page=96, chunk=8),
}
OPENHERMES_PROMPTS = {"R1": (200, 457, 714, 971, 1228, 1485, 1742, 2000),
                      "R2": (1024,) * 4}
# (K, N) the kernels refused before: the 32,002-wide head, N % 16 = 4 with
# K % 32 != 0 (4,000) and K % 16 = 4 (4,004), and an N below one tile.
ANY_QMM_SHAPES = ((4096, OPENHERMES_VOCAB), (4000, 4100), (4004, 4100), (4096, 40))
ANY_QMM_ROWS = (1, 16, 32, 1000, 1024)
# Page sizes of the K4/K5 cases: 40 on the chunk walk (int4: also 96 and
# 200, whole), the rest on the gather walk; int4 pages are even.
ANY_PAGE_SIZES = {"dense": (1, 4, 12, 40, 72, 96, 100, 200),
                  "int4": (2, 12, 40, 96, 100, 200)}
ANY_PAGE_LENGTHS = [0, 1, 4, 37, 300, 611, 2000]


def _poison_free_memory(mb: int = 512) -> None:
    """Fill the memory the caching allocator hands out next with 0xFF bytes
    (NaN in bf16 and fp32, -1 in int32): one large block (the large pool)
    and 1 MB blocks (the small pool), freed at once, so that an output or a
    workspace a kernel leaves unwritten reads as NaN."""
    blocks = [torch.full((mb << 20,), 0xFF, dtype=torch.uint8, device="cuda")]
    blocks += [torch.full((1 << 20,), 0xFF, dtype=torch.uint8, device="cuda")
               for _ in range(8)]
    del blocks


def phase_qmm_any_shape_cases() -> dict:
    """K6-K9 at ANY_QMM_SHAPES and m in ANY_QMM_ROWS, each call on NaN-
    poisoned memory: K6/K7 by ``_check_qmm``'s rule in each 64-row band;
    K8/K9 equal to their plain versions bit for bit, and ``quantize_rows``
    to the plain quantization on every K8/K9 input; one launch a call; no
    call copies the weight (its address, and a call's peak allocation below
    the weight's bytes at m <= 32 and N >= 4,096). Returns {kernel:
    {"max_abs_err", "worst_err_bound", "cases"}}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        KERNELS, quant_matmul, quant_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(41)
    result = {}
    for mode, act_quant in QMM_RECIPES:
        name = KERNELS[(mode, act_quant)]
        err_max = ratio_max = 0.0
        line = []
        for k, n in ANY_QMM_SHAPES:
            wq = _random_qweight(k, n, mode, act_quant, gen)
            ptr = wq.values.data_ptr()
            for m in ANY_QMM_ROWS:
                x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
                if act_quant:
                    _check_quantize_rows(x)
                sync()
                _poison_free_memory()
                torch.cuda.reset_peak_memory_stats()
                base, before = torch.cuda.memory_allocated(), _build.launch_counts[name]
                got = quant_matmul(x, wq, act_quant=act_quant)
                sync()
                call_bytes = torch.cuda.max_memory_allocated() - base
                launched = _build.launch_counts[name] - before
                ok, ratio, _, err = _check_qmm(got, x, wq, act_quant)
                if act_quant:
                    ok = ok and torch.equal(got, quant_matmul_plain(x, wq, True))
                copied = (m <= 32 and n >= 4096 and call_bytes >= wq.values.numel())
                ok = (ok and launched == 1 and got.shape == (m, n) and not copied
                      and wq.values.data_ptr() == ptr)
                err_max, ratio_max = max(err_max, err), max(ratio_max, ratio)
                line.append(f"m{m} {k}x{n} {ratio:.3f}")
                if not ok:
                    raise AssertionError(
                        f"{name} m {m} K {k} N {n}: err/bound {ratio}, launches {launched}, "
                        f"call bytes {call_bytes} (weight {wq.values.numel()}): disagrees "
                        "with its plain version or copied the weight")
                del x, got
            del wq
        result[name] = {"max_abs_err": err_max, "worst_err_bound": ratio_max,
                        "cases": len(line)}
        print(f"{name} at any shape: {', '.join(line)}; max|kernel-plain| {err_max:.3e}"
              f"{' (bit-equal)' if act_quant else ''} ok", flush=True)
        torch.cuda.empty_cache()
    return result


def _any_page_pool(lengths, ps, store, d, seed):
    """A shuffled pool of ``ps``-token pages (8 KV heads of width ``d``),
    NaN where no sequence owns a slot, as ``store`` pages (the quantized
    ones with each page's K scale also multiplied by its own factor in
    [0.5, 2], so a tile across pages must take each token's). Returns (k,
    v, lengths, tables, keyword arguments of the format)."""
    need = sum(-(-n // ps) for n in lengths)
    kp, vp, lens, tables = make_paged_pool(lengths, ps, need + 3, seed=seed,
                                           pages_per_seq=max(-(-n // ps) for n in lengths),
                                           d=d)
    if store == "dense":
        return kp, vp, lens, tables, {}
    qk, ks, qv, vs = _quantized_pool(kp, vp, store)
    ks = ks * torch.linspace(0.5, 2.0, ks.numel(), device="cuda").view_as(ks)
    return qk, qv, lens, tables, dict(mode=store, k_scales=ks, v_scales=vs)


def phase_paged_any_size_cases() -> dict:
    """K4/K5 at ANY_PAGE_SIZES in every store and int8 compute, d 128 (32/8
    heads) and d 256 (16/8), t 1 and 4, on pools of ANY_PAGE_LENGTHS with
    NaN in every slot no sequence owns, each call on NaN-poisoned memory:
    plain at split counts 1 and the plan's, a window of 100 and a softcap
    of 20 at the plan's, by the rule of ``_hold_paged`` against the plain
    version (without its line a call). Returns {"max_abs_err",
    "worst_err_bound", "calls", "gather_calls"}."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        MODE_INT8C, MODES, plan)
    from flash_attention_from_scratch_tpu_torch.utils.device import sm_count
    from flash_attention_from_scratch_tpu_torch.utils.testing import sliced_tolerance_check

    def by_token(x):
        return x.transpose(1, 2) if x.ndim == 4 else x[:, None]

    err_max = ratio_max = 0.0
    calls = gather_calls = 0
    lengths = ANY_PAGE_LENGTHS
    for d, heads in ((D, HEADS), (256, 16)):
        for store in ("dense", "int8", "fp8", "int4", "int8c"):
            i8c = store == "int8c"
            pages = "int8" if i8c else store
            for ps in ANY_PAGE_SIZES.get(pages, ANY_PAGE_SIZES["dense"]):
                k, v, lens, tables, kw0 = _any_page_pool(lengths, ps, pages, d,
                                                         seed=ps + d)
                p = plan(len(lengths), KV_HEADS, heads // KV_HEADS, tables.shape[1], ps,
                         MODE_INT8C if i8c else MODES[pages][0], sm_count(k.device),
                         d_head=d)
                worst = 0.0
                for t in (1, 4):
                    q = torch.randn((len(lengths), heads) + ((t,) if t > 1 else ()) + (d,),
                                    device="cuda").bfloat16()
                    for kw_name, kw in (("plain", {}), ("window 100", dict(window=100)),
                                        ("softcap 20", dict(softcap=20.0))):
                        kw = dict(kw0, scale=d ** -0.5, **kw)
                        native, ref32 = _paged_refs(q, k, v, lens, tables, i8c, kw)
                        for splits in ((1, 0) if kw_name == "plain" else (0,)):
                            sync()
                            _poison_free_memory(64)
                            out, launched = _paged_kernel(q, k, v, lens, tables, i8c, kw,
                                                          splits)
                            ok, ratio, where = sliced_tolerance_check(
                                by_token(out), by_token(native), by_token(ref32), lead=2)
                            err = float((out.float() - native.float()).abs().max())
                            good = (ok and launched == 1 and bool(torch.isfinite(out).all())
                                    and float(out[lengths.index(0)].abs().max()) == 0.0)
                            if not good:
                                raise AssertionError(
                                    f"paged_decode_attention {store} page {ps} d {d} t {t} "
                                    f"{kw_name} splits {splits or 'plan'}: err/bound "
                                    f"{ratio} at (length, token) ({lengths[where[0]]}, "
                                    f"{where[1]}), {launched} launches: disagrees with "
                                    "its plain version")
                            err_max, worst = max(err_max, err), max(worst, ratio)
                            calls += 1
                            gather_calls += p.gather
                ratio_max = max(ratio_max, worst)
                print(f"paged_decode_attention {store} page {ps} d {d}: "
                      f"{'gather' if p.gather else 'chunk'} walk, t 1 and 4, plain / "
                      f"window / softcap, splits 1 and {p.splits}: worst err/bound "
                      f"{worst:.3f} ok", flush=True)
                del k, v, lens, tables, kw0
    print(f"paged_decode_attention at any page size: {calls} calls ({gather_calls} on the "
          f"gather walk), max|kernel-plain| {err_max:.3e}, worst err/bound "
          f"{ratio_max:.3f} ok", flush=True)
    return {"max_abs_err": err_max, "worst_err_bound": ratio_max, "calls": calls,
            "gather_calls": gather_calls}


def phase_serve_openhermes(run: str, smi: str) -> dict:
    """OpenHermes-2.5-Mistral-7B's widths (``MISTRAL_7B`` with its 32,002-
    word vocabulary) served quantized, OPENHERMES_RUNS[run] with random
    weights from a seed: the checks of ``_serve_quant``, R1's replayed step
    held to the eager one at its prompts' lengths + 17."""
    from flash_attention_from_scratch_tpu_torch import MISTRAL_7B

    spec = OPENHERMES_RUNS[run]
    cfg = dataclasses.replace(MISTRAL_7B, vocab_size=OPENHERMES_VOCAB,
                              n_layers=spec["layers"])
    rng = np.random.default_rng(5)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(OPENHERMES_PROMPTS[run])}
    graph_lengths = [n + 17 for n in OPENHERMES_PROMPTS[run]] if run == "R1" else None
    return _serve_quant(run, "OpenHermes-2.5-Mistral-7B", cfg, spec, prompts, spec["page"],
                        smi, graph_lengths)


def time_lm_head_32002() -> dict:
    """The 4,096 x 32,002 lm_head at R1's decode batch (m 8), each recipe:
    the call's time by CUDA-graph replay (``_graph_ms``: torch.profiler
    dropped records of these launches, reading some calls below their
    bound), the plain version's, the bound (the weight's bytes once, plus
    x, scales and out, over 3.35 TB/s) and the library's, timed alike:
    cuBLAS ``x @ w`` on the dequantized bf16 weight; for a8
    ``torch._int_mm``, which takes no N % 8 != 0 (``library_note``)."""
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        KERNELS, quant_matmul, quant_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(43)
    k, n, m = 4096, OPENHERMES_VOCAB, 8
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    out = {}
    for mode, act_quant in QMM_RECIPES:
        wq = _random_qweight(k, n, mode, act_quant, gen)
        ms = _graph_ms(lambda: quant_matmul(x, wq, act_quant=act_quant))
        plain_ms = _time_ms(lambda: quant_matmul_plain(x, wq, act_quant), iters=3, warmup=1)
        nbytes, ops = _shape_work(m, k, n, wq)
        bound_b = nbytes / PEAK_BYTES_PER_S
        bound_o = ops / (PEAK_INT8_OPS if act_quant else PEAK_BF16_FLOPS)
        lib_ms, note = None, "cuBLAS x @ w on the dequantized bf16 weight"
        if act_quant:
            note = "torch._int_mm takes no N % 8 != 0: not timed"
        else:
            w_lib = wq.dequantize()
            lib_ms = _graph_ms(lambda: x @ w_lib)
            del w_lib
        out[KERNELS[(mode, act_quant)]] = {
            "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_note": note,
            "bound_ms": 1e3 * max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations",
            "shape": f"m {m} x K {k} x N {n}, {nbytes / 1e6:.1f} MB"}
        del wq
    return out


def time_paged_page_sizes() -> dict:
    """K4/K5 at R1's first decode step (8 sequences of R1's prompt lengths
    + 1, 32/8 heads, d 128, dense bf16 pages) at page 1 (the gather walk)
    and page 64 (the chunk walk): the same lengths and bytes, the whole call
    by CUDA-graph replay (``_graph_ms``), the plain version, the bound (the
    K/V bytes once over 3.35 TB/s). And R2's step (4 x 1,025 tokens, int8
    pages) at page 96 (gather) and 128 (chunk)."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain, plan)
    from flash_attention_from_scratch_tpu_torch.utils.device import sm_count

    out = {}
    for run, pages, store in (("R1", (1, 64), "dense"), ("R2", (96, 128), "int8")):
        lengths = [n + 1 for n in OPENHERMES_PROMPTS[run]]
        q = torch.from_numpy(np.random.default_rng(71).standard_normal(
            (len(lengths), HEADS, D)).astype(np.float32)).to("cuda", torch.bfloat16)
        per_token = KV_HEADS * D * (2 if store == "dense" else 1) * 2  # K and V
        nbytes = sum(lengths) * per_token + 2 * q.numel() * 2
        for ps in pages:
            k, v, lens, tables, kw = _any_page_pool(lengths, ps, store, D, seed=72)
            p = plan(len(lengths), KV_HEADS, HEADS // KV_HEADS, tables.shape[1], ps,
                     0 if store == "dense" else 1, sm_count(q.device))
            ms = _graph_ms(lambda: paged_decode_attention(q, k, v, lens, tables, **kw))
            plain_ms = _time_ms(lambda: paged_decode_attention_plain(
                q, k, v, lens, tables, scale=D ** -0.5, **kw), iters=3, warmup=1)
            # The plan's split count against forced ones (more CTAs on the walk).
            forced = {s: _graph_ms(lambda: paged_decode_attention(q, k, v, lens, tables,
                                                                  splits=s, **kw))
                      for s in (2, 4, 8, 16) if s != p.splits}
            out[f"{run}_page{ps}"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
                "walk": "gather" if p.gather else "chunk", "splits": p.splits,
                "forced_splits_ms": forced,
                "shape": f"lengths {lengths}, page {ps}, {store} pages, {HEADS}/{KV_HEADS} "
                         f"heads, d {D} (one layer)"}
            del k, v, lens, tables, kw
    return out


def _device_ms(fn, calls: int) -> dict:
    """Device time of one call of ``fn`` from torch.profiler, the mean over
    ``calls`` calls after one warm-up: "all" kernels it launches, the
    "kernel" share of the quantized matmul's own (``quant_matmul_*``: the
    product and its split-K finalize) and the "quantize" share of K8/K9's
    activation quantization kernel (``quantize_rows_kernel``). Device time,
    not a host clock: at decode the host enqueues these small launches more
    slowly than the card runs them. torch.profiler now and then records no
    kernel in a window (once three windows of K7's lm_head call in a row):
    an empty window is traced again, and after three the calls are timed by
    CUDA-graph replay (``_graph_ms``: the kernels and the gaps between
    them), with no share by kernel (None)."""
    fn()
    for _ in range(3):
        prof = _profile(lambda: [fn() for _ in range(calls)], top=10_000)
        if prof["device_ms"] > 0:
            break
    else:
        ms = _graph_ms(fn, calls=calls)
        print(f"torch.profiler recorded no kernel in three windows: {ms:.4f} ms a call "
              "by CUDA-graph replay, no share by kernel", flush=True)
        return {"all": ms, "kernel": None, "quantize": None}
    own = sum(ms for name, ms in prof["top_kernels_ms"].items()
              if "quant_matmul_" in name)
    quant = sum(ms for name, ms in prof["top_kernels_ms"].items()
                if "quantize_rows" in name)
    return {"all": prof["device_ms"] / calls, "kernel": own / calls,
            "quantize": quant / calls}


def _host_us_per_call(fn, calls: int = 200) -> float:
    """Wall microseconds per call of ``fn``, called back to back. Where the
    call's kernels are shorter than the host's work for it (decode's small
    weights), this is the host's cost of a call, which the card waits on."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def _shape_work(m, k, n, wq, out_bytes=2):
    """Bytes (weight values + scales, x, out, each once) and operations."""
    x_bytes = m * k * (1 if wq.act == "int8" else 2)
    return (wq.values.numel() + 4 * n + x_bytes + out_bytes * m * n, 2 * m * k * n)


def time_quant_matmul(mode: str, act_quant: bool, ptxas: dict,
                      dtype=torch.bfloat16) -> dict:
    """One recipe at a decode step's matmuls (m = 16: 7 x 32 projections,
    timed over 4 distinct layers so each weight streams from memory, plus
    the lm_head) and at one 1024-row prefill layer, as device time summed
    over the kernels each call launches (for a8 the activation quantization
    included; ``kernel_only_ms`` counts K6-K9's own kernels, the product and
    its split-K finalize; ``quantize_ms`` K8/K9's ``quantize_rows``).
    x and the output in ``dtype`` (bf16 or fp16).
    Library: cuBLAS ``x @ w`` on the weight dequantized to x's type (the same
    function up to rounding) for weight-only; for a8 ``torch._int_mm`` after
    the plain quantization, plus the scale epilogue, with x zero-padded to 32
    rows at decode (``_int_mm`` takes m > 16 only), timed in the same call,
    with the kernel's factor to it. At decode also the host's cost of one
    wrapper call and of one library call (``_host_us_per_call`` on w_k,
    whose kernel is the shortest). ``ptxas``: the build's registers and
    spills per mangled kernel name; the recipe's own kernels go into the
    result."""
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        KERNELS, quant_matmul, quant_matmul_plain, quantize_activations)

    gen = torch.Generator(device="cuda").manual_seed(23)
    layers = [[(name, _random_qweight(k, n, mode, act_quant, gen, dtype))
               for name, k, n in LAYER_SHAPES] for _ in range(4)]
    lm = _random_qweight(*LM_HEAD_SHAPE, mode, act_quant, gen, dtype)
    peak = PEAK_INT8_OPS if act_quant else PEAK_BF16_FLOPS

    def inputs(m):
        ks = {k for _, k, _ in LAYER_SHAPES} | {LM_HEAD_SHAPE[0]}
        return {k: torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                for k in ks}

    def run_layer(fn, xs, ws):
        return [fn(xs[w.k_dim], w) for _, w in ws]

    def kernel(x, w):
        return quant_matmul(x, w, act_quant=act_quant)

    def plain(x, w):
        return quant_matmul_plain(x, w, act_quant)

    # The library's operands for one layer: the unscaled int8 values, or the
    # dequantized bf16 weight.
    lib_ws = [w.stored_columns(torch.int8) if act_quant else w.dequantize()
              for _, w in layers[0]]

    def library(x, w_lib, scales):
        if not act_quant:
            return x @ w_lib
        xq, xs = quantize_activations(x)
        rows = xq.shape[0]
        if rows <= 16:  # torch._int_mm refuses m <= 16: zero rows up to 32
            xq = torch.cat([xq, xq.new_zeros(32 - rows, xq.shape[1])])
        return (torch._int_mm(xq, w_lib)[:rows].float() * xs * scales).to(x.dtype)

    def lib_layer(xs):
        return [library(xs[w.shape[0]], w, q.scales)
                for w, (_, q) in zip(lib_ws, layers[0])]

    out = {}
    for phase, m in (("decode", 16), ("prefill", 1024)):
        xs = inputs(m)
        reps = 32 if phase == "decode" else 1
        if phase == "decode":
            per_layer = _device_ms(lambda: [run_layer(kernel, xs, ws) for ws in layers],
                                   calls=5)
            per_layer = {k: None if v is None else v / len(layers)
                         for k, v in per_layer.items()}
            lm_t = _device_ms(lambda: kernel(xs[LM_HEAD_SHAPE[0]], lm), calls=5)
        else:
            per_layer = _device_ms(lambda: run_layer(kernel, xs, layers[0]), calls=3)
            lm_t = {"all": 0.0, "kernel": 0.0, "quantize": 0.0}
        ms, kernel_only, quantize = (
            None if per_layer[k] is None or lm_t[k] is None else reps * per_layer[k] + lm_t[k]
            for k in ("all", "kernel", "quantize"))
        plain_ms = reps * _device_ms(lambda: run_layer(plain, xs, layers[0]),
                                     calls=1)["all"]
        if phase == "decode":
            plain_ms += _device_ms(lambda: plain(xs[LM_HEAD_SHAPE[0]], lm), calls=1)["all"]
        nbytes = ops = 0
        for _, w in layers[0]:
            b, o = _shape_work(m, w.k_dim, w.shape[1], w)
            nbytes, ops = nbytes + reps * b, ops + reps * o
        if phase == "decode":
            b, o = _shape_work(m, *LM_HEAD_SHAPE, lm)
            nbytes, ops = nbytes + b, ops + o
        bound_b, bound_o = nbytes / PEAK_BYTES_PER_S, ops / peak
        lib_note = ("quantize_activations + torch._int_mm + the scale epilogue"
                    + (" (x zero-padded to 32 rows: _int_mm refuses m <= 16)"
                       if m <= 16 else "")
                    if act_quant else f"cuBLAS x @ w on the dequantized {_dname(dtype)} weight")
        try:
            lib_ms = reps * _device_ms(lambda: lib_layer(xs), calls=5)["all"]
            if phase == "decode":
                lm_lib = lm.stored_columns(torch.int8) if act_quant else lm.dequantize()
                lib_ms += _device_ms(lambda: library(xs[LM_HEAD_SHAPE[0]], lm_lib,
                                                     lm.scales), calls=5)["all"]
                del lm_lib
        except RuntimeError as e:  # torch._int_mm's shape rules
            lib_ms, lib_note = None, f"refused: {str(e).splitlines()[0][:160]}"
        if phase == "decode":
            (_, wk), wk_lib = next((nw, w) for nw, w in zip(layers[0], lib_ws)
                                   if nw[0] == "wk")
            host = {"host_us_per_call": _host_us_per_call(lambda: kernel(xs[wk.k_dim], wk))}
            if lib_ms is not None:
                host["library_host_us_per_call"] = _host_us_per_call(
                    lambda: library(xs[wk.k_dim], wk_lib, wk.scales))
        else:
            host = {}
        out[phase] = {
            **host,
            "ms": ms, "kernel_only_ms": kernel_only,
            **({"quantize_ms": quantize} if act_quant else {}), "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_note": lib_note,
            "library_factor": ms / lib_ms if lib_ms else None,
            "bound_ms": 1e3 * max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations",
            "shape": (f"one decode step: m 16, 7 x 32 projections + lm_head, "
                      f"{nbytes / 1e9:.3f} GB" if phase == "decode" else
                      "one prefill layer: m 1024, the 7 projections"),
        }
        del xs
    del layers, lm, lib_ws
    torch.cuda.empty_cache()
    # The kernel template of this recipe: quant_matmul_kernel<W4, A8, BT>
    # (Itanium-mangled bools W4, A8).
    own = f"quant_matmul_kernelILb{int(mode == 'int4')}ELb{int(act_quant)}E"
    regs = {name: v for name, v in ptxas.items() if own in name}
    for name, v in regs.items():
        print(f"ptxas {KERNELS[(mode, act_quant)]}: {name}: {v}", flush=True)
    return {**out["decode"], "prefill": out["prefill"], "ptxas": regs}


def time_paged_formats(dtype=torch.bfloat16) -> dict:
    """K4/K5 per page format at run A's first decode step: 16 sequences of
    1025 tokens, page 128, 32/8 heads, q (and dense pages) in ``dtype``
    (``_graph_ms``)."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    lengths, kp, vp, lens, tables, q = _run_a_pool(dtype)
    used_pages = sum(-(-n // QUANT_PAGE) for n in lengths)
    out = {}
    for mode, elem in (("dense", 2.0), ("int8", 1.0), ("fp8", 1.0), ("int4", 0.5)):
        if mode == "dense":
            k, v, kw = kp, vp, {}
        else:
            k, ks, v, vs = _quantized_pool(kp, vp, mode)
            kw = dict(mode=mode, k_scales=ks, v_scales=vs)
        ms = _graph_ms(lambda: paged_decode_attention(q, k, v, lens, tables, **kw))
        plain_ms = _time_ms(lambda: paged_decode_attention_plain(
            q, k, v, lens, tables, scale=D ** -0.5, **kw), iters=3, warmup=1)
        nbytes = (sum(lengths) * KV_HEADS * D * 2 * elem + 2 * q.numel() * 2
                  + (2 * 4 * KV_HEADS * used_pages if mode != "dense" else 0))
        out[mode] = {"ms": ms, "plain_ms": plain_ms,
                     "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes"}
    return {"shape": f"lengths 16 x {QUANT_PROMPT + 1}, page {QUANT_PAGE}, "
                     f"{HEADS}/{KV_HEADS} heads, d {D}, {_dname(dtype)} q (one layer)", **out}


def _time_paged_pair(q, k, v, lens, tables, kw, i8c, lengths, nbytes, shape) -> dict:
    """K4/K5 on ``q`` (int8_compute when ``i8c``) beside the single-token
    call without int8_compute at the same lengths (the last token of a
    multi-token q): times (``_graph_ms``), the byte bound, the plain
    version's time and the call's worst err/bound against the plain
    version."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    q1 = q[:, :, -1].contiguous() if q.ndim == 4 else q
    ms = _graph_ms(lambda: paged_decode_attention(q, k, v, lens, tables,
                                                  int8_compute=i8c, **kw))
    single_ms = _graph_ms(lambda: paged_decode_attention(q1, k, v, lens, tables, **kw))
    plain_ms = _time_ms(lambda: paged_decode_attention_plain(
        q, k, v, lens, tables, int8_compute=i8c, **kw), iters=3, warmup=1)
    out, launched = _paged_kernel(q, k, v, lens, tables, i8c, kw)
    _, ratio = _hold_paged(f"timed {shape}", out, *_paged_refs(q, k, v, lens, tables, i8c, kw),
                           lengths, launched)
    return {"ms": ms, "single_token_ms": single_ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
            "library_ms": None, "worst_err_bound": ratio, "shape": shape}


def time_paged_turns() -> dict:
    """K4/K5 by graph replay at the shapes of ``time_paged``,
    ``time_paged_verify`` (the speculative run's first verify step),
    ``time_paged_formats`` and ``time_paged_int8c``, through the public
    ``paged_decode_attention`` alone, so that this function times any
    tree's package: from a tree's root, ``python3 -c "import runpy; g =
    runpy.run_path('<this file>'); g['phase_device']();
    print(g['time_paged_turns']())"``, in turns with the parent's. Returns
    {call: ms}."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention)

    def q_of(batch, t, seed):
        shape = (batch, HEADS) + ((t,) if t > 1 else ()) + (D,)
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16)

    out = {}
    for name, t, seed in (("bf16_step", 1, 60), (f"verify_t{SPEC_K + 1}", SPEC_K + 1, 64)):
        lengths = [n + t for n in SERVE_PROMPT_LENS]
        kp, vp, lens, tables = make_paged_pool(lengths, SERVE_PAGE_SIZE, SERVE_PAGES,
                                               seed=seed, pages_per_seq=SERVE_PAGES_PER_SEQ)
        q = q_of(len(lengths), t, seed + 1)
        out[name] = _graph_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables))
    _, kp, vp, lens, tables, q = _run_a_pool()
    out["run_a_dense"] = _graph_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables))
    for mode in ("int8", "fp8", "int4"):
        k, ks, v, vs = _quantized_pool(kp, vp, mode)
        kw = dict(mode=mode, k_scales=ks, v_scales=vs)
        out[f"run_a_{mode}"] = _graph_ms(lambda: paged_decode_attention(q, k, v, lens, tables,
                                                                        **kw))
        if mode == "int8":
            out["run_a_int8c"] = _graph_ms(lambda: paged_decode_attention(
                q, k, v, lens, tables, int8_compute=True, **kw))
    return out


def time_paged_splits() -> dict:
    """K4/K5 by graph replay at forced split counts: the bf16 run's first
    decode step and verify call (dense pages, page 64) and run A's pool
    (page 128) on dense and int8 pages, the counts ``plan``'s floors
    (``MIN_SPLIT_TOKENS``) were chosen from. Returns {call: {splits: ms}}."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention)

    out = {}
    for name, t, seed in (("bf16_step", 1, 60), (f"verify_t{SPEC_K + 1}", SPEC_K + 1, 64)):
        lengths = [n + t for n in SERVE_PROMPT_LENS]
        kp, vp, lens, tables = make_paged_pool(lengths, SERVE_PAGE_SIZE, SERVE_PAGES,
                                               seed=seed, pages_per_seq=SERVE_PAGES_PER_SEQ)
        q = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
            (len(lengths), HEADS) + ((t,) if t > 1 else ()) + (D,)).astype(np.float32)).to(
                "cuda", torch.bfloat16)
        k8, ks, v8, vs = _quantized_pool(kp, vp, "int8")
        out[name] = {n: _graph_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables,
                                                                 splits=n))
                     for n in (1, 2, 4, 8, 16)}
        out[name + "_int8"] = {n: _graph_ms(lambda: paged_decode_attention(
            q, k8, v8, lens, tables, mode="int8", k_scales=ks, v_scales=vs, splits=n))
            for n in (2, 4, 8, 16)}
    _, kp, vp, lens, tables, q = _run_a_pool()
    k8, ks, v8, vs = _quantized_pool(kp, vp, "int8")
    out["run_a_dense"] = {n: _graph_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables,
                                                                      splits=n))
                          for n in (1, 2, 3, 5, 9)}
    out["run_a_int8"] = {n: _graph_ms(lambda: paged_decode_attention(
        q, k8, v8, lens, tables, mode="int8", k_scales=ks, v_scales=vs, splits=n))
        for n in (1, 2, 3, 5, 9)}
    return out


def time_paged_verify(lengths) -> dict:
    """K4/K5 with t = 4 query tokens at the speculative run's first verify
    step (``lengths``: prompt + 1 + spec_k, page 64, 32/8 heads, bf16 pages,
    one layer) beside the single-token call at the same lengths. Bytes: K/V
    once, q and out (t rows each)."""
    kp, vp, lens, tables = make_paged_pool(lengths, SERVE_PAGE_SIZE, SERVE_PAGES,
                                           seed=64, pages_per_seq=SERVE_PAGES_PER_SEQ)
    q = torch.from_numpy(np.random.default_rng(65).standard_normal(
        (len(lengths), HEADS, SPEC_K + 1, D)).astype(np.float32)).to("cuda", torch.bfloat16)
    nbytes = sum(lengths) * KV_HEADS * D * 2 * 2 + 2 * q.numel() * 2
    return _time_paged_pair(q, kp, vp, lens, tables, dict(scale=D ** -0.5), False,
                            lengths, nbytes, f"verify t {SPEC_K + 1}: lengths {lengths}, "
                            f"page {SERVE_PAGE_SIZE}, {HEADS}/{KV_HEADS} heads, bf16")


def time_paged_int8c(dtype=torch.bfloat16) -> dict:
    """K4/K5 with int8_compute at run E's first decode step (run A's pool:
    16 x 1025 tokens, int8 pages, page 128; q in ``dtype``) beside the
    int8-page call without it."""
    lengths, kp, vp, lens, tables, q = _run_a_pool(dtype)
    qk, ks, qv, vs = _quantized_pool(kp, vp, "int8")
    used_pages = sum(-(-n // QUANT_PAGE) for n in lengths)
    nbytes = sum(lengths) * KV_HEADS * D * 2 + 2 * 4 * KV_HEADS * used_pages + 2 * q.numel() * 2
    kw = dict(mode="int8", k_scales=ks, v_scales=vs, scale=D ** -0.5)
    return _time_paged_pair(q, qk, qv, lens, tables, kw, True, lengths, nbytes,
                            f"int8c: lengths 16 x {QUANT_PROMPT + 1}, page {QUANT_PAGE}, "
                            f"{HEADS}/{KV_HEADS} heads, int8 pages, {_dname(dtype)} q")


# ---------------------------------------------------------------------------
# Quantized prefill attention (K10), the K/V-ring forward (K11) and the
# bench tools that drive them.

# variant: (K/V mode, Q kind, int8_compute): the bench tool's four and
# bf16 Q over int4 K/V.
QUANT_VARIANTS = bench_quant.CHECK_VARIANTS
QUANT_CASE_SEQS, QUANT_CASE_BATCH = (1024, 2048), 2
# K10's d-256 cases (phase_d256_cases), Gemma-2-9B's 16/8 heads: (label,
# variant, seq, batch, KernelConfig fields, strided Q). Every variant full
# and causal at s 2048 (b 2); Gemma-2's prefill of the longest served
# prompt, 5,000 tokens padded to 5,120, with its 4,096 window and softcap 50
# (int8c, which refuses a softcap, without it); strided Q for int8kv and
# int8c.
D256_QUANT_CASES = [
    (f"{variant} {'causal' if causal else 'full'} s2048", variant, 2048, 2,
     dict(causal=causal), False)
    for variant in QUANT_VARIANTS for causal in (False, True)] + [
    (f"{variant} gemma2-9b prefill s5120 window {G9_WINDOW}"
     + ("" if i8c else f" softcap {G9_SOFTCAP:g}"), variant, 5120, 1,
     dict(causal=True, window=G9_WINDOW, **({} if i8c else dict(attn_softcap=G9_SOFTCAP))),
     False)
    for variant, (_, _, i8c) in QUANT_VARIANTS.items()] + [
    ("int8kv strided q causal s2048", "int8kv", 2048, 2, dict(causal=True), True),
    ("int8c strided q s2048", "int8c", 2048, 2, {}, True)]
PERF_BATCH, PERF_SEQ = 4, 4096  # the K10 and K11 timing shape


def _quant_qkv(variant, seq, seed, batch, strided=False, heads=HEADS, kv_heads=KV_HEADS,
               d=D):
    """Seeded bf16 Q, K, V (32/8 heads of 128 unless given) quantized as
    ``variant`` gives them; with ``strided``, Q (its values, when quantized)
    as a transposed view of (b, s, h, d) rows."""
    qq, kq, vq = bench_quant.quantize_inputs(
        *_cuda_qkv(seq, seq, seed, batch=batch, heads=heads, kv_heads=kv_heads, d=d), variant)
    if strided:
        if QUANT_VARIANTS[variant][1] == "bf16":
            qq = _as_model_rows(qq, True)
        else:
            qq.values = _as_model_rows(qq.values, True)
    return qq, kq, vq


def _dequantized(x, dtype):
    """A QTensor's values times its scales in ``dtype`` (a dense tensor
    cast to it)."""
    from flash_attention_from_scratch_tpu_torch.ops.quant import QTensor, dequantize

    if isinstance(x, QTensor):
        return dequantize(dataclasses.replace(x, orig_dtype=dtype))
    return x.to(dtype)


def _per_batch(fn, *xs):
    """``fn`` on one batch element of the dense tensors ``xs`` at a time,
    concatenated: a plain version's scores at the tools' shapes would need
    tens of GB at once."""
    return torch.cat([fn(*(x[i:i + 1] for x in xs)) for i in range(xs[0].shape[0])])


def _hold(label, out, native, ref32, launched, good=True, note="",
          plain=None) -> tuple[float, float]:
    """The tolerance rule in each (batch, head, 64-row band) on its own; the
    call must have launched its kernel once and given finite values, and
    ``good`` must hold (``note`` says what it checked). Returns (max
    |kernel - plain|, worst err/bound; ``plain``, where given, is the plain
    version when ``native`` is another reference); raises on a failure."""
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        row_bands, sliced_tolerance_check)

    ok, ratio, where = sliced_tolerance_check(
        row_bands(out), row_bands(native), row_bands(ref32), lead=3)
    err = float((out.float() - (native if plain is None else plain).float()).abs().max())
    good = good and ok and launched == 1 and bool(torch.isfinite(out).all())
    print(f"{label}: max|kernel-plain| {err:.3e}, worst err/bound {ratio:.3f} in "
          f"(batch, head, band) {where}{note}, {launched} launch "
          f"{'ok' if good else 'FAIL'}",
          flush=True)
    if not good:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err, ratio


def _flash_quant_case(label, qq, kq, vq, cfg, i8c) -> tuple[float, float]:
    """K10 on (qq, kq, vq) vs its plain version (for int8c its int8-compute
    path, which rounds P as the kernel does) and reference attention in fp32
    on the inputs dequantized in fp32; the output keeps Q's strides and is
    in the config's type."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
        KERNEL, flash_forward_quantized, flash_forward_quantized_plain)
    from flash_attention_from_scratch_tpu_torch.ops.quant import QTensor
    from flash_attention_from_scratch_tpu_torch.ops.reference import reference_attention

    before = _build.launch_counts[KERNEL]
    out = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c)
    sync()
    launched = _build.launch_counts[KERNEL] - before
    native = flash_forward_quantized_plain(qq, kq, vq, cfg, scale=cfg.softmax_scale,
                                           int8_compute=i8c)
    ref32 = _per_batch(lambda *x: reference_attention(
        *x, causal=cfg.causal, q_offset=0 if cfg.causal else None, window=cfg.window,
        softcap=cfg.attn_softcap), *(_dequantized(x, torch.float32) for x in (qq, kq, vq)))
    q_vals = qq.values if isinstance(qq, QTensor) else qq
    return _hold(f"flash_quant {label}", out, native, ref32, launched,
                 good=out.stride() == q_vals.stride() and out.dtype == cfg.dtype.torch_dtype)


def phase_flash_quant_cases() -> tuple[float, float]:
    """K10 vs its plain version for every variant, non-causal and causal at
    s 1024 and 2048, plus windows, a softcap and strided Q: b 2, 32/8 heads.
    Returns (max |kernel - plain|, worst err/bound)."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig

    cases = [(f"{variant} {'causal' if causal else 'full'} s{seq}", variant, seq,
              dict(causal=causal), False)
             for seq in QUANT_CASE_SEQS for variant in QUANT_VARIANTS
             for causal in (False, True)]
    cases += [("int8c window 512 s2048", "int8c", 2048, dict(causal=True, window=512), False),
              ("int8kv window 300 s2048", "int8kv", 2048, dict(causal=True, window=300), False),
              ("fp8 softcap 50 s2048", "fp8", 2048, dict(causal=True, attn_softcap=50.0), False),
              ("int8kv strided q s2048", "int8kv", 2048, dict(causal=True), True),
              ("int8c strided q s2048", "int8c", 2048, {}, True)]
    worst = (0.0, 0.0)
    for i, (name, variant, seq, kw, strided) in enumerate(cases):
        qq, kq, vq = _quant_qkv(variant, seq, seed=500 + i, batch=QUANT_CASE_BATCH,
                                strided=strided)
        got = _flash_quant_case(name, qq, kq, vq, KernelConfig(**kw),
                                QUANT_VARIANTS[variant][2])
        worst = tuple(map(max, worst, got))
        del qq, kq, vq
    return worst


def phase_bench_tool_cases() -> dict:
    """Each kernel of the tools' path vs its plain version on the tools' own
    inputs (``bench_inputs``), as the tools call them: K10 for every variant
    of ``bench_quant`` (non-causal; 16/16 heads, b 16 at its first two
    lengths, s 2048 and 4096; its s 8192 at b 8, whose plain versions cost
    the most, was cut to keep the smoke's time), K11 at ring depth 2
    (``bench_attention --kernels prog``'s FORI rungs: non-causal, 16/16
    heads, b 16, s 512-4096)
    and K11 at d 256 as ``bench_attention --kernels`` runs its d-256 FORI
    short form (causal, depth 2, 16/8 heads of 256, b 16, s 2048 and 4096;
    under ``"flash_forward_fori_d256"``), its plain versions run one batch
    element at a time. Returns {kernel: (max |kernel - plain|, worst
    err/bound)}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import (
        KernelConfig, KVLoop, parse_short_form)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL_FORI, flash_forward, flash_forward_plain)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import KERNEL as KQ

    worst = {KQ: (0.0, 0.0), KERNEL_FORI: (0.0, 0.0), "flash_forward_fori_d256": (0.0, 0.0)}
    for seq in bench_quant.DEFAULT_SEQ_LENS[:2]:
        q, k, v = bench_quant.bench_inputs(seq)
        for variant, (_, _, i8c) in bench_quant.VARIANTS.items():
            qq, kq, vq = bench_quant.quantize_inputs(q, k, v, variant)
            got = _flash_quant_case(
                f"bench_quant {variant} b{q.shape[0]} h{q.shape[1]} s{seq}",
                qq, kq, vq, KernelConfig(), i8c)
            worst[KQ] = tuple(map(max, worst[KQ], got))
            del qq, kq, vq
        del q, k, v
        torch.cuda.empty_cache()
    runs = [(KERNEL_FORI, "--fori nb2", KernelConfig(kv_loop=KVLoop.FORI), seq, {})
            for seq in bench_attention.DEFAULT_SEQ_LENS]
    form = BENCH_D256_FORMS.split(";")[0]
    runs += [("flash_forward_fori_d256", form, parse_short_form(form), seq,
              dict(heads=G9_HEADS, kv_heads=G9_KV_HEADS, d_head=G9_D)) for seq in (2048, 4096)]
    for label, what, cfg, seq, widths in runs:
        q, k, v = bench_attention.bench_inputs(seq, **widths)
        before = _build.launch_counts[KERNEL_FORI]
        out = flash_forward(q, k, v, cfg)
        sync()
        launched = _build.launch_counts[KERNEL_FORI] - before
        native = _per_batch(lambda *x: flash_forward_plain(*x, cfg)[0], q, k, v)
        ref32 = _per_batch(lambda *x: flash_forward_plain(*x, _fp32(cfg))[0],
                           q.float(), k.float(), v.float())
        got = _hold(f"bench_attention {what} b{q.shape[0]} h{q.shape[1]} s{seq}", out,
                    native, ref32, launched)
        worst[label] = tuple(map(max, worst[label], got))
        del q, k, v, out, native, ref32
    torch.cuda.empty_cache()
    return worst


def _attn_bytes(q, k, v, out) -> int:
    """Bytes of the inputs (values and scales) and the output, each once."""
    from flash_attention_from_scratch_tpu_torch.ops.quant import QTensor

    total = out.numel() * out.element_size()
    for x in (q, k, v):
        for t in ((x.values, x.scales) if isinstance(x, QTensor) else (x,)):
            total += t.numel() * t.element_size()
    return total


def _kernel_ptxas(ptxas: dict, kernels: tuple) -> dict:
    """{kernel and its mangled template arguments: registers and spills} of
    the kernels named in ``kernels`` (empty when this run built nothing)."""
    pattern = re.compile(r"\d(" + "|".join(kernels) + r")(I(?:L[ib]\d+E)+E)?")
    found = {}
    for name, v in ptxas.items():
        m = pattern.search(name)
        if m:
            found[m.group(1) + (m.group(2) or "")] = v
    return found


def time_flash_quant(ptxas: dict | None = None) -> dict:
    """K10 per variant, non-causal, at b 4, s 4096, 32/8 heads, d 128:
    time, bound (the two products' operations at the bf16 rate, or the
    int8 rate for int8c, against bytes), its share (bound / time) and the
    products' TFLOP/s (TOP/s for int8c), the plain version, and SDPA on the
    dequantized bf16 tensors. The top-level numbers are sums over the five
    variants. ``ptxas``: the build's registers and spills of
    ``flash_quant.cu``'s kernels (``flash_quant_kernelILi<Q>ELi<KV>``: Q 0
    bf16, 1 int8, 2 fp8; KV 1 int8, 2 fp8, 3 int4)."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import (
        KernelConfig, calc_self_attn_flop)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
        flash_forward_quantized, flash_forward_quantized_plain)

    cfg = KernelConfig()
    ops = _attn_ops(PERF_SEQ, HEADS, PERF_BATCH, causal=False)
    flops = calc_self_attn_flop(PERF_SEQ, D, HEADS, PERF_BATCH)  # the tools' model
    by_variant = {}
    for i, (variant, (_, _, i8c)) in enumerate(QUANT_VARIANTS.items()):
        qq, kq, vq = bench_quant.quantize_inputs(
            *_timing_qkv(PERF_SEQ, PERF_SEQ, seed=80 + 3 * i, batch=PERF_BATCH), variant)
        out = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c)
        ms = _time_ms(lambda: flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c))
        plain_ms = _time_ms(lambda: flash_forward_quantized_plain(
            qq, kq, vq, cfg, scale=D ** -0.5, int8_compute=i8c), iters=1, warmup=1)
        dq, dk, dv = (_dequantized(x, torch.bfloat16) for x in (qq, kq, vq))
        lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            dq, dk, dv, enable_gqa=True))
        bound_o = ops / (PEAK_INT8_OPS if i8c else PEAK_BF16_FLOPS)
        bound_b = _attn_bytes(qq, kq, vq, out) / PEAK_BYTES_PER_S
        bound_ms = 1e3 * max(bound_o, bound_b)
        by_variant[variant] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if bound_o >= bound_b else "bytes",
            "bound_share": bound_ms / ms, "product_tflops": ops / ms / 1e9,
            "tflops": flops / ms / 1e9}
        del qq, kq, vq, out, dq, dk, dv
    total = {key: sum(r[key] for r in by_variant.values())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {**total, "bound_by": "operations", "by_variant": by_variant,
            "ptxas": _kernel_ptxas(ptxas or {}, ("flash_quant_kernel", "flash_quant_i8_kernel")),
            "shape": f"sum over the variants {list(QUANT_VARIANTS)}: non-causal, "
                     f"b {PERF_BATCH}, {HEADS}/{KV_HEADS} heads, s {PERF_SEQ}, d {D}; "
                     "library: SDPA on the dequantized bf16 tensors"}


def time_fori(ptxas: dict | None = None) -> dict:
    """K11 at ring depths 1-4, non-causal and causal, with K1 and SDPA at
    the same shape (b 4, s 4096, 32/8 heads, d 128, bf16), each depth's
    share of the bound (bound / time) and TFLOP/s of the two products. The
    top-level numbers are the default depth's (2), summed over the two
    masks; the plain version runs one batch element at a time (its scores
    would need 8.6 GB at once). ``ptxas``: the build's registers and
    spills of ``flash_forward_fori.cu``'s kernels (``ILi<depth>``)."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig, KVLoop
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward, flash_forward_plain)

    q, k, v = _timing_qkv(PERF_SEQ, PERF_SEQ, seed=90, batch=PERF_BATCH)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())  # q, o, k, v in bf16
    by_mask = {}
    for causal in (False, True):
        cfg = KernelConfig(causal=causal)
        ops = _attn_ops(PERF_SEQ, HEADS, PERF_BATCH, causal)
        row = {f"nb{n}_ms": _time_ms(lambda: flash_forward(q, k, v, dataclasses.replace(
            cfg, kv_loop=KVLoop.FORI, num_kv_buffers=n))) for n in FORI_DEPTHS}
        row["flash_forward_k1_ms"] = _time_ms(lambda: flash_forward(q, k, v, cfg))
        row["library_ms"] = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
        row["plain_ms"] = _time_ms(lambda: _per_batch(
            lambda *x: flash_forward_plain(*x, cfg)[0], q, k, v), iters=1, warmup=1)
        row["bound_ms"] = 1e3 * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
        for n in FORI_DEPTHS:
            row[f"nb{n}_bound_share"] = row["bound_ms"] / row[f"nb{n}_ms"]
            row[f"nb{n}_tflops"] = ops / row[f"nb{n}_ms"] / 1e9
        by_mask["causal" if causal else "full"] = row
    total = {key: sum(r[src] for r in by_mask.values()) for key, src in (
        ("ms", "nb2_ms"), ("plain_ms", "plain_ms"), ("library_ms", "library_ms"),
        ("bound_ms", "bound_ms"))}
    del q, k, v
    return {**total, "bound_by": "operations", "by_mask": by_mask,
            "ptxas": _kernel_ptxas(ptxas or {}, ("flash_forward_fori_kernel",)),
            "shape": f"num_kv_buffers 2, non-causal + causal: b {PERF_BATCH}, "
                     f"{HEADS}/{KV_HEADS} heads, s {PERF_SEQ}, d {D}, bf16"}


def time_quant_fori_d256(quant_ptxas: dict | None = None,
                         fori_ptxas: dict | None = None) -> tuple[dict, dict]:
    """K10 per variant (non-causal) and K11 at ring depths 1-4 (non-causal
    and causal) at head width 256: b 4, s 4096, Gemma-2-9B's 16/8 heads, the
    same products as the d-128 rows' 32/8 heads of 128 (``time_flash_quant``,
    ``time_fori``), so the same bound. Beside each: the bound, its share
    (bound / time), the products' TFLOP/s (TOP/s for int8c), the plain
    version (one batch element at a time for K11) and the library call: SDPA
    on the dequantized bf16 tensors for K10, SDPA for K11 (beside K1 at d
    256). ``quant_ptxas`` / ``fori_ptxas``: the build's registers and spills
    of the d-256 libraries. Returns (K10's row, K11's row): top-level
    numbers are sums over the variants, and over the two masks at the
    default depth (2)."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig, KVLoop
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward, flash_forward_plain)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
        flash_forward_quantized, flash_forward_quantized_plain)

    widths = dict(heads=G9_HEADS, kv_heads=G9_KV_HEADS, d=G9_D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cfg = KernelConfig(d_head=G9_D)
    ops = _attn_ops(PERF_SEQ, G9_HEADS, PERF_BATCH, causal=False, d=G9_D)
    by_variant = {}
    for i, (variant, (_, _, i8c)) in enumerate(QUANT_VARIANTS.items()):
        qq, kq, vq = bench_quant.quantize_inputs(
            *_timing_qkv(PERF_SEQ, PERF_SEQ, seed=280 + 3 * i, batch=PERF_BATCH, **widths),
            variant)
        out = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c)
        ms = _time_ms(lambda: flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c))
        plain_ms = _time_ms(lambda: flash_forward_quantized_plain(
            qq, kq, vq, cfg, scale=cfg.softmax_scale, int8_compute=i8c), iters=1, warmup=1)
        dq, dk, dv = (_dequantized(x, torch.bfloat16) for x in (qq, kq, vq))
        lib_ms = _time_ms(lambda: sdpa(dq, dk, dv, enable_gqa=True))
        bound_o = ops / (PEAK_INT8_OPS if i8c else PEAK_BF16_FLOPS)
        bound_b = _attn_bytes(qq, kq, vq, out) / PEAK_BYTES_PER_S
        bound_ms = 1e3 * max(bound_o, bound_b)
        by_variant[variant] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if bound_o >= bound_b else "bytes",
            "bound_share": bound_ms / ms, "library_factor": ms / lib_ms,
            "product_tflops": ops / ms / 1e9}
        del qq, kq, vq, out, dq, dk, dv
    quant = {key: sum(r[key] for r in by_variant.values())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    quant.update(bound_by="operations", by_variant=by_variant,
                 ptxas=_kernel_ptxas(quant_ptxas or {}, ("flash_quant_kernel",
                                                         "flash_quant_i8_kernel")),
                 shape=f"sum over the variants {list(QUANT_VARIANTS)}: non-causal, "
                       f"b {PERF_BATCH}, {G9_HEADS}/{G9_KV_HEADS} heads, s {PERF_SEQ}, "
                       f"d {G9_D}; library: SDPA on the dequantized bf16 tensors")
    torch.cuda.empty_cache()

    q, k, v = _timing_qkv(PERF_SEQ, PERF_SEQ, seed=300, batch=PERF_BATCH, **widths)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())  # q, o, k, v in bf16
    by_mask = {}
    for causal in (False, True):
        base = KernelConfig(d_head=G9_D, causal=causal)
        ops = _attn_ops(PERF_SEQ, G9_HEADS, PERF_BATCH, causal, d=G9_D)
        row = {f"nb{n}_ms": _time_ms(lambda: flash_forward(q, k, v, dataclasses.replace(
            base, kv_loop=KVLoop.FORI, num_kv_buffers=n))) for n in FORI_DEPTHS}
        row["flash_forward_k1_ms"] = _time_ms(lambda: flash_forward(q, k, v, base))
        row["library_ms"] = _time_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True))
        row["plain_ms"] = _time_ms(lambda: _per_batch(
            lambda *x: flash_forward_plain(*x, base)[0], q, k, v), iters=1, warmup=1)
        row["bound_ms"] = 1e3 * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
        for n in FORI_DEPTHS:
            row[f"nb{n}_bound_share"] = row["bound_ms"] / row[f"nb{n}_ms"]
            row[f"nb{n}_library_factor"] = row[f"nb{n}_ms"] / row["library_ms"]
            row[f"nb{n}_tflops"] = ops / row[f"nb{n}_ms"] / 1e9
        by_mask["causal" if causal else "full"] = row
    fori = {key: sum(r[src] for r in by_mask.values()) for key, src in (
        ("ms", "nb2_ms"), ("plain_ms", "plain_ms"), ("library_ms", "library_ms"),
        ("bound_ms", "bound_ms"))}
    fori.update(bound_by="operations", by_mask=by_mask,
                ptxas=_kernel_ptxas(fori_ptxas or {}, ("flash_forward_fori_kernel",)),
                shape=f"num_kv_buffers 2, non-causal + causal: b {PERF_BATCH}, "
                      f"{G9_HEADS}/{G9_KV_HEADS} heads, s {PERF_SEQ}, d {G9_D}, bf16")
    del q, k, v
    torch.cuda.empty_cache()
    return quant, fori


# bench_attention's d-256 configs: K11 at depth 2 and K1, causal, by the
# JAX package's short forms (the head width is in the form).
BENCH_D256_FORMS = "fa_bf16_q128_kv128_d256_fori2_ca;fa_bf16_q128_kv128_d256_grid2_ca"
_D256_TOOL_ARGS = ("--kernels", BENCH_D256_FORMS, "--heads", str(G9_HEADS), "--kv-heads",
                   str(G9_KV_HEADS), "--seq-lens", "2048,4096", "--baseline", "--json")
# The tool's options as a user runs them: (label, arguments).
BENCH_ATTENTION_RUNS = (
    ("d256", _D256_TOOL_ARGS),
    ("d256_grad", _D256_TOOL_ARGS + ("--grad",)),
    ("host_timing", ("--fori", "--causal", "--seq-lens", "1024,2048", "--host-timing",
                     "--json")),
    ("prog", ("--kernels", "prog", "--json")),
)


def phase_bench_attention_options(smi: str) -> dict:
    """``tools/bench_attention.py``'s ``main`` with the JAX tool's options
    (BENCH_ATTENTION_RUNS): d-256 short forms with the SDPA baseline, the
    same with ``--grad`` (forward and backward), ``--host-timing``, and
    ``--kernels prog`` at its default seqs; each with the launch counts set
    to 0 just before and read just after. Each run must print a row of
    positive TFLOP/s for every config, name the kernels it launched and
    launch them: K11 and K1 (and, with ``--grad``, K2 or K3) at d 256, K11
    alone under ``--fori``, K1 and K11 for ``prog``. Returns {label:
    launches}."""
    import contextlib
    import io

    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, KERNEL_FORI)

    backward = (KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED)
    out = {}
    for label, args in BENCH_ATTENTION_RUNS:
        torch.cuda.empty_cache()
        text = io.StringIO()
        t = time.perf_counter()
        _build.launch_counts.clear()  # counts start at 0 just before the run
        with contextlib.redirect_stdout(text):
            rc = bench_attention.main(list(args))
        counts = dict(_build.launch_counts)  # read just after
        took = time.perf_counter() - t
        rows = [json.loads(line) for line in text.getvalue().splitlines()
                if line.startswith("{")]
        print(json.dumps({"bench_attention": {"args": " ".join(args), "rows": rows,
                                              "launches": counts, "s": took, "gpu": smi}}),
              flush=True)
        kernels = {r["kernel"] for r in rows}
        want = {"d256": {K1, KERNEL_FORI}, "d256_grad": {K1, KERNEL_FORI},
                "host_timing": {KERNEL_FORI}, "prog": {K1, KERNEL_FORI}}[label]
        good = (rc == 0 and rows and all(r["harmonic_mean"] > 0 and r["n_seqs"] > 0
                                         for r in rows)
                and all(counts.get(name, 0) > 0 for name in want)
                and ("--fori" not in args or not counts.get(K1))
                and ("--grad" not in args or sum(counts.get(n, 0) for n in backward) > 0)
                and ("--baseline" not in args or "sdpa" in kernels)
                and all(r["timing"] == ("host" if "--host-timing" in args else "cuda_events")
                        and r["grad"] == ("--grad" in args) for r in rows))
        if label.startswith("d256"):
            good = good and {r["config"] for r in rows} == set(BENCH_D256_FORMS.split(";")) | {
                "sdpa"}
        if not good:
            raise AssertionError(f"bench_attention {' '.join(args)}: rc {rc}, "
                                 f"launches {counts}, rows {rows}")
        out[label] = counts
    return out


def phase_bench_tools(smi: str) -> dict:
    """K10's main path: ``tools/bench_quant.py`` (every variant at its
    default shapes, then its numerics check) with the launch counts set to
    0 just before and read just after; K10 must have run. (K11's,
    ``tools/bench_attention.py``, is ``phase_bench_attention_options``.)
    Returns {kernel: launches}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import KERNEL as KQ

    _build.launch_counts.clear()  # counts start at 0 just before the path
    rows = bench_quant.bench_quant(bench_quant.DEFAULT_SEQ_LENS)
    numerics = bench_quant.numerics_check()
    quant_counts = dict(_build.launch_counts)  # read just after
    print(json.dumps({"bench_quant": {"rows": rows, "numerics": numerics,
                                      "launches": quant_counts, "gpu": smi}}), flush=True)
    if quant_counts.get(KQ, 0) == 0 or not all(r["adaptive_ok"] for r in numerics):
        raise AssertionError(f"bench_quant: launches {quant_counts}, numerics {numerics}")
    return {KQ: quant_counts[KQ]}


# ---------------------------------------------------------------------------
# The banded backward (ops/flash_backward.py::banded_backward) and the kernel
# tools (tools/bench_ladder.py to tools/quant_trace.py).

BANDED_BATCH, BANDED_SEQ, BANDED_BANDS = 2, 4096, 4  # at Llama-3-8B's 32/8 heads
BANDED_PREFIX_KEYS = (1024, 2048, 3072)  # band 1-3's past keys at s 4,096
BANDED_TIMED = (4096, 8192, 16384)  # causal, b 1, the JAX package's band count


def phase_banded_backward_cases() -> dict:
    """K2 at the banded backward's prefix shapes (1,024 Q rows against
    ``BANDED_PREFIX_KEYS`` keys, no mask, b 2, 32/8 heads: the past-key
    calls of bands 1-3 at s 4,096) against its plain version by the
    per-64-row-band rule (``_check_grads``); then ``flash_backward(...,
    bands=4)`` at b 2, 32/8 heads, d 128, s 4,096, causal, against the
    plain backward (one KV head at a time) by the same rule, and within
    that rule of the monolithic K3 call (K3's gradients in place of the
    bf16 reference), launching K2 exactly 2 * 4 - 1 = 7 times and no other
    kernel. Returns {"prefix", "banded", "banded_vs_k3": (max |kernel -
    reference|, worst err/bound), "launches": the banded call's counts}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_FUSED, flash_backward, flash_backward_plain)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward_with_lse)

    out = {"prefix": (0.0, 0.0)}
    rows, b = BANDED_SEQ // BANDED_BANDS, BANDED_BATCH
    full = KernelConfig()
    for i, keys in enumerate(BANDED_PREFIX_KEYS):
        q, k, v = _cuda_qkv(rows, keys, seed=400 + i, batch=b)
        do = _cuda_normal(q.shape, seed=410 + i)
        o, lse = flash_forward_with_lse(q, k, v, full)
        before = _build.launch_counts[KERNEL_FUSED]
        got = flash_backward(q, k, v, o, lse, do, full, fused=True)
        sync()
        if _build.launch_counts[KERNEL_FUSED] - before != 1:
            raise AssertionError(f"K2 prefix {rows}x{keys}: not one launch")
        ref16 = flash_backward_plain(q, k, v, o, lse, do, full)
        ref32 = flash_backward_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), _fp32(full))
        got = _check_grads(f"K2 prefix {rows} rows x {keys} keys", got, ref16, ref32)
        out["prefix"] = tuple(map(max, out["prefix"], got))
        print(f"K2 prefix b{b} {HEADS}/{KV_HEADS} heads {rows} rows x {keys} keys: "
              f"max|kernel-plain| {got[0]:.3e}, worst err/bound {got[1]:.3f}", flush=True)
        del q, k, v, do, o, lse, ref16, ref32
    cfg = KernelConfig(causal=True)
    q, k, v = _cuda_qkv(BANDED_SEQ, BANDED_SEQ, seed=420, batch=b)
    do = _cuda_normal(q.shape, seed=421)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    _build.launch_counts.clear()
    got = flash_backward(q, k, v, o, lse, do, cfg, bands=BANDED_BANDS)
    sync()
    launches = dict(_build.launch_counts)
    if launches != {KERNEL_FUSED: 2 * BANDED_BANDS - 1}:
        raise AssertionError(f"banded backward: launches {launches}")
    ref16 = _plain_backward_by_heads(q, k, v, o, lse, do, cfg)
    ref32 = _plain_backward_by_heads(q.float(), k.float(), v.float(), o.float(), lse,
                                     do.float(), _fp32(cfg))
    what = f"banded backward b{b} {HEADS}/{KV_HEADS} heads s{BANDED_SEQ} bands {BANDED_BANDS}"
    out["banded"] = _check_grads(what, got, ref16, ref32)
    mono = flash_backward(q, k, v, o, lse, do, cfg, fused=False)
    out["banded_vs_k3"] = _check_grads(what + " vs K3", got, mono, ref32)
    out["launches"] = launches
    line = {"prefix_keys": BANDED_PREFIX_KEYS, "rows": rows, **out}
    print(json.dumps({"banded_backward": line}), flush=True)
    del q, k, v, do, o, lse, got, ref16, ref32, mono
    torch.cuda.empty_cache()
    return out


def time_banded_backward() -> dict:
    """The banded backward against the monolithic K2 and K3 calls at
    ``BANDED_TIMED`` (causal, b 1, 32/8 heads, d 128; the JAX package's
    band count, 1,024-row bands: 4, 8, 16), each the whole
    ``flash_backward`` call by CUDA events, beside the bound of the
    backward (five tile products over the visible pairs, or the bytes: the
    larger) and SDPA's causal backward (``_sdpa_backward_ms``). Returns
    {seq: fields}."""
    from flash_attention_from_scratch_tpu_torch.ops import flash_backward as fb
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward_with_lse)

    cfg = KernelConfig(causal=True)
    out = {}
    for i, s in enumerate(BANDED_TIMED):
        bands = fb._bwd_band_count(s)
        q, k, v = _timing_qkv(s, s, seed=430 + 3 * i)
        do = _timing_normal(q.shape, seed=450 + i)
        o, lse = flash_forward_with_lse(q, k, v, cfg)
        flops = 5 * 2 * D * _attn_ops(s, HEADS, 1, True) // (4 * D)
        nbytes = 2 * (4 * HEADS * s * D + 4 * KV_HEADS * s * D) + 4 * HEADS * s
        bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
        lib_ms = _sdpa_backward_ms(q, k, v, do)
        times = {}
        for _ in range(2):  # in turns: banded, K2, K3, banded, K2, K3
            for name, kw in (("banded", dict(bands=bands)), ("fused", dict(fused=True)),
                             ("split", dict(fused=False))):
                ms = _time_ms(lambda kw=kw: fb.flash_backward(q, k, v, o, lse, do, cfg, **kw))
                times.setdefault(name, []).append(ms)
        out[s] = {"bands": bands, "k2_launches_per_call": 2 * bands - 1,
                  **{f"{name}_ms": min(t) for name, t in times.items()},
                  "ms_all": times, "bound_ms": bound_ms, "library_ms": lib_ms,
                  "banded_over_fused": min(times["banded"]) / min(times["fused"]),
                  "banded_over_split": min(times["banded"]) / min(times["split"])}
        del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return out


# Prog's configs that debug_steps steps through (ops/configs.py::
# get_kernel_progression_configs): 4_opt_softmax runs K1, 6_manual_pipeline
# K11 at depth 2.
DEBUG_GRID, DEBUG_FORI = 3, 5
PROFILED_CONFIG = "fa_bf16_q128_kv128_d128_fori2_x2+os+cp"  # prog's K11 at depth 2
_TRAIN_TOOL_ARGS = ("--dim", "4096", "--layers", str(TRAIN_LAYERS), "--heads", str(HEADS),
                    "--kv-heads", str(KV_HEADS), "--hidden", "14336", "--vocab", "128256",
                    "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--steps", "3",
                    "--warmup", "1")
# (label, tool, arguments; "{out}" is the run's output directory)
KERNEL_TOOL_RUNS = (
    ("bench_ladder", "bench_ladder", ("--seq-lens", "1024,4096", "--json")),
    ("bench_sweep", "bench_sweep", ("--seq-lens", "1024,4096", "--json")),
    ("bench_backward", "bench_backward", ("--seq-lens", "4096", "--json")),
    ("bench_backward_causal", "bench_backward", ("--causal", "--seq-lens", "4096", "--json")),
    ("bench_train", "bench_train", _TRAIN_TOOL_ARGS),
    ("autotune", "autotune", ("--kernels", "tune", "--seq", "4096", "--json")),
    ("sanity_check", "sanity_check", ("--kernels", "prog")),
    ("sanity_check_small", "sanity_check", ("--small",)),
    ("debug_steps_grid", "debug_steps", ("--small", "--kernel", str(DEBUG_GRID))),
    ("debug_steps_fori", "debug_steps", ("--small", "--kernel", str(DEBUG_FORI))),
    # K11 at depth 2 alone: quant_trace traces K1 below, and each trace is a
    # process of its own (about 20 s).
    ("profile_trace", "profile_trace", ("--kernels", PROFILED_CONFIG, "--seq", "4096", "--out",
                                        "{out}")),
    ("quant_trace", "quant_trace", ("--seq", "4096", "--out", "{out}")),
)
DEBUG_SLACK = 0.05  # a debug_steps map entry: bf16 outputs against the fp32 mirror


def _tool_rates(label: str, rows: list) -> list:
    """The TFLOP/s figures of the port's kernels a tool's JSON rows report
    (not SDPA's, a library's), as (name, value, ceiling factor): 2 for the
    int8 products of quant_trace's int8c."""
    keys = ("tflops", "fwdbwd_tflops", "bwd_tflops", "harmonic_mean", "model_tflops_per_s")
    out = [(f"{label} {k}", r[k], 1.0) for r in rows for k in keys if k in r]
    out += [(f"{label} seq{k[3:]}", v, 1.0) for r in rows for k, v in r.items()
            if re.fullmatch(r"seq\d+", k)]
    for r in rows:
        for name, t in r.get("chain_timing", {}).items():
            out.append((f"{label} {name}", t["eff_bf16_tflops"], 2.0 if name == "int8c" else 1.0))
    return out


def _tool_launches(runs: dict, *names) -> dict:
    """{tool run: launches of the kernels ``names``} of the runs that
    launched them."""
    counts = {label: sum(n.get(k, 0) for k in names) for label, n in runs.items()}
    return {label: c for label, c in counts.items() if c}


def phase_kernel_tools(smi: str, train_rate: dict, out_dir: str) -> dict:
    """The kernel tools as a user runs them (``KERNEL_TOOL_RUNS``), each
    through its ``main`` in this process, the launch counts set to 0 just
    before and read just after (``profile_trace`` and ``quant_trace`` also
    spawn their own capture processes, whose launches are their own). Each
    must exit 0 and launch its kernels (K1 and K11 the ladder, K1 the
    sweep, K2 and K3 the backward bench and K2 banded with ``--causal``,
    K1 and K3 the trainer, K1 the autotuner, K1 and K11 the checks, K11
    at depth 2 ``profile_trace``, K10 and K1 ``quant_trace``); every config of ``sanity_check``
    passes; no TFLOP/s is non-finite or above 1.05x the card's measured
    matmul rate (2x for int8c); ``debug_steps``' maps are finite and within
    ``DEBUG_SLACK``; ``bench_train`` prints the JAX tool's keys. Reported,
    not gated: ``bench_train``'s tokens/s and MFU beside the train phase's
    (``train_rate``), and which traces the profiler captured. Returns
    {label: launches}."""
    import contextlib
    import importlib
    import io

    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, KERNEL_FORI)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import KERNEL as KQ
    from flash_attention_from_scratch_tpu_torch.utils.chip import measured_matmul_tflops

    want = {"bench_ladder": {K1, KERNEL_FORI}, "bench_sweep": {K1},
            "bench_backward": {K1, KERNEL_FUSED, KERNEL_DKV, KERNEL_DQ},
            "bench_backward_causal": {K1, KERNEL_FUSED, KERNEL_DKV, KERNEL_DQ},
            "bench_train": {K1, KERNEL_DKV, KERNEL_DQ}, "autotune": {K1},
            "sanity_check": {K1, KERNEL_FORI}, "sanity_check_small": {K1, KERNEL_FORI},
            "debug_steps_grid": {K1}, "debug_steps_fori": {KERNEL_FORI},
            "profile_trace": {KERNEL_FORI}, "quant_trace": {KQ, K1}}
    ceiling = 1.05 * measured_matmul_tflops()
    out, lines = {}, {}
    for label, tool, args in KERNEL_TOOL_RUNS:
        args = [a.format(out=out_dir) for a in args]
        module = importlib.import_module(f"flash_attention_from_scratch_tpu_torch.tools.{tool}")
        torch.cuda.empty_cache()
        text = io.StringIO()
        t = time.perf_counter()
        _build.launch_counts.clear()  # counts start at 0 just before the run
        with contextlib.redirect_stdout(text):
            rc = module.main(args)
        counts = dict(_build.launch_counts)  # read just after
        took = time.perf_counter() - t
        printed = text.getvalue()
        rows = [json.loads(line) for line in printed.splitlines() if line.startswith("{")]
        missing = [n for n in want[label] if not counts.get(n)]
        bad_rates = [(n, x) for n, x, f in _tool_rates(label, rows)
                     if not (math.isfinite(x) and x <= f * ceiling)]
        fault = []
        if rc != 0 or missing or bad_rates or not rows and tool != "sanity_check":
            fault.append(f"rc {rc}, kernels not launched {missing}, rates {bad_rates}")
        if label == "bench_backward_causal" and not any(r["bands"] for r in rows):
            fault.append("no banded row")
        if tool == "autotune" and any(r["error"] for r in rows):
            fault.append("a config failed or timed impossibly")
        if tool == "sanity_check" and not re.search(r"^(\d+) of \1 configs passed$", printed,
                                                    re.M):
            fault.append("a config failed")
        if tool == "debug_steps":
            maps = rows[-1]["per_q_block_max_diff"] + rows[-1]["per_kv_step_max_diff"]
            if not all(math.isfinite(x) and x <= DEBUG_SLACK for x in maps):
                fault.append(f"diff maps {maps}")
        if tool == "bench_train":
            keys = ("metric", "value", "unit", "model_tflops_per_s", "tokens_per_s",
                    "ms_per_step", "loss", "dim", "layers", "seq", "batch", "device")
            if any(k not in rows[-1] for k in keys) or not math.isfinite(rows[-1]["loss"]):
                fault.append(f"line {rows[-1]}")
            rows[-1]["train_phase"] = train_rate
        if fault:
            raise AssertionError(f"{tool} {' '.join(args)}: {'; '.join(fault)}\n"
                                 f"{printed[-3000:]}")
        if tool == "profile_trace":
            rows = [{k: r[k] for k in ("config", "kernel", "trace_captured",
                                       "device_ms_per_call", "tflops", "hbm_gbps_model",
                                       "error", "device_event_totals_ns") if k in r}
                    for r in rows if r["config"] == r["traced_as"]]
        lines[label] = {"args": " ".join(args), "rows": rows, "launches": counts, "s": took}
        print(json.dumps({"kernel_tools": {label: lines[label], "gpu": smi}}), flush=True)
        out[label] = counts
    return out


# The port's last five JAX tools and its bench line (label, module under the
# package, arguments). The sanitizer modes run every kernel group.
PORT_TOOL_RUNS = (
    ("mosaic_dump_check", "tools.mosaic_dump", ("--check",)),
    ("check_races_eager", "tools.check_races", ()),
    ("check_races_vector_clocks", "tools.check_races", ("--mode", "vector-clocks",
                                                        "--timeout", "240")),
    ("check_races_on_wait", "tools.check_races", ("--mode", "on-wait", "--timeout", "240")),
    ("bench", "bench", ()),
    ("onchip_checklist", "tools.onchip_checklist", ()),
    ("tune_bands", "tools.tune_bands", ("--seq-lens", "8192", "--json")),
    ("tune_short_seq", "tools.tune_short_seq", ("--seq-lens", "512,1024", "--json")),
)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_sdpa_tflops", "pct_of_sol",
              "sol_tflops", "config", "ms_per_call", "device")


def phase_port_tools(smi: str) -> dict:
    """The port's counterparts of the JAX package's last five tools and its
    ``bench`` line, as a user runs them (``PORT_TOOL_RUNS``), each through
    its ``main`` in this process, launch counts set to 0 just before and
    read just after (the sanitizer modes run their cases in child processes
    under ``compute-sanitizer``, whose launches are the children's own).
    Gates: ``mosaic_dump --check`` passes the committed SASS baselines;
    ``check_races --mode eager`` holds every case and launches K11, K4/K5,
    K1, K2, K3, K10 and K6-K9; a sanitizer mode exits 0, or
    ``check_races.REFUSED_RC`` where the sanitizer refused this card at the
    tool's context-only probe and nothing else went wrong (each such
    (kernel group, tool) printed as refused, never as a pass; a reported
    error or hazard, or a run left unchecked otherwise, fails the phase);
    the ``bench`` line has its keys, the card's name and power limit, and a
    rate below 1.05x the card's measured matmul rate; every
    ``onchip_checklist`` item passes; ``tune_bands`` and ``tune_short_seq``
    rows are finite and below that ceiling, with the monolithic K1 and SDPA
    control rows. Returns {label: launches}."""
    import importlib
    import io

    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, KERNEL_FORI)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import KERNEL as KQ
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS
    from flash_attention_from_scratch_tpu_torch.tools.check_races import REFUSED_RC
    from flash_attention_from_scratch_tpu_torch.utils.chip import measured_matmul_tflops

    want = {"check_races_eager": {K1, KERNEL_FORI, KP, KERNEL_FUSED, KERNEL_DKV, KERNEL_DQ,
                                  KQ, *KERNELS.values()},
            "bench": {K1}, "onchip_checklist": {K1, KP},
            "tune_bands": {K1}, "tune_short_seq": {K1, KERNEL_FORI}}
    ceiling = 1.05 * measured_matmul_tflops()
    out = {}
    for label, module_name, args in PORT_TOOL_RUNS:
        module = importlib.import_module(f"flash_attention_from_scratch_tpu_torch.{module_name}")
        torch.cuda.empty_cache()
        text, err = io.StringIO(), io.StringIO()
        t = time.perf_counter()
        _build.launch_counts.clear()  # counts start at 0 just before the run
        with contextlib.redirect_stdout(text), contextlib.redirect_stderr(err):
            rc = module.main(list(args))
        counts = dict(_build.launch_counts)  # read just after
        took = time.perf_counter() - t
        printed = text.getvalue()
        rows = [json.loads(line) for line in printed.splitlines() if line.startswith("{")]
        missing = [n for n in want.get(label, ()) if not counts.get(n)]
        fault = [f"kernels not launched {missing}"] if missing else []
        line = {"args": " ".join(args), "rc": rc, "launches": counts, "s": took}
        if label.startswith("check_races_") and label != "check_races_eager":
            if rc not in (0, REFUSED_RC):
                fault.append(f"rc {rc}")
            line["checked"] = rc == 0
        elif rc != 0:
            fault.append(f"rc {rc}")
        if label == "bench":
            if len(rows) != 1 or tuple(rows[0]) != BENCH_KEYS:
                fault.append(f"line {rows}")
            elif not (math.isfinite(rows[0]["value"]) and rows[0]["value"] <= ceiling
                      and rows[0]["device"] == smi):
                fault.append(f"value {rows[0]['value']} (ceiling {ceiling:.1f}), device "
                             f"{rows[0]['device']!r}")
        if label == "onchip_checklist":
            summary = json.loads(printed.strip().splitlines()[-1])
            line["items"] = summary
            line["stderr"] = [x.strip() for x in err.getvalue().splitlines()
                              if x.startswith("  ") and (": PASS" in x or ": FAIL" in x)]
            if any(v != "PASS" for v in summary.values()):
                fault.append(f"items {summary}")
        if label in ("tune_bands", "tune_short_seq"):
            control = "monolithic" if label == "tune_bands" else "sdpa"
            bad = [(r["config"] if "config" in r else r["rule"], r["tflops"]) for r in rows
                   if not (math.isfinite(r["tflops"]) and 0 < r["tflops"] <= ceiling)]
            if bad or not any(r.get("rule", r.get("config")) == control for r in rows):
                fault.append(f"rows {bad}, control {control}")
        if fault:
            raise AssertionError(f"{module_name} {' '.join(args)}: {'; '.join(fault)}\n"
                                 f"{printed[-3000:]}\n{err.getvalue()[-2000:]}")
        if label in ("bench", "tune_bands", "tune_short_seq"):
            line["rows"] = rows
        else:
            line["printed"] = printed[-4000:]
        print(json.dumps({"port_tools": {label: line, "gpu": smi}}), flush=True)
        out[label] = counts
    return out


# ------------------------------------------------------------------------
# The parallel layer (parallel/): ring attention, sp and tp training, tp
# serving. The card's machine has one card, and NCCL refuses two ranks on
# one card, so these phases run their ranks as processes on card 0 over
# gloo, chosen here by name: the kernels run on the card and every tensor
# that crosses between ranks goes through pinned host memory
# (``mesh.staged_bytes``). A time taken so is not a multi-card speed.
PARALLEL_BACKEND, PARALLEL_DEVICE = "gloo", "cuda:0"
RING_SEQ, RING_WORLD = 16384, 4  # Llama-3-8B attention widths, 4,096 rows a rank
# (label, config options, with sinks)
RING_CASES = (("causal", dict(causal=True), False), ("full", {}, False),
              ("window 4096", dict(causal=True, window=4096), False),
              ("sinks", dict(causal=True), True))
TRAIN_PARALLEL_LAYERS, TRAIN_PARALLEL_SEQ, TRAIN_PARALLEL_STEPS = 2, 4096, 3
TRAIN_PARALLEL_GAP = 0.01  # a mesh's loss within this of the single rank's
# A mesh's first-step gradient, per leaf, within this share of the single
# rank's norm, in its norm and in its product with a fixed random sign
# tensor (``_grad_stats``). Both sides run bf16 products in different
# orders; a wrong dp/sp sum or a wrong tp transpose moves one of the two by
# a large share of the norm (AdamW's first steps, +-lr whatever the
# gradient's scale, hide such faults from the losses).
TRAIN_PARALLEL_GRAD_GAP = 0.05
SERVE_TP_INT8 = dict(layers=4, requests=4, new_tokens=16)
# The bf16 tp run's depth, cut from the full 32 layers to keep the smoke's time
# (8 until PR 24).
SERVE_TP_BF16_LAYERS = 4
# A tp token that differs from the single card's may sit this far below the
# single-card row max at the first difference: the bound of the JAX
# package's tensor-parallel server test (tests/test_generate.py). Each rank
# rounds its partial wo and w_down products to bf16 before the sum, and
# logits of magnitude 8 to 16 lie on a 0.0625 grid (bf16 lm_head products),
# so a one-ulp tie there already passes SLACK.
TP_SLACK = 0.1


def _spawn(fn, world, *args, timeout=900):
    from flash_attention_from_scratch_tpu_torch.parallel.launch import spawn

    torch.cuda.empty_cache()  # the ranks share this card
    return spawn(fn, world, backend=PARALLEL_BACKEND, device=PARALLEL_DEVICE,
                 timeout=timeout, args=args)


def _rank_line(phase, rank, world, staged, counts, **extra) -> None:
    print(json.dumps({f"{phase}_rank": {
        "rank": rank, "backend": PARALLEL_BACKEND, "world": world, "device": PARALLEL_DEVICE,
        "staged_bytes": staged, "launches": counts, **extra}}), flush=True)


def _ring_inputs(i):
    """Case i's global (q, k, v, dO): b 1, 32/8 heads, RING_SEQ, d 128."""
    gen = torch.Generator(device="cuda").manual_seed(500 + i)
    q = torch.randn((1, HEADS, RING_SEQ, D), generator=gen, device="cuda")
    k, v = (torch.randn((1, KV_HEADS, RING_SEQ, D), generator=gen, device="cuda")
            for _ in range(2))
    do = torch.randn(q.shape, generator=gen, device="cuda")
    return [t.bfloat16() for t in (q, k, v, do)]


def _ring_sinks():
    return torch.linspace(-2, 2, HEADS, device="cuda")


def ring_rank(rank, world, out_dir):
    """One rank of the ``ring`` phase: every RING_CASES case forward and
    backward on its sequence shard, its launches counted per case; its
    shards of the output and gradients saved for the parent's checks."""
    import torch.distributed as dist

    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import make_sp_mesh
    from flash_attention_from_scratch_tpu_torch.parallel.ring_attention import (
        ring_flash_attention)

    mesh = make_sp_mesh(world, device=PARALLEL_DEVICE, backend=PARALLEL_BACKEND)
    n = RING_SEQ // world
    counts, wall = {}, {}
    for i, (label, kw, with_sinks) in enumerate(RING_CASES):
        q, k, v, do = (t[:, :, rank * n:(rank + 1) * n].contiguous() for t in _ring_inputs(i))
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        z = _ring_sinks().requires_grad_(True) if with_sinks else None
        dist.barrier()
        _build.launch_counts.clear()
        t = time.perf_counter()
        out = ring_flash_attention(q, k, v, KernelConfig(**kw), mesh, sinks=z)
        (out * do).sum().backward()
        sync()
        wall[label] = time.perf_counter() - t
        counts[label] = dict(_build.launch_counts)
        torch.save({"out": out.detach().cpu(), "grads": [t.grad.cpu() for t in leaves],
                    "dsinks": None if z is None else z.grad.cpu()},
                   os.path.join(out_dir, f"ring{i}.{rank}.pt"))
    return {"counts": counts, "wall_s": wall, "staged_bytes": mesh.staged_bytes}


def _plain_backward_by_heads(q, k, v, o, lse, do, cfg):
    """The plain backward one KV head (and its Q heads) at a time: 32
    heads' fp32 scores at s 16384 would take 34 GB at once."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        flash_backward_plain)

    ratio = q.shape[1] // k.shape[1]
    parts = [flash_backward_plain(q[:, h * ratio:(h + 1) * ratio], k[:, h:h + 1],
                                  v[:, h:h + 1], o[:, h * ratio:(h + 1) * ratio],
                                  lse[:, h * ratio:(h + 1) * ratio],
                                  do[:, h * ratio:(h + 1) * ratio], cfg)
             for h in range(k.shape[1])]
    return [torch.cat([p[i] for p in parts], 1) for i in range(3)]


def phase_ring(smi: str, out_dir: str) -> dict:
    """Ring attention (``parallel/ring_attention.py``) over 4 gloo ranks on
    this card, at Llama-3-8B attention widths: b 1, 32/8 heads, d 128,
    global s 16,384 (4,096 a rank), causal, non-causal, a 4,096 window (2
    hops) and sinks, forward and backward. Each rank's K1/K2/K3 launches
    must equal its ``launch_plan``. The gathered output is held by the
    adaptive rule in each 64-row band against single-rank
    ``flash_attention`` on the whole sequence (bf16) and the plain fp32
    version (head by head), its gradients by ``_check_grads``, d(sinks) by
    the rule of ``_backward_sinks_case``. Returns per-rank launches."""
    from flash_attention_from_scratch_tpu_torch.ops.autodiff import flash_attention
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.parallel.ring_attention import launch_plan
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        adaptive_tolerance_check, row_bands, sliced_tolerance_check)

    t0 = time.perf_counter()
    ranks = _spawn(ring_rank, RING_WORLD, out_dir)
    spawn_s = time.perf_counter() - t0
    n = RING_SEQ // RING_WORLD
    for rank, r in enumerate(ranks):
        _rank_line("ring", rank, RING_WORLD, r["staged_bytes"], r["counts"],
                   wall_s=r["wall_s"])
        for label, kw, _ in RING_CASES:
            want = dict(launch_plan(KernelConfig(**kw), RING_WORLD, n, rank))
            if r["counts"][label] != want:
                raise AssertionError(f"ring {label} rank {rank}: launches "
                                     f"{r['counts'][label]}, plan {want}")
    cases = {}
    for i, (label, kw, with_sinks) in enumerate(RING_CASES):
        parts = [torch.load(os.path.join(out_dir, f"ring{i}.{r}.pt"))
                 for r in range(RING_WORLD)]
        out = torch.cat([p["out"] for p in parts], 2).cuda()
        got = [torch.cat([p["grads"][j] for p in parts], 2).cuda() for j in range(3)]
        del parts[1:]
        cfg = KernelConfig(**kw)
        q, k, v, do = _ring_inputs(i)
        z = _ring_sinks() if with_sinks else None
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        zz = None if z is None else z.clone().requires_grad_(True)
        whole = flash_attention(*leaves, cfg, zz)
        (whole * do).sum().backward()
        ref16 = [t.grad for t in leaves]
        f32 = [t.float() for t in (q, k, v)]
        o32, lse32 = _plain_by_heads(*f32, _fp32(cfg), z, group=4)
        ok, ratio, where = sliced_tolerance_check(row_bands(out), row_bands(whole.detach()),
                                                  row_bands(o32), lead=3)
        if not ok or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"ring {label}: output err/bound {ratio:.3f} at {where}")
        ref32 = _plain_backward_by_heads(*f32, o32, lse32, do.float(), _fp32(cfg))
        err, grad_ratio = _check_grads(f"ring {label}", got, ref16, ref32)
        line = {"case": label, "out_worst_err_bound": ratio, "grads_worst_err_bound": grad_ratio,
                "max_abs_err": max(err, float((out.float() - whole.float()).abs().max()))}
        if with_sinks:
            d32 = -(torch.exp(z[None, :, None] - lse32) * (do.float() * o32).sum(-1)).sum((0, 2))
            zok, kerr, berr = adaptive_tolerance_check(parts[0]["dsinks"].cuda(), zz.grad, d32)
            if not (zok or kerr <= max(2 * berr, 0.02 * float(d32.abs().max()))):
                raise AssertionError(f"ring sinks: d(sinks) err {kerr} baseline {berr}")
            line["dsinks_err"] = kerr
        print(f"ring_case: {json.dumps(line)}", flush=True)
        cases[label] = line
        del out, got, whole, leaves, ref16, ref32, o32, lse32, f32, q, k, v, do
        torch.cuda.empty_cache()
    result = {"world": RING_WORLD, "backend": PARALLEL_BACKEND, "seq": RING_SEQ,
              "shard": n, "heads": f"{HEADS}/{KV_HEADS}", "cases": cases,
              "staged_bytes": [r["staged_bytes"] for r in ranks],
              "ring_wall_s": [r["wall_s"] for r in ranks], "spawn_s": spawn_s,
              "note": "ranks are processes time-sharing one card over gloo: no time "
                      "here is a multi-card speed", "gpu": smi}
    print(json.dumps({"ring": result}), flush=True)
    return {"counts": [r["counts"] for r in ranks]}


def _train_tokens():
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, 128256, (1, TRAIN_PARALLEL_SEQ + 1))).to("cuda")


def _train_run(mesh=None) -> dict:
    """TRAIN_PARALLEL_STEPS AdamW steps of Llama-3-8B's width at
    TRAIN_PARALLEL_LAYERS layers from seed 0, on ``mesh`` (this rank's
    shard) or on one rank; the launches counted over the steps."""
    from flash_attention_from_scratch_tpu_torch import (
        LLAMA3_8B, init_params, make_optimizer, make_train_step)
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import shard_params

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=TRAIN_PARALLEL_LAYERS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    if mesh is not None:
        params = shard_params(params, mesh)
        torch.cuda.empty_cache()
    optimizer = make_optimizer(params)
    grads, stats_s = {}, [0.0]

    def first_grads(*_):  # the first step's gradients, as the optimizer gets them
        if not grads:
            t = time.perf_counter()
            grads.update(_grad_stats(params, mesh))
            stats_s[0] = time.perf_counter() - t

    optimizer.register_step_pre_hook(first_grads)
    step = make_train_step(cfg, optimizer, mesh=mesh)
    tokens = _train_tokens()
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    losses, step_s = [], []
    for _ in range(TRAIN_PARALLEL_STEPS):
        t = time.perf_counter()
        losses.append(float(step(params, tokens)))
        sync()
        step_s.append(time.perf_counter() - t)
    step_s[0] -= stats_s[0]
    return {"losses": losses, "step_s": step_s, "counts": dict(_build.launch_counts),
            "grads": grads, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "staged_bytes": 0 if mesh is None else mesh.staged_bytes}


def _grad_stats(params, mesh=None) -> dict:
    """Each leaf's gradient as two numbers over the whole leaf: its sum of
    squares, and its product with a fixed random +-1 tensor of the leaf's
    global shape (seeded by the leaf's place in the tree). A tp rank's
    shard gives its block's share of both (``"shard": True``; the shares
    add up over the tp ranks), a replicated leaf the whole."""
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import (
        MODEL_AXIS, llama_param_specs)

    specs = llama_param_specs(params)
    named = [(k, params[k], specs[k]) for k in ("embed", "final_norm", "lm_head")]
    named += [(f"layers.{i}.{k}", v, specs["layers"][i][k])
              for i, layer in enumerate(params["layers"]) for k, v in layer.items()]
    tp = 1 if mesh is None else mesh.size(MODEL_AXIS)
    out = {}
    for j, (name, p, spec) in enumerate(named):
        g = p.grad.float()
        shape, dim = list(g.shape), None
        if tp > 1 and MODEL_AXIS in spec:
            dim = spec.index(MODEL_AXIS)
            shape[dim] *= tp
        gen = torch.Generator(device="cuda").manual_seed(1000 + j)
        signs = torch.randint(0, 2, shape, generator=gen, device="cuda", dtype=torch.int8)
        if dim is not None:
            signs = signs.narrow(dim, mesh.coord(MODEL_AXIS) * g.shape[dim], g.shape[dim])
        out[name] = {"sumsq": float(g.square().sum(dtype=torch.float64)),
                     "proj": float((g * (2 * signs - 1)).sum(dtype=torch.float64)),
                     "shard": dim is not None}
        del g, signs
    return out


def _grad_gaps(single: dict, ranks: list) -> dict:
    """Per leaf, how far a mesh's first-step gradient lies from the single
    rank's, as shares of the single rank's norm: (|norm difference|,
    |difference of the products with the random signs|); the mesh's
    numbers are its tp shards' sums, or rank 0's for a replicated leaf."""
    gaps = {}
    for name, want in single.items():
        got = [r["grads"][name] for r in ranks]
        whole = {k: sum(x[k] for x in got) if got[0]["shard"] else got[0][k]
                 for k in ("sumsq", "proj")}
        norm = math.sqrt(want["sumsq"])
        gaps[name] = (abs(math.sqrt(whole["sumsq"]) - norm) / norm,
                      abs(whole["proj"] - want["proj"]) / norm)
    return gaps


def train_rank(rank, world):
    """The train_parallel runs of one rank: on the sp mesh, then on the tp
    mesh of the same ranks."""
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import make_mesh, make_sp_mesh

    kw = dict(device=PARALLEL_DEVICE, backend=PARALLEL_BACKEND)
    out = {"sp": _train_run(make_sp_mesh(world, **kw))}
    torch.cuda.empty_cache()
    out["tp"] = _train_run(make_mesh(1, world, **kw))
    return out


def phase_train_parallel(smi: str) -> dict:
    """Llama-3-8B's width at 2 layers, batch 1, 4,096 tokens, 3 AdamW steps
    from seed 0: on one rank, then on an sp 2 mesh (the ring) and a tp 2
    mesh, in turns. Every loss finite and falling, each mesh's within
    TRAIN_PARALLEL_GAP of the single rank's at every step (the gap
    reported), the ranks' losses equal, each mesh's first-step gradient
    within TRAIN_PARALLEL_GRAD_GAP of the single rank's on every leaf
    (``_grad_gaps``, the worst reported), and each rank's K1/K2/K3 launches
    those of its plan: per layer and step, the ring's ``launch_plan`` on
    sp, one K1 and one K3 on tp."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.parallel.ring_attention import launch_plan

    per_call = TRAIN_PARALLEL_LAYERS * TRAIN_PARALLEL_STEPS
    single = _train_run()
    torch.cuda.empty_cache()
    runs = {"single": single}
    line = {"model": "LLAMA3_8B", "layers": TRAIN_PARALLEL_LAYERS, "batch": 1,
            "seq": TRAIN_PARALLEL_SEQ, "steps": TRAIN_PARALLEL_STEPS,
            "single": {k: single[k] for k in ("losses", "step_s", "counts", "peak_gb")}}
    both = _spawn(train_rank, 2)
    for kind in ("sp", "tp"):
        ranks = [r[kind] for r in both]
        runs[kind] = ranks
        for rank, r in enumerate(ranks):
            _rank_line(f"train_{kind}", rank, 2, r["staged_bytes"], r["counts"],
                       losses=r["losses"], step_s=r["step_s"], peak_gb=r["peak_gb"])
            if kind == "sp":
                plan = launch_plan(KernelConfig(causal=True), 2, TRAIN_PARALLEL_SEQ // 2, rank)
                want = {name: c * per_call for name, c in plan.items()}
            else:
                want = {K1: per_call, KERNEL_DKV: per_call, KERNEL_DQ: per_call}
            if r["counts"] != want:
                raise AssertionError(f"train {kind} rank {rank}: launches {r['counts']}, "
                                     f"plan {want}")
        losses = ranks[0]["losses"]
        gaps = [abs(a - b) for a, b in zip(losses, single["losses"])]
        grad_gaps = _grad_gaps(single["grads"], ranks)
        worst = {k: max(g[k] for g in grad_gaps.values()) for k in (0, 1)}
        line[kind] = {"losses": losses, "gap_to_single": gaps,
                      "grad_norm_gap": worst[0], "grad_proj_gap": worst[1],
                      "step_s": [r["step_s"] for r in ranks],
                      "staged_bytes": [r["staged_bytes"] for r in ranks],
                      "peak_gb": [r["peak_gb"] for r in ranks]}
        if (any(r["losses"] != losses for r in ranks) or not all(np.isfinite(losses))
                or not losses[-1] < losses[0] or max(gaps) > TRAIN_PARALLEL_GAP):
            raise AssertionError(f"train {kind}: losses {[r['losses'] for r in ranks]}, "
                                 f"single {single['losses']}")
        if max(worst.values()) > TRAIN_PARALLEL_GRAD_GAP:
            raise AssertionError(f"train {kind}: first-step gradients off the single "
                                 f"rank's: {grad_gaps}")
    if not single["losses"][-1] < single["losses"][0]:
        raise AssertionError(f"train single: losses {single['losses']} not falling")
    line.update(backend=PARALLEL_BACKEND, world=2, gpu=smi,
                note="ranks are processes time-sharing one card over gloo: no time here "
                     "is a multi-card speed")
    print(json.dumps({"train_parallel": line}), flush=True)
    return {kind: [r["counts"] for r in runs[kind]] for kind in ("sp", "tp")}


def _tp_server(kind, mesh=None):
    """The serve_tp phase's server of ``kind``: "bf16" (the serve phase's
    Llama-3-8B at SERVE_TP_BF16_LAYERS layers, seed 0) or "int8" (run A's
    int8 weights and int8 KV at SERVE_TP_INT8's depth), tensor-parallel with
    ``mesh``."""
    from flash_attention_from_scratch_tpu_torch import (
        LLAMA3_8B, GenerationServer, init_params, init_quantized_params)

    gen = torch.Generator(device="cuda").manual_seed(0)
    if kind == "bf16":
        cfg = dataclasses.replace(LLAMA3_8B, n_layers=SERVE_TP_BF16_LAYERS)
        kw = dict(num_pages=SERVE_PAGES, page_size=SERVE_PAGE_SIZE, max_batch=8,
                  pages_per_seq=SERVE_PAGES_PER_SEQ)
        params = init_params(cfg, gen)
    else:
        cfg = dataclasses.replace(LLAMA3_8B, n_layers=SERVE_TP_INT8["layers"])
        per_seq = -(-(QUANT_PROMPT + SERVE_TP_INT8["new_tokens"]) // QUANT_PAGE)
        kw = dict(num_pages=SERVE_TP_INT8["requests"] * per_seq + 2, page_size=QUANT_PAGE,
                  max_batch=SERVE_TP_INT8["requests"], pages_per_seq=per_seq, mode="int8")
        params = init_quantized_params(cfg, gen, "int8")
    return cfg, kw, GenerationServer(params, cfg, mesh=mesh, **kw)


def _tp_prompts(kind, vocab):
    rng = np.random.default_rng(0)
    if kind == "bf16":  # the serve phase's
        return {i: rng.integers(0, vocab, n).tolist() for i, n in enumerate(SERVE_PROMPT_LENS)}
    return {i: rng.integers(0, vocab, QUANT_PROMPT).tolist()
            for i in range(SERVE_TP_INT8["requests"])}


def serve_tp_rank(rank, world):
    """The serve_tp runs of one rank, bf16 then int8, each on a tp mesh of
    its own (its own staged bytes)."""
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for kind in ("bf16", "int8"):
        mesh = make_mesh(1, world, device=PARALLEL_DEVICE, backend=PARALLEL_BACKEND)
        cfg, _, server = _tp_server(kind, mesh)
        torch.cuda.empty_cache()  # the whole weights this rank drew are gone
        new = SERVE_NEW_TOKENS if kind == "bf16" else SERVE_TP_INT8["new_tokens"]
        prompts = _tp_prompts(kind, cfg.vocab_size)
        run = _drive(server, prompts, new)
        out[kind] = {
            "tokens": {sid: server.seqs[sid].generated for sid in prompts},
            "counts": run["counts"], "stats": run["stats"], "nonfinite": run["nonfinite"],
            "prefill_s": run["prefill_s"], "decode_s": run["decode_s"],
            "decode_tokens": run["decode_tokens"], "wall_s": run["wall_s"],
            "peak_gb": run["peak_mem_gb"], "staged_bytes": mesh.staged_bytes}
        del server
        torch.cuda.empty_cache()
    return out


def _first_difference_gaps(kind, single_tokens, tp_tokens, slack_std):
    """Per request whose tp tokens differ from the single card's, the gap
    of the tp token at the first difference below the single-card
    full-recompute row max (``_teacher_forced_gaps``) and the row's
    standard deviation; every such gap must be a near-tie."""
    differ = [sid for sid in tp_tokens if tp_tokens[sid] != single_tokens[sid]]
    if not differ:
        return {}
    cfg, _, server = _tp_server(kind)
    prompts = _tp_prompts(kind, cfg.vocab_size)
    out = {}
    for sid in differ:
        j = next(i for i, (a, b) in enumerate(zip(tp_tokens[sid], single_tokens[sid]))
                 if a != b)
        gaps, std = _teacher_forced_gaps(server.params, cfg, prompts[sid],
                                         tp_tokens[sid][:j + 1])
        gap = float(gaps[-1])
        bound = TP_SLACK if slack_std is None else slack_std * float(std[-1])
        out[sid] = {"first_difference": j, "gap": gap, "bound": bound}
        if gap > bound:
            raise AssertionError(f"serve_tp {kind} request {sid}: token {j} differs from the "
                                 f"single card's and sits {gap} below the row max")
    del server
    torch.cuda.empty_cache()
    return out


def phase_serve_tp(smi: str) -> dict:
    """Tensor-parallel serving over 2 gloo ranks on this card: the serve
    phase's bf16 Llama-3-8B at full width and SERVE_TP_BF16_LAYERS layers
    (its 8 requests, 32 greedy tokens), then run A's int8 weights and int8
    KV at 4 layers (4 requests of 1,024 tokens, 16 new), which hands K6 its
    column and row shards; each against the same server on the single card
    first. Every rank
    serves the same tokens; where they differ from the single card's, the
    first difference is a near-tie (TP_SLACK below the single-card row
    max, or QUANT_SLACK_STD row deviations for int8, whose recompute reads
    K/V unquantized). Each rank's launches are its plan's: K1 per layer and
    prompt, K4/K5 and its merge per layer and decode step at 4 KV heads,
    K6 (7 x layers + 1) per call. Decode tokens/s is two processes
    time-sharing one card over gloo: not a tp speed."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS

    counts, single = {}, {}
    # Each run's single-card tokens, in this process before the ranks.
    for kind in ("bf16", "int8"):
        cfg1, kw1, server1 = _tp_server(kind)
        prompts1 = _tp_prompts(kind, cfg1.vocab_size)
        new = SERVE_NEW_TOKENS if kind == "bf16" else SERVE_TP_INT8["new_tokens"]
        _warm_graphs(server1, cfg1.vocab_size, new)
        _drive(server1, prompts1, new)
        single[kind] = {sid: server1.seqs[sid].generated for sid in prompts1}
        if kind == "int8":
            kw8 = kw1
        del server1
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    both = _spawn(serve_tp_rank, 2)
    spawn_s = time.perf_counter() - t0
    for kind in ("bf16", "int8"):
        ranks = [r[kind] for r in both]
        layers = SERVE_TP_BF16_LAYERS if kind == "bf16" else SERVE_TP_INT8["layers"]
        kw = (dict(max_batch=8, pages_per_seq=SERVE_PAGES_PER_SEQ, page_size=SERVE_PAGE_SIZE)
              if kind == "bf16" else dict(max_batch=kw8["max_batch"],
                                          pages_per_seq=kw8["pages_per_seq"],
                                          page_size=QUANT_PAGE, mode="int8"))
        for rank, r in enumerate(ranks):
            st = r["stats"]
            want = {K1: layers * len(r["tokens"]), KP: layers * st["decode_steps"]}
            if kind == "int8":
                want[KERNELS[("int8", False)]] = (7 * layers + 1) * (
                    len(r["tokens"]) + st["decode_steps"])
            want = _with_merges(want, kv_heads=KV_HEADS // 2, **kw)
            _rank_line(f"serve_tp_{kind}", rank, 2, r["staged_bytes"], r["counts"],
                       decode_tok_s=r["decode_tokens"] / r["decode_s"], peak_gb=r["peak_gb"])
            if r["counts"] != want or r["nonfinite"] or st["preemptions"]:
                raise AssertionError(f"serve_tp {kind} rank {rank}: launches {r['counts']}, "
                                     f"plan {want}; {r['nonfinite']} non-finite logits, "
                                     f"{st['preemptions']} preemptions")
        tokens = ranks[0]["tokens"]
        if ranks[1]["tokens"] != tokens:
            raise AssertionError(f"serve_tp {kind}: the ranks served different tokens")
        gaps = _first_difference_gaps(kind, single[kind], tokens,
                                      None if kind == "bf16" else QUANT_SLACK_STD)
        counts[kind] = [x["counts"] for x in ranks]
        r = ranks[0]
        line = {
            "model": "LLAMA3_8B", "layers": layers, "tp": 2, "requests": len(tokens),
            "equal_to_single_card": sum(tokens[s] == single[kind][s] for s in tokens),
            "first_differences": gaps,
            "decode_tok_s": r["decode_tokens"] / r["decode_s"],
            "prefill_tok_s": r["stats"]["prefill_tokens"] / r["prefill_s"],
            "wall_s": r["wall_s"], "spawn_s_both_runs": spawn_s,
            "staged_bytes": [x["staged_bytes"] for x in ranks],
            "peak_gb": [x["peak_gb"] for x in ranks], "launches": r["counts"],
            "backend": PARALLEL_BACKEND, "gpu": smi,
            "note": "gloo on one card, two processes time-sharing it: not a tp speed"}
        print(json.dumps({f"serve_tp_{kind}": line}), flush=True)
    return {"counts": counts}


def phase_bench_ring(smi: str) -> list:
    """``tools/bench_ring.py`` as a user runs it, in its own process: the
    ring's compute side (every Q shard's hop kernels and merges, all shards
    on this card) against one K1 call, at s 16,384 (the ring phase's
    length), 2/4/8 shards, 32 heads; each ring within 2^-6 of the monolithic output's
    largest value (two bf16 ulps there: the hops' outputs are rounded to
    bf16 before the merge)."""
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "flash_attention_from_scratch_tpu_torch.tools.bench_ring",
           "--seq", str(RING_SEQ), "--shards", "2,4,8", "--heads", str(HEADS), "--iters", "3",
           "--json"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"bench_ring --seq {RING_SEQ} exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    rows = json.loads(proc.stdout.strip().splitlines()[-1])["rows"]
    if any(r["max_abs_diff"] > 2.0 ** -6 * r["max_abs_ref"] or not r["ms"] > 0 for r in rows):
        raise AssertionError(f"bench_ring --seq {RING_SEQ}: {rows}")
    print(json.dumps({"bench_ring": {"rows": rows, "gpu": smi}}), flush=True)
    return rows


# The ring's hop configs at the ring phase's shard (4,096 rows a rank):
# (label, config options, visible (q, kv) pairs per head).
_L = RING_SEQ // RING_WORLD
SHARD_HOPS = (("diagonal causal", dict(causal=True), _L * (_L + 1) // 2),
              ("plain hop", {}, _L * _L),
              ("window hop", dict(causal=True, q_offset=_L, window=_L), _L * (_L - 1) // 2))
# Llama-3-8B's projections as a tp 2 rank holds them, (name, K, N).
TP_SHAPES = (("wq", 4096, 2048), ("wk", 4096, 512), ("wv", 4096, 512), ("wo", 2048, 4096),
             ("w_gate", 4096, 7168), ("w_up", 4096, 7168), ("w_down", 7168, 4096),
             ("lm_head", 4096, 64128))


def time_shards() -> dict:
    """The kernels at the parallel phases' shard shapes, each beside its
    bound, its plain version and a library call where there is one: K1 at
    the ring's three hop configs (b 1, 32/8 heads, 4,096 rows a rank;
    library: SDPA with the hop's mask), K3 on the causal ones and K2 on the
    plain hop (the backward the ring runs there; library: SDPA's backward
    with the hop's mask), K4/K5 at serve_tp's first
    decode step on a rank's 4 KV heads, and K6 on a tp 2 rank's shard of
    each Llama-3-8B projection at the decode batch (m 8; library: the bf16
    product on the dequantized weight)."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        _visible, flash_backward, flash_backward_plain, fused_choice)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward, flash_forward_plain, flash_forward_with_lse)
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        quant_matmul, quant_matmul_plain)

    out = {"k1": {}, "backward": {}}
    q, k, v = _cuda_qkv(_L, _L, seed=70)
    do = _cuda_normal(q.shape, seed=71)
    io_bytes = 2 * (2 * q.numel() + 2 * k.numel())
    for label, kw, pairs in SHARD_HOPS:
        cfg = KernelConfig(**kw)
        mask = _visible(_L, _L, cfg, "cuda") if cfg.causal else None
        ops = 4 * D * pairs * HEADS
        out["k1"][label] = {
            "ms": _time_ms(lambda: flash_forward(q, k, v, cfg)),
            "plain_ms": _time_ms(lambda: _plain_by_heads(q, k, v, cfg, None), iters=3, warmup=1),
            "library_ms": _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)),
            "bound_ms": 1e3 * max(ops / PEAK_BF16_FLOPS, io_bytes / PEAK_BYTES_PER_S),
            "bound_by": "operations" if ops / PEAK_BF16_FLOPS > io_bytes / PEAK_BYTES_PER_S
            else "bytes"}
        o, lse = flash_forward_with_lse(q, k, v, cfg)
        kernel = "K2" if fused_choice(None, cfg.causal) else "K3"
        bops, bbytes = 2.5 * ops, 2 * (5 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        # The library's backward as time_backward's: SDPA with the hop's
        # mask (K/V repeated to 32 heads), forward + autograd.grad minus the
        # same forward.
        qg = q.clone().requires_grad_()
        kg = k.repeat_interleave(HEADS // KV_HEADS, 1).requires_grad_()
        vg = v.repeat_interleave(HEADS // KV_HEADS, 1).requires_grad_()

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(qg, kg, vg,
                                                                    attn_mask=mask)

        fwd_ms = _time_ms(sdpa)
        out["backward"][label] = {
            "kernel": kernel,
            "ms": _time_ms(lambda: flash_backward(q, k, v, o, lse, do, cfg)),
            "plain_ms": _time_ms(lambda: flash_backward_plain(q, k, v, o, lse, do, cfg),
                                 iters=1, warmup=1),
            "library_ms": _time_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do))
            - fwd_ms,
            "bound_ms": 1e3 * max(bops / PEAK_BF16_FLOPS, bbytes / PEAK_BYTES_PER_S),
            "bound_by": "operations"}
        del o, lse, qg, kg, vg
    out["shape"] = (f"b 1, {HEADS}/{KV_HEADS} heads, {_L} rows and keys a rank, d {D}, "
                    "bf16: one hop of the ring phase")
    del q, k, v, do
    lengths = [n + 1 for n in SERVE_PROMPT_LENS]
    kp, vp, lens, tables = make_paged_pool(lengths, SERVE_PAGE_SIZE, SERVE_PAGES, seed=72,
                                           pages_per_seq=SERVE_PAGES_PER_SEQ)
    kvh = KV_HEADS // 2
    kp, vp = kp[:kvh].contiguous(), vp[:kvh].contiguous()
    qd = _cuda_normal((len(lengths), HEADS // 2, D), seed=73)
    nbytes = sum(lengths) * kvh * D * 2 * 2 + 2 * qd.numel() * 2
    out["paged"] = {
        "ms": _graph_ms(lambda: paged_decode_attention(qd, kp, vp, lens, tables)),
        "plain_ms": _time_ms(lambda: paged_decode_attention_plain(
            qd, kp, vp, lens, tables, scale=D ** -0.5), iters=3, warmup=1),
        "library_ms": None, "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
        "shape": f"serve_tp's first decode step on one rank: lengths {lengths}, "
                 f"{HEADS // 2}/{kvh} heads, page {SERVE_PAGE_SIZE}"}
    del kp, vp
    gen = torch.Generator(device="cuda").manual_seed(74)
    k6 = {}
    for name, kk, n in TP_SHAPES:
        wq = _random_qweight(kk, n, "int8", False, gen)
        x = _cuda_normal((8, kk), seed=75)
        w16 = wq.dequantize()
        nb, ops = _shape_work(8, kk, n, wq)
        k6[name] = {"ms": _graph_ms(lambda: quant_matmul(x, wq)),
                    "plain_ms": _time_ms(lambda: quant_matmul_plain(x, wq), iters=3, warmup=1),
                    "library_ms": _graph_ms(lambda: x @ w16),
                    "bound_ms": 1e3 * max(ops / PEAK_BF16_FLOPS, nb / PEAK_BYTES_PER_S),
                    "bound_by": "bytes", "k": kk, "n": n}
        del wq, w16
    out["k6"] = k6
    torch.cuda.empty_cache()
    return out


# ---- the parallel layer, part 2: expert parallelism, the pipeline, LoRA
# under tp, the scaling report and the dry run, each over gloo ranks on
# this card as the phases above.
MOE_EP_WORLD, MOE_EP_TOKENS, MOE_EP_LAYERS = 4, 2048, 2
MOE_EP_GAP = 0.01  # the bf16 ep loss within this of one rank's
PIPE_WORLD, PIPE_LAYERS, PIPE_BATCH, PIPE_MICRO = 4, 4, 4, 4
PIPE_GRAD_LEAVES = ("embed", "lm_head", "layers.0.wq", f"layers.{PIPE_LAYERS - 1}.wq")
TP_LORA = dict(layers=4, prompt_lens=(200, 500, 750, 1000), adapters=(-1, 0, 1, 2),
               new_tokens=16, verify_t=4)
DRYRUN_RANKS = 4


def _ep_layer(cfg, experts, seed: int = 0):
    """One fp32 MoE layer of ``cfg``'s widths on the card: the router from
    ``seed`` and expert e of ``experts`` from ``seed + 1 + e``, so every
    rank draws its own experts as one rank draws them all."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, h = cfg.dim, cfg.hidden_dim
    router = torch.randn((d, cfg.n_experts), generator=gen, device="cuda") / math.sqrt(d)
    parts = {"w_gate": [], "w_up": [], "w_down": []}
    for e in experts:
        g = torch.Generator(device="cuda").manual_seed(seed + 1 + e)
        parts["w_gate"].append(torch.randn((d, h), generator=g, device="cuda") / math.sqrt(d))
        parts["w_up"].append(torch.randn((d, h), generator=g, device="cuda") / math.sqrt(d))
        parts["w_down"].append(torch.randn((h, d), generator=g, device="cuda") / math.sqrt(h))
    return {"router": router, "experts": {k: torch.stack(v) for k, v in parts.items()}}


def _ep_mlp(cfg, layer, mesh=None) -> dict:
    """``_moe_mlp`` forward and backward of sum(out * dO) + aux on fp32
    activations (1, MOE_EP_TOKENS, dim) and dO from seed 77, the same on
    every rank: out, aux and the gradients of x, the router and w_down."""
    from flash_attention_from_scratch_tpu_torch.models.moe import _moe_mlp

    gen = torch.Generator(device="cuda").manual_seed(77)
    x = torch.randn((1, MOE_EP_TOKENS, cfg.dim), generator=gen, device="cuda")
    dout = torch.randn(x.shape, generator=gen, device="cuda")
    x.requires_grad_(True)
    for t in (layer["router"], layer["experts"]["w_down"]):
        t.requires_grad_(True)
    out, aux = _moe_mlp(cfg, layer, x, mesh)
    ((out * dout).sum() + aux).backward()
    return {"out": out.detach(), "aux": float(aux.detach()), "x": x.grad,
            "router": layer["router"].grad, "w_down": layer["experts"]["w_down"].grad}


def _moe_ep_loss(cfg, mesh=None) -> dict:
    """``moe_loss_fn`` forward and backward of the bf16 MoE model at
    MOE_EP_LAYERS layers (seed 0), batch 1 x MOE_EP_TOKENS + 1 tokens,
    on ``mesh`` (this rank's experts) or one rank; the launches counted."""
    from flash_attention_from_scratch_tpu_torch import init_moe_params, moe_loss_fn
    from flash_attention_from_scratch_tpu_torch.models.moe import shard_moe_params
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
    from flash_attention_from_scratch_tpu_torch.ops import _build

    params = init_moe_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    if mesh is not None:
        params = shard_moe_params(params, mesh)
        torch.cuda.empty_cache()
    for p in param_leaves(params):
        p.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, MOE_EP_TOKENS + 1))).to("cuda")
    _build.launch_counts.clear()
    t = time.perf_counter()
    loss = moe_loss_fn(params, tokens, cfg, mesh)
    loss.backward()
    sync()
    return {"loss": float(loss.detach()), "s": time.perf_counter() - t,
            "counts": dict(_build.launch_counts),
            "router_grad": float(params["layers"][0]["router"].grad.abs().max())}


def moe_ep_rank(rank, world):
    """One rank of ``moe_ep``: the fp32 layer on the shared activations
    with all experts and no mesh (one rank's computation, made here so no
    gradient crosses processes), then with its own experts on the ep mesh,
    compared on the card; then the bf16 loss and gradients of its experts'
    model. Returns the comparisons, the losses and the launches."""
    from flash_attention_from_scratch_tpu_torch.models.moe import EXPERT_AXIS
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import make_axis_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_axis_mesh(EXPERT_AXIS, world, device=PARALLEL_DEVICE, backend=PARALLEL_BACKEND)
    cfg = _mixtral(1, dtype=DType.FP32)
    n = cfg.n_experts // world
    want = _ep_mlp(cfg, _ep_layer(cfg, range(cfg.n_experts)))
    want["w_down"] = want["w_down"][rank * n:(rank + 1) * n].clone()
    torch.cuda.empty_cache()
    got = _ep_mlp(cfg, _ep_layer(cfg, range(rank * n, (rank + 1) * n)), mesh)
    mlp = {"out_ok": bool(torch.allclose(got["out"], want["out"], atol=1e-4, rtol=1e-4)),
           "out_err": float((got["out"] - want["out"]).abs().max()),
           "aux": got["aux"], "single_aux": want["aux"],
           **{name: float((got[name] - want[name]).abs().max() / want[name].abs().max())
              for name in ("x", "router", "w_down")}}
    mlp_staged = mesh.staged_bytes
    del got, want
    torch.cuda.empty_cache()
    loss = _moe_ep_loss(_mixtral(MOE_EP_LAYERS), mesh)
    return {"mlp": mlp, "mlp_staged": mlp_staged, "loss": loss,
            "staged_bytes": mesh.staged_bytes - mlp_staged}


def phase_moe_ep(smi: str) -> dict:
    """Expert parallelism over MOE_EP_WORLD gloo ranks on this card at
    Mixtral-8x7B's widths (8 experts, 2 a rank). (a) ``_moe_mlp`` alone, one
    fp32 layer (5.6 GB of experts, 1.4 GB a rank; TF32 off), b 1 x 2,048
    tokens, the same activations on every rank, against the same layer
    with all experts on one rank: out within atol and rtol 1e-4, aux within
    rtol 1e-5 (``tests/test_moe.py``'s bounds), and the gradients of x, the
    router and the rank's w_down within 1e-4 of the one rank's largest.
    (b) ``moe_loss_fn`` in bf16 at 2 layers, batch 1 x 2,049 tokens,
    forward and backward: finite, within MOE_EP_GAP of one rank's, a router
    gradient, and each rank's K1/K3 launches one a layer (attention runs
    replicated)."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1

    single_loss = _moe_ep_loss(_mixtral(MOE_EP_LAYERS))
    torch.cuda.empty_cache()
    ranks = _spawn(moe_ep_rank, MOE_EP_WORLD)
    plan = {K1: MOE_EP_LAYERS, KERNEL_DKV: MOE_EP_LAYERS, KERNEL_DQ: MOE_EP_LAYERS}
    worst = {}
    for rank, r in enumerate(ranks):
        m, ls = r["mlp"], r["loss"]
        _rank_line("moe_ep", rank, MOE_EP_WORLD, r["staged_bytes"], ls["counts"],
                   mlp_staged_bytes=r["mlp_staged"], loss=ls["loss"], step_s=ls["s"])
        for name in ("out_err", "x", "router", "w_down"):
            worst[name] = max(worst.get(name, 0.0), m[name])
        gap = abs(ls["loss"] - single_loss["loss"])
        worst["loss_gap"] = max(worst.get("loss_gap", 0.0), gap)
        if (not m["out_ok"] or abs(m["aux"] - m["single_aux"]) > 1e-5 * abs(m["single_aux"])
                or max(m[k] for k in ("x", "router", "w_down")) > 1e-4
                or not math.isfinite(ls["loss"]) or gap > MOE_EP_GAP
                or not ls["router_grad"] > 0 or ls["counts"] != plan):
            raise AssertionError(f"moe_ep rank {rank}: {m}, loss {ls['loss']} vs "
                                 f"{single_loss['loss']}, launches {ls['counts']} "
                                 f"(plan {plan})")
    line = {"model": "Mixtral-8x7B widths", "ep": MOE_EP_WORLD,
            "experts_a_rank": _mixtral(1).n_experts // MOE_EP_WORLD,
            "mlp_tokens": MOE_EP_TOKENS, "loss_layers": MOE_EP_LAYERS,
            "mlp_err_worst": worst, "single_loss": single_loss["loss"],
            "single_step_s": single_loss["s"], "loss": [r["loss"]["loss"] for r in ranks],
            "step_s": [r["loss"]["s"] for r in ranks],
            "staged_bytes": [r["staged_bytes"] for r in ranks], "backend": PARALLEL_BACKEND,
            "gpu": smi, "note": "gloo on one card: not a multi-card speed"}
    print(json.dumps({"moe_ep": line}), flush=True)
    return {"counts": [r["loss"]["counts"] for r in ranks]}


def _pipe_stats(grads: dict) -> dict:
    """Each PIPE_GRAD_LEAVES gradient present as (sum of squares,
    product with a fixed random +-1 tensor seeded by the leaf's place)."""
    out = {}
    for j, name in enumerate(PIPE_GRAD_LEAVES):
        if name not in grads:
            continue
        g = grads[name]
        gen = torch.Generator(device="cuda").manual_seed(2000 + j)
        signs = torch.randint(0, 2, g.shape, generator=gen, device="cuda", dtype=torch.int8)
        sumsq = proj = 0.0
        for gc, sc in zip(g.chunk(16), signs.chunk(16)):  # 1/16 of a 2 GB leaf at a time
            gc = gc.float()
            sumsq += float(gc.square().sum(dtype=torch.float64))
            proj += float((gc * (2 * sc - 1)).sum(dtype=torch.float64))
        out[name] = {"sumsq": sumsq, "proj": proj}
        del signs
    return out


def _pipe_run(mesh=None) -> dict:
    """One forward and backward of Llama-3-8B's width at PIPE_LAYERS
    layers (seed 0), batch PIPE_BATCH x (TRAIN_PARALLEL_SEQ / 2 + 1) tokens:
    ``pipeline_loss_fn`` over ``mesh`` (this rank's stage) in PIPE_MICRO
    microbatches, or ``loss_fn`` on one rank; the launches counted and the
    first-step gradient stats of PIPE_GRAD_LEAVES."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, init_params, loss_fn
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.parallel.pipeline import (
        PIPELINE_AXIS, pipeline_loss_fn, shard_pipeline_params, stack_pipeline_params)

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=PIPE_LAYERS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    if mesh is not None:
        params = shard_pipeline_params(stack_pipeline_params(params, PIPE_WORLD), mesh)
        torch.cuda.empty_cache()
    for p in param_leaves(params):
        p.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (PIPE_BATCH, TRAIN_PARALLEL_SEQ // 2 + 1))).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()
    t = time.perf_counter()
    if mesh is None:
        loss = loss_fn(params, tokens, cfg)
    else:
        loss = pipeline_loss_fn(params, tokens, cfg, mesh, PIPE_MICRO)
    loss.backward()
    sync()
    took = time.perf_counter() - t
    loss, peak = float(loss.detach()), torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()  # the ranks share the card
    grads = {"embed": params["embed"].grad, "lm_head": params["lm_head"].grad}
    if mesh is None:
        grads.update({f"layers.{i}.wq": layer["wq"].grad
                      for i, layer in enumerate(params["layers"])})
    else:
        me = mesh.coord(PIPELINE_AXIS)
        grads[f"layers.{me}.wq"] = params["stages"]["wq"].grad[0, 0]
    return {"loss": loss, "s": took, "counts": dict(_build.launch_counts),
            "grads": _pipe_stats(grads), "peak_gb": peak}


def pipe_rank(rank, world):
    """One rank of the ``pipeline`` phase: its stage of the pp mesh."""
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import make_axis_mesh
    from flash_attention_from_scratch_tpu_torch.parallel.pipeline import PIPELINE_AXIS

    mesh = make_axis_mesh(PIPELINE_AXIS, world, device=PARALLEL_DEVICE,
                          backend=PARALLEL_BACKEND)
    return {**_pipe_run(mesh), "staged_bytes": mesh.staged_bytes}


def phase_pipeline(smi: str) -> dict:
    """GPipe over PIPE_WORLD gloo ranks on this card: Llama-3-8B's width at
    4 layers (one a stage), batch 4 x 2,049 tokens, 4 microbatches, one
    forward and backward of ``pipeline_loss_fn`` against ``loss_fn`` on one
    rank: every rank's loss within TRAIN_PARALLEL_GAP of the single rank's;
    the first-step gradients of the embedding and the LM head (every rank
    its own) and of the first and last layer's wq (their stage's rank)
    within TRAIN_PARALLEL_GRAD_GAP of the single rank's norm, in norm and in
    random-sign projection (``train_parallel``'s rule); each rank's K1/K3
    launches its ``launch_plan``'s. The bubble: a rank idles PIPE_WORLD - 1
    of the PIPE_MICRO + PIPE_WORLD - 1 steps, its launches the plan's."""
    from flash_attention_from_scratch_tpu_torch.parallel.pipeline import launch_plan

    single = _pipe_run()
    torch.cuda.empty_cache()
    ranks = _spawn(pipe_rank, PIPE_WORLD)
    plan = dict(launch_plan(PIPE_LAYERS, PIPE_WORLD, PIPE_MICRO))
    worst = {}
    for rank, r in enumerate(ranks):
        _rank_line("pipeline", rank, PIPE_WORLD, r["staged_bytes"], r["counts"],
                   loss=r["loss"], step_s=r["s"], peak_gb=r["peak_gb"])
        for name, got in r["grads"].items():
            want = single["grads"][name]
            norm = math.sqrt(want["sumsq"])
            gaps = (abs(math.sqrt(got["sumsq"]) - norm) / norm,
                    abs(got["proj"] - want["proj"]) / norm)
            worst[f"{rank}:{name}"] = max(gaps)
        gap = abs(r["loss"] - single["loss"])
        if (gap > TRAIN_PARALLEL_GAP or r["counts"] != plan
                or max(v for k, v in worst.items() if k.startswith(f"{rank}:"))
                > TRAIN_PARALLEL_GRAD_GAP):
            raise AssertionError(f"pipeline rank {rank}: loss {r['loss']} vs "
                                 f"{single['loss']}, launches {r['counts']} (plan {plan}), "
                                 f"gradient gaps {worst}")
    held = {name for r in ranks for name in r["grads"]}
    if held != set(PIPE_GRAD_LEAVES):
        raise AssertionError(f"pipeline: gradients held {held}")
    steps = PIPE_MICRO + PIPE_WORLD - 1
    line = {"model": "LLAMA3_8B", "layers": PIPE_LAYERS, "pp": PIPE_WORLD,
            "n_micro": PIPE_MICRO, "batch": PIPE_BATCH, "seq": TRAIN_PARALLEL_SEQ // 2,
            "single_loss": single["loss"], "single_s": single["s"],
            "single_peak_gb": single["peak_gb"], "loss": [r["loss"] for r in ranks],
            "grad_gap_worst": max(worst.values()), "grad_gaps": worst,
            "launch_plan": plan, "steps": steps, "idle_steps_a_rank": PIPE_WORLD - 1,
            "bubble_share": (PIPE_WORLD - 1) / steps, "step_s": [r["s"] for r in ranks],
            "staged_bytes": [r["staged_bytes"] for r in ranks],
            "peak_gb": [r["peak_gb"] for r in ranks], "backend": PARALLEL_BACKEND, "gpu": smi,
            "note": "gloo on one card: the stages time-share it, so the bubble shows as "
                    "launches against the plan, not as time"}
    print(json.dumps({"pipeline": line}), flush=True)
    return {"counts": [r["counts"] for r in ranks]}


def _tp_lora_run(mesh=None) -> dict:
    """Llama-3-8B at full width and TP_LORA's depth (seed 0) with 4 LoRA
    adapters (``_lora_stack``), on ``mesh`` (this rank's shards) or one
    rank: each prompt's prefill on its adapter, then TP_LORA new_tokens
    greedy decode steps of the whole batch, then one verify step of
    verify_t tokens per row (the last token and the next prompt tokens).
    Returns the tokens (token j of a request picked from ``rows[j]``, the
    prefill's logits and then each decode step's), the verify logits, the
    launches and the staged bytes (CPU values)."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, init_params
    from flash_attention_from_scratch_tpu_torch.models import decode
    from flash_attention_from_scratch_tpu_torch.models.lora import shard_lora
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import shard_params

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=TP_LORA["layers"])
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    lora = _lora_stack(cfg, LORA_ADAPTERS)
    if mesh is not None:
        params, lora = shard_params(params, mesh), shard_lora(lora, mesh)
        torch.cuda.empty_cache()
    lens = TP_LORA["prompt_lens"]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    per_seq = -(-(max(lens) + TP_LORA["new_tokens"] + TP_LORA["verify_t"]) // SERVE_PAGE_SIZE)
    cache = decode.init_cache(cfg, len(lens) * per_seq, SERVE_PAGE_SIZE, mesh=mesh)
    tables = torch.arange(len(lens) * per_seq, dtype=torch.int32,
                          device="cuda").view(len(lens), per_seq)
    ids = torch.tensor(TP_LORA["adapters"], device="cuda")
    _build.launch_counts.clear()
    t0 = time.perf_counter()
    with torch.no_grad():
        first = []
        for i, p in enumerate(prompts):
            arr = torch.zeros((1, _padded(len(p))), dtype=torch.long, device="cuda")
            arr[0, :len(p)] = torch.tensor(p, device="cuda")
            logits, cache = decode.prefill(params, arr, cfg, cache, tables[i],
                                           prompt_len=len(p), lora=lora,
                                           adapter_ids=ids[i:i + 1], mesh=mesh)
            first.append(logits)
        first = torch.stack(first)
        tokens = first.argmax(-1)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out, rows = [tokens.tolist()], [first.float().cpu()]
        for _ in range(TP_LORA["new_tokens"]):
            lengths = lengths + 1
            logits, cache = decode.decode_step(params, tokens, cfg, cache, lengths, tables,
                                               lora=lora, adapter_ids=ids, mesh=mesh)
            tokens = logits.argmax(-1)
            rows.append(logits.float().cpu())
            out.append(tokens.tolist())
        t = TP_LORA["verify_t"]
        draft = torch.tensor([p[:t - 1] for p in prompts], device="cuda")
        vtok = torch.cat([tokens[:, None], draft], dim=1)
        verify, cache = decode.verify_step(params, vtok, cfg, cache, lengths + t, tables,
                                           lora=lora, adapter_ids=ids, mesh=mesh)
    sync()
    return {"tokens": [list(r) for r in zip(*out)], "rows": rows,
            "verify": verify.float().cpu(), "counts": dict(_build.launch_counts),
            "s": time.perf_counter() - t0,
            "staged_bytes": 0 if mesh is None else mesh.staged_bytes}


def serve_tp_lora_rank(rank, world):
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import make_mesh

    return _tp_lora_run(make_mesh(1, world, device=PARALLEL_DEVICE, backend=PARALLEL_BACKEND))


def phase_serve_tp_lora(smi: str) -> dict:
    """LoRA under tp 2 on gloo ranks on this card: Llama-3-8B at full width
    and 4 layers with ``serve_lora``'s adapters (4 of rank 16, B non-zero,
    scaled 0.3), 4 prompts of 200-1,000 tokens on adapters -1, 0, 1, 2:
    prefill, 16 greedy decode steps and one 4-token verify step (K4's
    multi-token q) through the model functions (the server refuses LoRA
    with a mesh, as JAX's). Both ranks pick the same tokens and compute the
    same verify logits; against the same steps on one rank a request's
    tokens may differ only where the tp token is a near-tie, within TP_SLACK
    of the single rank's row max at the first difference; where a request's
    tokens agree, its verify rows' argmaxes agree or are such near-ties.
    Each rank's launches: K1 per layer and prompt, K4/K5 (and its merge) per
    layer and step, K4's multi-token entry per layer."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        KERNEL as KP, KERNEL_MERGE, KERNEL_MULTI)

    single = _tp_lora_run()
    torch.cuda.empty_cache()
    ranks = _spawn(serve_tp_lora_rank, 2)
    layers, n = TP_LORA["layers"], len(TP_LORA["prompt_lens"])
    for rank, r in enumerate(ranks):
        _rank_line("serve_tp_lora", rank, 2, r["staged_bytes"], r["counts"], s=r["s"])
        c = r["counts"]
        plan_ok = (c.get(K1) == layers * n and c.get(KP) == layers * TP_LORA["new_tokens"]
                   and c.get(KERNEL_MULTI) == layers
                   and c.get(KERNEL_MERGE, 0) <= c[KP] + c[KERNEL_MULTI])
        if not plan_ok:
            raise AssertionError(f"serve_tp_lora rank {rank}: launches {c}")
    if ranks[0]["tokens"] != ranks[1]["tokens"] or not torch.equal(ranks[0]["verify"],
                                                                   ranks[1]["verify"]):
        raise AssertionError("serve_tp_lora: the ranks computed different tokens or logits")
    got, want = ranks[0]["tokens"], single["tokens"]
    firsts = {}
    for i in range(n):
        j = next((k for k, (a, b) in enumerate(zip(got[i], want[i])) if a != b), None)
        if j is None:
            vt, vs = ranks[0]["verify"][i], single["verify"][i]
            for row in range(vt.shape[0]):
                a = int(vt[row].argmax())
                gap = float(vs[row].max() - vs[row][a])
                if gap > TP_SLACK:
                    raise AssertionError(f"serve_tp_lora request {i}: verify row {row} "
                                         f"picks a token {gap} below the single rank's max")
            continue
        row = single["rows"][j][i]
        gap = float(row.max() - row[got[i][j]])
        firsts[i] = {"first_difference": j, "gap": gap}
        if gap > TP_SLACK:
            raise AssertionError(f"serve_tp_lora request {i}: token {j} differs from the "
                                 f"single rank's and sits {gap} below its row max")
    line = {"model": "LLAMA3_8B", "layers": layers, "tp": 2, "adapters": TP_LORA["adapters"],
            "lora_rank": LORA_RANK, "prompt_lens": TP_LORA["prompt_lens"],
            "new_tokens": TP_LORA["new_tokens"], "verify_t": TP_LORA["verify_t"],
            "equal_to_single_rank": sum(got[i] == want[i] for i in range(n)),
            "first_differences": firsts, "s": [r["s"] for r in ranks], "single_s": single["s"],
            "staged_bytes": [r["staged_bytes"] for r in ranks], "launches": ranks[0]["counts"],
            "backend": PARALLEL_BACKEND, "gpu": smi,
            "note": "eager under a mesh, gloo on one card: not a tp speed"}
    print(json.dumps({"serve_tp_lora": line}), flush=True)
    return {"counts": [r["counts"] for r in ranks]}


SCALING_TPS = (1, 2, 4)
SCALING_BAND = (0.45, 0.56)  # tp 2's byte ratio (tests/test_scaling_report.py); / 2 at tp 4


def phase_scaling_report(smi: str, single_chip_ms: float) -> dict:
    """``tools/scaling_report.py`` as a user runs it, in its own process:
    Llama-3-8B, W8A8 weights (K8 on every shard), int8 KV, tp 1, 2 and 4
    as gloo ranks on this card, the projection anchored on this run's
    ``bench_decode`` int8 step (``single_chip_ms``). Every row executed;
    the byte ratio at tp 2 within SCALING_BAND, at tp 4 within half of it;
    the collectives ``collective_plan``'s; rank 0's launches K8 7 x layers
    + 1 and K4/K5 once a layer."""
    import subprocess

    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS
    from flash_attention_from_scratch_tpu_torch.tools.scaling_report import collective_plan

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "flash_attention_from_scratch_tpu_torch.tools.scaling_report",
           "--model", "8b", "--weights", "int8", "--kv", "int8",
           "--tps", ",".join(map(str, SCALING_TPS)), "--single-chip-ms", repr(single_chip_ms),
           "--device", PARALLEL_DEVICE, "--backend", PARALLEL_BACKEND]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900)
    took = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"scaling_report exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    rows = [json.loads(x) for x in proc.stdout.strip().splitlines()[-len(SCALING_TPS):]]
    k8 = KERNELS[("int8", True)]
    layers = LLAMA3_8B.n_layers
    for row in rows:
        tp = row["tp"]
        lo, hi = (b * 2 / tp for b in SCALING_BAND) if tp > 1 else (1.0, 1.0)
        c = row["launches"]
        if (not row["executed"] or not lo <= row["byte_ratio_vs_tp1"] <= hi
                or row["collectives"] != collective_plan(LLAMA3_8B, tp)
                or c.get(k8) != 7 * layers + 1 or c.get(KP) != layers):
            raise AssertionError(f"scaling_report tp {tp}: {row}")
    print(json.dumps({"scaling_report": {
        "rows": rows, "process_s": took, "single_chip_ms": single_chip_ms,
        "backend": PARALLEL_BACKEND, "gpu": smi,
        "note": "bytes and collectives counted on one card's gloo ranks; the projected "
                "columns are a projection on NVLink 4's published 450 GB/s a direction "
                "(a spec sheet figure), not a measurement"}}), flush=True)
    return {"counts": [row["launches"] for row in rows], "tps": [row["tp"] for row in rows]}


def phase_dryrun(smi: str) -> list:
    """``entry.dryrun_multichip(4, device="cuda", backend="gloo")``, one
    spawn: the dp x tp train step, the sink + window step, tp prefill and
    decode, the ring, the ep MoE loss and the pp pipeline loss, every
    assert of the JAX dry run."""
    from flash_attention_from_scratch_tpu_torch.entry import dryrun_multichip

    torch.cuda.empty_cache()
    t = time.perf_counter()
    lines = dryrun_multichip(DRYRUN_RANKS, device="cuda", backend=PARALLEL_BACKEND)
    if len(lines) != 6:
        raise AssertionError(f"dryrun_multichip printed {lines}")
    print(json.dumps({"dryrun": {"ranks": DRYRUN_RANKS, "lines": lines,
                                 "s": time.perf_counter() - t, "backend": PARALLEL_BACKEND,
                                 "gpu": smi}}), flush=True)
    return lines


def _parallel_fields(names, ring=None, train=None, serve=None, **phases) -> dict:
    """Each rank's launches of the kernels ``names`` in the parallel phases,
    for the kernels line: the ring phase (its four cases), train_parallel
    (by mesh) and serve_tp (by run); each of ``phases`` (a name and its
    per-rank counts, or per-row for the scaling report) as
    ``launches_parallel_<name>``."""
    def total(c):
        return sum(c.get(n, 0) for n in names)

    out = {f"launches_parallel_{k}": [total(c) for c in v] for k, v in phases.items()}
    if ring:
        out["launches_parallel_ring"] = [sum(total(c) for c in rank.values())
                                         for rank in ring["counts"]]
    if train:
        out["launches_parallel_train"] = {k: [total(c) for c in v] for k, v in train.items()}
    if serve:
        out["launches_parallel_serve_tp"] = {k: [total(c) for c in v]
                                             for k, v in serve["counts"].items()}
    return out


# ---------------------------------------------------------------------------
# fp16 on the card: every kernel from its fp16 library (the same sources
# built with FA_F16: csrc/*_f16.cu), and the serving and training paths in
# fp16 (LlamaConfig.dtype FP16). fp32: the section after this one.

FP16 = torch.float16
# K1's and K11's fp16 cases: (label, d, heads, kv_heads, seq_q, seq_kv,
# KernelConfig fields, sinks), b 1; every case with its LSE.
FP16_FLASH_CASES = (
    ("d128 causal q_offset 512 s512/1024", D, HEADS, KV_HEADS, 512, 1024,
     dict(causal=True, q_offset=512), False),
    ("d128 window 512 s2048", D, HEADS, KV_HEADS, 2048, 2048,
     dict(causal=True, window=512), False),
    ("d128 softcap 50 s1024", D, HEADS, KV_HEADS, 1024, 1024,
     dict(causal=True, attn_softcap=50.0), False),
    ("d128 sinks s1024", D, HEADS, KV_HEADS, 1024, 1024, dict(causal=True), True),
    ("d128 full s2048", D, HEADS, KV_HEADS, 2048, 2048, {}, False),
    ("d256 causal q_offset 512 s512/1024", G9_D, G9_HEADS, G9_KV_HEADS, 512, 1024,
     dict(causal=True, q_offset=512), False),
    ("d256 window 512 softcap 50 s2048", G9_D, G9_HEADS, G9_KV_HEADS, 2048, 2048,
     dict(causal=True, window=512, attn_softcap=G9_SOFTCAP), False),
    ("d256 sinks s1024", G9_D, G9_HEADS, G9_KV_HEADS, 1024, 1024, dict(causal=True), True),
    ("d256 full s1024", G9_D, G9_HEADS, G9_KV_HEADS, 1024, 1024, {}, False),
)
# K4/K5's fp16 cases: page sizes per store (64: the chunk walk; 1 and 12,
# int4 2 and 12: the gather walk) on pools of ANY_PAGE_LENGTHS.
FP16_PAGE_SIZES = {"dense": (64, 1, 12), "int8": (64, 1, 12), "fp8": (64, 1, 12),
                   "int4": (64, 2, 12)}
# K6-K9's fp16 cases: aligned (K, N) of Llama-3-8B and the ragged ones of
# the any-shape phase (N % 16 = 2; K % 8 = 4), at m 1, 16 and 1,024.
FP16_QMM_SHAPES = ((4096, 4096), (14336, 4096), (4096, 14336), (4096, OPENHERMES_VOCAB),
                   (4004, 4100))
FP16_QMM_ROWS = (1, 16, 1024)


def _typed_flash_cases(dtype) -> dict:
    """K1 and K11 at depths 1-4 in ``dtype`` against the plain version, by
    the rule in each (batch, head, 64-row band), every call on NaN-poisoned
    memory, its output in ``dtype``, one launch of the kernel a call. fp16
    (FP16_FLASH_CASES): against the plain version in fp16 and in fp32 with
    fp16's eps, the LSE within 1e-3 of the fp32 one. fp32
    (FP32_FLASH_CASES): ``utils/testing.py::fp32_tolerance_check``, the
    kernel's error from the exact answer (the plain version in fp64) at most
    twice the plain fp32 version's, fp32's floors, the LSE within 1e-4 of
    the plain fp32 one; each call's err/bound by the floors alone against
    the plain fp32 version beside it, and the exact answer's. Returns
    {kernel name: (max |kernel - plain|, worst err/bound)} (fp32: and
    "floors", {"kernel", "exact"}: the worst of those)."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig, KVLoop
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL, KERNEL_FORI, flash_forward_plain, flash_forward_with_lse)

    fp32 = dtype == FP32
    cases, lse_tol = (FP32_FLASH_CASES, 1e-4) if fp32 else (FP16_FLASH_CASES, 1e-3)
    loops = {KERNEL: {}, **{f"{KERNEL_FORI} nb{n}": dict(kv_loop=KVLoop.FORI,
                                                         num_kv_buffers=n)
                            for n in FORI_DEPTHS}}
    worst = {KERNEL: (0.0, 0.0), KERNEL_FORI: (0.0, 0.0)}
    floors = {"kernel": 0.0, "exact": 0.0}
    for i, (name, d, heads, kvh, sq, skv, kw, with_sinks) in enumerate(cases):
        q, k, v = _cuda_qkv(sq, skv, seed=700 + i, heads=heads, kv_heads=kvh, d=d, dtype=dtype)
        sinks = (torch.from_numpy(np.random.default_rng(710 + i).standard_normal(
            heads).astype(np.float32) * 2).cuda() if with_sinks else None)
        base = KernelConfig(d_head=d, dtype=DType.from_torch(dtype), **kw)
        ref32, lse32 = flash_forward_plain(q.float(), k.float(), v.float(), _fp32(base), sinks)
        if fp32:  # the exact answer, and the plain fp32 version's error from it
            native = _exact_by_heads(q, k, v, base, sinks).float()
            floors["exact"] = max(floors["exact"], _floors_ratio(native, ref32))
        else:
            native = flash_forward_plain(q, k, v, base, sinks)[0]
        for label, loop in loops.items():
            cfg = dataclasses.replace(base, **loop)
            kernel = KERNEL_FORI if cfg.kv_loop == KVLoop.FORI else KERNEL
            _poison_free_memory()
            before = _build.launch_counts[kernel]
            out, lse = flash_forward_with_lse(q, k, v, cfg, sinks=sinks)
            sync()
            launched = _build.launch_counts[kernel] - before
            lse_err = float((lse - lse32).abs().max())
            note = f", lse err {lse_err:.3e}"
            if fp32:
                floor = _floors_ratio(out, ref32)
                floors["kernel"] = max(floors["kernel"], floor)
                note += f", against the plain fp32 version by the floors alone {floor:.3f}"
            got = _hold(f"{_dname(dtype)} {label} {name}", out, native, ref32, launched,
                        good=lse_err <= lse_tol and out.dtype == dtype, note=note,
                        plain=ref32 if fp32 else None)
            worst[kernel] = tuple(map(max, worst[kernel], got))
        del q, k, v, native, ref32
    if fp32:
        print(f"fp32 cases: by the floors alone against the plain fp32 version, the kernels' "
              f"worst err/bound {floors['kernel']:.3f}, the exact answer's "
              f"{floors['exact']:.3f}", flush=True)
        worst["floors"] = floors
    return worst


def _fp16_paged_cases() -> tuple[float, float, int]:
    """K4/K5 with fp16 q on every store (dense fp16 pages, int8, fp8, int4
    and int8 compute), t 1 and 4, d 128 (32/8 heads) and 256 (16/8), at
    FP16_PAGE_SIZES (the chunk walk and the gather walk), plain and with a
    window of 100 and a softcap of 20, on NaN-poisoned memory: the rule of
    ``_hold_paged`` per (sequence, token) against the plain version with
    fp16 q; fp16 out; one launch. Returns (max |kernel - plain|, worst
    err/bound, calls)."""
    from flash_attention_from_scratch_tpu_torch.utils.testing import sliced_tolerance_check

    def by_token(x):
        return x.transpose(1, 2) if x.ndim == 4 else x[:, None]

    err_max = ratio_max = 0.0
    calls = 0
    lengths = ANY_PAGE_LENGTHS
    for d, heads in ((D, HEADS), (G9_D, G9_HEADS)):
        for store in ("dense", "int8", "fp8", "int4", "int8c"):
            i8c = store == "int8c"
            pages = "int8" if i8c else store
            for ps in FP16_PAGE_SIZES[pages]:
                k, v, lens, tables, kw0 = _any_page_pool(lengths, ps, pages, d, seed=ps + d + 7)
                if pages == "dense":
                    k, v = k.to(FP16), v.to(FP16)
                worst = 0.0
                for t in (1, 4):
                    q = torch.randn((len(lengths), heads) + ((t,) if t > 1 else ()) + (d,),
                                    device="cuda").to(FP16)
                    for kw_name, kw in (("plain", {}),
                                        ("window 100 softcap 20", dict(window=100,
                                                                       softcap=20.0))):
                        kw = dict(kw0, scale=d ** -0.5, **kw)
                        native, ref32 = _paged_refs(q, k, v, lens, tables, i8c, kw)
                        sync()
                        _poison_free_memory(64)
                        out, launched = _paged_kernel(q, k, v, lens, tables, i8c, kw)
                        ok, ratio, where = sliced_tolerance_check(
                            by_token(out), by_token(native), by_token(ref32), lead=2)
                        err = float((out.float() - native.float()).abs().max())
                        good = (ok and launched == 1 and out.dtype == FP16
                                and bool(torch.isfinite(out).all())
                                and float(out[lengths.index(0)].abs().max()) == 0.0)
                        if not good:
                            raise AssertionError(
                                f"fp16 paged_decode_attention {store} page {ps} d {d} t {t} "
                                f"{kw_name}: err/bound {ratio} at (length, token) "
                                f"({lengths[where[0]]}, {where[1]}), {launched} launches, "
                                f"out {out.dtype}: disagrees with its plain version")
                        err_max, worst = max(err_max, err), max(worst, ratio)
                        calls += 1
                ratio_max = max(ratio_max, worst)
                print(f"fp16 paged_decode_attention {store} page {ps} d {d}: t 1 and 4, "
                      f"plain / window and softcap: worst err/bound {worst:.3f} ok", flush=True)
                del k, v, lens, tables, kw0
    return err_max, ratio_max, calls


def _fp16_qmm_cases() -> dict:
    """K6-K9 with fp16 x at FP16_QMM_SHAPES and FP16_QMM_ROWS, on NaN-
    poisoned memory: K6/K7 by ``_check_qmm``'s rule (fp16's eps) in each
    64-row band, K8/K9 equal to their plain versions bit for bit and
    ``quantize_rows`` on fp16 rows to the plain quantization; fp16 out, one
    launch a call. Returns {kernel: {"max_abs_err", "worst_err_bound",
    "cases"}}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        KERNELS, quant_matmul, quant_matmul_plain)

    gen = torch.Generator(device="cuda").manual_seed(43)
    result = {}
    for mode, act_quant in QMM_RECIPES:
        name = KERNELS[(mode, act_quant)]
        err_max = ratio_max = 0.0
        cases = 0
        for k, n in FP16_QMM_SHAPES:
            wq = _random_qweight(k, n, mode, act_quant, gen, FP16)
            for m in FP16_QMM_ROWS:
                x = torch.randn(m, k, generator=gen, device="cuda").to(FP16)
                if act_quant:
                    _check_quantize_rows(x)
                sync()
                _poison_free_memory()
                before = _build.launch_counts[name]
                got = quant_matmul(x, wq, act_quant=act_quant)
                sync()
                launched = _build.launch_counts[name] - before
                ok, ratio, _, err = _check_qmm(got, x, wq, act_quant)
                if act_quant:
                    ok = ok and torch.equal(got, quant_matmul_plain(x, wq, True))
                ok = ok and launched == 1 and got.dtype == FP16 and got.shape == (m, n)
                if not ok:
                    raise AssertionError(f"fp16 {name} m {m} K {k} N {n}: err/bound {ratio}, "
                                         f"launches {launched}, out {got.dtype}: disagrees "
                                         "with its plain version")
                err_max, ratio_max = max(err_max, err), max(ratio_max, ratio)
                cases += 1
                del x, got
            del wq
        result[name] = {"max_abs_err": err_max, "worst_err_bound": ratio_max, "cases": cases}
        print(f"fp16 {name}: {cases} cases, max|kernel-plain| {err_max:.3e}, worst err/bound "
              f"{ratio_max:.3f}{' (bit-equal)' if act_quant else ''} ok", flush=True)
        torch.cuda.empty_cache()
    return result


def phase_fp16_cases() -> dict:
    """Each fp16 kernel against its plain version (``_typed_flash_cases``,
    ``_fp16_paged_cases``, ``_fp16_qmm_cases``; the types still refused are
    the ``cuda`` tests' ``test_types_without_a_kernel_raise``). Returns the
    worst errors per kernel."""
    t0 = time.perf_counter()
    line = {"flash": _typed_flash_cases(FP16), "paged": _fp16_paged_cases(),
            "qmm": _fp16_qmm_cases()}
    line["s"] = time.perf_counter() - t0
    print(json.dumps({"fp16_cases": line}), flush=True)
    return line


FP16_QUANT_LAYERS = 4
# The fp16 quantized runs: run A's recipe, run B's weights over fp8 KV, and
# (4 requests each) K8 over int4 KV and K7 over int8 KV with int8 compute,
# so that every fp16 kernel and page store serves.
FP16_QUANT_RUNS = {
    "A_fp16": dict(wmode="int8", act="bf16", kv="int8", requests=16),
    "B_fp16": dict(wmode="int4", act="int8", kv="fp8", requests=16),
    "C_fp16": dict(wmode="int8", act="int8", kv="int4", requests=4),
    "D_fp16": dict(wmode="int4", act="bf16", kv="int8", requests=4, attn_int8=True),
}


def phase_serve_fp16_quant(smi: str) -> dict:
    """fp16 activations over quantized weights and KV pages at full width,
    FP16_QUANT_LAYERS layers (FP16_QUANT_RUNS): run A's recipe (int8
    weights on K6, int8 KV) and run B's weights (W4A8 on K9,
    ``quantize_rows`` on fp16 rows) over fp8 KV, 16 requests of 1,024
    tokens, page 128; then W8A8 (K8) over int4 KV and int4 weights (K7)
    over int8 KV with int8 compute, 4 requests each; by ``_serve_quant``
    (run A's gates: launches, tokens, finite logits, two requests within
    QUANT_SLACK_STD row standard deviations of ``forward``, a replayed step
    equal to the eager one). Returns {run: ``_serve_quant``'s result}."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=FP16_QUANT_LAYERS, dtype=DType.FP16)
    rng = np.random.default_rng(0)
    out = {}
    for run, spec in FP16_QUANT_RUNS.items():
        prompts = {i: rng.integers(0, cfg.vocab_size, QUANT_PROMPT).tolist()
                   for i in range(spec["requests"])}
        out[run] = _serve_quant(run, "LLAMA3_8B fp16", cfg, dict(spec, layers=cfg.n_layers),
                                prompts, QUANT_PAGE, smi, [QUANT_PROMPT + 17] * spec["requests"])
        torch.cuda.empty_cache()
    return out


G9_FP16_LAYERS = 8
G9_FP16_PROMPT_LENS = (513, 2048, 3000, 5000)  # the last past the 4,096 window


def phase_serve_gemma2_9b_fp16(smi: str) -> dict:
    """Gemma-2-9B in fp16 at full width, its first G9_FP16_LAYERS layers
    (``serve_gemma2_9b``'s random weights, converted by ``from_hf_gemma2(...,
    dtype=torch.float16)``): 4 requests of G9_FP16_PROMPT_LENS (one past
    the window), 32 greedy tokens, page 64, every decode step a graph
    replay: K1 at d 256 (window and global layers, softcap 50) and K4/K5 at
    d 256, in fp16. Gates as ``serve_gemma2_9b``'s: weights and pages fp16,
    the launches, finite logits, every request teacher-forced within SLACK
    of the row max, fewer than half the tokens repeating their input.
    Returns {"counts"}."""
    import types

    from flash_attention_from_scratch_tpu_torch import GenerationServer, from_hf_gemma2
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP

    t0 = time.perf_counter()
    hf = dict(GEMMA2_9B_HF, num_hidden_layers=G9_FP16_LAYERS)
    # serve_gemma2_9b's embedding scale (a tenth) and final norm (~10) keep
    # the current token's own logit ~0.65 row std ahead at 42 layers, whose
    # 84 normed sublayer outputs set the residual's RMS (~sqrt(84)); at 8
    # layers (~sqrt(16)) the same weights put it ~1.5 ahead and most tokens
    # repeat their input. The embedding scaled by sqrt(16 / 84), and the
    # final norm by its inverse (the logits' unit spread), keep it ~0.65.
    depth = math.sqrt(G9_FP16_LAYERS / GEMMA2_9B_HF["num_hidden_layers"])
    sd = _gemma2_state_dict(hf, torch.Generator(device="cuda").manual_seed(0),
                            embed_std=0.1 * depth * hf["hidden_size"] ** -0.5,
                            final_norm=10.0 / depth - 1.0)
    model = types.SimpleNamespace(config=types.SimpleNamespace(**hf), state_dict=lambda: sd)
    params, cfg = from_hf_gemma2(model, dtype=FP16)
    del sd, model
    torch.cuda.empty_cache()
    per_seq = -(-(max(G9_FP16_PROMPT_LENS) + SERVE_NEW_TOKENS) // SERVE_PAGE_SIZE)
    need = sum(-(-(n + SERVE_NEW_TOKENS) // SERVE_PAGE_SIZE) for n in G9_FP16_PROMPT_LENS)
    server = GenerationServer(params, cfg, num_pages=need + 8, page_size=SERVE_PAGE_SIZE,
                              max_batch=len(G9_FP16_PROMPT_LENS), pages_per_seq=per_seq)
    dtypes = {p.dtype for p in param_leaves(params)} | {server.cache.k_pages[0].dtype}
    if dtypes != {FP16}:
        raise AssertionError(f"serve_gemma2_9b_fp16: weights and pages in {dtypes}")
    rng = np.random.default_rng(5)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(G9_FP16_PROMPT_LENS)}
    _warm_graphs(server, cfg.vocab_size, SERVE_NEW_TOKENS)
    served = _serve_run("serve_gemma2_9b_fp16", server, prompts, smi)
    run, tokens = served["run"], served["tokens"]
    want = _with_merges({K1: cfg.n_layers * len(prompts),
                         KP: cfg.n_layers * run["stats"]["decode_steps"]}, len(prompts),
                        per_seq, SERVE_PAGE_SIZE, kv_heads=cfg.n_kv_heads,
                        group=cfg.n_heads // cfg.n_kv_heads, d_head=cfg.d_head)
    if run["counts"] != want:
        raise AssertionError(f"serve_gemma2_9b_fp16: launches {run['counts']}, expected {want}")
    gaps = [float(_teacher_forced_gaps(params, cfg, prompts[sid], tokens[sid])[0].max())
            for sid in prompts]
    repeats = sum(t == ([prompts[sid][-1]] + tokens[sid])[i]
                  for sid in prompts for i, t in enumerate(tokens[sid]))
    print(f"serve_gemma2_9b_fp16: launches {run['counts']} ok; teacher-forced worst gap per "
          f"request {gaps} (limit {SLACK}); {repeats} of {len(prompts) * SERVE_NEW_TOKENS} "
          "tokens repeat their input", flush=True)
    if max(gaps) > SLACK or repeats * 2 > len(prompts) * SERVE_NEW_TOKENS:
        raise AssertionError("serve_gemma2_9b_fp16: served tokens off the full recompute, or "
                             "repeating their input")
    line = {"model": "Gemma-2-9B", "dtype": "fp16", "layers": cfg.n_layers,
            "d_head": cfg.d_head, "window_pattern": list(cfg.window_pattern),
            "softcaps": [cfg.attn_softcap, cfg.final_softcap],
            "prompt_lens": list(G9_FP16_PROMPT_LENS), **served["line"],
            "teacher_forced_worst_gap": max(gaps), "repeated_input_tokens": repeats,
            "peak_mem_gb": run["peak_mem_gb"], "launches": run["counts"],
            "s": time.perf_counter() - t0}
    print(json.dumps({"serve_gemma2_9b_fp16": line}), flush=True)
    del server, params
    torch.cuda.empty_cache()
    return {"counts": run["counts"]}


# bench_attention --dtype f16 on K1's and K11's d-128 forms (the grid and
# FORI rungs of the prog ladder, in fp16), causal, with the SDPA baseline;
# then the same with --grad (forward and backward through flash_attention:
# K3, the causal backward, from its fp16 library).
BENCH_F16_FORMS = "fa_f16_q128_kv128_d128_grid2_x2+os+cp;fa_f16_q128_kv128_d128_fori2_x2+os+cp"
BENCH_F16_ARGS = ("--dtype", "f16", "--kernels", BENCH_F16_FORMS, "--causal", "--seq-lens",
                  "2048,4096", "--baseline", "--json")


def phase_bench_attention_fp16(smi: str) -> dict:
    """``tools/bench_attention.py``'s ``main`` with ``--dtype f16``
    (BENCH_F16_ARGS), then with ``--grad`` too, the launch counts of each
    run set to 0 just before and read just after: a row of positive TFLOP/s
    for each form and SDPA's in each run; K1 and K11 launched in both, and
    K3's two kernels (the causal backward) in the ``--grad`` run. Returns
    {"forward", "grad": the launches}."""
    import contextlib
    import io

    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, KERNEL_FORI)

    out = {}
    for run, extra, kernels in (("forward", [], (K1, KERNEL_FORI)),
                                ("grad", ["--grad"], (K1, KERNEL_FORI, KERNEL_DKV, KERNEL_DQ))):
        torch.cuda.empty_cache()
        args = list(BENCH_F16_ARGS) + extra
        text = io.StringIO()
        t = time.perf_counter()
        _build.launch_counts.clear()  # counts start at 0 just before the run
        with contextlib.redirect_stdout(text):
            rc = bench_attention.main(args)
        counts = dict(_build.launch_counts)  # read just after
        rows = [json.loads(line) for line in text.getvalue().splitlines()
                if line.startswith("{")]
        print(json.dumps({"bench_attention": {"args": " ".join(args), "rows": rows,
                                              "launches": counts, "s": time.perf_counter() - t,
                                              "gpu": smi}}), flush=True)
        want = {f + "+ca" for f in BENCH_F16_FORMS.split(";")} | {"sdpa"}
        good = (rc == 0 and {r["config"] for r in rows} == want
                and all(r["harmonic_mean"] > 0 for r in rows)
                and all(counts.get(k, 0) > 0 for k in kernels))
        if not good:
            raise AssertionError(f"bench_attention {' '.join(args)}: rc {rc}, launches "
                                 f"{counts}, rows {rows}")
        out[run] = counts
    return out


# K2/K3 in fp16 against their plain version (phase_fp16_backward_cases), in
# BACKWARD_CASES' form: every mask (causal with a q_offset, a window, softcap
# 50, none), the banded backward's non-square past keys (1,024 rows over
# 2,048 keys, no mask), and at d 128 the training run's strided shape.
FP16_BACKWARD_CASES = (
    ("causal q_offset 512 s512/1024", 512, 1024, dict(causal=True, q_offset=512), {}),
    ("window 512 s2048", 2048, 2048, dict(causal=True, window=512), {}),
    ("softcap 50 s1024", 1024, 1024, dict(causal=True, attn_softcap=50.0), {}),
    ("full s1024", 1024, 1024, {}, {}),
    ("past keys s1024/2048", 1024, 2048, {}, {}),
)
FP16_BANDS = 2  # flash_backward(bands=) at b 1, 32/8 heads, s 2,048, causal


def phase_fp16_backward_cases() -> dict:
    """K2 and K3 in fp16 against their plain version in fp16 and in fp32
    (``_hold_backward_cases``: the rule per 64-row band with fp16's eps,
    reruns equal, one launch a call, fp16 gradients): FP16_BACKWARD_CASES
    and the training shape at d 128 (32/8 heads), FP16_BACKWARD_CASES at d
    256 (16/8 heads); then ``flash_backward(bands=FP16_BANDS)`` in fp16
    (2 * bands - 1 K2 calls) by the same rule against the plain backward.
    Returns {"d128", "d256": {mode: (max |kernel - plain|, worst
    err/bound)}, "banded": (max, worst), "launches": the banded call's}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_FUSED, flash_backward, flash_backward_plain)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward_with_lse)

    t0 = time.perf_counter()
    out = {"d128": _hold_backward_cases(FP16_BACKWARD_CASES + (TRAIN_CASE,), "fp16 ",
                                        dtype=FP16),
           "d256": _hold_backward_cases(FP16_BACKWARD_CASES, "fp16 d256 ", heads=G9_HEADS,
                                        kv_heads=G9_KV_HEADS, d=G9_D, dtype=FP16)}
    cfg = KernelConfig(causal=True, dtype=DType.FP16)
    q, k, v = _cuda_qkv(2048, 2048, seed=430, dtype=FP16)
    do = _cuda_normal(q.shape, seed=431, dtype=FP16)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    _build.launch_counts.clear()
    got = flash_backward(q, k, v, o, lse, do, cfg, bands=FP16_BANDS)
    sync()
    launches = dict(_build.launch_counts)
    if launches != {KERNEL_FUSED: 2 * FP16_BANDS - 1} or {g.dtype for g in got} != {FP16}:
        raise AssertionError(f"fp16 banded backward: launches {launches}, "
                             f"{[g.dtype for g in got]}")
    ref16 = flash_backward_plain(q, k, v, o, lse, do, cfg)
    ref32 = flash_backward_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                 do.float(), _fp32(cfg))
    out["banded"] = _check_grads(f"fp16 banded backward s2048 bands {FP16_BANDS}", got,
                                 ref16, ref32)
    out["launches"] = launches
    del q, k, v, do, o, lse, got, ref16, ref32
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(json.dumps({"fp16_backward_cases": out}), flush=True)
    return out


# K10 in fp16 (phase_fp16_quant_cases): (K/V mode, Q kind, int8_compute) of
# every variant: a dense fp16 Q over int8, fp8 and int4 K/V, an int8 and an
# fp8 Q (upcast), and int8 compute; every QTensor from fp16 tensors (its
# orig_dtype fp16, which the wrapper takes as the compute type).
FP16_QUANT_VARIANTS = {
    "int8kv": ("int8", "dense", False), "fp8kv": ("fp8", "dense", False),
    "int4kv": ("int4", "dense", False), "int8u": ("int8", "int8", False),
    "fp8": ("fp8", "fp8", False), "int8c": ("int8", "int8", True),
}


def _fp16_quant_inputs(variant, seq, seed, batch, heads=HEADS, kv_heads=KV_HEADS, d=D):
    """Seeded fp16 Q, K, V as ``variant`` of FP16_QUANT_VARIANTS gives them."""
    from flash_attention_from_scratch_tpu_torch.ops.quant import quantize_kv

    kv_mode, q_kind, _ = FP16_QUANT_VARIANTS[variant]
    q, k, v = _cuda_qkv(seq, seq, seed, batch=batch, heads=heads, kv_heads=kv_heads, d=d,
                        dtype=FP16)
    qq = q if q_kind == "dense" else quantize_kv(q, q_kind)
    return qq, quantize_kv(k, kv_mode), quantize_kv(v, kv_mode)


def phase_fp16_quant_cases() -> dict:
    """K10 in fp16, every variant of FP16_QUANT_VARIANTS, against its plain
    version in fp16 and reference attention in fp32 (``_flash_quant_case``:
    the rule per 64-row band with fp16's eps, one launch, fp16 out with Q's
    strides): at d 128 (b 2, 32/8 heads, s 1,024) full and causal, with a
    window of 300 and, but for int8c, softcap 50; at d 256 (b 1, 16/8 heads,
    s 2,048) causal, with the 4,096 window over s 5,120 and, but for int8c,
    softcap 50. The launch counts are set to 0 before the cases and read
    after them. Then a quantized Q of fp32 ``orig_dtype`` must raise
    ValueError naming item 4c. Returns {"d128", "d256": (max |kernel -
    plain|, worst err/bound), "launches", "calls"}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
        KERNEL, flash_forward_quantized)
    from flash_attention_from_scratch_tpu_torch.ops.quant import quantize_kv

    t0 = time.perf_counter()
    cases = []
    for variant, (_, _, i8c) in FP16_QUANT_VARIANTS.items():
        cap = {} if i8c else dict(attn_softcap=50.0)
        cases += [("d128", variant, 1024, 2, dict(causal=False), {}),
                  ("d128", variant, 1024, 2, dict(causal=True), {}),
                  ("d128", variant, 1024, 2, dict(causal=True, window=300, **cap), {}),
                  ("d256", variant, 2048, 1, dict(causal=True),
                   dict(heads=G9_HEADS, kv_heads=G9_KV_HEADS, d=G9_D)),
                  ("d256", variant, 5120, 1, dict(causal=True, window=G9_WINDOW, **cap),
                   dict(heads=G9_HEADS, kv_heads=G9_KV_HEADS, d=G9_D))]
    out = {"d128": (0.0, 0.0), "d256": (0.0, 0.0)}
    _build.launch_counts.clear()  # counts start at 0 just before the cases
    for i, (width, variant, seq, batch, kw, widths) in enumerate(cases):
        qq, kq, vq = _fp16_quant_inputs(variant, seq, seed=600 + i, batch=batch, **widths)
        cfg = KernelConfig(d_head=widths.get("d", D), dtype=DType.FP16, **kw)
        got = _flash_quant_case(f"fp16 {width} {variant} s{seq} {kw}", qq, kq, vq, cfg,
                                FP16_QUANT_VARIANTS[variant][2])
        out[width] = tuple(map(max, out[width], got))
        del qq, kq, vq
    out["launches"] = dict(_build.launch_counts)  # read just after
    out["calls"] = len(cases)
    if out["launches"] != {KERNEL: len(cases)}:
        raise AssertionError(f"fp16 K10 cases: launches {out['launches']} for {len(cases)} "
                             "calls")
    x = torch.zeros(1, 2, 128, D, device="cuda")
    try:
        flash_forward_quantized(quantize_kv(x, "int8"), quantize_kv(x.half(), "int8"),
                                quantize_kv(x.half(), "int8"))
    except ValueError as e:
        if "item 4c" not in str(e):
            raise
        print(f"flash_forward_quantized, Q of fp32 orig_dtype: refused ({e}) ok", flush=True)
    else:
        raise AssertionError("a quantized Q of fp32 orig_dtype ran on the card")
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(json.dumps({"fp16_quant_cases": out}), flush=True)
    return out


def time_typed_fori(d: int, dtype=torch.float16) -> dict:
    """K11 at depth 2 and head width ``d`` in ``dtype`` (fp16 or fp32) at
    the bf16 rows' shape (b 4, s 4096, 32/8 heads at d 128, 16/8 at d 256;
    full plus causal) beside the same calls in bf16 (``bf16_ms``), the
    library call in ``dtype`` (``_library_attention``) and the plain version
    one batch element at a time; the bound at the type's rate
    (``_peak_ops``)."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig, KVLoop
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward, flash_forward_plain)

    heads, kv_heads = (HEADS, KV_HEADS) if d == D else (G9_HEADS, G9_KV_HEADS)
    out = {"ms": 0.0, "bf16_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for typ in (dtype, torch.bfloat16):
        q, k, v = _timing_qkv(PERF_SEQ, PERF_SEQ, seed=290, batch=PERF_BATCH, dtype=typ,
                              heads=heads, kv_heads=kv_heads, d=d)
        for causal in (False, True):
            cfg = KernelConfig(d_head=d, causal=causal, dtype=DType.from_torch(typ),
                               kv_loop=KVLoop.FORI, num_kv_buffers=2)
            ms = _time_ms(lambda: flash_forward(q, k, v, cfg))
            if typ != dtype:
                out["bf16_ms"] += ms
                continue
            out["ms"] += ms
            out["library_ms"] += _time_ms(_library_attention(q, k, v, causal))
            out["plain_ms"] += _time_ms(lambda: _per_batch(
                lambda *x: flash_forward_plain(*x, cfg)[0], q, k, v), iters=1, warmup=1)
            ops = _attn_ops(PERF_SEQ, heads, PERF_BATCH, causal, d=d)
            nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
            out["bound_ms"] += 1e3 * max(ops / _peak_ops(typ), nbytes / PEAK_BYTES_PER_S)
        del q, k, v
    return {**out, "bound_by": "operations",
            "shape": f"num_kv_buffers 2, non-causal + causal: b {PERF_BATCH}, "
                     f"{heads}/{kv_heads} heads, s {PERF_SEQ}, d {d}, {_dname(dtype)} "
                     "(bf16_ms: the same calls in bf16)"}


def time_fp16_backward(d: int) -> tuple[dict, dict]:
    """K2 and K3 in fp16 at the bf16 top rows' shape: d 128, the training
    layer (causal, b 2, 32/8 heads, s 2,048); d 256, Gemma-2-9B's global
    layer (causal, b 1, 16/8 heads, s 8,192, softcap 50): the whole
    ``flash_backward`` call and its kernels' launch alone (D computed
    beforehand), by CUDA events, beside the bound (the bf16 rows': same
    products, same bytes), SDPA's backward in fp16 (causal, no softcap, K/V
    repeated) and the plain version in fp16 (one KV head at a time at d
    256). Returns (K2's, K3's)."""
    from flash_attention_from_scratch_tpu_torch.ops import flash_backward as fb
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward_with_lse)

    if d == D:
        b, s, heads, kvh, extra = TRAIN_BATCH, TRAIN_SEQ, HEADS, KV_HEADS, {}
        plain, what = fb.flash_backward_plain, "one layer of train_fp16"
    else:
        b, s, heads, kvh, extra = 1, G9_TRAIN_SEQ, G9_HEADS, G9_KV_HEADS, dict(
            attn_softcap=G9_SOFTCAP)
        plain, what = _plain_backward_by_heads, ("one global layer of train_gemma2_9b_fp16; "
                                                 "plain: one KV head at a time")
    cfg = KernelConfig(d_head=d, causal=True, dtype=DType.FP16, **extra)
    q, k, v = _timing_qkv(s, s, seed=95, batch=b, heads=heads, kv_heads=kvh, d=d, dtype=FP16)
    do = _timing_normal(q.shape, seed=98, dtype=FP16)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    dsum = fb._row_sums(o, do)
    flops = 5 * _attn_ops(s, heads, b, True, 0, d) // 2
    nbytes = 2 * (4 * b * heads * s * d + 4 * b * kvh * s * d) + 4 * b * heads * s
    common = {"plain_ms": _time_ms(lambda: plain(q, k, v, o, lse, do, cfg), iters=2, warmup=1),
              "library_ms": _sdpa_backward_ms(q, k, v, do),
              "bound_ms": 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S),
              "bound_by": "operations",
              "shape": f"causal, b {b}, {heads}/{kvh} heads, s {s}, d {d}"
                       + (f", softcap {G9_SOFTCAP:g}" if extra else "")
                       + f", fp16 ({what}); library: SDPA's fp16 backward, causal, no softcap"}
    out = []
    for fused in (True, False):
        ms = _time_ms(lambda: fb.flash_backward(q, k, v, o, lse, do, cfg, fused=fused))
        kernel_ms = _time_ms(lambda: fb._launch(q, k, v, lse, dsum, do, cfg,
                                                cfg.softmax_scale, fused))
        out.append({"ms": ms, **common, "kernel_ms": kernel_ms,
                    "bound_share": common["bound_ms"] / ms, "tflops": flops / ms / 1e9})
    del q, k, v, do, o, lse, dsum
    torch.cuda.empty_cache()
    return out[0], out[1]


def time_fp16_quant(d: int) -> dict:
    """K10 in fp16 per variant of FP16_QUANT_VARIANTS, non-causal, at the
    bf16 rows' shape (b 4, s 4,096; 32/8 heads at d 128, 16/8 at d 256):
    time, bound (the bf16 rows': the products at 989 TFLOP/s, int8c's at
    1979 TOP/s, or the bytes), the plain version and SDPA in fp16 on the
    dequantized tensors. Top-level numbers are sums over the variants."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
        flash_forward_quantized, flash_forward_quantized_plain)
    from flash_attention_from_scratch_tpu_torch.ops.quant import quantize_kv

    heads, kvh = (HEADS, KV_HEADS) if d == D else (G9_HEADS, G9_KV_HEADS)
    cfg = KernelConfig(d_head=d, dtype=DType.FP16)
    ops = _attn_ops(PERF_SEQ, heads, PERF_BATCH, causal=False, d=d)
    q, k, v = _timing_qkv(PERF_SEQ, PERF_SEQ, seed=380, batch=PERF_BATCH, heads=heads,
                          kv_heads=kvh, d=d, dtype=FP16)
    by_variant = {}
    for variant, (kv_mode, q_kind, i8c) in FP16_QUANT_VARIANTS.items():
        qq = q if q_kind == "dense" else quantize_kv(q, q_kind)
        kq, vq = quantize_kv(k, kv_mode), quantize_kv(v, kv_mode)
        out = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c)
        ms = _time_ms(lambda: flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c))
        plain_ms = _time_ms(lambda: flash_forward_quantized_plain(
            qq, kq, vq, cfg, scale=cfg.softmax_scale, int8_compute=i8c), iters=1, warmup=1)
        dq, dk, dv = (_dequantized(x, FP16) for x in (qq, kq, vq))
        lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            dq, dk, dv, enable_gqa=True))
        bound_o = ops / (PEAK_INT8_OPS if i8c else PEAK_BF16_FLOPS)
        bound_b = _attn_bytes(qq, kq, vq, out) / PEAK_BYTES_PER_S
        by_variant[variant] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": 1e3 * max(bound_o, bound_b),
            "bound_by": "operations" if bound_o >= bound_b else "bytes",
            "product_tflops": ops / ms / 1e9}
        del qq, kq, vq, out, dq, dk, dv
    del q, k, v
    torch.cuda.empty_cache()
    total = {key: sum(r[key] for r in by_variant.values())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {**total, "bound_by": "operations", "by_variant": by_variant,
            "shape": f"sum over the variants {list(FP16_QUANT_VARIANTS)}: non-causal, "
                     f"b {PERF_BATCH}, {heads}/{kvh} heads, s {PERF_SEQ}, d {d}, fp16; "
                     "library: SDPA in fp16 on the dequantized tensors"}


def fp16_training_entries(bf16: dict, bwd: dict, quant: dict, trained: dict,
                          trained9: dict, bench_grad: dict, logs: dict) -> list:
    """The fp16 entries of K2, K3 and K10 in the ``kernels`` line: launches
    on their fp16 paths (``train_fp16``'s and ``train_gemma2_9b_fp16``'s
    steps, ``bench_attention --dtype f16 --grad``, ``fp16_quant_cases``),
    the worst errors against the plain versions, and the times of
    ``time_fp16_backward`` / ``time_fp16_quant`` beside the bf16 entries'
    at the same shapes from this run (``bf16_ms``; ``bf16``: the entries by
    name)."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import KERNEL as KQ

    pkg = "flash_attention_from_scratch_tpu_torch/csrc/"
    tpu = "flash_attention_from_scratch_tpu/ops/"
    ptx = {d: _ptxas_by_kernel(logs.get(f"flash_backward{w}_f16.cu", ""))
           for d, w in ((D, ""), (G9_D, "_d256"))}
    (fused, split), (fused9, split9) = time_fp16_backward(D), time_fp16_backward(G9_D)

    def both(counts):
        return counts.get(KERNEL_DKV, 0) + counts.get(KERNEL_DQ, 0)

    def ptxas(d, mode):
        found = _kernel_ptxas(ptx[d], ("flash_backward_dkv_kernel", "flash_backward_dq_kernel"))
        return {n: v for n, v in found.items() if ("Lb1E" in n) == (mode == "fused")}

    def beside_variants(f16: dict, bf16_row: dict) -> dict:
        """Each fp16 variant's bf16 ms where the bf16 row times it, and both
        types' sums over those variants (the bf16 row has no fp8kv)."""
        same = [v for v in f16["by_variant"] if v in bf16_row["by_variant"]]
        for v in same:
            f16["by_variant"][v]["bf16_ms"] = bf16_row["by_variant"][v]["ms"]
        return {**f16, "bf16_ms": sum(bf16_row["by_variant"][v]["ms"] for v in same),
                "ms_same_variants": sum(f16["by_variant"][v]["ms"] for v in same)}

    q_err = tuple(map(max, quant["d128"], quant["d256"]))
    entries = [
        {"name": KERNEL_FUSED + "_f16", "route": "cuda", "source": pkg + "flash_backward_f16.cu",
         "replaces": tpu + "flash_backward.py:278", "counted_as": KERNEL_FUSED,
         "launches": trained["fused"].get(KERNEL_FUSED, 0),
         "launches_path": "train_fp16: one step with fused=True, 8 layers (Llama-3-8B in fp16)",
         "launches_fp16_backward_cases_banded": bwd["launches"].get(KERNEL_FUSED, 0),
         "max_abs_err": max(bwd["d128"]["fused"][0], bwd["banded"][0]),
         "worst_err_bound": max(bwd["d128"]["fused"][1], bwd["banded"][1]),
         **fused, "bf16_ms": bf16[KERNEL_FUSED]["ms"], "ptxas": ptxas(D, "fused"),
         "d256": {"source": pkg + "flash_backward_d256_f16.cu",
                  "launches": trained9["fused"].get(KERNEL_FUSED, 0),
                  "launches_path": "train_gemma2_9b_fp16: one step with fused=True",
                  "max_abs_err": bwd["d256"]["fused"][0],
                  "worst_err_bound": bwd["d256"]["fused"][1], **fused9,
                  "bf16_ms": bf16["flash_backward_fused_d256"]["ms"],
                  "ptxas": ptxas(G9_D, "fused")}},
        {"name": "flash_backward_split_f16", "route": "cuda",
         "source": pkg + "flash_backward_f16.cu", "replaces": tpu + "flash_backward.py:118",
         "also_replaces": tpu + "flash_backward.py:198", "counted_as": [KERNEL_DKV, KERNEL_DQ],
         "launches": both(trained["split"]),
         "launches_by_entry": {n: trained["split"].get(n, 0) for n in (KERNEL_DKV, KERNEL_DQ)},
         "launches_path": f"train_fp16: {TRAIN_STEPS} steps x {TRAIN_LAYERS} layers "
                          "(the default backward)",
         "launches_bench_attention_f16_grad": both(bench_grad),
         "max_abs_err": bwd["d128"]["split"][0], "worst_err_bound": bwd["d128"]["split"][1],
         **split, "bf16_ms": bf16["flash_backward_split"]["ms"], "ptxas": ptxas(D, "split"),
         "d256": {"source": pkg + "flash_backward_d256_f16.cu",
                  "launches": both(trained9["split"]),
                  "launches_path": f"train_gemma2_9b_fp16: {G9_TRAIN_STEPS} steps x "
                                   f"{G9_TRAIN_LAYERS} layers",
                  "max_abs_err": bwd["d256"]["split"][0],
                  "worst_err_bound": bwd["d256"]["split"][1], **split9,
                  "bf16_ms": bf16["flash_backward_split_d256"]["ms"],
                  "ptxas": ptxas(G9_D, "split")}},
        {"name": KQ + "_f16", "route": "cuda", "source": pkg + "flash_quant_f16.cu",
         "replaces": tpu + "flash_quant.py:129", "also_replaces": tpu + "flash_quant.py:46",
         "also_source": pkg + "flash_quant_d256_f16.cu", "counted_as": KQ,
         "launches": quant["launches"].get(KQ, 0),
         "launches_path": f"fp16_quant_cases: flash_forward_quantized in fp16, every variant "
                          f"at d 128 and 256 ({quant['calls']} calls)",
         "max_abs_err": q_err[0], "worst_err_bound": q_err[1],
         **beside_variants(time_fp16_quant(D), bf16[KQ]),
         "ptxas": _kernel_ptxas(_ptxas_by_kernel(logs.get("flash_quant_f16.cu", "")),
                                ("flash_quant_kernel", "flash_quant_i8_kernel")),
         "d256": beside_variants(time_fp16_quant(G9_D), bf16["flash_quant_d256"])},
    ]
    return entries


def fp16_kernel_entries(bf16: dict, cases: dict, served: dict, quant: dict, gemma: dict,
                        bench: dict, logs: dict) -> list:
    """The fp16 entries of the ``kernels`` line: each fp16 form's launches on
    its fp16 path, its worst error against the plain version, and its times
    beside its bound, the plain version's and the library call's, from the
    bf16 entries' timing functions at their shapes (fp16 has bf16's bytes
    and 989 TFLOP/s peak, so the bounds are the bf16 rows'), with the bf16
    entry's ms from the same run in ``bf16_ms`` (``bf16``: the bf16
    entries by name)."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, KERNEL_FORI)
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        KERNEL as KP, KERNEL_MERGE)
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS

    pkg = "flash_attention_from_scratch_tpu_torch/csrc/"
    tpu = "flash_attention_from_scratch_tpu/ops/"

    def beside(f16: dict, name: str) -> dict:
        return {**f16, "bf16_ms": bf16[name]["ms"]}

    flash_ptx = _ptxas_by_kernel(logs.get("flash_forward_f16.cu", ""))
    fori_ptx = _ptxas_by_kernel(logs.get("flash_forward_fori_f16.cu", ""))
    paged_ptx = _ptxas_by_kernel(logs.get("paged_attention_f16.cu", ""))
    qmm_ptx = _ptxas_by_kernel(logs.get("quant_matmul_f16.cu", ""))
    g9 = gemma["counts"]
    entries = [
        {"name": "flash_forward_f16", "route": "cuda", "source": pkg + "flash_forward_f16.cu",
         "replaces": tpu + "flash_forward.py:284", "counted_as": K1,
         "launches": served["counts"].get(K1, 0),
         "launches_path": "serve_fp16: 32 layers x 8 prompts (Llama-3-8B in fp16)",
         "launches_quant": {r: c["counts"].get(K1, 0) for r, c in quant.items()},
         "launches_gemma2_9b_fp16": g9.get(K1, 0),
         "launches_bench_attention_f16": bench.get(K1, 0),
         "max_abs_err": cases["flash"][K1][0], "worst_err_bound": cases["flash"][K1][1],
         **beside(time_flash(flash_ptx, FP16), K1),
         "d256": beside(time_flash_d256(flash_ptx, FP16), "flash_forward_d256")},
        {"name": "flash_forward_fori_f16", "route": "cuda",
         "source": pkg + "flash_forward_fori_f16.cu", "replaces": tpu + "flash_forward.py:578",
         "also_source": pkg + "flash_forward_fori_d256_f16.cu", "counted_as": KERNEL_FORI,
         "launches": bench.get(KERNEL_FORI, 0),
         "launches_path": "tools/bench_attention.py " + " ".join(BENCH_F16_ARGS),
         "max_abs_err": cases["flash"][KERNEL_FORI][0],
         "worst_err_bound": cases["flash"][KERNEL_FORI][1],
         **time_typed_fori(D), "d256": time_typed_fori(G9_D),
         "ptxas": _kernel_ptxas(fori_ptx, ("flash_forward_fori_kernel",))},
        {"name": "paged_decode_attention_f16", "route": "cuda",
         "source": pkg + "paged_attention_f16.cu", "replaces": tpu + "paged_attention.py:280",
         "also_replaces": tpu + "paged_attention.py:69", "counted_as": KP,
         "launches": served["counts"].get(KP, 0),
         "merge_launches": served["counts"].get(KERNEL_MERGE, 0),
         "launches_path": "serve_fp16: 32 layers x decode steps, by CUDA-graph replay",
         "launches_quant": {r: c["counts"].get(KP, 0) for r, c in quant.items()},
         "launches_gemma2_9b_fp16": g9.get(KP, 0),
         "max_abs_err": cases["paged"][0], "worst_err_bound": cases["paged"][1],
         "cases": cases["paged"][2], **beside(time_paged(FP16), KP),
         "by_format": time_paged_formats(FP16), "int8c": time_paged_int8c(FP16),
         "d256": beside(time_paged_d256(paged_ptx, FP16), "paged_decode_attention_d256")},
    ]
    tpu_lines = {("int8", False): 159, ("int4", False): 135, ("int8", True): 178,
                 ("int4", True): 206}
    for mode, act_quant in QMM_RECIPES:
        name = KERNELS[(mode, act_quant)]
        run = next((r for r, c in quant.items() if c["counts"].get(name)), None)
        timed = time_quant_matmul(mode, act_quant, qmm_ptx, FP16)
        entries.append({
            "name": name + "_f16", "route": "cuda", "source": pkg + "quant_matmul_f16.cu",
            "replaces": f"{tpu}quant_matmul.py:{tpu_lines[(mode, act_quant)]}",
            "counted_as": name, "launches": quant[run]["counts"][name] if run else 0,
            "launches_path": (f"serve_fp16_quant run {run}" if run else
                              "no fp16 serving run takes this recipe: fp16_cases only"),
            "case_launches": cases["qmm"][name]["cases"],
            "max_abs_err": cases["qmm"][name]["max_abs_err"],
            "worst_err_bound": cases["qmm"][name]["worst_err_bound"],
            **timed, "bf16_ms": bf16[name]["ms"],
            "prefill": {**timed["prefill"], "bf16_ms": bf16[name]["prefill"]["ms"]}})
    return entries


# ---------------------------------------------------------------------------
# fp32 on the card: K1 and K11 from their fp32 libraries
# (csrc/flash_forward_f32.cu, flash_forward_fori_f32.cu and its d-256 build,
# on the fp32 main loop csrc/flash_f32.cuh: 3xTF32 products, P in fp32), and
# the model's prefill in fp32 (LlamaConfig.dtype FP32). The other kernels
# refuse fp32 on the card (ROADMAP Queue 1, items 4c-2 and 4c-3), and so does
# an fp32 GenerationServer.

FP32 = torch.float32
# The bound of the fp32 attention products: 3xTF32 takes three TF32 products
# of the H100's 495 TFLOP/s (dense tensor cores, NVIDIA data sheet) for one.
PEAK_FP32_PRODUCTS = 495e12 / 3
# K1's and K11's fp32 cases: FP16_FLASH_CASES' masks, sinks, GQA and
# q_offset, with s 64 beside s 2,048 at both widths.
FP32_FLASH_CASES = FP16_FLASH_CASES + (
    ("d128 causal s64", D, HEADS, KV_HEADS, 64, 64, dict(causal=True), False),
    ("d128 full sinks s64", D, HEADS, KV_HEADS, 64, 64, {}, True),
    ("d128 causal s2048", D, HEADS, KV_HEADS, 2048, 2048, dict(causal=True), False),
    ("d256 causal softcap 50 s64", G9_D, G9_HEADS, G9_KV_HEADS, 64, 64,
     dict(causal=True, attn_softcap=G9_SOFTCAP), False),
    ("d256 causal s2048", G9_D, G9_HEADS, G9_KV_HEADS, 2048, 2048, dict(causal=True), False),
)


def _exact_by_heads(q, k, v, cfg, sinks, group: int = 8):
    """The exact answer: the plain version in fp64 (``reference_attention``
    on fp64 inputs), ``group`` Q heads at a time (their KV heads with them),
    so that an s 4,096 prompt's fp64 scores stay a few GB."""
    from flash_attention_from_scratch_tpu_torch.ops.reference import reference_attention

    per = q.shape[1] // k.shape[1]
    group = max(group // per, 1) * per
    outs = []
    for h0 in range(0, q.shape[1], group):
        kv = slice(h0 // per, (h0 + group) // per)
        outs.append(reference_attention(
            q[:, h0:h0 + group].double(), k[:, kv].double(), v[:, kv].double(),
            causal=cfg.causal, scale_override=cfg.softmax_scale,
            q_offset=cfg.q_offset if cfg.causal else None, window=cfg.window,
            softcap=cfg.attn_softcap,
            sinks=None if sinks is None else sinks[h0:h0 + group]))
    return torch.cat(outs, 1)


def _floors_ratio(out, ref32) -> float:
    """The worst err/bound of ``out`` against the plain fp32 version by the
    rule's floors alone (its native and fp32 references one computation)."""
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        row_bands, sliced_tolerance_check)

    return sliced_tolerance_check(row_bands(out), row_bands(ref32), row_bands(ref32),
                                  lead=3)[1]


def phase_fp32_cases() -> dict:
    """K1 and K11 in fp32 against their plain version (``_typed_flash_cases``
    on FP32_FLASH_CASES); the other kernels' refusals are the ``cuda``
    tests' ``test_types_without_a_kernel_raise``."""
    t0 = time.perf_counter()
    line = {"flash": _typed_flash_cases(FP32)}
    line["s"] = time.perf_counter() - t0
    print(json.dumps({"fp32_cases": line}), flush=True)
    return line


G9_FP32_LAYERS = 8
FP32_CHUNK_SLACK = 1e-3  # prefill_chunked's last-row logits: of prefill's row max |logit|


def _prefill_fp32_run(label, params, cfg, prompt_lens) -> dict:
    """One model's prefill in fp32 at page SERVE_PAGE_SIZE: each prompt of
    ``prompt_lens`` (random tokens, padded to the prompt quantum) through
    ``prefill`` into a dense fp32 cache, the launch counts set to 0 just
    before and read just after (K1: one a layer and prompt, nothing else).
    Gates: fp32 pages, finite fp32 logits; the longest prompt's first and
    last layers' recorded q, k and v run again through K1 and held by the
    rule (``_hold``: the error from the exact answer at most twice the plain
    fp32 version's, fp32's floors); ``prefill_chunked`` of the longest
    prompt in PREFILL_CHUNK-token chunks (K1 at q_offset > 0 over the pages
    read back) within FP32_CHUNK_SLACK of ``prefill``'s row max. Reports
    prefill tokens/s, peak memory, K1's ms on the recorded layers and the
    profiled device time of the longest prompt's prefill by class."""
    from flash_attention_from_scratch_tpu_torch.models import llama
    from flash_attention_from_scratch_tpu_torch.models.decode import (
        init_cache, prefill, prefill_chunked)
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, flash_forward, flash_forward_plain)

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in prompt_lens]
    pages = [-(-_padded(n) // SERVE_PAGE_SIZE) for n in prompt_lens]
    longest = int(np.argmax(prompt_lens))

    def tokens(i):
        toks = torch.zeros((1, _padded(prompt_lens[i])), dtype=torch.long)
        toks[0, :prompt_lens[i]] = torch.from_numpy(prompts[i])
        return toks.cuda()

    cache = init_cache(cfg, sum(pages), SERVE_PAGE_SIZE)
    if cache.k_pages[0].dtype != FP32:
        raise AssertionError(f"{label}: pages in {cache.k_pages[0].dtype}")
    keep, recorded, calls = (0, cfg.n_layers - 1), {}, [0]
    attention = llama.flash_forward

    def record(q, k, v, acfg, sinks=None):  # the longest prompt's kept layers' inputs
        layer = calls[0] % cfg.n_layers
        calls[0] += 1
        if record.on and layer in keep:
            recorded[layer] = (q.clone(), k.clone(), v.clone(), acfg)
        return attention(q, k, v, acfg, sinks)

    logits, first = [], 0
    torch.cuda.reset_peak_memory_stats()
    llama.flash_forward = record
    try:
        sync()
        _build.launch_counts.clear()  # counts start at 0 just before the run
        t = time.perf_counter()
        for i in range(len(prompt_lens)):
            record.on = i == longest
            table = torch.arange(first, first + pages[i], dtype=torch.int32, device="cuda")
            first += pages[i]
            row, cache = prefill(params, tokens(i), cfg, cache, table,
                                 prompt_len=prompt_lens[i])
            logits.append(row)
        sync()
        wall = time.perf_counter() - t
        counts = dict(_build.launch_counts)  # read just after
    finally:
        llama.flash_forward = attention
    peak = torch.cuda.max_memory_allocated() / 1e9
    del cache
    want = {K1: cfg.n_layers * len(prompt_lens)}
    finite = all(bool(torch.isfinite(r).all()) and r.dtype == FP32 for r in logits)
    if counts != want or not finite:
        raise AssertionError(f"{label}: launches {counts} (expected {want}), finite fp32 "
                             f"logits {finite}")
    held = {}
    for layer, (q, k, v, acfg) in sorted(recorded.items()):
        _build.launch_counts.clear()
        out = flash_forward(q, k, v, acfg)
        sync()
        plain = flash_forward_plain(q, k, v, acfg)[0]
        exact = _exact_by_heads(q, k, v, acfg, None).float()
        err, ratio = _hold(f"{label} layer {layer}", out, exact, plain,
                           _build.launch_counts[K1], note=", the recorded prompt's inputs",
                           plain=plain)
        held[layer] = {"max_abs_err": err, "worst_err_bound": ratio,
                       "floors_ratio": _floors_ratio(out, plain),
                       "k1_ms": _time_ms(lambda: flash_forward(q, k, v, acfg)),
                       "window": acfg.window, "softcap": acfg.attn_softcap,
                       "shape": list(q.shape)}
        del out, plain, exact
    del recorded
    n = prompt_lens[longest]
    table = torch.arange(pages[longest], dtype=torch.int32, device="cuda")
    _build.launch_counts.clear()
    chunked, _ = prefill_chunked(params, tokens(longest), cfg,
                                 init_cache(cfg, pages[longest], SERVE_PAGE_SIZE), table,
                                 prompt_len=n, chunk_tokens=PREFILL_CHUNK)
    sync()
    chunk_counts = dict(_build.launch_counts)
    gap = float((chunked - logits[longest]).abs().max() / logits[longest].abs().max())
    chunk_want = {K1: cfg.n_layers * -(-n // PREFILL_CHUNK)}
    print(f"{label}: prefill_chunked of {n} tokens in {PREFILL_CHUNK}-token chunks: launches "
          f"{chunk_counts}, last-row logits within {gap:.3e} of prefill's row max (limit "
          f"{FP32_CHUNK_SLACK})", flush=True)
    if gap > FP32_CHUNK_SLACK or chunk_counts != chunk_want:
        raise AssertionError(f"{label}: prefill_chunked off prefill, or launches "
                             f"{chunk_counts} (expected {chunk_want})")
    cache = init_cache(cfg, pages[longest], SERVE_PAGE_SIZE)
    prof = _profile(lambda: prefill(params, tokens(longest), cfg, cache, table,
                                    prompt_len=n))
    del cache
    line = {"model": label, "dtype": "fp32", "layers": cfg.n_layers, "d_head": cfg.d_head,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "window_pattern": list(cfg.window_pattern),
            "softcap": cfg.attn_softcap, "prompt_lens": list(prompt_lens),
            "prefill_tok_s": sum(prompt_lens) / wall, "prefill_wall_s": wall,
            "launches": counts, "peak_mem_gb": peak, "recorded_layers": held,
            "chunked": {"prompt": n, "chunk_tokens": PREFILL_CHUNK, "launches": chunk_counts,
                        "last_row_gap_of_row_max": gap},
            "longest_prompt_profile": {
                "device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
                "k1_device_ms": prof["device_ms_by_class"].get("flash forward (K1)", 0.0),
                "device_ms_by_class": prof["device_ms_by_class"]}}
    return line


def phase_prefill_fp32(smi: str) -> dict:
    """Llama-3-8B in fp32 at full width and depth (``init_params`` from seed
    0: ~32 GB of weights) over SERVE_PROMPT_LENS, then Gemma-2-9B in fp32 at
    full width and its first G9_FP32_LAYERS layers (``serve_gemma2_9b``'s
    random weights converted by ``from_hf_gemma2(..., dtype=torch.float32)``:
    d 256, a 4,096 window on alternate layers, softcap 50) over
    G9_PROMPT_LENS (the longest past the window), each by
    ``_prefill_fp32_run``. Prints a ``prefill_fp32`` line a model; returns
    {"llama", "gemma2"}: those lines."""
    import types

    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, DType, from_hf_gemma2
    from flash_attention_from_scratch_tpu_torch.models.llama import init_params
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves

    out = {}
    t0 = time.perf_counter()
    cfg = dataclasses.replace(LLAMA3_8B, dtype=DType.FP32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    if {p.dtype for p in param_leaves(params)} != {FP32}:
        raise AssertionError("prefill_fp32: Llama-3-8B's weights are not all fp32")
    out["llama"] = _prefill_fp32_run("Llama-3-8B", params, cfg, SERVE_PROMPT_LENS)
    out["llama"].update(s=time.perf_counter() - t0, gpu=smi)
    print(json.dumps({"prefill_fp32": out["llama"]}), flush=True)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hf = dict(GEMMA2_9B_HF, num_hidden_layers=G9_FP32_LAYERS)
    sd = _gemma2_state_dict(hf, torch.Generator(device="cuda").manual_seed(0))
    model = types.SimpleNamespace(config=types.SimpleNamespace(**hf), state_dict=lambda: sd)
    params, cfg = from_hf_gemma2(model, dtype=FP32)
    del sd, model
    torch.cuda.empty_cache()
    if {p.dtype for p in param_leaves(params)} != {FP32}:
        raise AssertionError("prefill_fp32: Gemma-2-9B's weights are not all fp32")
    out["gemma2"] = _prefill_fp32_run("Gemma-2-9B", params, cfg, G9_PROMPT_LENS)
    out["gemma2"].update(s=time.perf_counter() - t0, gpu=smi)
    print(json.dumps({"prefill_fp32": out["gemma2"]}), flush=True)
    del params
    torch.cuda.empty_cache()
    return out


# bench_attention --dtype f32 on K1's and K11's d-128 and d-256 forms (JAX's
# progression has no fp32 config), causal, with SDPA's fp32 baseline (its
# memory-efficient backend); sanity_check --dtype f32 on the d-128 forms (its
# inputs are d 128).
SANITY_F32_FORMS = "fa_f32_q128_kv128_d128_grid2_x2+os+cp;fa_f32_q128_kv128_d128_fori2_x2+os+cp"
BENCH_F32_FORMS = (SANITY_F32_FORMS + ";fa_f32_q128_kv128_d256_grid2_x2+os+cp;"
                   "fa_f32_q128_kv128_d256_fori2_x2+os+cp")
BENCH_F32_ARGS = ("--dtype", "f32", "--kernels", BENCH_F32_FORMS, "--causal", "--seq-lens",
                  "2048,4096", "--baseline", "--json")
SANITY_F32_ARGS = ("--dtype", "f32", "--kernels", SANITY_F32_FORMS, "--batch", "2")


def phase_bench_attention_fp32(smi: str) -> dict:
    """``tools/bench_attention.py``'s ``main`` with BENCH_F32_ARGS, the launch
    counts set to 0 just before and read just after: a row of positive
    TFLOP/s for each form and SDPA's (named as its memory-efficient
    backend), K1 and K11 launched; then ``tools/sanity_check.py``'s
    ``main`` with SANITY_F32_ARGS, which must exit 0. Returns the bench
    run's launches."""
    import contextlib
    import io

    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, KERNEL_FORI)
    from flash_attention_from_scratch_tpu_torch.tools import sanity_check

    torch.cuda.empty_cache()
    text = io.StringIO()
    t = time.perf_counter()
    _build.launch_counts.clear()  # counts start at 0 just before the run
    with contextlib.redirect_stdout(text):
        rc = bench_attention.main(list(BENCH_F32_ARGS))
    counts = dict(_build.launch_counts)  # read just after
    rows = [json.loads(line) for line in text.getvalue().splitlines() if line.startswith("{")]
    print(json.dumps({"bench_attention": {"args": " ".join(BENCH_F32_ARGS), "rows": rows,
                                          "launches": counts, "s": time.perf_counter() - t,
                                          "gpu": smi}}), flush=True)
    want = {f + "+ca" for f in BENCH_F32_FORMS.split(";")} | {"sdpa"}
    good = (rc == 0 and {r["config"] for r in rows} == want
            and all(r["harmonic_mean"] > 0 for r in rows)
            and {r["kernel"] for r in rows if r["config"] == "sdpa"}
            == {"sdpa:" + bench_attention.SDPA_FP32_BACKEND}
            and all(counts.get(k, 0) > 0 for k in (K1, KERNEL_FORI)))
    if not good:
        raise AssertionError(f"bench_attention {' '.join(BENCH_F32_ARGS)}: rc {rc}, launches "
                             f"{counts}, rows {rows}")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = sanity_check.main(list(SANITY_F32_ARGS))
    print(f"sanity_check {' '.join(SANITY_F32_ARGS)}: exit {rc}\n{text.getvalue()}", flush=True)
    if rc != 0:
        raise AssertionError(f"sanity_check {' '.join(SANITY_F32_ARGS)} exited {rc}")
    return counts


def fp32_kernel_entries(cases: dict, prefilled: dict, bench: dict, bf16: dict,
                        logs: dict) -> list:
    """The fp32 entries of the ``kernels`` line: K1 and K11 from their fp32
    libraries, each with its launches on the fp32 path (K1: ``prefill_fp32``'s
    Llama-3-8B run; K11: ``bench_attention --dtype f32``), its worst error
    against the plain version (``fp32_cases``), its registers and spills and
    its times beside the bound (the products at PEAK_FP32_PRODUCTS, or the
    bytes), the plain version's and SDPA's in fp32, at the bf16 entries'
    shapes, with the bf16 entry's ms from the same run in ``bf16_ms``
    (``bf16``: the bf16 entries by name)."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, KERNEL_FORI)

    pkg = "flash_attention_from_scratch_tpu_torch/csrc/"
    tpu = "flash_attention_from_scratch_tpu/ops/"
    flash_ptx = _ptxas_by_kernel(logs.get("flash_forward_f32.cu", ""))
    fori_ptx = _ptxas_by_kernel(logs.get("flash_forward_fori_f32.cu", "")
                                + logs.get("flash_forward_fori_d256_f32.cu", ""))
    llama, gemma = prefilled["llama"], prefilled["gemma2"]
    floors = cases["flash"]["floors"]
    return [
        {"name": "flash_forward_f32", "route": "cuda", "source": pkg + "flash_forward_f32.cu",
         "replaces": tpu + "flash_forward.py:284", "counted_as": K1,
         "launches": llama["launches"].get(K1, 0),
         "launches_path": f"prefill_fp32: Llama-3-8B in fp32, {llama['layers']} layers x "
                          f"{len(llama['prompt_lens'])} prompts",
         "launches_gemma2_9b_fp32": gemma["launches"].get(K1, 0),
         "launches_chunked": {"llama": llama["chunked"]["launches"].get(K1, 0),
                              "gemma2": gemma["chunked"]["launches"].get(K1, 0)},
         "launches_bench_attention_f32": bench.get(K1, 0),
         "max_abs_err": cases["flash"][K1][0], "worst_err_bound": cases["flash"][K1][1],
         "worst_err_bound_by_floors": floors["kernel"],
         "exact_answer_err_bound_by_floors": floors["exact"],
         **time_flash(flash_ptx, FP32), "bf16_ms": bf16[K1]["ms"],
         "d256": {**time_flash_d256(flash_ptx, FP32),
                  "bf16_ms": bf16["flash_forward_d256"]["ms"]}},
        {"name": "flash_forward_fori_f32", "route": "cuda",
         "source": pkg + "flash_forward_fori_f32.cu", "replaces": tpu + "flash_forward.py:578",
         "also_source": pkg + "flash_forward_fori_d256_f32.cu", "counted_as": KERNEL_FORI,
         "launches": bench.get(KERNEL_FORI, 0),
         "launches_path": "tools/bench_attention.py " + " ".join(BENCH_F32_ARGS),
         "max_abs_err": cases["flash"][KERNEL_FORI][0],
         "worst_err_bound": cases["flash"][KERNEL_FORI][1],
         **time_typed_fori(D, FP32), "d256": time_typed_fori(G9_D, FP32),
         "ptxas": _kernel_ptxas(fori_ptx, ("flash_f32_kernel",))},
    ]


def serving_turn() -> None:
    """The serving runs alone, to time this tree against another in one
    call (parent, change, change, parent): bf16 serving (graph cases and
    profile), ``serve_chunk``, ``serve_sample`` and ``serve_prefix`` on the
    fused weights, quantized runs A and B.
    Run: ``python3 -c "import chip_smoke; chip_smoke.serving_turn()"``."""
    smi = phase_device()
    phase_build()
    served = phase_serve(smi)
    params = served["server"].params
    del served
    _fuse_in_place(params)
    phase_serve_chunk(params, smi)
    phase_serve_sample(params, smi)
    phase_serve_prefix(params, smi)
    del params
    torch.cuda.empty_cache()
    for run in ("A", "B"):
        phase_serve_quant(run, smi)
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    laps, mark = {}, [t0]

    def lap(name):  # the wall time since the last lap, printed as phase_s
        now = time.perf_counter()
        laps[name] = now - mark[0]
        mark[0] = now

    smi = phase_device()
    logs = phase_build()
    lap("device and build")
    ptxas = _ptxas_by_kernel(logs.get("quant_matmul.cu", ""))
    flash_err, flash_ratio = phase_flash_cases()
    fori_err, fori_ratio = phase_fori_cases()
    banded = banded_case()
    quant_err, quant_ratio = phase_flash_quant_cases()
    paged_err = max(phase_paged_cases(), phase_quant_paged_cases())
    multi_err, multi_ratio = phase_paged_multi_cases()
    d256 = phase_d256_cases()
    qmm_err = phase_quant_matmul_cases()
    backward_err = phase_backward_cases()
    sampled_pick = sampler_case()
    lap("kernel cases")
    qmm_any = phase_qmm_any_shape_cases()
    paged_any = phase_paged_any_size_cases()
    lap("kernel cases at any shape and page size")
    fp16_cases = phase_fp16_cases()
    fp16_bwd = phase_fp16_backward_cases()
    fp16_quant = phase_fp16_quant_cases()
    lap("fp16 kernel cases")
    fp32_cases = phase_fp32_cases()
    lap("fp32 kernel cases")
    served = phase_serve(smi)
    counts, serve_line = served["counts"], served["line"]
    params = served["server"].params
    spec = phase_serve_spec(params, smi)  # the same weights
    del served
    _fuse_in_place(params)
    chunked = phase_serve_chunk(params, smi)
    sampled = phase_serve_sample(params, smi)
    prefixed = phase_serve_prefix(params, smi)
    chunk_case = prefill_chunked_case(params)
    lora = phase_serve_lora(params, smi)
    lap("serve phases (bf16)")
    del params  # frees the 16 GB of weights before the MoE phases and training
    torch.cuda.empty_cache()
    served16 = phase_serve(smi, FP16)
    del served16["server"]
    torch.cuda.empty_cache()
    print(json.dumps({"serve_fp16_beside_bf16": {
        key: {"fp16": served16["line"][key], "bf16": serve_line[key]}
        for key in ("decode_tok_s", "prefill_tok_s", "ttft_p50_s", "device_busy_share",
                    "decode_wall_ms_per_step", "launches", "peak_mem_gb")}}), flush=True)
    quant16 = phase_serve_fp16_quant(smi)
    gemma16 = phase_serve_gemma2_9b_fp16(smi)
    lap("serve phases (fp16)")
    prefilled32 = phase_prefill_fp32(smi)
    lap("prefill_fp32")
    moe_served = phase_serve_moe(smi)
    lap("serve_moe")
    torch.cuda.empty_cache()
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_files")
    try:
        moe_trained = phase_train_moe(smi, os.path.join(scratch, "checkpoint"))
        torch.cuda.empty_cache()
        converted = phase_convert(smi, os.path.join(scratch, "hf_shards"))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    torch.cuda.empty_cache()
    lap("train_moe, checkpoint, convert")
    gemma9 = phase_serve_gemma2_9b(smi)
    torch.cuda.empty_cache()
    lap("serve_gemma2_9b")
    trained = phase_train(smi)
    lap("train")
    trained16 = phase_train(smi, FP16)
    print(json.dumps({"train_fp16_beside_bf16": {
        key: {"fp16": trained16["line"][key], "bf16": trained["line"][key]}
        for key in ("launches", "fused_launches", "train_tok_s", "step_ms", "peak_mem_gb",
                    "losses", "optimizer", "lr")}}), flush=True)
    lap("train_fp16")
    trained9 = phase_train_gemma2_9b(smi)
    lap("train_gemma2_9b")
    trained9_16 = phase_train_gemma2_9b(smi, FP16)
    lap("train_gemma2_9b_fp16")
    torch.cuda.empty_cache()
    quant_runs = {}
    for run in QUANT_RUNS:
        quant_runs[run] = phase_serve_quant(run, smi, graph_check=run in ("A", "B"))
        torch.cuda.empty_cache()
    lora_quant = phase_serve_lora_quant(smi)
    lap("serve_quant, serve_lora_quant")
    openhermes = {}
    for run in OPENHERMES_RUNS:
        openhermes[run] = phase_serve_openhermes(run, smi)
        torch.cuda.empty_cache()
    lap("serve_openhermes")
    torch.cuda.empty_cache()
    tools = phase_bench_tools(smi)
    torch.cuda.empty_cache()
    attn_options = phase_bench_attention_options(smi)
    torch.cuda.empty_cache()
    bench16 = phase_bench_attention_fp16(smi)
    torch.cuda.empty_cache()
    bench32 = phase_bench_attention_fp32(smi)
    torch.cuda.empty_cache()
    tool_cases = phase_bench_tool_cases()
    torch.cuda.empty_cache()
    decode_tool = phase_serving_tools(smi)[0]
    phase_entry()
    lap("tools, entry")
    torch.cuda.empty_cache()
    banded_bwd = phase_banded_backward_cases()
    os.makedirs(scratch, exist_ok=True)
    try:
        kernel_tools = phase_kernel_tools(smi, trained["rate"],
                                          os.path.join(scratch, "kernel_tools"))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    lap("banded backward, kernel tools")
    torch.cuda.empty_cache()
    port_tools = phase_port_tools(smi)
    lap("port_tools")
    torch.cuda.empty_cache()
    ring_dir = os.path.join(scratch, "ring")
    os.makedirs(ring_dir, exist_ok=True)
    try:
        ring = phase_ring(smi, ring_dir)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    torch.cuda.empty_cache()
    lap("ring")
    train_par = phase_train_parallel(smi)
    lap("train_parallel")
    serve_tp = phase_serve_tp(smi)
    lap("serve_tp")
    phase_bench_ring(smi)
    lap("bench_ring")
    moe_ep = phase_moe_ep(smi)
    lap("moe_ep")
    torch.cuda.empty_cache()
    pipe = phase_pipeline(smi)
    lap("pipeline")
    torch.cuda.empty_cache()
    tp_lora = phase_serve_tp_lora(smi)
    lap("serve_tp_lora")
    scaling = phase_scaling_report(smi, decode_tool["ms_per_step"])
    lap("scaling_report")
    phase_dryrun(smi)
    lap("dryrun")
    shards = time_shards()
    lap("time_shards")

    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED, fused_choice)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, KERNEL_FORI)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import KERNEL as KQ
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        KERNEL as KP, KERNEL_INT8C, KERNEL_MERGE, KERNEL_MULTI, KERNEL_MULTI_INT8C)
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS

    pkg = "flash_attention_from_scratch_tpu_torch/csrc/"
    kernels = [
        {"name": K1, "route": "cuda", "source": pkg + "flash_forward.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_forward.py:284",
         "launches": counts.get(K1, 0), "max_abs_err": flash_err,
         "worst_err_bound": flash_ratio,
         "launches_serve_chunk": chunked["counts"].get(K1, 0),
         "launches_serve_sample": sampled["counts"][1].get(K1, 0),
         "launches_serve_prefix": prefixed["counts"].get(K1, 0),
         "launches_serve_lora": {str(c): n.get(K1, 0) for c, n in lora["counts"].items()},
         "launches_serve_lora_quant": lora_quant["counts"].get(K1, 0),
         "launches_serve_moe": {r: n.get(K1, 0) for r, n in moe_served["counts"].items()},
         "launches_train_moe": moe_trained["counts"].get(K1, 0),
         "launches_convert": {r: n.get(K1, 0) for r, n in converted.items()},
         "prefill_chunked_case": chunk_case, "banded_case": banded,
         "launches_kernel_tools": _tool_launches(kernel_tools, K1),
         "launches_port_tools": _tool_launches(port_tools, K1),
         **_parallel_fields((K1,), ring, train_par, serve_tp, moe_ep=moe_ep["counts"],
                            pipeline=pipe["counts"], serve_tp_lora=tp_lora["counts"]),
         "shards": shards["k1"],
         **time_flash(_ptxas_by_kernel(logs.get("flash_forward.cu", "")))},
        {"name": KP, "route": "cuda", "source": pkg + "paged_attention.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/paged_attention.py:280",
         "also_replaces": "flash_attention_from_scratch_tpu/ops/paged_attention.py:69",
         "launches": counts.get(KP, 0), "max_abs_err": max(paged_err, multi_err),
         "worst_err_bound_multi_int8c": multi_ratio, **time_paged(),
         "launches_by_entry": {
             KP: counts.get(KP, 0), KERNEL_MULTI: spec["counts"].get(KERNEL_MULTI, 0),
             KERNEL_INT8C: quant_runs["E"]["counts"].get(KERNEL_INT8C, 0),
             KERNEL_MULTI_INT8C: quant_runs["F"]["counts"].get(KERNEL_MULTI_INT8C, 0)},
         "launches_serve_chunk": chunked["counts"].get(KP, 0),
         "launches_port_tools": _tool_launches(port_tools, KP),
         "launches_serve_sample": {str(c): n.get(KP, 0)
                                   for c, n in sampled["counts"].items()},
         "launches_serve_prefix": prefixed["counts"].get(KP, 0),
         "launches_serve_lora": {str(c): n.get(KP, 0) for c, n in lora["counts"].items()},
         "launches_serve_lora_quant": lora_quant["counts"].get(KP, 0),
         "launches_serve_moe": {r: n.get(KP, 0) for r, n in moe_served["counts"].items()},
         "launches_convert": {r: n.get(KP, 0) for r, n in converted.items()},
         **_parallel_fields((KP, KERNEL_MULTI), serve=serve_tp,
                            serve_tp_lora=tp_lora["counts"],
                            scaling_report=scaling["counts"]),
         "launches_parallel_scaling_report_tps": scaling["tps"], "shards": shards["paged"],
         "launches_path": "bf16 serving; multi: the speculative run; int8c: run E; "
                          "multi_int8c: run F; serve_sample at chunk 1 and 8 (the "
                          "pick in the graphs), serve_prefix; every count by "
                          "CUDA-graph replay",
         "sampled_pick": sampled_pick,
         "merge": {"name": KERNEL_MERGE, "source": pkg + "paged_attention.cu",
                   "launches": counts.get(KERNEL_MERGE, 0),
                   "launches_path": "bf16 serving (one a K4/K5 call)"},
         "by_format": time_paged_formats(),
         "verify_t4": time_paged_verify(spec["verify_lengths"]),
         "int8c": time_paged_int8c(),
         "any_page_size": {**paged_any, "page_sizes": ANY_PAGE_SIZES,
                           "lengths": ANY_PAGE_LENGTHS},
         "launches_openhermes": {run: {n: r["counts"].get(n, 0) for n in (KP, KERNEL_MERGE)}
                                 for run, r in openhermes.items()},
         "launches_openhermes_path": "R1: 32 layers x decode steps, dense pages of 1 "
                                     "token; R2: 4 layers, int8 pages of 96 (decode loops)",
         "page_sizes": time_paged_page_sizes()},
        # Head width 256: the same wrappers and sources, their d-256
        # instantiations; launches from serve_gemma2_9b (counted under the
        # wrappers' names).
        {"name": "flash_forward_d256", "route": "cuda", "source": pkg + "flash_forward.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_forward.py:284",
         "counted_as": K1, "launches": gemma9["counts"].get(K1, 0),
         "launches_int8_run": gemma9["int8_counts"].get(K1, 0),
         "launches_path": "serve_gemma2_9b: 42 layers x 8 prompts (int8 run: 8 layers); "
                          "train_gemma2_9b: its default steps, 8 layers each",
         "launches_train_gemma2_9b": trained9["split"].get(K1, 0),
         "max_abs_err": d256["flash"][0], "worst_err_bound": d256["flash"][1],
         **time_flash_d256(_ptxas_by_kernel(logs.get("flash_forward.cu", "")))},
        {"name": "paged_decode_attention_d256", "route": "cuda",
         "source": pkg + "paged_attention.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/paged_attention.py:280",
         "also_replaces": "flash_attention_from_scratch_tpu/ops/paged_attention.py:69",
         "counted_as": KP, "launches": gemma9["counts"].get(KP, 0),
         "launches_int8_run": gemma9["int8_counts"].get(KP, 0),
         "merge_launches": gemma9["counts"].get(KERNEL_MERGE, 0),
         "launches_path": "serve_gemma2_9b: 42 layers x decode steps, by CUDA-graph replay "
                          "(int8 run: 8 layers, int8 pages)",
         "max_abs_err": d256["paged"][0], "worst_err_bound": d256["paged"][1],
         **time_paged_d256(_ptxas_by_kernel(logs.get("paged_attention.cu", "")))},
    ]
    lap("kernel timing: K1, K4/K5")
    backward_ptxas = _ptxas_by_kernel(logs.get("flash_backward.cu", "")
                                      + logs.get("flash_backward_d256.cu", ""))
    fused_t, split_t = time_backward(backward_ptxas)
    fused9_t, split9_t = time_backward_d256(backward_ptxas)
    split = trained["split"]
    paths = {True: "one training step with fused=True",
             False: f"{TRAIN_STEPS} training steps (the default backward)"}
    kernels += [
        {"name": KERNEL_FUSED, "route": "cuda", "source": pkg + "flash_backward.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_backward.py:278",
         "launches": trained["fused"].get(KERNEL_FUSED, 0),
         "launches_path": paths[not fused_choice(causal=True)],
         **_parallel_fields((KERNEL_FUSED,), ring, train_par),
         "shards": {k: v for k, v in shards["backward"].items() if v["kernel"] == "K2"},
         "launches_kernel_tools": _tool_launches(kernel_tools, KERNEL_FUSED),
         "launches_port_tools": _tool_launches(port_tools, KERNEL_FUSED),
         "banded_backward": {
             "launches": banded_bwd["launches"][KERNEL_FUSED],
             "launches_path": f"flash_backward(bands={BANDED_BANDS}): b {BANDED_BATCH}, "
                              f"{HEADS}/{KV_HEADS} heads, s {BANDED_SEQ}, causal",
             "max_abs_err": banded_bwd["banded"][0],
             "worst_err_bound": banded_bwd["banded"][1],
             "worst_err_bound_vs_k3": banded_bwd["banded_vs_k3"][1],
             "prefix_shapes": {"rows": BANDED_SEQ // BANDED_BANDS, "keys": BANDED_PREFIX_KEYS,
                               "max_abs_err": banded_bwd["prefix"][0],
                               "worst_err_bound": banded_bwd["prefix"][1]},
             "by_seq": time_banded_backward()},
         "max_abs_err": backward_err[KERNEL_FUSED], **fused_t},
        {"name": "flash_backward_split", "route": "cuda",
         "source": pkg + "flash_backward.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_backward.py:118",
         "also_replaces": "flash_attention_from_scratch_tpu/ops/flash_backward.py:198",
         "launches": split.get(KERNEL_DKV, 0) + split.get(KERNEL_DQ, 0),
         "launches_by_entry": {n: split.get(n, 0) for n in (KERNEL_DKV, KERNEL_DQ)},
         "launches_train_moe": {n: moe_trained["counts"].get(n, 0)
                                for n in (KERNEL_DKV, KERNEL_DQ)},
         "launches_path": paths[fused_choice(causal=True)],
         **_parallel_fields((KERNEL_DKV, KERNEL_DQ), ring, train_par, moe_ep=moe_ep["counts"],
                            pipeline=pipe["counts"]),
         "shards": {k: v for k, v in shards["backward"].items() if v["kernel"] == "K3"},
         "launches_kernel_tools": _tool_launches(kernel_tools, KERNEL_DKV, KERNEL_DQ),
         "launches_port_tools": _tool_launches(port_tools, KERNEL_DKV, KERNEL_DQ),
         "max_abs_err": backward_err["split"], **split_t},
        # Head width 256: the same wrappers and kernels, their d-256
        # instantiations (flash_backward.cu built again at 256 by
        # flash_backward_d256.cu); launches from train_gemma2_9b (counted
        # under the wrappers' names).
        {"name": "flash_backward_fused_d256", "route": "cuda",
         "source": pkg + "flash_backward_d256.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_backward.py:278",
         "counted_as": KERNEL_FUSED, "launches": trained9["fused"].get(KERNEL_FUSED, 0),
         "launches_path": f"train_gemma2_9b: one step with fused=True, {G9_TRAIN_LAYERS} layers",
         "max_abs_err": d256["backward"]["fused"][0],
         "worst_err_bound": d256["backward"]["fused"][1], **fused9_t},
        {"name": "flash_backward_split_d256", "route": "cuda",
         "source": pkg + "flash_backward_d256.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_backward.py:118",
         "also_replaces": "flash_attention_from_scratch_tpu/ops/flash_backward.py:198",
         "counted_as": [KERNEL_DKV, KERNEL_DQ],
         "launches": trained9["split"].get(KERNEL_DKV, 0) + trained9["split"].get(KERNEL_DQ, 0),
         "launches_by_entry": {n: trained9["split"].get(n, 0) for n in (KERNEL_DKV, KERNEL_DQ)},
         "launches_path": f"train_gemma2_9b: {G9_TRAIN_STEPS} steps x {G9_TRAIN_LAYERS} layers "
                          "(the default backward)",
         "max_abs_err": d256["backward"]["split"][0],
         "worst_err_bound": d256["backward"]["split"][1], **split9_t},
    ]
    lap("kernel timing: K2/K3")
    tpu_lines = {("int8", False): 159, ("int4", False): 135, ("int8", True): 178,
                 ("int4", True): 206}
    lm_head = time_lm_head_32002()
    by_kernel = {}  # each kernel's launches from the first run that takes it
    for name, r in quant_runs.items():
        by_kernel.setdefault(r["kernel"], (name, r["launches"]))
    for mode, act_quant in QMM_RECIPES:
        name = KERNELS[(mode, act_quant)]
        run, launches = by_kernel[name]
        kernels.append({
            "name": name, "route": "cuda", "source": pkg + "quant_matmul.cu",
            "replaces": "flash_attention_from_scratch_tpu/ops/quant_matmul.py:"
                        f"{tpu_lines[(mode, act_quant)]}",
            "launches": launches, "launches_path": f"serve run {run}",
            "launches_port_tools": _tool_launches(port_tools, name),
            "max_abs_err": qmm_err[name], **time_quant_matmul(mode, act_quant, ptxas),
            "any_shape": {**qmm_any[name], "shapes": ANY_QMM_SHAPES, "rows": ANY_QMM_ROWS},
            "lm_head_32002": lm_head[name],
            **{f"launches_openhermes_{run}": r["counts"].get(name, 0)
               for run, r in openhermes.items() if name in r["counts"]}})
        if name == KERNELS[("int8", False)]:
            kernels[-1]["also_replaces"] = ("flash_attention_from_scratch_tpu/ops/"
                                            "quant_matmul.py:247")
            kernels[-1]["launches_serve_lora_quant"] = lora_quant["counts"][name]
            kernels[-1]["launches_convert_int8"] = converted["int8"][name]
            kernels[-1].update(_parallel_fields((name,), serve=serve_tp), shards=shards["k6"])
        if name == KERNELS[("int8", True)]:
            kernels[-1].update(_parallel_fields((name,), scaling_report=scaling["counts"]),
                               launches_parallel_scaling_report_tps=scaling["tps"])
    kernels += [
        {"name": KQ, "route": "cuda", "source": pkg + "flash_quant.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_quant.py:129",
         "also_replaces": "flash_attention_from_scratch_tpu/ops/flash_quant.py:46",
         "launches": tools[KQ],
         "launches_path": "tools/bench_quant.py: bench_quant and numerics_check "
                          "at their defaults",
         "launches_kernel_tools": _tool_launches(kernel_tools, KQ),
         "launches_port_tools": _tool_launches(port_tools, KQ),
         "max_abs_err": max(quant_err, tool_cases[KQ][0]),
         "worst_err_bound": max(quant_ratio, tool_cases[KQ][1]),
         **time_flash_quant(_ptxas_by_kernel(logs.get("flash_quant.cu", "")))},
        {"name": KERNEL_FORI, "route": "cuda", "source": pkg + "flash_forward_fori.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_forward.py:578",
         "launches": attn_options["prog"][KERNEL_FORI],
         "launches_path": "tools/bench_attention.py --kernels prog --json at its default seqs "
                          "(its FORI rungs: depths 1 and 2)",
         "launches_fori_host_timing": attn_options["host_timing"][KERNEL_FORI],
         "launches_kernel_tools": _tool_launches(kernel_tools, KERNEL_FORI),
         "launches_port_tools": _tool_launches(port_tools, KERNEL_FORI),
         "max_abs_err": max(fori_err, tool_cases[KERNEL_FORI][0]),
         "worst_err_bound": max(fori_ratio, tool_cases[KERNEL_FORI][1]),
         **time_fori(_ptxas_by_kernel(logs.get("flash_forward_fori.cu", "")))},
    ]
    quant9_t, fori9_t = time_quant_fori_d256(
        _ptxas_by_kernel(logs.get("flash_quant_d256.cu", "")),
        _ptxas_by_kernel(logs.get("flash_forward_fori_d256.cu", "")))
    kernels += [
        # Head width 256: the same wrappers and kernels, their d-256
        # instantiations, each width a library of its own (counted under
        # the wrappers' names).
        {"name": "flash_quant_d256", "route": "cuda", "source": pkg + "flash_quant_d256.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_quant.py:129",
         "also_replaces": "flash_attention_from_scratch_tpu/ops/flash_quant.py:46",
         "counted_as": KQ, "launches": d256["quant_launches"],
         "launches_path": "phase_d256_cases: flash_forward_quantized at d 256, Gemma-2-9B's "
                          f"16/8 heads, every variant ({len(D256_QUANT_CASES)} calls)",
         "max_abs_err": d256["quant"][0], "worst_err_bound": d256["quant"][1], **quant9_t},
        {"name": "flash_forward_fori_d256", "route": "cuda",
         "source": pkg + "flash_forward_fori_d256.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_forward.py:578",
         "counted_as": KERNEL_FORI, "launches": attn_options["d256"][KERNEL_FORI],
         "launches_path": "tools/bench_attention.py " + " ".join(_D256_TOOL_ARGS),
         "launches_grad": attn_options["d256_grad"].get(KERNEL_FORI, 0),
         "launches_d256_cases": d256["fori_launches"],
         "max_abs_err": max(d256["fori"][0], tool_cases["flash_forward_fori_d256"][0]),
         "worst_err_bound": max(d256["fori"][1], tool_cases["flash_forward_fori_d256"][1]),
         **fori9_t},
    ]
    lap("kernel timing: K6-K9, K10, K11")
    by_name = {k["name"]: k for k in kernels}
    kernels += fp16_kernel_entries(by_name, fp16_cases, served16, quant16, gemma16,
                                   bench16["forward"], logs)
    lap("kernel timing: fp16 K1, K11, K4/K5, K6-K9")
    kernels += fp16_training_entries(by_name, fp16_bwd, fp16_quant, trained16, trained9_16,
                                     bench16["grad"], logs)
    lap("kernel timing: fp16 K2/K3, K10")
    kernels += fp32_kernel_entries(fp32_cases, prefilled32, bench32, by_name, logs)
    lap("kernel timing: fp32 K1, K11")
    print(json.dumps({"phase_s": laps}), flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
