"""Decode throughput benchmark: Llama with quantized weights + paged KV.

Counterpart of ``flash_attention_from_scratch_tpu/tools/bench_decode.py``:
the north-star serving metric (Llama-3-8B, int8 KV decode, tokens/s on one
card) against an HBM roofline. Decode is bandwidth-bound, so the ceiling is
``HBM_bw / bytes_moved_per_step`` where the bytes are the weight stream
(of the embedding table only the rows gathered) plus the KV window each
step reads. Random weights are made directly in int8 or
int4 (``init_quantized_params``) from seed 0; the cache starts as zeros at
``--context`` tokens a sequence, as in the JAX tool.

A step runs as the server runs it on the card, a CUDA-graph replay
(``models/step_graphs.py::StepGraphs``, the JAX tool's jitted step): per
step one ``decode_step`` replay fed its own argmax; ``--scan`` one
``decode_loop`` graph of ``--steps`` steps (the JAX ``lax.scan``);
``--unroll n`` a loop graph of n steps, replayed steps / n times. The first
call of each shape captures its graph and is not timed. The bounds use the
published peaks of an H100 SXM (``utils/chip.py``); every line carries the
card's name and power limit (``device``).

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_decode \\
        --model 8b --batch 16 --context 1024 --steps 32 --kv int8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from ..dispatch import sync
from ..models.decode import init_cache
from ..models.llama import (
    LLAMA3_8B, LLAMA31_8B, MISTRAL_7B, LlamaConfig, fuse_projections,
    init_params, init_quantized_params,
)
from ..models.step_graphs import StepGraphs
from ..ops.quant_matmul import TOKEN_TILES, QuantizedWeight
from ..utils.chip import chip_int8_tops, chip_sol_tflops, device_kind, hbm_gbps
from ..utils.device import resolve_device

__all__ = ["MODELS", "main"]

MODELS = {
    "8b": LLAMA3_8B,
    "8b-3.1": LLAMA31_8B,
    "mistral-7b": MISTRAL_7B,
    "1b": LlamaConfig(vocab_size=128256, dim=2048, n_layers=16, n_heads=16,
                      n_kv_heads=8, d_head=128, hidden_dim=8192),
    "tiny": LlamaConfig(vocab_size=2048, dim=512, n_layers=4, n_heads=4,
                        n_kv_heads=2, d_head=128, hidden_dim=2048),
}

# cuBLAS picks its own tiles for the bf16 projections; the bound assumes it
# pads the rows to 64, the M of one warpgroup's wgmma (not observable here).
BF16_ROW_TILE = 64


def _leaves(params):
    """Every tensor of the tree, a QuantizedWeight as its values and scales
    (the JAX pytree's leaves)."""
    if isinstance(params, dict):
        return [x for v in params.values() for x in _leaves(v)]
    if isinstance(params, (list, tuple)):
        return [x for v in params for x in _leaves(v)]
    if isinstance(params, QuantizedWeight):
        return [params.values, params.scales]
    return [params]


def _param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(params))


def _dense_matmul_params(params) -> int:
    """Total elements of the weights streamed through the tensor cores.

    Everything 2-D except the embedding table (a gather, not a matmul);
    quantized weights count their logical (K, N), not packed bytes.
    """
    def walk(x):
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        if isinstance(x, QuantizedWeight):
            return x.shape[0] * x.shape[1]
        return x.numel() if x.dim() == 2 else 0

    return walk({k: v for k, v in params.items() if k != "embed"})


def weight_bytes_per_step(params, batch: int) -> int:
    """Weight bytes a decode step of ``batch`` tokens reads: every weight
    once (the batch shares the stream), but of the embedding table only
    the batch's rows, a gather. (The JAX tool counts the whole table, 1.05
    GB of Llama-3-8B's bf16 step bytes.)"""
    embed = params["embed"]
    return (_param_bytes(params) - embed.numel() * embed.element_size()
            + batch * embed.shape[1] * embed.element_size())


def matmul_rows(m: int, quantized: bool) -> int:
    """The rows a decode matmul of m tokens computes: the quantized kernels'
    token tile (``ops/quant_matmul.py::plan``: the least of 16, 32, 64 and
    128 that holds m, whole 128s past it), or ``BF16_ROW_TILE`` multiples
    for cuBLAS on bf16 weights."""
    if not quantized:
        return -(-m // BF16_ROW_TILE) * BF16_ROW_TILE
    return next((t for t in TOKEN_TILES if m <= t), -(-m // 128) * 128)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="8b", choices=sorted(MODELS))
    ap.add_argument("--weights", default="int8", choices=["int8", "int4", "bf16"])
    ap.add_argument("--act", default="bf16", choices=["bf16", "int8"],
                    help="activation handling in the dense layers: bf16 = "
                         "weight-only dequant matmuls; int8 = W8A8/W4A8 "
                         "(per-row activation quant, int8 tensor-core products)")
    ap.add_argument("--kv", default="int8", choices=["dense", "int8", "fp8"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--context", type=int, default=1024,
                    help="KV tokens already in cache per sequence")
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--scan", action="store_true",
                    help="all steps in one decode_loop graph: device throughput "
                         "without a host call a step")
    ap.add_argument("--window", type=int, default=0,
                    help="override sliding_window (the paged kernel skips pages "
                         "below the window)")
    ap.add_argument("--attn-int8", action="store_true",
                    help="int8-compute paged attention (int8 KV only)")
    ap.add_argument("--fuse", action="store_true",
                    help="fuse QKV and gate|up projections into single weight "
                         "streams (models.llama.fuse_projections)")
    ap.add_argument("--unroll", type=int, default=1,
                    help="decode steps per graph replay (a loop graph of n steps)")
    ap.add_argument("--trace", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.trace is not None:
        raise SystemExit("--trace (an Xprof trace of the TPU) is not ported to the "
                         "GPU: see ROADMAP.md, Queue 1 item 8 (profile_trace)")
    if args.unroll > 1 and args.steps % args.unroll:
        ap.error(f"--steps ({args.steps}) must be a multiple of --unroll ({args.unroll})")

    dev = resolve_device("cuda")
    cfg = MODELS[args.model]
    if args.window:
        cfg = dataclasses.replace(cfg, sliding_window=args.window)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.weights == "bf16":
        params = init_params(cfg, gen, dev)
    else:
        params = init_quantized_params(cfg, gen, args.weights, act=args.act, device=dev)
    if args.fuse:
        params = fuse_projections(params)
    pbytes = _param_bytes(params)

    pages_per_seq = -(-(args.context + 2 * args.steps + args.warmup + 1)
                      // args.page_size)
    num_pages = args.batch * pages_per_seq + 1
    cache = init_cache(cfg, num_pages, args.page_size, args.kv, dev)
    cbytes = cache.nbytes()
    print(f"device={device_kind()} params={pbytes / 1e9:.2f} GB "
          f"cache={cbytes / 1e9:.2f} GB pages={num_pages}", file=sys.stderr)

    # Page tables: sequence i owns pages [i * pps, (i + 1) * pps).
    tables = torch.arange(args.batch * pages_per_seq, dtype=torch.int32).view(
        args.batch, pages_per_seq)
    lengths = torch.full((args.batch,), args.context, dtype=torch.int32)
    tokens = torch.zeros(args.batch, dtype=torch.int64, device=dev)
    graphs = StepGraphs(params, cfg, cache, attn_int8=args.attn_int8)

    if args.scan or args.unroll > 1:
        n = args.steps if args.scan else args.unroll

        def run_n(toks, lens):
            out, lens = graphs.decode_loop(toks, lens, tables, n)
            return out[:, -1], lens

        tokens, lengths = run_n(tokens, lengths)  # capture + warm
        sync()
        t0 = time.perf_counter()
        for _ in range(args.steps // n):
            tokens, lengths = run_n(tokens, lengths)
        sync()
        dt = time.perf_counter() - t0
    else:
        def step():
            nonlocal tokens, lengths
            lengths = lengths + 1
            tokens = graphs.decode_step(tokens, lengths, tables).argmax(-1)

        for _ in range(args.warmup):  # the first captures
            step()
        sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        sync()
        dt = time.perf_counter() - t0

    toks = args.batch * args.steps
    tps = toks / dt
    ms_per_step = dt / args.steps * 1e3

    # HBM roofline: a step reads the weights once (the batch shares the
    # stream) plus each sequence's KV window.
    kv_bytes_per_tok = cache.k_pages[0].element_size() * cfg.d_head * 2
    # Mean context of the timed window: the loop modes warm with one call
    # (steps or unroll tokens), the per-step mode with --warmup steps.
    warm_tokens = (args.steps if args.scan
                   else args.unroll if args.unroll > 1 else args.warmup)
    mean_ctx = args.context + warm_tokens + args.steps / 2
    if cfg.sliding_window:
        mean_ctx = min(mean_ctx, cfg.sliding_window)  # the kernel skips older pages
    kv_read = args.batch * mean_ctx * cfg.n_kv_heads * cfg.n_layers * kv_bytes_per_tok
    step_bytes = weight_bytes_per_step(params, args.batch) + kv_read
    roofline_tps = hbm_gbps() * 1e9 / step_bytes * args.batch

    # Tensor-core bound: a decode product computes whole row tiles, so below
    # the tile the dense stack costs 2 * rows * sum(K * N) a step whatever
    # the weights' type; int8 activations run at the int8 peak.
    rows = matmul_rows(args.batch, args.weights != "bf16")
    rate = chip_int8_tops() if args.act == "int8" else chip_sol_tflops()
    mxu_s = 2.0 * rows * _dense_matmul_params(params) / (rate * 1e12)
    hbm_s = step_bytes / (hbm_gbps() * 1e9)
    bound_s = max(mxu_s, hbm_s)
    print(json.dumps({
        "metric": (f"decode_tokens_per_s_{args.model}_w{args.weights}"
                   + ("a8" if args.act == "int8" else "")
                   + f"_kv{args.kv}"
                   + ("i8" if args.attn_int8 else "")
                   + (f"_w{cfg.sliding_window}" if cfg.sliding_window else "")),
        "value": round(tps, 2),
        "unit": "tokens/s/card",
        "ms_per_step": round(ms_per_step, 3),
        "batch": args.batch,
        "context": args.context,
        "tokens_per_s_per_seq": round(tps / args.batch, 2),
        "hbm_roofline_tokens_per_s": round(roofline_tps, 2),
        "pct_of_roofline": round(100 * tps / roofline_tps, 2),
        "hbm_bound_ms": round(hbm_s * 1e3, 3),
        "mxu_bound_ms": round(mxu_s * 1e3, 3),
        "matmul_rows": rows,
        "binding_constraint": "tensor_core_padding" if mxu_s > hbm_s else "hbm",
        "pct_of_bound": round(100 * bound_s / (dt / args.steps), 2),
        "step_mode": ("scan" if args.scan else f"unroll{args.unroll}"
                      if args.unroll > 1 else "step"),
        "graphs": graphs.graphs,
        "param_gb": round(pbytes / 1e9, 3),
        "step_gb": round(step_bytes / 1e9, 3),
        "cache_gb": round(cbytes / 1e9, 3),
        "device": device_kind(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
