"""Training throughput: a Llama train step's tokens/s and model FLOPs utilization.

Counterpart of ``flash_attention_from_scratch_tpu/tools/bench_train.py``.
The whole training path runs: the flash forward with its LSE (K1), the
causal backward (K3 by default, ``ops/flash_backward.py::fused_choice``),
the dense products and their gradients (cuBLAS) and AdamW. The config comes
from the JAX tool's arguments and defaults (``config_from_args``: its
``d_head`` rule, dim / heads floored at 128); the random weights from a
seeded ``torch.Generator`` (``models/llama.py::init_params``), the tokens
too. ``--warmup`` steps, then ``--steps`` timed on the host between two
``torch.cuda.synchronize()``. The FLOP model is the JAX tool's
(``train_flops``): 6 x matmul parameters x tokens, plus the causal
attention at 3.5x its forward; MFU is against the bf16 peak of 989 TFLOP/s
(``utils/chip.py::chip_sol_tflops``). Prints one JSON line with the JAX
tool's keys. On the card only: raises without one.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_train \\
        --dim 4096 --layers 8 --heads 32 --kv-heads 8 --hidden 14336 \\
        --vocab 128256 --seq 2048 --batch 2 --steps 3 --warmup 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..models.llama import LlamaConfig, init_params
from ..models.train import make_optimizer, make_train_step
from ..utils.chip import chip_sol_tflops, device_kind
from ..utils.device import resolve_device

__all__ = ["train_flops", "config_from_args", "parser", "run", "main"]


def train_flops(cfg: LlamaConfig, batch: int, seq: int) -> float:
    """Forward plus backward FLOPs of one step: 6 x matmul parameters x
    tokens (the LM head, not the embedding gather) plus the causal
    attention's forward (two products, half the pairs) x 3.5 a layer. The
    JAX tool's formula."""
    n_params = cfg.vocab_size * cfg.dim + cfg.n_layers * (
        cfg.dim * cfg.n_heads * cfg.d_head * 2
        + cfg.dim * cfg.n_kv_heads * cfg.d_head * 2
        + 3 * cfg.dim * cfg.hidden_dim)
    attn_fwd = 2 * 2 * seq * seq * cfg.d_head * cfg.n_heads * batch / 2
    return 6 * n_params * batch * seq + attn_fwd * 3.5 * cfg.n_layers


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dim", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=8192)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=2)
    return ap


def config_from_args(args) -> LlamaConfig:
    """The JAX tool's model config from its arguments: d_head = dim /
    heads, at least 128."""
    return LlamaConfig(
        vocab_size=args.vocab, dim=args.dim, n_layers=args.layers, n_heads=args.heads,
        n_kv_heads=args.kv_heads, d_head=max(args.dim // args.heads, 128),
        hidden_dim=args.hidden)


def run(args) -> dict:
    """Build, warm up and time the steps on the card: the result line.
    Raises without a card."""
    dev = resolve_device("cuda")
    cfg = config_from_args(args)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq + 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    step = make_train_step(cfg, make_optimizer(params))
    for _ in range(args.warmup):
        loss = step(params, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = step(params, tokens)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / args.steps
    tflops = train_flops(cfg, args.batch, args.seq) / per_step / 1e12
    return {
        "metric": "train_step_mfu", "value": round(100 * tflops / chip_sol_tflops(), 2),
        "unit": "% MFU", "model_tflops_per_s": round(tflops, 2),
        "tokens_per_s": round(args.batch * args.seq / per_step, 1),
        "ms_per_step": round(per_step * 1e3, 2), "loss": round(float(loss), 4),
        "dim": args.dim, "layers": args.layers, "seq": args.seq, "batch": args.batch,
        "device": device_kind(),
    }


def main(argv=None):
    print(json.dumps(run(parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
