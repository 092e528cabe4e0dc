"""Headline benchmark: flash-attention TFLOP/s at seq 4096, d_head 128, bf16, on the card.

Counterpart of the repository's root ``bench.py`` (the JAX package's), with
its keys. Prints ONE JSON line. ``value`` is K1's attention TFLOP/s through
``flash_forward`` with ``KernelConfig.for_shape(4096, 4096, heads=16,
kv_heads=16)`` at b 16 (``BATCH_SIZE_FOR_SEQ_LEN[4096]``), 16 heads, no
mask, on the FLOP model ``4 s^2 d + 6 s^2`` a head (``calc_self_attn_flop``).
``vs_baseline`` is ours over PyTorch's ``scaled_dot_product_attention`` at
the same shape (``baseline_sdpa_tflops``), the role JAX's production TPU
flash kernel plays in the root ``bench.py``; ``pct_of_sol`` is against the
bf16 peak of an H100 SXM (``sol_tflops``, 989). Both are timed as the root
``bench.py`` times: a chain of calls, each call's output the next call's Q,
at two chain lengths (``dispatch.chain_runtime``), the slope taken, so a
fixed cost per chain drops out. ``device`` is the card's name and power
limit (``utils/chip.py::device_kind``). The root ``bench.py`` prints an error
line when its chip is unreachable; this one raises without a card.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.bench
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .dispatch import chain_runtime
from .ops.configs import KernelConfig, calc_self_attn_flop
from .ops.flash_forward import flash_forward
from .utils.chip import chip_sol_tflops, device_kind
from .utils.device import resolve_device
from .utils.testing import BATCH_SIZE_FOR_SEQ_LEN, generate_qkv

__all__ = ["main", "slope_seconds", "METRIC", "CHAIN_LENGTHS"]

METRIC = "attn_tflops_seq4096_d128_bf16"
CHAIN_LENGTHS = (8, 24)


def slope_seconds(step, q, k, v, lengths=CHAIN_LENGTHS, iters: int = 7) -> float:
    """Seconds a call of ``step(x, k, v)``: the slope between chains of
    ``lengths`` calls (``chain_runtime``, median of ``iters`` samples)."""
    n1, n2 = lengths
    t1 = chain_runtime(step, q, k, v, steps=n1, iters=iters) * n1
    t2 = chain_runtime(step, q, k, v, steps=n2, iters=iters) * n2
    return (t2 - t1) / (n2 - n1)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve_device("cuda")
    seq, d_head, heads = 4096, 128, 16
    batch = BATCH_SIZE_FOR_SEQ_LEN[seq]
    q, k, v = generate_qkv(seq, d_head=d_head, n_heads=heads, batch=batch, device=dev)
    cfg = KernelConfig.for_shape(seq, seq, heads=heads, kv_heads=heads)
    flops = calc_self_attn_flop(seq, d_head, heads, batch)
    secs = slope_seconds(lambda x, k_, v_: flash_forward(x, k_, v_, cfg), q, k, v)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    base_secs = slope_seconds(lambda x, k_, v_: sdpa(x, k_, v_), q, k, v)
    tflops = flops / secs / 1e12
    baseline = flops / base_secs / 1e12
    sol = chip_sol_tflops()
    print(json.dumps({
        "metric": METRIC,
        "value": round(tflops, 2),
        "unit": "TFLOP/s",
        "vs_baseline": round(tflops / baseline, 4),
        "baseline_sdpa_tflops": round(baseline, 2),
        "pct_of_sol": round(100.0 * tflops / sol, 2),
        "sol_tflops": sol,
        "config": cfg.short_form(),
        "ms_per_call": round(secs * 1e3, 4),
        "device": device_kind(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
