"""Autotuner: time each candidate config on the card and rank them.

Counterpart of ``flash_attention_from_scratch_tpu/tools/autotune.py``.
``--kernels`` picks configs as the JAX tool does (``tune``, the pruned
autotuning sweep, by default; ``prog`` | ``all`` | ``'<bq>,<bkv>'`` | short
forms separated by ``;``), filtered by ``--dtype``. On Hopper the TPU's
knobs select no kernel, so the configs that share a launch
(``bench_attention.launch_key``) are timed once and share its figures, and
every row names its kernel: ``tune``'s configs are all K1 (bf16; fp16 and
fp32 run from their libraries). A config the wrapper refuses (its
``ValueError``) gives a row with the refusal as its ``error``, as the JAX
tool records a failed compile; a kernel fault raises. Timing is CUDA events
(``dispatch.median_runtime``); a row's ``first_call_s`` is its launch's first
call (the kernel's build, the first time, and one run).

The JAX tool's guard against impossible figures stays
(:func:`guarded_seconds`): a time implying more than 1.05x the card's
measured bf16 matmul rate (x2 for int8 and fp8, as JAX scales it) is
measured once more, the slower kept; a row still above it is marked a timing
artifact with 0 TFLOP/s. Rows are sorted by TFLOP/s; their ``config``
column round-trips through ``parse_short_form``. On the card only: raises
without one. Prints the table; ``--csv`` also writes it.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.autotune \\
        --seq 4096 --heads 16 --batch 16 --kernels tune --csv profiles/traces/autotune.csv
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import json
import os
import sys
import time

import torch

from ..dispatch import median_runtime
from ..ops.configs import DType, calc_self_attn_flop, get_kernel_configs
from ..ops.flash_forward import flash_forward
from ..utils.chip import chip_sol_tflops, device_kind, measured_matmul_tflops
from ..utils.device import resolve_device
from ..utils.testing import generate_qkv
from .bench_attention import kernel_of, launch_key

__all__ = ["tune", "guarded_seconds", "main"]

ARTIFACT_FACTOR = 1.05  # a time above this share of the ceiling is an artifact


def guarded_seconds(measure, flops: float, ceiling_tflops: float) -> tuple[float, str]:
    """(seconds, error) of ``measure()``: if the time implies more than
    ``ceiling_tflops``, measured once more and the slower kept; if that is
    still above, error names the timing artifact."""
    secs = measure()
    if flops / secs / 1e12 > ceiling_tflops:
        secs = max(secs, measure())
    tflops = flops / secs / 1e12
    if tflops > ceiling_tflops:
        return secs, f"timing artifact: {tflops:.1f} TFLOP/s > ceiling {ceiling_tflops:.1f}"
    return secs, ""


def tune(configs, seq: int, heads: int, batch: int, iters: int = 7, log=print):
    """Rows of every config that tiles ``seq`` (JAX's rule), sorted by
    TFLOP/s, each launch timed once. On the card only: raises without one."""
    groups: dict[DType, list] = {}
    for cfg in configs:
        groups.setdefault(cfg.dtype, []).append(cfg)
    rows = []
    for dtype, cfgs in groups.items():
        rate = 2.0 if dtype.bytes == 1 else 1.0  # 8-bit tensor cores: twice bf16's rate
        ceiling = measured_matmul_tflops() * rate * ARTIFACT_FACTOR
        q, k, v = generate_qkv(seq, d_head=cfgs[0].d_head, n_heads=heads, batch=batch,
                               dtype=dtype.torch_dtype)
        launches: dict[tuple, dict] = {}
        for cfg in cfgs:
            if seq % cfg.block_q or seq % cfg.block_kv:
                continue
            flops = calc_self_attn_flop(seq, cfg.d_head, heads, batch)
            key = launch_key(cfg)
            if key not in launches:
                launches[key] = _time_launch(cfg, q, k, v, flops, ceiling, iters)
                r = launches[key]
                log(f"  {kernel_of(cfg):<24} {cfg.short_form()}: "
                    + (f"{r['ms']:8.3f} ms {r['tflops']:7.2f} TFLOP/s" if not r["error"]
                       else r["error"]))
            rows.append({"config": cfg.short_form(), **launches[key]})
        del q, k, v
    rows.sort(key=lambda r: -r["tflops"])
    return rows


def _time_launch(cfg, q, k, v, flops: float, ceiling: float, iters: int) -> dict:
    """One launch's row fields; a launch the card refuses is a row with its
    error, as a failed compile is in the JAX tool."""
    kernel = kernel_of(cfg)
    try:
        t0 = time.perf_counter()
        flash_forward(q, k, v, cfg)
        if q.is_cuda:
            torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t0
        secs, error = guarded_seconds(
            lambda: median_runtime(lambda: flash_forward(q, k, v, cfg), iters=iters),
            flops, ceiling)
    except ValueError as e:  # the wrapper refuses the inputs; a kernel fault raises
        return dict(kernel=kernel, ms=None, tflops=0.0, pct_sol=0.0, first_call_s=None,
                    error=f"{type(e).__name__}: {str(e)[:200]}")
    tflops = 0.0 if error else flops / secs / 1e12
    return dict(kernel=kernel, ms=round(secs * 1e3, 4), tflops=round(tflops, 2),
                pct_sol=round(100 * tflops / chip_sol_tflops(), 2),
                first_call_s=round(first_call_s, 3), error=error)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--kernels", default="tune",
                    help="prog | all | tune | '<block_q>,<block_kv>' | 'fa_...;fa_...'")
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--json", action="store_true", help="also one JSON line per row")
    ap.add_argument("--csv", default=None, help="write the rows here")
    args = ap.parse_args(argv)

    resolve_device("cuda")
    dtype = DType.from_short(args.dtype)
    configs = [c for c in get_kernel_configs(args.kernels) if c.dtype == dtype]
    print(f"device={device_kind()} bf16 peak={chip_sol_tflops()} TFLOP/s timing=cuda_events")
    print(f"tuning {len(configs)} configs at seq={args.seq} heads={args.heads} "
          f"batch={args.batch} dtype={dtype.short}")
    rows = tune(configs, args.seq, args.heads, args.batch, iters=args.iters)
    mm = measured_matmul_tflops()
    print(f"\nmeasured matmul rate: {mm:.1f} TFLOP/s")
    print(f"{'config':<48} {'kernel':<24} {'ms':>9} {'TFLOP/s':>8} {'%SoL':>6} {'%mm':>6}")
    for r in rows[:20]:
        print(f"{r['config']:<48} {r['kernel']:<24} {r['ms'] or float('nan'):>9} "
              f"{r['tflops']:>8} {r['pct_sol']:>6} {100 * r['tflops'] / mm:>6.2f}")
    if args.json:
        for r in rows:
            print(json.dumps(r))
    if args.csv and not rows:
        print("no configs ran (dtype filter / tileability); CSV not written")
    elif args.csv:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        with open(args.csv, "w", newline="") as f:
            w = csv_mod.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
