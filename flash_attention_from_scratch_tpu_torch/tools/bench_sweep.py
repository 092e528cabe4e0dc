"""Per-seq headline sweep: the best-known config against PyTorch's SDPA.

Counterpart of ``flash_attention_from_scratch_tpu/tools/bench_sweep.py``:
one row a sequence length with ``KernelConfig.for_shape``'s config run by
the port's ``flash_forward`` (K1 on the card: its TPU knobs select no
kernel), the baseline at the same shape, the share of the card's measured
bf16 matmul rate and of the 989 TFLOP/s peak, and harmonic means over the
sweep. The JAX tool's baseline is the TPU's production flash kernel; here
that role goes to PyTorch's ``scaled_dot_product_attention``, timed as
``bench_attention --baseline`` times it, so the column is
``baseline_sdpa_tflops``. Batch per seq from ``BATCH_SIZE_FOR_SEQ_LEN``.
Timing is CUDA events (``dispatch.median_runtime``). On the card only:
raises without one. Prints the rows; ``--csv`` also writes them.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_sweep \\
        --seq-lens 512,1024,2048,4096,8192,16384 --csv profiles/traces/sweep.csv
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import json
import os
import statistics
import sys

from ..dispatch import median_runtime
from ..ops.configs import KernelConfig, calc_self_attn_flop
from ..ops.flash_forward import flash_forward
from ..utils.chip import chip_sol_tflops, device_kind, measured_matmul_tflops
from ..utils.device import resolve_device
from ..utils.testing import BATCH_SIZE_FOR_SEQ_LEN, generate_qkv
from .bench_attention import _sdpa, kernel_of
from .bench_ladder import DEFAULT_SEQ_LENS
from .bench_quant import _git_commit

__all__ = ["sweep", "main"]


def sweep(seq_lens, heads: int = 16, d_head: int = 128, iters: int = 7, log=print):
    """One row a seq: the port's kernel against SDPA and the card's
    measured matmul rate. On the card only: raises without one."""
    dev = resolve_device("cuda")
    mm, sol = measured_matmul_tflops(), chip_sol_tflops()
    rows = []
    for seq in seq_lens:
        batch = BATCH_SIZE_FOR_SEQ_LEN.get(seq, 4)
        q, k, v = generate_qkv(seq, d_head=d_head, n_heads=heads, batch=batch, device=dev)
        cfg = KernelConfig.for_shape(seq, seq, heads=heads, kv_heads=heads, d_head=d_head,
                                     batch=batch)
        flops = calc_self_attn_flop(seq, d_head, heads, batch)
        secs = median_runtime(lambda: flash_forward(q, k, v, cfg), iters=iters)
        ours = flops / secs / 1e12
        sdpa = _sdpa(cfg, seq, dev)
        base_secs = median_runtime(lambda: sdpa(q, k, v), iters=iters)
        base = flops / base_secs / 1e12
        rows.append({
            "seq": seq, "batch": batch, "heads": heads, "config": cfg.short_form(),
            "kernel": kernel_of(cfg), "ms": round(secs * 1e3, 4), "tflops": round(ours, 2),
            "baseline_sdpa_ms": round(base_secs * 1e3, 4),
            "baseline_sdpa_tflops": round(base, 2), "vs_baseline": round(ours / base, 4),
            "pct_matmul_ceiling": round(100 * ours / mm, 2),
            "pct_sol": round(100 * ours / sol, 2),
        })
        log(f"  seq {seq:>6} {cfg.short_form():<54} {secs * 1e3:9.3f} ms {ours:7.2f} "
            f"TFLOP/s ({rows[-1]['pct_matmul_ceiling']:5.1f}% mm, "
            f"{rows[-1]['vs_baseline']:4.2f}x sdpa)")
        del q, k, v
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq-lens", default=",".join(map(str, DEFAULT_SEQ_LENS)))
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--iters", type=int, default=7)
    ap.add_argument("--json", action="store_true", help="also one JSON line per seq")
    ap.add_argument("--csv", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    seq_lens = [int(s) for s in args.seq_lens.split(",")]

    resolve_device("cuda")
    mm = measured_matmul_tflops()
    device = device_kind()
    print(f"device={device} measured matmul rate={mm:.1f} TFLOP/s "
          f"bf16 peak={chip_sol_tflops()} timing=cuda_events")
    rows = sweep(seq_lens, heads=args.heads, iters=args.iters)
    ours = statistics.harmonic_mean([r["tflops"] for r in rows])
    base = statistics.harmonic_mean([r["baseline_sdpa_tflops"] for r in rows])
    print(f"\nharmonic mean: ours {ours:.1f} TFLOP/s ({100 * ours / mm:.1f}% of the "
          f"matmul rate), sdpa {base:.1f} -> {ours / base:.2f}x")
    commit = _git_commit()
    for r in rows:
        r.update(commit=commit, device=device)
        if args.json:
            print(json.dumps(r))
    if args.json:
        print(json.dumps({"harmonic_mean_tflops": round(ours, 2),
                          "harmonic_mean_sdpa_tflops": round(base, 2)}))
    if args.csv and rows:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        with open(args.csv, "w", newline="") as f:
            w = csv_mod.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
