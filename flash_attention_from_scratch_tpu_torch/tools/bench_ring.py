"""Ring attention's compute-side overhead, measured on one card.

Counterpart of ``flash_attention_from_scratch_tpu/tools/bench_ring.py``.
Each rank of a P-way ring runs P hop kernels (K1) on (L/P x L/P) tiles and
P - 1 LSE merges (``parallel/ring_attention.py::_merge``) for its Q shard,
in place of one (L x L) kernel. This tool runs that work for all P Q
shards with every shard resident on one card (the same total work as the
monolithic call, so TFLOP/s compare directly) and times it against one K1
call on the whole sequence, non-causal, as the JAX tool does. What it cannot
see is the transfer between ranks. The timer is CUDA events
(``dispatch.median_runtime``): a local card needs no chain timer. The rows
keep the JAX tool's CSV keys.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_ring \\
        --seq 8192 --shards 2,4,8 --heads 32 --json
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import json
import sys

import torch

from ..dispatch import median_runtime
from ..ops.configs import KernelConfig, calc_self_attn_flop
from ..ops.flash_forward import flash_forward, flash_forward_with_lse
from ..parallel.ring_attention import _merge
from ..utils.chip import device_kind, measured_matmul_tflops
from ..utils.device import resolve_device
from ..utils.testing import BATCH_SIZE_FOR_SEQ_LEN, BENCHMARK_N_HEADS, generate_qkv
from .bench_quant import _git_commit

__all__ = ["bench_ring_sim", "ring_sim_step", "main"]


def ring_sim_step(cfg: KernelConfig, n_shards: int, shard_len: int):
    """``step(q, k, v)``: every Q shard's ring work (n_shards hop kernels
    and n_shards - 1 merges), the shards' outputs concatenated."""

    def step(q, k, v):
        outs = []
        for qi in range(n_shards):
            qs = q[:, :, qi * shard_len:(qi + 1) * shard_len]
            o_acc = lse_acc = None
            for hop in range(n_shards):
                rows = slice(hop * shard_len, (hop + 1) * shard_len)
                o, lse = flash_forward_with_lse(qs, k[:, :, rows], v[:, :, rows], cfg)
                if o_acc is None:
                    o_acc, lse_acc = o.float(), lse
                else:
                    o_acc, lse_acc = _merge(o_acc, lse_acc, o.float(), lse)
            outs.append(o_acc.to(q.dtype))
        return torch.cat(outs, dim=2)

    return step


def bench_ring_sim(seq: int, shards_list, heads: int = BENCHMARK_N_HEADS, iters: int = 5,
                   device="cuda", log=print) -> list[dict]:
    """Rows (the JAX tool's keys) for one monolithic K1 call (shards 1) and
    the ring's compute side at each shard count, plus each ring's largest
    difference from the monolithic output (``max_abs_diff``) and that
    output's largest value (``max_abs_ref``)."""
    dev = resolve_device(device)
    batch = BATCH_SIZE_FOR_SEQ_LEN.get(seq, 4)
    q, k, v = generate_qkv(seq, n_heads=heads, batch=batch, device=dev)
    flops = calc_self_attn_flop(seq, 128, heads, batch)
    mm = measured_matmul_tflops()
    cfg = KernelConfig()
    mono = flash_forward(q, k, v, cfg)
    mono_s = median_runtime(lambda: flash_forward(q, k, v, cfg), iters=iters)
    rows = [{"seq": seq, "batch": batch, "heads": heads, "shards": 1,
             "config": cfg.short_form(), "ms": mono_s * 1e3,
             "tflops": flops / mono_s / 1e12, "overhead_pct": 0.0,
             "pct_matmul_ceiling": 100 * flops / mono_s / 1e12 / mm, "max_abs_diff": 0.0,
             "max_abs_ref": float(mono.float().abs().max())}]
    log(f"  monolithic          {mono_s * 1e3:9.3f} ms {rows[0]['tflops']:7.2f} TFLOP/s")
    for n in shards_list:
        step = ring_sim_step(cfg, n, seq // n)
        diff = float((step(q, k, v).float() - mono.float()).abs().max())
        secs = median_runtime(lambda: step(q, k, v), iters=iters)
        tf = flops / secs / 1e12
        rows.append({"seq": seq, "batch": batch, "heads": heads, "shards": n,
                     "config": cfg.short_form(), "ms": secs * 1e3, "tflops": tf,
                     "overhead_pct": 100.0 * (secs - mono_s) / mono_s,
                     "pct_matmul_ceiling": 100 * tf / mm, "max_abs_diff": diff,
                     "max_abs_ref": rows[0]["max_abs_ref"]})
        log(f"  ring-sim {n}-shard   {secs * 1e3:9.3f} ms {tf:7.2f} TFLOP/s "
            f"(+{rows[-1]['overhead_pct']:.1f}% vs monolithic)")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--shards", default="2,4")
    ap.add_argument("--heads", type=int, default=BENCHMARK_N_HEADS)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--csv", default=None)
    ap.add_argument("--json", action="store_true",
                    help="end with one JSON line: the rows and the card")
    args = ap.parse_args(argv)
    resolve_device("cuda")
    kind = device_kind()
    print(f"device={kind} commit={_git_commit()} timing=cuda_events")
    rows = bench_ring_sim(args.seq, [int(s) for s in args.shards.split(",")],
                          heads=args.heads, iters=args.iters)
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv_mod.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    if args.json:
        print(json.dumps({"rows": rows, "device": kind}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
