"""Short-sequence sweep: K1's launch knobs and K11's ring depths at seq 512-1024.

Counterpart of ``flash_attention_from_scratch_tpu/tools/tune_short_seq.py``.
The JAX tool sweeps ``fold_batch`` / ``head_pack`` / ``q_splits`` / block
sizes at the short end of the sequence table, knobs that select no kernel
on Hopper (``ops/configs.py``: TPU hints). What the card does run differently
there is K1's launch and the choice of the other kernel that computes the
same function, so :func:`candidates` returns those:

- K1's ``ctas`` (``ops/flash_forward.py::_launch``): 0 launches one CTA a
  work item (a plain grid); a count launches that many persistent CTAs (at
  most the items), against ``grid_plan``'s default of one an SM. The
  counts tried are half the SMs, the fewest with the default's number of
  rounds (every round full), and the SMs;
- K11 at ring depths 1-4.

Each candidate is timed with CUDA events (``dispatch.median_runtime``) on
``generate_qkv`` inputs (bf16, d 128, ``--heads`` heads, no mask, batch from
``BATCH_SIZE_FOR_SEQ_LEN``), and PyTorch's ``scaled_dot_product_attention``
at the same shape is the control row. Rows carry the JAX tool's keys
(``config``, ``ms``, ``tflops``, ``pct_sol``, ``first_call_s``, ``error``,
``seq``) and the share of the card's measured matmul rate (``pct_matmul``)
and the ratio to SDPA (``vs_sdpa``). Nothing here changes a default. On the
card only: raises without one.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.tune_short_seq \\
        --seq-lens 512,1024 --csv profiles/traces/short_seq.csv
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
from ..ops.configs import KernelConfig, KVLoop, calc_self_attn_flop
from ..ops.flash_forward import KERNEL, KERNEL_FORI, _launch, grid_plan
from ..utils.chip import chip_sol_tflops, device_kind, measured_matmul_tflops
from ..utils.device import resolve_device, sm_count
from ..utils.testing import BATCH_SIZE_FOR_SEQ_LEN, generate_qkv

__all__ = ["candidates", "label", "main", "SDPA", "LAUNCH_KNOBS"]

SDPA = "sdpa"
LAUNCH_KNOBS = ("kernel", "ctas", "num_kv_buffers")  # what a candidate may set


def candidates(seq: int, heads: int = 16, batch: int | None = None,
               sms: int | None = None, d_head: int = 128) -> list[dict]:
    """K1's launch knobs and K11's depths at one short seq (no mask):
    dicts of :data:`LAUNCH_KNOBS` only, K1's first (its default, one CTA
    an SM, among them). ``sms`` defaults to the card's SM count."""
    batch = batch or BATCH_SIZE_FOR_SEQ_LEN.get(seq, 16)
    sms = sms or sm_count(resolve_device("cuda"))
    items = grid_plan(batch, heads, seq, seq, False, 0, 0, sms, d_head).n_items
    rounds = -(-items // sms)
    ctas = sorted({min(c, items) for c in (sms // 2, -(-items // rounds), sms)})
    out = [{"kernel": KERNEL, "ctas": 0}] + [{"kernel": KERNEL, "ctas": c} for c in ctas]
    out += [{"kernel": KERNEL_FORI, "num_kv_buffers": nb} for nb in (1, 2, 3, 4)]
    return out


def label(cand: dict, default_ctas: int | None = None) -> str:
    """A candidate's row name: ``K1 ctas=132 (default)``, ``K1 grid``,
    ``K11 depth 2``."""
    if cand["kernel"] == KERNEL_FORI:
        return f"K11 depth {cand['num_kv_buffers']}"
    if cand["ctas"] == 0:
        return "K1 grid"
    return f"K1 ctas={cand['ctas']}" + (" (default)" if cand["ctas"] == default_ctas else "")


def _call(cand: dict, q, k, v):
    """A zero-argument call that runs ``cand`` on (q, k, v)."""
    if cand["kernel"] == KERNEL_FORI:
        cfg = KernelConfig(kv_loop=KVLoop.FORI, num_kv_buffers=cand["num_kv_buffers"])
        return lambda: _launch(q, k, v, cfg, None, False)
    return lambda: _launch(q, k, v, KernelConfig(), None, False, ctas=cand["ctas"])


def _row(name: str, fn, flops: float, mm: float, iters: int) -> dict:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    secs = median_runtime(fn, iters=iters)
    tflops = flops / secs / 1e12
    return dict(config=name, ms=round(secs * 1e3, 4), tflops=round(tflops, 2),
                pct_sol=round(100 * tflops / chip_sol_tflops(), 2),
                pct_matmul=round(100 * tflops / mm, 2), first_call_s=round(first, 3),
                error="")


def sweep(seq: int, heads: int = 16, iters: int = 5, log=print) -> list[dict]:
    """Rows of every candidate and the SDPA control at ``seq``, sorted by
    TFLOP/s; each has ``vs_sdpa``. On the card only: raises without one."""
    dev = resolve_device("cuda")
    batch = BATCH_SIZE_FOR_SEQ_LEN.get(seq, 16)
    sms = sm_count(dev)
    mm = measured_matmul_tflops()
    default = grid_plan(batch, heads, seq, seq, False, 0, 0, sms, 128).ctas
    q, k, v = generate_qkv(seq, n_heads=heads, batch=batch, device=dev)
    flops = calc_self_attn_flop(seq, 128, heads, batch)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = [dict(_row(SDPA, lambda: sdpa(q, k, v), flops, mm, iters), kernel=SDPA)]
    for cand in candidates(seq, heads, batch, sms):
        rows.append(dict(_row(label(cand, default), _call(cand, q, k, v), flops, mm, iters),
                         **cand))
    base = rows[0]["tflops"]
    for r in rows:
        r.update(seq=seq, batch=batch, heads=heads, vs_sdpa=round(r["tflops"] / base, 4))
        log(f"  seq {seq} {r['config']:<22} {r['ms']:9.4f} ms {r['tflops']:8.2f} TFLOP/s "
            f"({r['pct_matmul']:5.1f}% mm, {r['vs_sdpa']:.3f}x SDPA)")
    del q, k, v
    return sorted(rows, key=lambda r: -r["tflops"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq-lens", default="512,1024")
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--json", action="store_true", help="also one JSON line per row")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)

    sms = sm_count(resolve_device("cuda"))
    mm = measured_matmul_tflops()
    print(f"device={device_kind()} measured matmul rate={mm:.1f} TFLOP/s timing=cuda_events")
    print("fold_batch, head_pack, q_splits and block sizes select no kernel on Hopper: "
          "the candidates are K1's CTA counts and K11's ring depths")
    all_rows = []
    for seq in [int(s) for s in args.seq_lens.split(",")]:
        n = len(candidates(seq, args.heads, sms=sms))
        print(f"seq {seq}: {n} candidates + the SDPA control")
        rows = sweep(seq, args.heads, args.iters)
        all_rows.extend(rows[:args.top])
        for r in rows[:args.top]:
            print(f"  {r['config']:<22} {r['tflops']:>8.2f} TFLOP/s "
                  f"({r['pct_matmul']:5.1f}% mm, {r['vs_sdpa']:.3f}x SDPA)")
            if args.json:
                print(json.dumps(r))
    if args.csv and all_rows:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        fields = list(dict.fromkeys(k for r in all_rows for k in r))
        with open(args.csv, "w", newline="") as f:
            w = csv_mod.DictWriter(f, fieldnames=fields)
            w.writeheader()
            w.writerows(all_rows)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
