"""Quantized prefill attention bench (K10): TFLOP/s per variant, and numerics.

Counterpart of ``flash_attention_from_scratch_tpu/tools/bench_quant.py``:

  * **Timing**: ``flash_forward_quantized`` per variant of ``VARIANTS``
    (the int8-compute path and the upcast paths), timed with CUDA events
    (``dispatch.median_runtime``). TFLOP/s is on the bf16 FLOP model
    (``calc_self_attn_flop``), the rate a bf16 user sees when switching,
    beside the card's measured bf16 matmul rate (``utils/chip.py``). The
    Hopper kernel's tiles are constants, so each (variant, seq) gives one
    row; the JAX tool's tile sweep has no counterpart.
  * **Numerics**: the adaptive 2x rule of each variant's output against the
    bf16 reference on the dequantized inputs, with the fp32 reference on
    the unquantized inputs as the baseline, and the quantization noise
    reported beside it.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_quant \\
        --seq-lens 2048,4096,8192 --csv chiprun_out/quant_prefill.csv
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import os
import subprocess
import sys

import torch

from ..dispatch import median_runtime
from ..ops.configs import calc_self_attn_flop
from ..ops.flash_quant import I8_P_GROUP, flash_forward_quantized
from ..ops.quant import QTensor, dequantize, quantize_kv
from ..ops.reference import reference_attention
from ..utils.chip import device_kind, measured_matmul_tflops
from ..utils.device import resolve_device
from ..utils.testing import (
    BATCH_SIZE_FOR_SEQ_LEN, BENCHMARK_N_HEADS, adaptive_tolerance_check, generate_qkv,
    make_qkv,
)

__all__ = ["VARIANTS", "CHECK_VARIANTS", "DEFAULT_SEQ_LENS", "bench_inputs",
           "quantize_inputs", "bench_quant", "numerics_check", "main"]

DEFAULT_SEQ_LENS = (2048, 4096, 8192)

# (K/V mode, Q kind, int8_compute) per variant. fp8 Q/K/V and bf16 Q with
# int8 K/V run the upcast path: storage savings at the bf16 compute rate.
VARIANTS = {
    "int8c": ("int8", "int8", True),     # both products in int8
    "int8u": ("int8", "int8", False),    # the same tensors, upcast products
    "int8kv": ("int8", "bf16", False),   # bf16 Q, int8 K/V storage
    "fp8": ("fp8", "fp8", False),        # fp8 Q/K/V storage, bf16 products
}
# The timed variants and bf16 Q over int4 K/V: every kind of K/V tile the
# kernel converts, which its checks cover.
CHECK_VARIANTS = {**VARIANTS, "int4kv": ("int4", "bf16", False)}
# The kernel's tiles (csrc/flash_quant.cu): 64 Q rows per CTA; 64 keys per
# tile upcast, 128 (one P quantization group) in int8.
_BLOCK_Q, _BLOCK_KV = 64, 64

CSV_FIELDS = ["variant", "mode", "seq", "batch", "heads", "block_q", "block_kv",
              "kv_splits", "tflops", "pct_bf16_ceiling", "adaptive_ok",
              "kernel_err", "bf16_baseline_err", "quant_err", "timing", "commit"]


def _git_commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, timeout=30,
                              cwd=os.path.dirname(__file__)).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def quantize_inputs(q, k, v, variant: str):
    """Dense Q, K, V as ``variant`` of ``CHECK_VARIANTS`` hands them to
    ``flash_forward_quantized``: (Q or its QTensor, K and V QTensors)."""
    kv_mode, q_kind, _ = CHECK_VARIANTS[variant]
    qq = q if q_kind == "bf16" else quantize_kv(q, q_kind)
    return qq, quantize_kv(k, kv_mode), quantize_kv(v, kv_mode)


def bench_inputs(seq: int, heads: int = BENCHMARK_N_HEADS, device="cuda"):
    """The bf16 Q, K, V (b, heads, seq, 128) that :func:`bench_quant` times
    at ``seq``, as the JAX tool makes them: ``generate_qkv`` (batch from
    ``BATCH_SIZE_FOR_SEQ_LEN``; drawn on ``device``)."""
    return generate_qkv(seq, n_heads=heads, batch=BATCH_SIZE_FOR_SEQ_LEN.get(seq, 4),
                        device=device)


def bench_quant(seq_lens, heads: int = BENCHMARK_N_HEADS, variants=None,
                iters: int = 5, log=print):
    """One row per (variant, seq): ms and TFLOP/s on the bf16 FLOP model,
    and the share of the card's measured bf16 matmul rate. On the card
    only: raises without one."""
    dev = resolve_device("cuda")
    mm = measured_matmul_tflops()
    rows = []
    for seq in seq_lens:
        q, k, v = bench_inputs(seq, heads, dev)
        batch = q.shape[0]
        flops = calc_self_attn_flop(seq, q.shape[-1], heads, batch)
        for name in variants or VARIANTS:
            mode, _, i8c = VARIANTS[name]
            qq, kq, vq = quantize_inputs(q, k, v, name)
            secs = median_runtime(
                lambda: flash_forward_quantized(qq, kq, vq, int8_compute=i8c),
                iters=iters)
            tf = flops / secs / 1e12
            rows.append(dict(variant=name, mode=mode, seq=seq, batch=batch,
                             heads=heads, block_q=_BLOCK_Q,
                             block_kv=I8_P_GROUP if i8c else _BLOCK_KV,
                             kv_splits=1, ms=secs * 1e3, tflops=round(tf, 2),
                             pct_bf16_ceiling=round(100 * tf / mm, 2)))
            log(f"seq {seq} {name}: {secs * 1e3:.3f} ms, {tf:.1f} TFLOP/s "
                f"({rows[-1]['pct_bf16_ceiling']}% of the bf16 matmul rate)")
            del qq, kq, vq
    return rows


def numerics_check(seq: int = 1024, heads: int = 4, batch: int = 1, log=print,
                   device="cuda"):
    """The adaptive 2x rule for every variant.

    Kernel error is measured against the bf16 reference on the
    dequantized inputs (the kernel's own function), with the fp32
    reference on the unquantized inputs as the baseline; the quantization
    noise (dequantized reference vs the fp32 one) is reported as
    ``quant_err``. The int8-compute path also rounds P to int8 at the
    constant 127, which must fit inside the rule's 2x headroom. ``device``
    "cpu" runs the plain version.
    """
    dev = resolve_device(device)
    qf, kf, vf = (torch.from_numpy(x).to(dev) for x in make_qkv(batch, heads, seq,
                                                                seed=3))
    q, k, v = (t.bfloat16() for t in (qf, kf, vf))
    ref_fp32 = reference_attention(qf, kf, vf)
    rows = []
    for name, (mode, _, i8c) in VARIANTS.items():
        qq, kq, vq = quantize_inputs(q, k, v, name)
        out = flash_forward_quantized(qq, kq, vq, int8_compute=i8c)
        qd = dequantize(qq) if isinstance(qq, QTensor) else qq
        ref_deq = reference_attention(qd, dequantize(kq), dequantize(vq))
        ok, kerr, berr = adaptive_tolerance_check(out, ref_deq, ref_fp32, factor=2.0)
        quant_err = float((ref_deq.float() - ref_fp32).abs().max())
        rows.append(dict(variant=name, mode=mode, seq=seq, adaptive_ok=bool(ok),
                         kernel_err=round(kerr, 6), bf16_baseline_err=round(berr, 6),
                         quant_err=round(quant_err, 6)))
        log(f"numerics {name}: ok={ok} kernel_err={kerr:.2e} "
            f"baseline={berr:.2e} quant_noise={quant_err:.2e}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq-lens", default=",".join(map(str, DEFAULT_SEQ_LENS)))
    ap.add_argument("--heads", type=int, default=BENCHMARK_N_HEADS)
    ap.add_argument("--variants", default=None,
                    help="comma list from: " + ",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--skip-numerics", action="store_true")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    seq_lens = [int(s) for s in args.seq_lens.split(",")]
    variants = args.variants.split(",") if args.variants else None

    resolve_device("cuda")
    print(f"device: {device_kind()}, bf16 matmul rate "
          f"{measured_matmul_tflops():.1f} TFLOP/s")
    rows = bench_quant(seq_lens, heads=args.heads, variants=variants,
                       iters=args.iters)
    nrows = [] if args.skip_numerics else numerics_check()
    if args.csv:
        commit = _git_commit()
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        with open(args.csv, "w", newline="") as f:
            w = csv_mod.DictWriter(f, fieldnames=CSV_FIELDS, extrasaction="ignore")
            w.writeheader()
            for r in rows:
                w.writerow({**r, "timing": "cuda_events", "commit": commit})
            for r in nrows:
                w.writerow({**r, "timing": "numerics", "commit": commit})
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
