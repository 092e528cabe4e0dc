"""Attention bench: a seq sweep of the forward kernels over JAX's configs, TFLOP/s, harmonic mean.

Counterpart of ``flash_attention_from_scratch_tpu/tools/bench_attention.py``.
``--kernels`` picks configs as the JAX tool does (``prog`` | ``all`` |
``tune`` | ``'<bq>,<bkv>'`` | short forms separated by ``;``, from
``ops/configs.py::get_kernel_configs``), filtered by ``--dtype`` and patched
by ``--causal``, ``--window`` and ``--fori`` as JAX's ``main`` patches them
(:func:`resolve_configs`). Each config runs the port's ``flash_forward`` on
(b, heads, seq, ``cfg.d_head``) inputs: K1, K11 at its ring depth for a
FORI config, or the row-band dispatch for a ``decompose`` one. The TPU's
block sizes and other knobs select no kernel here, so configs that share a
launch (:func:`launch_key`) are timed once and share its figures; every
row is keyed by ``cfg.short_form()`` and names the kernel it ran. JAX's
rules for skipping a seq stay (``seq`` a multiple of the config's TPU
blocks; a window shorter than ``seq``).

Timing is CUDA events (``dispatch.median_runtime``); ``--host-timing`` times
each call on the host between two ``torch.cuda.synchronize()`` instead.
``--grad`` times forward plus backward (``ops/autodiff.py::flash_attention``,
gradients for q, k and v: the backward's K2 or K3), on JAX's FLOP model:
x3.5 the forward's. TFLOP/s uses the JAX tool's FLOP model
(``calc_self_attn_flop``, or ``calc_causal_attn_flop`` over the visible
pairs); GB/s the forward's bytes: Q and O once, K and V once per KV tile
the launched kernel copies (its plan's keys a tile) and Q head.
``--baseline`` also times PyTorch's ``scaled_dot_product_attention`` (its
backward too under ``--grad``) as the library yardstick; in fp32 on its
memory-efficient backend (``SDPBackend.EFFICIENT_ATTENTION``, named in the
row's ``kernel``; flash attention takes no fp32), K and V repeated to Q's
heads beforehand. ``--dtype f32`` runs K1's and K11's fp32 libraries; JAX's
progression has no fp32 config, so name its short forms in ``--kernels``
(``fa_f32_...``); ``--grad`` in fp32 raises (no fp32 K2/K3 yet). On the
card only: every timing path raises without one.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_attention \\
        --kernels prog --seq-lens 512,1024,2048,4096 --json
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_attention \\
        --kernels 'fa_bf16_q128_kv128_d256_fori2_ca;fa_bf16_q128_kv128_d256_grid2_ca' \\
        --heads 16 --kv-heads 8 --seq-lens 2048,4096 --grad --baseline --json
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_attention \\
        --fori --causal --num-kv-buffers 3 --host-timing
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_attention --dtype f32 \\
        --kernels 'fa_f32_q128_kv128_d128_grid2_x2+os+cp;fa_f32_q128_kv128_d128_fori2_x2+os+cp' \\
        --causal --seq-lens 2048,4096 --baseline --json
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import dataclasses
import json
import os
import statistics
import sys
import time

import torch

from ..dispatch import median_runtime
from ..ops import _build
from ..ops.causal_decomp import band_count, band_slices
from ..ops.configs import (
    DType, KernelConfig, KVLoop, calc_causal_attn_flop, calc_self_attn_flop,
    get_kernel_configs,
)
from ..ops.flash_forward import (
    KERNEL, KERNEL_FORI, flash_forward, fori_plan, grid_plan,
)
from ..utils.chip import device_kind, measured_matmul_tflops
from ..utils.device import resolve_device, sm_count
from ..utils.testing import BATCH_SIZE_FOR_SEQ_LEN, BENCHMARK_N_HEADS, generate_qkv
from .bench_quant import _git_commit

__all__ = ["bench", "bench_inputs", "harmonic_mean", "main", "resolve_configs",
           "launch_key", "kernel_of", "flops", "DEFAULT_SEQ_LENS", "PEAK_BF16_TFLOPS",
           "GRAD_FLOP_FACTOR"]

DEFAULT_SEQ_LENS = (512, 1024, 2048, 4096)

PEAK_BF16_TFLOPS = 989.0  # H100 SXM, dense bf16 tensor cores (NVIDIA data sheet)
# Forward plus backward: 7 products of 2 s^2 d each (QK and PV forward; the
# S recompute, dV, dP, dQ and dK backward) against the forward's 2.
GRAD_FLOP_FACTOR = 3.5


def resolve_configs(kernels: str = "prog", dtype: str = "bf16", causal: bool = False,
                    window: int = 0, fori: bool = False,
                    num_kv_buffers: int | None = None) -> list[KernelConfig]:
    """The configs the JAX tool's ``main`` builds from the same options:
    ``get_kernel_configs(kernels)`` of ``dtype``; with ``causal`` or
    ``window`` each made causal with that window and ``reverse_kv`` off
    (``optimized_softmax`` off under a window); with ``fori`` each on the
    FORI loop with ``q_splits`` 1; duplicates dropped, first kept.
    ``num_kv_buffers`` (the port's shorthand) sets the ring depth of every
    FORI config."""
    dt = DType.from_short(dtype)
    configs = [c for c in get_kernel_configs(kernels) if c.dtype == dt]
    if causal or window:
        kw = dict(causal=True, window=window, reverse_kv=False)
        if window:
            kw["optimized_softmax"] = False
        configs = [dataclasses.replace(c, **kw) for c in configs]
    if fori:
        configs = [dataclasses.replace(c, kv_loop=KVLoop.FORI, q_splits=1) for c in configs]
    if num_kv_buffers is not None:
        configs = [dataclasses.replace(c, num_kv_buffers=num_kv_buffers)
                   if c.kv_loop == KVLoop.FORI else c for c in configs]
    return list(dict.fromkeys(configs))


def _banded(cfg: KernelConfig) -> bool:
    """Does ``flash_forward`` band this config on the bench's
    self-attention inputs (seq_kv == q_offset + seq_q holds at q_offset 0)?"""
    return cfg.decompose and cfg.causal and not cfg.q_offset


def kernel_of(cfg: KernelConfig) -> str:
    """The kernel ``flash_forward`` launches for ``cfg`` on the bench's
    inputs: K11 at its depth, the row-band dispatch (one K1 call a band)
    or K1."""
    if cfg.kv_loop == KVLoop.FORI:
        return f"{KERNEL_FORI}_nb{cfg.num_kv_buffers}"
    return f"{KERNEL}_banded" if _banded(cfg) else KERNEL


def launch_key(cfg: KernelConfig) -> tuple:
    """What decides the launch: the kernel and the function it computes.
    Configs with the same key differ only in knobs that shape the TPU
    kernel, and run the same launch here."""
    return (kernel_of(cfg), cfg.d_head, cfg.dtype, cfg.resolved_out_dtype, cfg.causal,
            cfg.window if cfg.causal else 0, cfg.q_offset, cfg.attn_softcap,
            cfg.softmax_scale)


def flops(cfg: KernelConfig, seq: int, heads: int, batch: int, grad: bool = False) -> float:
    """The JAX tool's FLOP model: the two forward products over every pair
    (or the causal pairs in the window), x3.5 with the backward."""
    if cfg.causal:
        n = calc_causal_attn_flop(seq, cfg.d_head, heads, batch, window=cfg.window)
    else:
        n = calc_self_attn_flop(seq, cfg.d_head, heads, batch)
    return n * GRAD_FLOP_FACTOR if grad else n


def _visible_tiles(cfg: KernelConfig, rows: int, keys: int, seq_q: int, seq_kv: int,
                   q_offset: int) -> int:
    """KV tiles of ``keys`` keys a kernel copies over its Q tiles of
    ``rows`` rows (``cta_tiles`` in csrc/flash_wgmma.cuh): a causal walk
    ends at the diagonal, a window starts at the first visible tile."""
    total = 0
    for q0 in range(0, seq_q, rows):
        first, last = 0, -(-seq_kv // keys) - 1
        if cfg.causal:
            q_min = q_offset + q0
            last = min(last, (q_min + min(rows, seq_q - q0) - 1) // keys)
            if cfg.window:
                first = max(0, q_min - cfg.window + 1) // keys
        total += max(last - first + 1, 0)
    return total


def _bytes(cfg: KernelConfig, batch: int, heads: int, seq: int, sms: int) -> int:
    """Bytes the launched forward moves: Q and O once, and K and V once per
    KV tile its plan copies, per Q head (``keys`` keys of ``d_head``
    columns a tile)."""
    d, elem = cfg.d_head, cfg.dtype.bytes
    qo = batch * heads * seq * d * (elem + cfg.resolved_out_dtype.bytes)
    if cfg.kv_loop == KVLoop.FORI:
        p = fori_plan(cfg.num_kv_buffers, batch, heads, seq, seq, d, elem)
        calls = [(p.rows, p.keys, seq, seq, cfg.q_offset)]
    elif _banded(cfg):
        n = band_count(seq)
        rows = seq // n
        calls = []
        for row0, kv_start in band_slices(seq, 0, cfg.window, n):
            skv = row0 + rows - kv_start
            p = grid_plan(batch, heads, rows, skv, True, cfg.window, row0 - kv_start, sms, d,
                          elem)
            calls.append((p.rows, p.keys, rows, skv, row0 - kv_start))
    else:
        p = grid_plan(batch, heads, seq, seq, cfg.causal, cfg.window, cfg.q_offset, sms, d,
                      elem)
        calls = [(p.rows, p.keys, seq, seq, cfg.q_offset)]
    kv = sum(_visible_tiles(cfg, rows, keys, sq, skv, off) * keys
             for rows, keys, sq, skv, off in calls)
    return qo + 2 * batch * heads * kv * d * elem


# The SDPA backend timed for fp32 (flash attention takes 16-bit inputs only).
SDPA_FP32_BACKEND = "efficient_attention"


def _sdpa(cfg: KernelConfig, seq: int, device):
    """PyTorch's fused attention as a function of (q, k, v) with ``cfg``'s
    mask and scale at ``seq``: the library yardstick. fp32 runs on the
    memory-efficient backend only (:data:`SDPA_FP32_BACKEND`), so that the
    row names the backend that ran; the caller repeats K and V to Q's
    heads."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = cfg.softmax_scale
    if cfg.window:
        pos = torch.arange(seq, device=device)
        mask = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < cfg.window)
        kw = dict(attn_mask=mask)
    else:
        kw = dict(is_causal=cfg.causal)
    if cfg.dtype != DType.FP32:
        return lambda q, k, v: sdpa(q, k, v, scale=scale, enable_gqa=True, **kw)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def efficient(q, k, v):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return sdpa(q, k, v, scale=scale, **kw)

    return efficient


def _with_grad(forward, q, k, v):
    """A step that runs ``forward(q, k, v)`` on leaves that need gradients
    and its backward to q, k and v (the gradient of the fp32 sum of the
    output, as the JAX tool's ``jax.grad``)."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def step():
        out = forward(*leaves)
        return torch.autograd.grad(out, leaves, torch.ones_like(out))

    return step


def _host_seconds(fn, *, warmup: int = 2, iters: int = 5) -> float:
    """Median seconds of one call on the host's clock, each call between
    two ``torch.cuda.synchronize()`` (the fence's own cost included)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def bench_inputs(seq: int, heads: int = BENCHMARK_N_HEADS, kv_heads: int | None = None,
                 device="cuda", d_head: int = 128, dtype=torch.bfloat16):
    """The Q (b, heads, seq, d_head) and K, V (b, kv_heads, seq, d_head) in
    ``dtype`` that :func:`bench` times at ``seq``, as the JAX tool makes them:
    Q from one ``generate_qkv`` call, K and V from another at the KV heads
    (batch from ``BATCH_SIZE_FOR_SEQ_LEN``, 4 for other lengths; drawn on
    ``device``)."""
    batch = BATCH_SIZE_FOR_SEQ_LEN.get(seq, 4)
    q, _, _ = generate_qkv(seq, d_head, heads, batch, dtype=dtype, device=device)
    _, k, v = generate_qkv(seq, d_head, kv_heads or heads, batch, dtype=dtype, device=device)
    return q, k, v


def bench(seq_lens, heads: int = BENCHMARK_N_HEADS, kv_heads: int | None = None,
          causal: bool = False, window: int = 0, fori: bool = False,
          num_kv_buffers: int | None = None, iters: int = 5, baseline: bool = False,
          log=print, *, kernels: str = "prog", dtype: str = "bf16", grad: bool = False,
          host_timing: bool = False):
    """Returns {config short form: {seq: {"ms", "tflops", "gbps",
    "kernel"}}} over :func:`resolve_configs`'s configs (and, with
    ``baseline``, ``"sdpa"``), each launch timed once a seq. On the card
    only: raises without one. bf16, fp16 and fp32 run; ``grad`` raises for
    fp32 (K2/K3 have no fp32 library yet: ROADMAP Queue 1, item 4c-3)."""
    dev = resolve_device("cuda")
    dt = DType.from_short(dtype)
    _build.typed_source("flash_backward.cu" if grad else "flash_forward.cu", dt.torch_dtype,
                        "--grad's K2/K3" if grad else "K1/K11")
    configs = resolve_configs(kernels, dtype, causal, window, fori, num_kv_buffers)
    kvh = kv_heads or heads
    sms = sm_count(dev)
    timer = ((lambda fn: _host_seconds(fn, iters=iters)) if host_timing
             else (lambda fn: median_runtime(fn, iters=iters)))
    results: dict[str, dict[int, dict]] = {}
    for seq in seq_lens:
        groups: dict[tuple, list[KernelConfig]] = {}
        for cfg in configs:
            if seq % cfg.block_q or seq % cfg.block_kv:
                continue  # JAX's rule: the TPU blocks must tile the seq
            if cfg.window and cfg.window >= seq:
                continue  # a window as long as seq is plain causal
            groups.setdefault(launch_key(cfg), []).append(cfg)
        inputs = {}
        for key, group in groups.items():
            cfg = group[0]
            if cfg.d_head not in inputs:
                inputs[cfg.d_head] = bench_inputs(seq, heads, kvh, dev, cfg.d_head,
                                                  dt.torch_dtype)
            q, k, v = inputs[cfg.d_head]
            batch = q.shape[0]
            if grad:
                from ..ops.autodiff import flash_attention

                fn = _with_grad(lambda q, k, v, cfg=cfg: flash_attention(q, k, v, cfg), q, k, v)
            else:
                fn = lambda q=q, k=k, v=v, cfg=cfg: flash_forward(q, k, v, cfg)  # noqa: E731
            secs = timer(fn)
            row = {"ms": secs * 1e3,
                   "tflops": flops(cfg, seq, heads, batch, grad) / secs / 1e12,
                   "gbps": _bytes(cfg, batch, heads, seq, sms) / secs / 1e9,
                   "kernel": kernel_of(cfg)}
            for c in group:
                results.setdefault(c.short_form(), {})[seq] = row
            log(f"  seq {seq:>6} {kernel_of(cfg):<28} {row['ms']:9.3f} ms "
                f"{row['tflops']:7.2f} TFLOP/s {row['gbps']:7.1f} GB/s "
                f"({len(group)} config{'s' if len(group) > 1 else ''})")
        if baseline and groups:
            # One baseline row a seq, at the first config's inputs and mask.
            cfg = next(iter(groups.values()))[0]
            q, k, v = inputs[cfg.d_head]
            if dt == DType.FP32:  # the efficient backend, on Q's heads
                k, v = (x.repeat_interleave(q.shape[1] // x.shape[1], 1) for x in (k, v))
            sdpa = _sdpa(cfg, seq, dev)
            fn = (_with_grad(sdpa, q, k, v) if grad
                  else lambda q=q, k=k, v=v: sdpa(q, k, v))  # noqa: E731
            secs = timer(fn)
            row = {"ms": secs * 1e3,
                   "tflops": flops(cfg, seq, heads, q.shape[0], grad) / secs / 1e12,
                   "gbps": 0.0, "kernel": ("sdpa:" + SDPA_FP32_BACKEND if dt == DType.FP32
                                           else "sdpa")}
            results.setdefault("sdpa", {})[seq] = row
            log(f"  seq {seq:>6} {'sdpa':<28} {row['ms']:9.3f} ms {row['tflops']:7.2f} TFLOP/s")
        del inputs
    return results


def harmonic_mean(vals):
    vals = [v for v in vals if v > 0]
    return statistics.harmonic_mean(vals) if vals else 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="prog",
                    help="prog | all | tune | '<bq>,<bkv>' | 'fa_...;fa_...'")
    ap.add_argument("--seq-lens", default=",".join(map(str, DEFAULT_SEQ_LENS)))
    ap.add_argument("--heads", type=int, default=BENCHMARK_N_HEADS)
    ap.add_argument("--kv-heads", type=int, default=None,
                    help="GQA KV heads (default = --heads)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtype", default="bf16",
                    help="bf16, f16 or f32 (f32: K1 and K11, by their fa_f32_ short forms; "
                         "not with --grad)")
    ap.add_argument("--causal", action="store_true",
                    help="causal masks, causal FLOP accounting")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding window (implies --causal)")
    ap.add_argument("--fori", action="store_true",
                    help="force the FORI kv loop (K11) on every config")
    ap.add_argument("--num-kv-buffers", type=int, default=None,
                    help="K11's ring depth, 1-4, for every FORI config")
    ap.add_argument("--host-timing", action="store_true",
                    help="time each call on the host between two synchronizes, "
                         "in place of CUDA events")
    ap.add_argument("--baseline", action="store_true",
                    help="also time torch's scaled_dot_product_attention per seq")
    ap.add_argument("--grad", action="store_true",
                    help="time forward + backward (gradients for q, k, v; FLOP "
                         "model x3.5)")
    ap.add_argument("--json", action="store_true", help="one JSON line per config")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)

    resolve_device("cuda")
    seq_lens = [int(s) for s in args.seq_lens.split(",")]
    timing = "host" if args.host_timing else "cuda_events"
    print(f"device={device_kind()} commit={_git_commit()} bf16 peak "
          f"{PEAK_BF16_TFLOPS} TFLOP/s timing={timing} grad={args.grad}")
    results = bench(seq_lens, heads=args.heads, kv_heads=args.kv_heads,
                    causal=args.causal, window=args.window, fori=args.fori,
                    num_kv_buffers=args.num_kv_buffers, iters=args.iters,
                    baseline=args.baseline, kernels=args.kernels, dtype=args.dtype,
                    grad=args.grad, host_timing=args.host_timing)
    mm = measured_matmul_tflops()
    header = (f"{'config':<48}" + "".join(f"{s:>9}" for s in seq_lens)
              + f"{'harm.':>9}{'%peak':>7}{'%mm':>7}")
    print(f"\nmeasured bf16 matmul rate: {mm:.1f} TFLOP/s\n{header}")
    rows = []
    for name, per_seq in results.items():
        hm = harmonic_mean([r["tflops"] for r in per_seq.values()])
        print(f"{name:<48}" + "".join(
            f"{per_seq[s]['tflops']:>9.1f}" if s in per_seq else f"{'-':>9}"
            for s in seq_lens) + f"{hm:>9.1f}{100 * hm / PEAK_BF16_TFLOPS:>7.1f}"
            f"{100 * hm / mm:>7.1f}")
        row = {"config": name, "kernel": next(iter(per_seq.values()))["kernel"],
               **{f"seq{s}": round(per_seq[s]["tflops"], 2) if s in per_seq else 0
                  for s in seq_lens},
               **{f"gbps{s}": round(per_seq[s]["gbps"], 1) if s in per_seq else 0
                  for s in seq_lens},
               "harmonic_mean": round(hm, 2),
               "pct_peak": round(100 * hm / PEAK_BF16_TFLOPS, 2),
               "pct_matmul": round(100 * hm / mm, 2), "n_seqs": len(per_seq),
               "timing": timing, "grad": args.grad, "commit": _git_commit()}
        rows.append(row)
        if args.json:
            print(json.dumps(row))
    if args.csv and not rows:
        print("no configs ran; CSV not written")
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
