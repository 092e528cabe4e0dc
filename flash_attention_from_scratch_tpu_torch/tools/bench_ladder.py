"""The optimization ladder: a rung x seq table of TFLOP/s with harmonic means.

Counterpart of ``flash_attention_from_scratch_tpu/tools/bench_ladder.py``.
``RUNGS`` keeps the JAX tool's twelve labels and config functions: each makes, per
(seq, heads, batch), the JAX tool's ``KernelConfig`` (JAX's defaults,
``ops/configs.py::_tpu_config``; the champion rung is
``KernelConfig.for_shape``). On Hopper the TPU's knobs (blocks, ``use_exp2``,
``optimized_softmax``, ``scale_q``, ``kv_splits``, ``q_splits``,
``head_pack``, ``reverse_kv``) select no kernel: rung 01 runs K11 at ring
depth 1, rung 06 K11 at depth 2, the other ten K1. Rungs that share a
launch (``bench_attention.launch_key``) are timed once a seq and share its
figures; every row names the kernel it ran. JAX's rule for skipping a seq
stays (the rung's TPU blocks must tile it).

Each rung runs the port's ``flash_forward`` on ``utils/testing.py::
generate_qkv`` inputs (bf16, d 128, batch from ``BATCH_SIZE_FOR_SEQ_LEN``),
timed with CUDA events (``dispatch.median_runtime``). FLOPs are the
non-causal model (``calc_self_attn_flop``); ``pct_sol`` is against the bf16
peak of 989 TFLOP/s, ``pct_matmul`` against the card's measured matmul rate
(``utils/chip.py::measured_matmul_tflops``). On the card only: raises
without one. Prints the table; ``--json`` adds a JSON line a rung and
``--csv`` writes the table.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_ladder \\
        --seq-lens 512,1024,2048,4096,8192,16384 --csv profiles/traces/ladder.csv
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import json
import os
import statistics
import sys

from ..dispatch import median_runtime
from ..ops.configs import KernelConfig, KVLoop, _tpu_config, calc_self_attn_flop
from ..ops.flash_forward import flash_forward
from ..utils.chip import chip_sol_tflops, device_kind, measured_matmul_tflops
from ..utils.device import resolve_device
from ..utils.testing import BATCH_SIZE_FOR_SEQ_LEN, generate_qkv
from .bench_attention import kernel_of, launch_key
from .bench_quant import _git_commit

__all__ = ["RUNGS", "DEFAULT_SEQ_LENS", "bench_ladder", "main"]

DEFAULT_SEQ_LENS = (512, 1024, 2048, 4096, 8192, 16384)


def _sp_for(seq: int) -> int:
    """The JAX tool's kv_splits for whole-sequence KV at this length."""
    return {512: 1, 1024: 1, 2048: 2, 4096: 2, 8192: 4}.get(seq, 8)


def _hp_for(seq: int) -> int:
    """The JAX tool's head_pack at this length."""
    return {512: 16, 1024: 8, 2048: 4, 4096: 2, 8192: 2}.get(seq, 1)


# (label, config(seq, heads, batch) -> KernelConfig), the JAX tool's.
RUNGS = [
    ("01-naive-fori", lambda s, h, b: _tpu_config(
        block_q=128, block_kv=128, kv_loop=KVLoop.FORI, num_kv_buffers=1,
        use_exp2=False, optimized_softmax=False, scale_q=False)),
    ("02-grid-pipeline", lambda s, h, b: _tpu_config(
        block_q=128, block_kv=128, use_exp2=False, optimized_softmax=False,
        scale_q=False)),
    ("03-exp2", lambda s, h, b: _tpu_config(
        block_q=128, block_kv=128, optimized_softmax=False, scale_q=False)),
    ("04-online-softmax", lambda s, h, b: _tpu_config(
        block_q=128, block_kv=128, scale_q=False)),
    ("05-reverse-kv", lambda s, h, b: _tpu_config(
        block_q=128, block_kv=128, scale_q=False, reverse_kv=True)),
    ("06-fori-dma2", lambda s, h, b: _tpu_config(
        block_q=128, block_kv=128, scale_q=False, kv_loop=KVLoop.FORI,
        num_kv_buffers=2)),
    ("07-big-tiles", lambda s, h, b: _tpu_config(
        block_q=min(512, s), block_kv=min(1024, s), scale_q=False)),
    ("08-scale-q", lambda s, h, b: _tpu_config(
        block_q=min(512, s), block_kv=min(1024, s))),
    ("09-whole-seq-kv", lambda s, h, b: _tpu_config(
        block_q=min(512, s), block_kv=s, kv_splits=_sp_for(s))),
    ("10-q-splits", lambda s, h, b: _tpu_config(
        block_q=min(512, s), block_kv=s, kv_splits=_sp_for(s),
        q_splits=2 if s >= 1024 else 1)),
    ("11-head-pack", lambda s, h, b: _tpu_config(
        block_q=min(512, s), block_kv=s, kv_splits=_sp_for(s),
        q_splits=2 if s >= 1024 else 1, head_pack=_hp_for(s))),
    ("12-champion", lambda s, h, b: KernelConfig.for_shape(
        s, s, heads=h, kv_heads=h, batch=b)),
]


def bench_ladder(seq_lens, heads: int = 16, iters: int = 5, rungs=None, log=print):
    """[(label, {seq: {"ms", "tflops", "kernel", "config"}})] in rung order,
    each launch timed once a seq. On the card only: raises without one."""
    dev = resolve_device("cuda")
    rungs = rungs if rungs is not None else RUNGS
    out = [(label, {}) for label, _ in rungs]
    for seq in seq_lens:
        batch = BATCH_SIZE_FOR_SEQ_LEN.get(seq, 4)
        groups: dict[tuple, list] = {}
        for i, (_, build) in enumerate(rungs):
            cfg = build(seq, heads, batch)
            if cfg is None or seq % cfg.block_q or seq % cfg.block_kv:
                continue  # JAX's rule: the rung's TPU blocks must tile the seq
            groups.setdefault(launch_key(cfg), []).append((i, cfg))
        if not groups:
            continue
        q, k, v = generate_qkv(seq, n_heads=heads, batch=batch, device=dev)
        flops = calc_self_attn_flop(seq, q.shape[-1], heads, batch)
        for members in groups.values():
            cfg = members[0][1]
            secs = median_runtime(lambda cfg=cfg: flash_forward(q, k, v, cfg), iters=iters)
            for i, c in members:
                out[i][1][seq] = {"ms": secs * 1e3, "tflops": flops / secs / 1e12,
                                  "kernel": kernel_of(c), "config": c.short_form()}
            log(f"  seq {seq:>6} {kernel_of(cfg):<24} {secs * 1e3:9.3f} ms "
                f"{flops / secs / 1e12:7.2f} TFLOP/s "
                f"({', '.join(rungs[i][0] for i, _ in members)})")
        del q, k, v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq-lens", default=",".join(map(str, DEFAULT_SEQ_LENS)))
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--json", action="store_true", help="also one JSON line per rung")
    ap.add_argument("--csv", default=None, help="also write the table here")
    args = ap.parse_args(argv)
    seq_lens = [int(s) for s in args.seq_lens.split(",")]

    resolve_device("cuda")
    sol, mm = chip_sol_tflops(), measured_matmul_tflops()
    commit = _git_commit()
    print(f"device={device_kind()} commit={commit} bf16 peak={sol} "
          f"measured matmul rate={mm:.1f} timing=cuda_events")
    results = bench_ladder(seq_lens, heads=args.heads, iters=args.iters)

    print("\n" + f"{'rung':<20}{'kernel':<24}" + "".join(f"{s:>9}" for s in seq_lens)
          + f"{'harm.':>9}{'%mm':>7}")
    rows = []
    for label, per_seq in results:
        if not per_seq:
            continue
        hm = statistics.harmonic_mean([r["tflops"] for r in per_seq.values()])
        kernel = next(iter(per_seq.values()))["kernel"]
        print(f"{label:<20}{kernel:<24}" + "".join(
            f"{per_seq[s]['tflops']:>9.1f}" if s in per_seq else f"{'-':>9}"
            for s in seq_lens) + f"{hm:>9.1f}{100 * hm / mm:>7.1f}")
        rows.append({"rung": label, "kernel": kernel,
                     **{f"seq{s}": round(per_seq[s]["tflops"], 2) if s in per_seq else 0
                        for s in seq_lens},
                     "harmonic_mean": round(hm, 2), "pct_sol": round(100 * hm / sol, 2),
                     "pct_matmul": round(100 * hm / mm, 2), "n_seqs": len(per_seq),
                     "timing": "cuda_events", "commit": commit})
        if args.json:
            print(json.dumps(rows[-1]))
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
