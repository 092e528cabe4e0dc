"""Backward-pass rung table: split against fused, and the banded causal backward.

Counterpart of ``flash_attention_from_scratch_tpu/tools/bench_backward.py``,
with the JAX tool's variant labels (``variants``): ``split_2048`` runs K3
(the dK/dV and dQ kernels), the ``fused_*`` rows K2, and with ``--causal``
``banded`` and ``banded_2048`` run ``flash_backward(..., bands=n)`` (K2 on
each band's diagonal square and past keys, ``ops/flash_backward.py::
banded_backward``) with the JAX tool's band counts (``band_count``). The
fused rows' tiles and ``q_splits`` are TPU knobs: they share one K2 launch,
timed once a seq, and every row names its kernel. K2 and K3 are timed as
the JAX tool times them, bound calls given D = rowsum(dO * O)
(``make_flash_backward*``); the banded rows time the whole call, D
included.

FLOPs are the JAX tool's ideal model, 3.5x the forward's (2 forward + 5
backward products), over the visible pairs with ``--causal``. Each row's
forward is the one the port's model dispatches for the shape
(``forward_config``): with ``--causal`` at seq % 512 == 0 and seq >= 2048,
the JAX tool's ``decompose`` config, i.e. the row-band dispatch over K1;
else ``KernelConfig.for_shape``'s (K1). ``--kv-heads`` gives GQA. Timing is
CUDA events (``dispatch.median_runtime``). On the card only: raises without
one.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_backward \\
        --seq-lens 4096,8192,16384 --causal --heads 32 --kv-heads 8
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import dataclasses
import json
import os
import sys

from ..dispatch import median_runtime
from ..ops.configs import (
    KernelConfig, _tpu_config, calc_causal_attn_flop, calc_self_attn_flop,
)
from ..ops.flash_backward import (
    KERNEL_FUSED, flash_backward, make_flash_backward, make_flash_backward_fused,
)
from ..ops.flash_forward import flash_forward_with_lse
from ..utils.chip import chip_sol_tflops, device_kind, measured_matmul_tflops
from ..utils.device import resolve_device
from ..utils.testing import BATCH_SIZE_FOR_SEQ_LEN, generate_qkv
from .bench_attention import GRAD_FLOP_FACTOR
from .bench_quant import _git_commit

__all__ = ["VARIANTS", "CAUSAL_VARIANTS", "variants", "band_count", "forward_config",
           "bench_backward", "main"]

# (label, kernel: False split / True fused / "banded", TPU block_q, TPU
# block_kv, q_splits or, for "banded", rows a band (None: 1024)): the JAX
# tool's table.
VARIANTS = (
    ("split_2048", False, 2048, 2048, None),
    ("fused_512", True, 512, 512, None),
    ("fused_1024", True, 1024, 1024, None),
    ("fused_2048", True, 2048, 2048, None),
    ("fused_1024_qs2", True, 1024, 1024, 2),
)
CAUSAL_VARIANTS = VARIANTS + (
    ("banded", "banded", None, None, None),
    ("banded_2048", "banded", None, None, 2048),
)
KERNEL_SPLIT = "flash_backward_split"


def variants(causal: bool) -> tuple:
    """The rows the tool runs: with ``causal`` the banded ones too."""
    return CAUSAL_VARIANTS if causal else VARIANTS


def band_count(seq: int, band_rows: int | None) -> int | None:
    """The JAX tool's band count for a banded row at ``seq``: seq //
    band_rows (1024 by default), at least 2; None (the row is skipped)
    when fewer than two bands fit."""
    band_rows = band_rows or 1024
    if seq // band_rows < 2:
        return None
    return max(2, seq // band_rows)


def forward_config(cfg: KernelConfig, seq: int, heads: int, kv_heads: int,
                   causal: bool) -> KernelConfig:
    """The forward the model dispatches for the shape, the JAX tool's rule:
    the row-band ``decompose`` config for causal seq % 512 == 0 from 2048
    (head_pack 4 or 2 where the heads and the GQA group allow), else
    ``cfg``."""
    if causal and seq % 512 == 0 and seq >= 2048:
        group = heads // kv_heads
        hp = next((c for c in (4, 2) if heads % c == 0 and group % c == 0), 1)
        return _tpu_config(block_q=512, block_kv=2048, causal=True, decompose=True,
                           kv_splits=2, q_splits=2, head_pack=hp)
    return cfg


def _kernel(fused, bands) -> str:
    if fused == "banded":
        return f"{KERNEL_FUSED}_banded{bands}"
    return KERNEL_FUSED if fused else KERNEL_SPLIT


def bench_backward(seq_lens, heads: int = 16, kv_heads: int | None = None,
                   causal: bool = False, iters: int = 5, log=print):
    """Rows: (variant, seq) -> forward + backward TFLOP/s on the 3.5x model,
    each launch timed once a seq. On the card only: raises without one."""
    dev = resolve_device("cuda")
    kv_heads = kv_heads or heads
    mm = measured_matmul_tflops()
    rows = []
    for seq in seq_lens:
        batch = BATCH_SIZE_FOR_SEQ_LEN.get(seq, 4)
        q = generate_qkv(seq, n_heads=heads, batch=batch, device=dev)[0]
        _, k, v = generate_qkv(seq, n_heads=kv_heads, batch=batch, seed=1, device=dev)
        do = generate_qkv(seq, n_heads=heads, batch=batch, seed=2, device=dev)[0]
        d = q.shape[-1]
        fwd_flops = (calc_causal_attn_flop(seq, d, heads, batch) if causal
                     else calc_self_attn_flop(seq, d, heads, batch))
        flops = int(GRAD_FLOP_FACTOR * fwd_flops)
        cfg = KernelConfig.for_shape(seq, seq, heads=heads, kv_heads=kv_heads, causal=causal)
        o, lse = flash_forward_with_lse(q, k, v, cfg)
        dsum = (do.float() * o.float()).sum(-1)
        fwd_cfg = forward_config(cfg, seq, heads, kv_heads, causal)
        fsecs = median_runtime(lambda: flash_forward_with_lse(q, k, v, fwd_cfg), iters=iters)
        timed: dict[tuple, float] = {}
        for label, fused, _, _, extra in variants(causal):
            bands = band_count(seq, extra) if fused == "banded" else None
            if fused == "banded" and bands is None:
                continue
            key = (fused, bands)
            if key not in timed:
                if fused == "banded":
                    dcfg = dataclasses.replace(cfg, causal=True, decompose=True, window=0,
                                               q_offset=0)

                    def step(dcfg=dcfg, bands=bands):
                        flash_backward(q, k, v, o, lse, do, dcfg, bands=bands)
                elif fused:
                    call = make_flash_backward_fused(cfg, batch, heads, seq, seq, kv_heads,
                                                     device=dev)

                    def step(call=call):
                        call(q, k, v, do, lse, dsum)
                else:
                    dq_call, dkv_call = make_flash_backward(cfg, batch, heads, seq, seq,
                                                            kv_heads, device=dev)

                    def step(dq_call=dq_call, dkv_call=dkv_call):
                        dq_call(q, k, v, do, lse, dsum)
                        dkv_call(q, k, v, do, lse, dsum)

                timed[key] = median_runtime(step, iters=iters)
            secs = timed[key]
            tot = secs + fsecs
            tflops = flops / 1e12 / tot
            rows.append({
                "seq": seq, "batch": batch, "heads": heads, "kv_heads": kv_heads,
                "causal": causal, "variant": label, "kernel": _kernel(fused, bands),
                "bands": bands, "bwd_ms": round(secs * 1e3, 4), "fwd_ms": round(fsecs * 1e3, 4),
                "fwdbwd_tflops": round(tflops, 2),
                "bwd_tflops": round((flops - fwd_flops) / 1e12 / secs, 2),
                "pct_matmul_ceiling": round(100 * tflops / mm, 2),
            })
            log(f"  seq {seq:>6} {label:<16} {rows[-1]['kernel']:<30} bwd {secs * 1e3:9.3f} "
                f"ms fwd+bwd {tflops:7.2f} TFLOP/s ({rows[-1]['pct_matmul_ceiling']:5.1f}% mm)")
        del q, k, v, do, o, lse, dsum
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq-lens", default="2048,4096")
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--kv-heads", type=int, default=None, help="GQA KV heads (default --heads)")
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--json", action="store_true", help="also one JSON line per row")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)

    resolve_device("cuda")
    print(f"device={device_kind()} commit={_git_commit()} bf16 peak={chip_sol_tflops()} "
          f"timing=cuda_events flop_model=3.5x_fwd_ideal")
    rows = bench_backward([int(s) for s in args.seq_lens.split(",")], heads=args.heads,
                          kv_heads=args.kv_heads, causal=args.causal, iters=args.iters)
    if args.json:
        for r in rows:
            print(json.dumps(r))
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
