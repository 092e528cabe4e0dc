"""Step-by-step debugger: diff the kernel against the block-by-block mirror.

Counterpart of ``flash_attention_from_scratch_tpu/tools/debug_steps.py``.
The mirror is ``ops/reference.py::block_flash_attention`` with the config's
``block_q``, ``block_kv``, ``use_exp2`` and ``reverse_kv``: the online
softmax recurrence a (Q block, KV block) pair at a time in fp32, whose
intermediates (S, the running max m and sum l, P, the partial O) ``--trace``
prints. It is compared with the port's ``flash_forward`` (the config's
kernel on the card, its plain version with ``--device cpu``):

1. per Q block (:func:`_diff_map` over the output's rows): the largest
   difference between the kernel's output and the mirror's, which locates
   the block rows where the two diverge;
2. per KV step: the kernel run over the keys the mirror has visited after
   step j (a prefix, or with ``reverse_kv`` a suffix, of the KV blocks)
   against the mirror's running output O / l after that step, which
   locates the step where the recurrence diverges.

The JAX tool also steps the Pallas kernel in interpret mode to compare its
intermediates with the mirror's. A CUDA kernel exposes no intermediates
and has no interpret mode, so that step has no counterpart here: the
comparisons are of outputs. The last line printed is a JSON object with
both maps and the mirror's difference from the plain softmax.

Usage:
    python -m flash_attention_from_scratch_tpu_torch.tools.debug_steps --kernel 3 --small
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops.configs import DType, get_kernel_configs
from ..ops.flash_forward import flash_forward
from ..ops.reference import block_flash_attention, reference_attention
from ..utils.device import resolve_device
from ..utils.testing import generate_qkv
from .bench_attention import kernel_of

__all__ = ["debug", "main"]


def _diff_map(out, ref, block: int, axis: int) -> list[float]:
    """Max abs diff per block of ``block`` indices along ``axis``."""
    d = np.abs(out.float().cpu().numpy() - ref.float().cpu().numpy())
    n = d.shape[axis] // block
    return [float(np.max(np.take(d, range(i * block, (i + 1) * block), axis=axis)))
            for i in range(n)]


def debug(cfg, q, k, v, trace: bool = False, log=print) -> dict:
    """The two diff maps of ``cfg``'s kernel against the mirror on (q, k,
    v), and the mirror's difference from the plain softmax."""
    bq, bkv = cfg.block_q, cfg.block_kv
    mirror, steps = block_flash_attention(q, k, v, block_q=bq, block_kv=bkv,
                                          use_exp2=cfg.use_exp2, reverse_kv=cfg.reverse_kv,
                                          collect_trace=True)
    if trace:
        for t in steps:
            log(f"-- q_block {t['q_block']} kv_block {t['kv_block']}: "
                f"S range [{float(t['S'].min()):+.4f}, {float(t['S'].max()):+.4f}] "
                f"m max {float(t['m'].max()):+.4f} l max {float(t['l'].max()):.4f} "
                f"O max {float(t['O'].abs().max()):.4f}")
    out = flash_forward(q, k, v, cfg)
    n_kv = k.shape[2] // bkv
    order = list(range(n_kv - 1, -1, -1)) if cfg.reverse_kv else list(range(n_kv))
    by_q = _diff_map(out, mirror, bq, axis=2)
    by_kv = []
    for j in range(n_kv):
        lo, hi = min(order[:j + 1]) * bkv, (max(order[:j + 1]) + 1) * bkv
        partial = flash_forward(q, k[:, :, lo:hi], v[:, :, lo:hi], cfg)
        running = torch.cat([t["O"] / t["l"] for t in steps[j::n_kv]], dim=2)
        by_kv.append(float((partial.float() - running).abs().max()))
    ref = reference_attention(q, k, v)
    return {"config": cfg.short_form(), "kernel": kernel_of(cfg), "seq": q.shape[2],
            "per_q_block_max_diff": by_q, "per_kv_step_max_diff": by_kv,
            "mirror_vs_softmax_max_diff": float((mirror.float() - ref.float()).abs().max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="prog")
    ap.add_argument("--kernel", type=int, default=0, help="index into the config list")
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--small", action="store_true", help="seq 512")
    ap.add_argument("--trace", action="store_true",
                    help="print every per-block intermediate of the mirror")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.small:
        args.seq = 512

    dtype = DType.from_short(args.dtype)
    cfg = [c for c in get_kernel_configs(args.kernels) if c.dtype == dtype][args.kernel]
    print(f"debugging {cfg.short_form()} ({kernel_of(cfg)} on {dev}) at seq {args.seq}")
    q, k, v = generate_qkv(args.seq, n_heads=1, batch=1, dtype=dtype.torch_dtype, device=dev)
    result = debug(cfg, q, k, v, trace=args.trace)
    print("kernel-vs-mirror per-q-block max diff: "
          f"{['%.2e' % r for r in result['per_q_block_max_diff']]}")
    print("kernel-vs-mirror per-kv-step max diff: "
          f"{['%.2e' % r for r in result['per_kv_step_max_diff']]}")
    print(f"mirror-vs-plain-softmax max diff: {result['mirror_vs_softmax_max_diff']:.3e}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
