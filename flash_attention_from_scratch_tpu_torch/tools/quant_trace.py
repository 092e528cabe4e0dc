"""What holds K10's int8-compute path below the bf16 forward: traces and an ablation.

Counterpart of ``flash_attention_from_scratch_tpu/tools/quant_trace.py``, at
its shape (16 heads of 128, batch from ``BATCH_SIZE_FOR_SEQ_LEN``):

  * **Traces**: ``torch.profiler`` (CUDA activity) of six calls of K10's
    int8c path (``flash_forward_quantized`` on int8 Q, K and V,
    ``int8_compute=True``) and of K1 on ``KernelConfig.for_shape``'s config
    at the same shape, each in a subprocess killed after ``--timeout``
    (``profile_trace.capture_trace``), summarized by
    ``profile_trace.summarize_trace``. A trace without the launched
    kernel's name is reported as not captured, with the reason.
  * **Ablation** (``chain_timing``, the JAX tool's key): int8c, int8u (the
    same int8 tensors through the upcast path: bf16 products) and the bf16
    K1 launch, timed as ``bench_quant`` times them (CUDA events,
    ``dispatch.median_runtime``), each as seconds a call and TFLOP/s on the
    bf16 FLOP model. int8c against int8u is what the int8 products buy on
    K10's skeleton; int8c against K1 is the gap.

The JAX tool writes its summary to a committed file; here it is printed,
and written only where ``--summary`` names a file. Traces go under
``profiles/traces/`` (git-ignored) by default. On the card only: raises
without one.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.quant_trace --seq 4096
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..dispatch import median_runtime
from ..ops.configs import KernelConfig, calc_self_attn_flop
from ..ops.flash_forward import KERNEL, flash_forward
from ..ops.flash_quant import flash_forward_quantized
from ..ops.quant import quantize_kv
from ..utils.chip import device_kind, measured_matmul_tflops
from ..utils.device import resolve_device
from ..utils.testing import BATCH_SIZE_FOR_SEQ_LEN, generate_qkv
from .profile_trace import _traced, capture_trace, summarize_trace

__all__ = ["ablation", "main"]

HEADS = 16
# The launch-count name whose device kernel each trace must show.
TRACED = {"int8c": "flash_quant_i8", "bf16": KERNEL}

_SNIPPET = """
import os, sys, torch
from torch.profiler import ProfilerActivity, profile
from flash_attention_from_scratch_tpu_torch.tools.quant_trace import _runner

run = _runner(sys.argv[1], int(sys.argv[2]))
run()  # build and warm up outside the trace
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(6):
        run()
    torch.cuda.synchronize()
prof.export_chrome_trace(os.path.join(sys.argv[5], "trace.json"))
print("TRACE_OK")
"""


def _inputs(seq: int):
    return generate_qkv(seq, n_heads=HEADS, batch=BATCH_SIZE_FOR_SEQ_LEN.get(seq, 4))


def _runner(which: str, seq: int):
    """A call of ``which`` (int8c, int8u or bf16) at ``seq`` on the card."""
    q, k, v = _inputs(seq)
    if which == "bf16":
        cfg = KernelConfig.for_shape(seq, seq, heads=HEADS, kv_heads=HEADS, batch=q.shape[0])
        return lambda: flash_forward(q, k, v, cfg)
    qq, kq, vq = (quantize_kv(t, "int8") for t in (q, k, v))
    del q, k, v
    return lambda: flash_forward_quantized(qq, kq, vq, int8_compute=which == "int8c")


def ablation(seq: int, iters: int = 5) -> dict:
    """{int8c, int8u, bf16_champion: seconds a call and TFLOP/s on the
    bf16 FLOP model}, timed as ``bench_quant`` times K10."""
    flops = calc_self_attn_flop(seq, 128, HEADS, BATCH_SIZE_FOR_SEQ_LEN.get(seq, 4))
    rows = {}
    for name, which in (("int8c", "int8c"), ("int8u", "int8u"), ("bf16_champion", "bf16")):
        secs = median_runtime(_runner(which, seq), iters=iters)
        rows[name] = {"secs_per_call": secs, "eff_bf16_tflops": round(flops / secs / 1e12, 2)}
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--out", default="profiles/traces", help="trace directory (git-ignored)")
    ap.add_argument("--summary", default=None, help="also write the summary JSON here")
    ap.add_argument("--timeout", type=int, default=420)
    args = ap.parse_args(argv)

    resolve_device("cuda")
    out = {"device": device_kind(), "bf16_matmul_ceiling_tflops": measured_matmul_tflops(),
           "seq": args.seq, "timing": "cuda_events"}
    for which in ("int8c", "bf16"):
        tdir = os.path.join(args.out, f"quant_{which}")
        ok, msg = capture_trace(which, args.seq, 0, 0, tdir, args.timeout, snippet=_SNIPPET)
        summary = summarize_trace(tdir) if ok else {"trace": None}
        if ok:
            ok, msg = _traced(summary, TRACED[which])
        out[f"trace_{which}"] = {"trace_captured": ok, **({} if ok else {"error": msg}),
                                 **summary}
        print(which, "trace:", "ok" if ok else msg)
    out["chain_timing"] = ablation(args.seq)
    for name, r in out["chain_timing"].items():
        print(f"{name}: {r['secs_per_call'] * 1e3:.3f} ms, {r['eff_bf16_tflops']} TFLOP/s "
              "(bf16 FLOP model)")
    if args.summary:
        os.makedirs(os.path.dirname(args.summary) or ".", exist_ok=True)
        with open(args.summary, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.summary}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
