"""Per-kernel profiler traces and a device-time summary.

Counterpart of ``flash_attention_from_scratch_tpu/tools/profile_trace.py``.
For each launch the selected configs run (``--kernels``, ``--dtype``;
configs that share a launch, ``bench_attention.launch_key``, are traced
once), :func:`capture_trace` runs five calls of the port's ``flash_forward``
under ``torch.profiler`` (CUDA activity) in a subprocess killed after
``--timeout`` seconds, as the JAX tool does, and writes a Chrome trace under
``--out/<config>/``. :func:`summarize_trace` reads it into device time and
call counts by kernel name, the top 10.

Each row also carries the call's time from CUDA events
(``dispatch.median_runtime``), its TFLOP/s (``bench_attention.flops``, JAX's model) and
its model GB/s (``bench_attention``'s bytes: Q and O once, K and V once per
KV tile the launched kernel copies), whatever the trace gave.
``torch.profiler`` now and then records no kernel in a window of ctypes
launches: a trace without the launched kernel's name (``device_name``) is
reported as ``trace_captured: false`` with that reason, never as zero time.

Traces go under ``profiles/traces/`` (git-ignored) by default; the summary
is printed, and written only where ``--summary`` names a file. On the card
only: raises without one.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.profile_trace \\
        --kernels prog --seq 4096 --out profiles/traces
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

from ..dispatch import median_runtime
from ..ops.configs import DType, KVLoop, get_kernel_configs
from ..ops.flash_forward import KERNEL, KERNEL_FORI, flash_forward
from ..utils.chip import device_kind
from ..utils.device import resolve_device, sm_count
from ..utils.testing import BATCH_SIZE_FOR_SEQ_LEN, generate_qkv
from .bench_attention import _bytes, flops, kernel_of, launch_key

__all__ = ["capture_trace", "summarize_trace", "device_name", "main"]

# The package's parent, the subprocess's working directory.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CAPTURE_SNIPPET = """
import os, sys, torch
from torch.profiler import ProfilerActivity, profile
from flash_attention_from_scratch_tpu_torch.ops.configs import parse_short_form
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import flash_forward
from flash_attention_from_scratch_tpu_torch.utils.testing import generate_qkv

cfg = parse_short_form(sys.argv[1])
seq, heads, batch, out_dir = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
q, k, v = generate_qkv(seq, d_head=cfg.d_head, n_heads=heads, batch=batch,
                       dtype=cfg.dtype.torch_dtype)
flash_forward(q, k, v, cfg)  # build and warm up outside the trace
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(5):
        flash_forward(q, k, v, cfg)
    torch.cuda.synchronize()
prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
print("TRACE_OK")
"""


def device_name(kernel: str) -> str:
    """The device symbol's name of a launch-count name (``flash_forward``
    -> ``flash_forward_kernel``), which a trace of it must show."""
    return f"{kernel}_kernel"


def capture_trace(cfg_short: str, seq: int, heads: int, batch: int, out_dir: str,
                  timeout_s: int = 300, snippet: str = _CAPTURE_SNIPPET) -> tuple[bool, str]:
    """Capture one launch's trace into ``out_dir`` in a subprocess killed
    after ``timeout_s``: (ok, message); a hang or a failure is reported,
    never raised."""
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    try:
        p = subprocess.run([sys.executable, "-c", snippet, cfg_short, str(seq), str(heads),
                            str(batch), out_dir],
                           cwd=_ROOT, capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, f"profiler hung > {timeout_s}s"
    if "TRACE_OK" not in p.stdout:
        return False, (p.stderr or p.stdout)[-300:]
    return True, "ok"


def summarize_trace(trace_dir: str, top: int = 10) -> dict:
    """Device time and count by kernel name in the newest Chrome trace
    under ``trace_dir`` (its ``kernel`` events), the ``top`` largest."""
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not files:
        return {"trace": None}
    with open(files[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    totals: dict[str, list] = {}
    for ev in events:
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            t = totals.setdefault(ev["name"], [0.0, 0])
            t[0] += float(ev.get("dur", 0.0))
            t[1] += 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    return {"trace": os.path.relpath(files[-1]),
            "device_event_totals_ns": [{"name": n, "total_ns": round(us * 1e3), "count": c}
                                       for n, (us, c) in ranked]}


def _traced(summary: dict, kernel: str) -> tuple[bool, str]:
    """Whether the summary shows the launched kernel; else the reason."""
    names = [e["name"] for e in summary.get("device_event_totals_ns", [])]
    if any(device_name(kernel) in n for n in names):
        return True, ""
    return False, (f"the trace holds no {device_name(kernel)} event (torch.profiler "
                   f"dropped the window; kernels seen: {names[:5]})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="prog")
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--out", default="profiles/traces", help="trace directory (git-ignored)")
    ap.add_argument("--summary", default=None, help="also write the summary JSON here")
    ap.add_argument("--timeout", type=int, default=300)
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    dtype = DType.from_short(args.dtype)
    batch = args.batch or BATCH_SIZE_FOR_SEQ_LEN.get(args.seq, 4)
    launches: dict[tuple, dict] = {}
    rows = []
    for cfg in get_kernel_configs(args.kernels):
        if cfg.dtype != dtype or args.seq % cfg.block_q or args.seq % cfg.block_kv:
            continue
        name, kernel = cfg.short_form(), kernel_of(cfg)
        key = launch_key(cfg)
        if key not in launches:
            tdir = os.path.join(args.out, name)
            ok, msg = capture_trace(name, args.seq, args.heads, batch, tdir, args.timeout)
            summary = summarize_trace(tdir) if ok else {"trace": None}
            if ok:
                ok, msg = _traced(summary, KERNEL_FORI if cfg.kv_loop == KVLoop.FORI
                                  else KERNEL)
            q, k, v = generate_qkv(args.seq, d_head=cfg.d_head, n_heads=args.heads,
                                   batch=batch, dtype=cfg.dtype.torch_dtype, device=dev)
            secs = median_runtime(lambda: flash_forward(q, k, v, cfg), iters=3)
            launches[key] = {
                "kernel": kernel, "traced_as": name, "trace_captured": ok,
                **({} if ok else {"error": msg}),
                "device_ms_per_call": round(secs * 1e3, 4),
                "tflops": round(flops(cfg, args.seq, args.heads, batch) / secs / 1e12, 2),
                "hbm_gbps_model": round(_bytes(cfg, batch, args.heads, args.seq,
                                               sm_count(dev)) / secs / 1e9, 1),
                **summary}
            del q, k, v
        rows.append({"config": name, "seq": args.seq, "heads": args.heads, "batch": batch,
                     **launches[key]})
        print(json.dumps(rows[-1]))
    out = {"device": device_kind(), "rows": rows}
    if args.summary:
        os.makedirs(os.path.dirname(args.summary) or ".", exist_ok=True)
        with open(args.summary, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.summary}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
