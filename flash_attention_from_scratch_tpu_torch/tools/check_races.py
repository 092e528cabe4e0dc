"""Hazard checking for the kernels that drive their own copies, on the card.

Counterpart of ``flash_attention_from_scratch_tpu/tools/check_races.py`` (the
reference's ``tools/debug/check_race.sh``: compute-sanitizer racecheck over
a small workload). The JAX tool runs its kernels in the Pallas interpreter
and the TPU emulator; on Hopper the kernels run on the card, and the modes
map to NVIDIA's ``compute-sanitizer``:

1. **eager (default, fast)**: each case's kernel on the card, held to its
   plain version on the same inputs at the JAX tool's shapes and bound
   (max|diff| < 0.05; for the cases beyond the JAX tool's two kernels, 0.05
   times the plain output's largest magnitude, at least 1). Memory a case
   never reads is NaN: K/V rows past the sequence, page positions past a
   sequence's length, whole pages below a window and pages no table names,
   so a read that escapes its mask shows as NaN (the JAX tool's emulator
   poisons memory for the same reason).
2. **on-wait**: the eager cases in a child process under
   ``compute-sanitizer --tool memcheck``, then ``--tool initcheck``: the
   nearest counterparts of the emulator's poisoned memory and its
   least-eager copy order (out-of-bounds and misaligned accesses, reads of
   memory never written).
3. **vector-clocks**: the eager cases under ``--tool racecheck``
   (shared-memory hazards), then ``--tool synccheck`` (barrier misuse).

Cases (``--kernels``, a comma list of groups; default all): ``k11`` (the
FORI forward at s 384, b 1, one head, ring depths 1-4, d 128 and 256),
``k4k5`` (paged decode at pages_per_seq 2 and 6, page 128, lengths
``[pps*128-3, 129]``, pps 6 also with a window of 200; one int8-page case),
and beyond the JAX tool's two kernels, one small launch of each other
TMA/mbarrier kernel: ``k1`` (causal, window, d 128 and 256), ``k2k3`` (K2
and K3), ``k10`` (an upcast variant and int8c), ``k6k9`` (K6-K9 at decode
m 16). The sanitizer instruments only the port's kernels (its
``--kernel-name`` filter), not torch's.

Before the cases' child, each sanitizer tool runs a probe that only opens
a CUDA context and allocates: if the sanitizer prints its "Device not
supported" banner there, the child is not started and every group is
reported as refused, with the sanitizer's and the driver's versions.

Each (kernel group, mode) prints one line, then ``PASS`` or ``FAIL``. Exit
codes: 0 when every eager case held and every sanitizer run reported zero
errors and hazards; 1 when a case failed or a sanitizer run of the cases
reported an error or hazard (whatever else it printed); 2 when nothing
failed but some case could not be checked (the sanitizer is missing, or its
run of the cases printed no summary, no count or ran out of time); 3 when
nothing failed or went unchecked otherwise but the sanitizer refused this
card at its probe. None of 1-3 is a pass. On the card only: raises without
one.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.check_races
    python -m flash_attention_from_scratch_tpu_torch.tools.check_races \\
        --mode vector-clocks --kernels k11,k4k5
"""

from __future__ import annotations

import argparse
import math
import os
import re
import shutil
import subprocess
import sys

import torch

from ..ops import _build
from ..ops.configs import KernelConfig, KVLoop
from ..ops.flash_backward import flash_backward, flash_backward_plain
from ..ops.flash_forward import D_HEADS, flash_forward, flash_forward_plain, flash_forward_with_lse
from ..ops.flash_quant import flash_forward_quantized, flash_forward_quantized_plain
from ..ops.paged_attention import paged_decode_attention, paged_decode_attention_plain
from ..ops.quant import quantize_kv, quantize_kv_pages
from ..ops.quant_matmul import quant_matmul, quant_matmul_plain
from ..utils.device import resolve_device

__all__ = ["MODES", "SANITIZER_TOOLS", "GROUPS", "KERNEL_FILTERS", "BOUND", "REFUSED_RC", "main",
           "child_command", "parse_report", "find_sanitizer", "run_eager", "sanitizer_run",
           "verdict", "versions"]

MODES = ("eager", "on-wait", "vector-clocks")
SANITIZER_TOOLS = {"on-wait": ("memcheck", "initcheck"),
                   "vector-clocks": ("racecheck", "synccheck")}
BOUND = 0.05  # the JAX tool's max|diff| against its oracle
REFUSED_RC = 3  # the exit code when the only gap is a probe the sanitizer refused
FORI_DEPTHS = (1, 2, 3, 4)
# Kernel group -> regular expression of its kernels' mangled names, the
# sanitizer's --kernel-name filter.
KERNEL_FILTERS = {
    "k11": "flash_forward_fori_kernel",
    "k4k5": "paged_decode_",
    "k1": "flash_forward_kernel",
    "k2k3": "flash_backward_",
    "k10": "flash_quant_",
    "k6k9": "quant_matmul_|quantize_rows_kernel",
}
GROUPS = tuple(KERNEL_FILTERS)
MODULE = "flash_attention_from_scratch_tpu_torch.tools.check_races"  # the child's -m


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def _normal(shape, gen) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def _poisoned_rows(x: torch.Tensor, extra: int = 128) -> torch.Tensor:
    """A view of ``x`` (b, h, s, d) whose storage runs on ``extra`` NaN
    rows past the sequence, so a read past seq shows."""
    b, h, s, d = x.shape
    store = torch.full((b, h, s + extra, d), float("nan"), dtype=x.dtype, device=x.device)
    store[:, :, :s] = x
    return store[:, :, :s]


def _err(out, ref) -> float:
    """max|out - ref| in fp32; NaN if either holds a NaN."""
    diff = (out.float() - ref.float()).abs()
    return float("nan") if diff.isnan().any() else float(diff.max())


def _report(what: str, errs, bounds, log) -> bool:
    """Log one case's errors; True when each is finite and below its bound."""
    ok = all(math.isfinite(e) and e < b for e, b in zip(errs, bounds))
    log(f"  {what}: max|diff|=" + "/".join(f"{e:.3e}" for e in errs)
        + f" {'ok' if ok else 'HAZARD'}")
    return ok


def _scaled_bound(ref) -> float:
    """0.05 times the plain output's largest magnitude (at least 1)."""
    return BOUND * max(1.0, float(ref.float().abs().max()))


def check_fori_forward(num_kv_buffers: int, d_head: int = 128, log=print) -> bool:
    """K11 at the JAX tool's shape (s 384, b 1, one head), K/V rows past
    the sequence NaN, against its plain version."""
    gen = _gen(num_kv_buffers + d_head)
    q, k, v = (_normal((1, 1, 384, d_head), gen) for _ in range(3))
    cfg = KernelConfig(block_q=128, block_kv=128, kv_loop=KVLoop.FORI,
                       num_kv_buffers=num_kv_buffers, d_head=d_head)
    out = flash_forward(_poisoned_rows(q), _poisoned_rows(k), _poisoned_rows(v), cfg)
    err = _err(out, flash_forward_plain(q, k, v, cfg)[0])
    return _report(f"fori forward nbuf={num_kv_buffers} d={d_head}", [err], [BOUND], log)


def _paged_pool(pages_per_seq: int, lengths, window: int, gen):
    """The JAX tool's pool (kv_heads 1, page 128, a page per table entry)
    plus two pages no table names; (clean K, clean V, poisoned K, poisoned
    V, page tables). Poisoned: positions past a sequence's length, whole
    pages below its window, and the unnamed pages."""
    batch, page_size = len(lengths), 128
    num_pages = batch * pages_per_seq + 2
    kp, vp = (_normal((1, num_pages, page_size, 128), gen) for _ in range(2))
    tables = torch.arange(batch * pages_per_seq, dtype=torch.int32,
                          device="cuda").reshape(batch, pages_per_seq)
    keep = torch.zeros((num_pages, page_size), dtype=torch.bool, device="cuda")
    for b, length in enumerate(lengths):
        pos = torch.arange(pages_per_seq * page_size, device="cuda")
        live = pos < length
        if window:
            page_end = (pos // page_size + 1) * page_size
            live &= page_end > length - window
        keep[tables[b].long()] = live.reshape(pages_per_seq, page_size)
    nan = torch.tensor(float("nan"), dtype=kp.dtype, device="cuda")
    poison = keep[None, :, :, None]
    return kp, vp, torch.where(poison, kp, nan), torch.where(poison, vp, nan), tables


def check_paged_decode(pages_per_seq: int, log=print, window: int = 0,
                       mode: str = "dense") -> bool:
    """K4/K5 at the JAX tool's shapes (batch 2, kv_heads 1, heads 2, d 128,
    page 128, lengths [pps*128-3, 129]) on a NaN-poisoned pool, against its
    plain version on the clean pool."""
    gen = _gen(pages_per_seq + window)
    lengths = [pages_per_seq * 128 - 3, 129]
    kp, vp, kp_bad, vp_bad, tables = _paged_pool(pages_per_seq, lengths, window, gen)
    q = _normal((2, 2, 128), gen)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(scale=128 ** -0.5, window=window)
    if mode == "int8":
        (kq, ks), (vq, vs) = quantize_kv_pages(kp, "int8"), quantize_kv_pages(vp, "int8")
        # int8 holds no NaN: a page never read gets a NaN scale instead.
        ks_bad = torch.where(kp_bad.isnan().all(dim=(2, 3)), float("nan"), ks)
        vs_bad = torch.where(vp_bad.isnan().all(dim=(2, 3)), float("nan"), vs)
        out = paged_decode_attention(q, kq, vq, lens, tables, mode="int8", k_scales=ks_bad,
                                     v_scales=vs_bad, window=window)
        ref = paged_decode_attention_plain(q, kq, vq, lens, tables, mode="int8",
                                           k_scales=ks, v_scales=vs, **kw)
    else:
        out = paged_decode_attention(q, kp_bad, vp_bad, lens, tables, window=window)
        ref = paged_decode_attention_plain(q, kp, vp, lens, tables, **kw)
    tag = f"pages={pages_per_seq}" + (f" window={window}" if window else "") + (
        f" {mode}" if mode != "dense" else "")
    return _report(f"paged decode {tag}", [_err(out, ref)], [BOUND], log)


def check_flash_forward(d_head: int, log=print) -> bool:
    """K1, causal with a window of 100, at s 384 (b 1, 2 heads), rows past
    the sequence NaN, against its plain version."""
    gen = _gen(d_head)
    q, k, v = (_normal((1, 2, 384, d_head), gen) for _ in range(3))
    cfg = KernelConfig(causal=True, window=100, d_head=d_head)
    out = flash_forward(_poisoned_rows(q), _poisoned_rows(k), _poisoned_rows(v), cfg)
    ref = flash_forward_plain(q, k, v, cfg)[0]
    return _report(f"flash forward causal window=100 d={d_head}", [_err(out, ref)],
                   [_scaled_bound(ref)], log)


def check_flash_backward(fused: bool, log=print) -> bool:
    """K2 (``fused``) or K3, causal at s 384 (b 1, 2 heads, d 128), against
    the plain backward on the same saved (O, LSE)."""
    gen = _gen(int(fused))
    q, k, v, do = (_normal((1, 2, 384, 128), gen) for _ in range(4))
    cfg = KernelConfig(causal=True)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    got = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
    want = flash_backward_plain(q, k, v, o, lse, do, cfg)
    return _report(f"flash backward {'K2' if fused else 'K3'} causal (dq/dk/dv)",
                   [_err(g, w) for g, w in zip(got, want)],
                   [_scaled_bound(w) for w in want], log)


def check_flash_quant(int8_compute: bool, log=print) -> bool:
    """K10 at s 384 (b 1, 2 heads, d 128): int8 K/V upcast, or int8 Q/K/V
    on int8 products, against its plain version."""
    gen = _gen(10 + int(int8_compute))
    q, k, v = (_normal((1, 2, 384, 128), gen) for _ in range(3))
    cfg = KernelConfig()
    kq, vq = quantize_kv(k, "int8"), quantize_kv(v, "int8")
    qq = quantize_kv(q, "int8") if int8_compute else q
    out = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=int8_compute)
    ref = flash_forward_quantized_plain(qq, kq, vq, cfg, scale=cfg.softmax_scale,
                                        int8_compute=int8_compute)
    return _report(f"flash quant {'int8c' if int8_compute else 'int8kv'}", [_err(out, ref)],
                   [_scaled_bound(ref)], log)


def check_quant_matmul(mode: str, act_quant: bool, log=print) -> bool:
    """K6-K9 at decode (m 16, K 512, N 256) against the plain version."""
    from ..models.llama import random_quantized_weight

    gen = _gen(6)
    x = _normal((16, 512), gen)
    w = random_quantized_weight((512, 256), mode, "int8" if act_quant else "bf16", gen)
    out = quant_matmul(x, w, act_quant=act_quant)
    ref = quant_matmul_plain(x, w, act_quant)
    return _report(f"quant matmul {mode}{' a8' if act_quant else ''} m16", [_err(out, ref)],
                   [_scaled_bound(ref)], log)


def _cases(group: str) -> list:
    """The zero-argument checks of one kernel group."""
    if group == "k11":
        return [lambda nb=nb, d=d: check_fori_forward(nb, d)
                for d in D_HEADS for nb in FORI_DEPTHS]
    if group == "k4k5":
        # Sliding window: pages below it are never read; poisoned, any
        # mask slip or 0 * NaN leak shows up here.
        return [lambda: check_paged_decode(2), lambda: check_paged_decode(6),
                lambda: check_paged_decode(6, window=200),
                lambda: check_paged_decode(2, mode="int8")]
    if group == "k1":
        return [lambda d=d: check_flash_forward(d) for d in D_HEADS]
    if group == "k2k3":
        return [lambda: check_flash_backward(True), lambda: check_flash_backward(False)]
    if group == "k10":
        return [lambda: check_flash_quant(False), lambda: check_flash_quant(True)]
    if group == "k6k9":
        return [lambda m=m, a=a: check_quant_matmul(m, a)
                for a in (False, True) for m in ("int8", "int4")]
    raise ValueError(f"unknown kernel group {group!r}; one of {GROUPS}")


def run_eager(groups) -> dict[str, bool]:
    """{group: every case held} for the eager mode."""
    out = {}
    for group in groups:
        ok = True
        for case in _cases(group):
            ok &= case()
        torch.cuda.synchronize()
        out[group] = ok
    return out


def find_sanitizer() -> str | None:
    """``compute-sanitizer`` beside ``nvcc`` in the CUDA toolkit (else on
    the PATH), or None."""
    try:
        path = os.path.join(os.path.dirname(_build._nvcc()), "compute-sanitizer")
    except RuntimeError:
        path = ""
    if os.path.exists(path):
        return path
    return shutil.which("compute-sanitizer")


# The sanitizer's banner when it cannot attach to the card at all; only the
# probe's output is read for it (see :func:`sanitizer_run`).
_REFUSED = re.compile(r"^========= Error: Device not supported\b.*$", re.M)
_ERROR_SUMMARY = re.compile(r"ERROR SUMMARY: (\d+) error")
_RACE_SUMMARY = re.compile(r"RACECHECK SUMMARY: (\d+) hazards? displayed \((\d+) errors?, "
                           r"(\d+) warnings?\)")


def parse_report(text: str, tool: str, rc: int, groups=GROUPS, probe: bool = False) -> dict:
    """What one sanitizer run says: {"status": "pass" | "fail" |
    "unchecked" | "refused", "errors": n or None, "hazards": n or None,
    "by_group": {group: errors attributed to its kernels}, "detail": str}.

    Of the cases' run, any error or hazard fails it, whatever else it
    printed; then a missing summary or the refusal banner leaves it
    unchecked, and a child that exited non-zero (its eager check failed
    under the sanitizer) fails it. Of the ``probe`` (which launches no
    kernel), the refusal banner alone makes it "refused": the errors that
    follow it are the probe's own calls failing."""
    lines = [ln for ln in text.splitlines() if ln.startswith("=========")]
    banner = _REFUSED.search(text)
    refused = banner.group(0).strip("= ").strip() if banner else None
    errors = hazards = None
    if m := _ERROR_SUMMARY.search(text):
        errors = int(m.group(1))
    if m := _RACE_SUMMARY.search(text):
        hazards, errors = int(m.group(1)), int(m.group(2)) + int(m.group(3))
    by_group = {g: 0 for g in groups}
    for i, ln in enumerate(lines):
        body = ln.strip("= ").strip()
        if not re.match(r"(Invalid|Error|Race|Uninitialized|Barrier|Warning|Potential)", body):
            continue
        block = " ".join(lines[i:i + 4])
        for g in groups:
            if re.search(KERNEL_FILTERS[g], block):
                by_group[g] += 1
                break
    if probe and refused:
        status, detail = "refused", f"{tool} refused: {refused}"
    elif errors or hazards:
        status, detail = "fail", f"{tool}: {errors} errors, {hazards or 0} hazards"
    elif refused:
        status, detail = "unchecked", f"{tool} refused the cases: {refused}"
    elif errors is None:
        tail = " | ".join(text.strip().splitlines()[-3:])
        status, detail = "unchecked", f"{tool} printed no summary (exit {rc}): {tail[-300:]}"
    elif rc != 0:
        status, detail = "fail", f"{tool}: 0 errors, but the cases failed (exit {rc})"
    else:
        status, detail = "pass", f"{tool}: 0 errors" + (", 0 hazards" if tool == "racecheck"
                                                        else "")
    return {"status": status, "errors": errors, "hazards": hazards, "by_group": by_group,
            "detail": detail}


def versions(sanitizer: str) -> str:
    """The sanitizer's version line and the card's driver version, for a
    refusal's report."""
    def first(cmd, pick):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout
        except (OSError, subprocess.TimeoutExpired):
            return "unknown"
        return next((ln.strip() for ln in out.splitlines() if pick(ln)), "unknown")

    tool = first([sanitizer, "--version"], lambda ln: ln.startswith("Version"))
    driver = first(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                   lambda ln: ln.strip())
    return f"compute-sanitizer {tool}, driver {driver}"


# Opens a CUDA context and allocates through the driver, nothing else: run
# under the sanitizer first, it shows in a second whether the sanitizer can
# attach to this card at all, before the cases' child spends its start-up.
_PROBE = ("import ctypes; c = ctypes.CDLL('libcuda.so.1'); d, x, p = ctypes.c_int(), "
          "ctypes.c_void_p(), ctypes.c_void_p(); c.cuInit(0); "
          "c.cuDeviceGet(ctypes.byref(d), 0); c.cuCtxCreate_v2(ctypes.byref(x), 0, d); "
          "c.cuMemAlloc_v2(ctypes.byref(p), 256)")


def child_command(sanitizer: str, tool: str, groups) -> list[str]:
    """The command that runs the eager cases of ``groups`` under ``tool``,
    instrumenting only their kernels."""
    cmd = [sanitizer, "--tool", tool, "--print-limit", "100"]
    for g in groups:
        cmd += ["--kernel-name", f"regex={KERNEL_FILTERS[g]}"]
    if tool == "racecheck":
        cmd += ["--racecheck-report", "all"]
    return cmd + [sys.executable, "-m", MODULE, "--mode", "eager", "--kernels", ",".join(groups)]


def sanitizer_run(tool: str, groups, timeout: float = 900.0) -> dict:
    """The eager cases of ``groups`` in a child process under
    ``compute-sanitizer --tool <tool>``, instrumenting only their kernels;
    :func:`parse_report` of its output, or an unchecked result when the
    sanitizer is missing or the child ran out of time; a refused result
    when the sanitizer refuses a context-only probe (then the cases' child
    is not started)."""
    sanitizer = find_sanitizer()
    if sanitizer is None:
        return {"status": "unchecked", "errors": None, "hazards": None,
                "by_group": {}, "detail": "compute-sanitizer not found beside nvcc"}
    try:
        probe = subprocess.run([sanitizer, "--tool", tool, sys.executable, "-c", _PROBE],
                               capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        probe = None
    if probe is not None:
        res = parse_report(probe.stdout + probe.stderr, tool, probe.returncode, groups,
                           probe=True)
        if res["status"] == "refused":
            res["detail"] += (f" (probe: a bare CUDA context, before the cases ran; "
                              f"{versions(sanitizer)})")
            return res
    cmd = child_command(sanitizer, tool, groups)
    env = dict(os.environ)
    if tool in ("memcheck", "initcheck"):
        # Each tensor its own allocation, so an access past it is out of bounds.
        env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return {"status": "unchecked", "errors": None, "hazards": None, "by_group": {},
                "detail": f"{tool} did not finish within {timeout:.0f} s"}
    return parse_report(proc.stdout + proc.stderr, tool, proc.returncode, groups)


def verdict(statuses) -> int:
    """The exit code of a set of statuses: 1 if any failed, else 2 if any
    was unchecked, else ``REFUSED_RC`` if any was refused, else 0."""
    statuses = list(statuses)
    for status, rc in (("fail", 1), ("unchecked", 2), ("refused", REFUSED_RC)):
        if status in statuses:
            return rc
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="eager", choices=list(MODES),
                    help="eager: the kernels against their plain versions on poisoned "
                         "memory; on-wait: under compute-sanitizer memcheck and initcheck; "
                         "vector-clocks: under racecheck and synccheck")
    ap.add_argument("--kernels", default=",".join(GROUPS),
                    help="comma list of kernel groups: " + ",".join(GROUPS))
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a sanitizer run may take")
    args = ap.parse_args(argv)
    groups = [g for g in args.kernels.split(",") if g]
    for g in groups:
        if g not in KERNEL_FILTERS:
            ap.error(f"unknown kernel group {g!r}; one of {','.join(GROUPS)}")
    resolve_device("cuda")
    print(f"hazard check: mode={args.mode} kernels={','.join(groups)}", flush=True)
    statuses = []
    if args.mode == "eager":
        for group, ok in run_eager(groups).items():
            print(f"{group} eager: {'ok' if ok else 'HAZARD'}", flush=True)
            statuses.append("pass" if ok else "fail")
    else:
        for tool in SANITIZER_TOOLS[args.mode]:
            res = sanitizer_run(tool, groups, args.timeout)
            for g in groups:
                status = res["status"]
                if status == "fail" and any(res["by_group"].values()):
                    status = "fail" if res["by_group"].get(g) else "pass"
                print(f"{g} {tool}: {status} ({res['detail']}; "
                      f"attributed {res['by_group'].get(g, 0)})", flush=True)
                statuses.append(status)
    rc = verdict(statuses)
    if rc in (2, REFUSED_RC):
        gaps = statuses.count("unchecked") + statuses.count("refused")
        print(f"{gaps} of {len(statuses)} (kernel, mode) runs could not be checked: not a pass")
    print("PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
