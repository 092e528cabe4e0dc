#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check, serve, measure.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases: (1) print the card's name and power limit; (2) build every kernel
from ``flash_attention_from_scratch_tpu_torch/csrc`` with nvcc for sm_90a;
(3) hold each kernel against its plain PyTorch version on the card, in bf16,
by the adaptive tolerance rule in each sequence or 64-row band on its own;
(4) serve Llama-3-8B at full width and depth (random bf16 weights from a
seed) through ``GenerationServer``: 8 requests, 32 greedy tokens each, with
the launch counts of both kernels checked and two requests teacher-forced
through the full-recompute ``forward``; (5) profile a few decode steps of
the same server (device time by kernel, the card's busy share); (6) time
each kernel at the serving run's shapes beside its bound, its plain version
and the library call. Prints ``serve``, ``profile`` and ``kernels`` JSON
lines and, last, one JSON object with ``"ok": true``. Any failure raises,
so the exit code is not 0. Without a CUDA device it exits with code 2
before it does anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores and HBM3 bandwidth. The bound of a kernel is the larger of its
# operations over the first and its bytes over the second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FLASH_CASE_SEQS = (512, 2048, 4096)
HEADS, KV_HEADS, D = 32, 8, 128


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return smi


def phase_build() -> None:
    from flash_attention_from_scratch_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(["flash_forward.cu", "paged_attention.cu",
                         "paged_runtime.cpp"])
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"build {name}: {line.strip()}", flush=True)
    print(f"build: {sorted(logs)} in {secs:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)


def _cuda_qkv(sq, skv, seed):
    from flash_attention_from_scratch_tpu_torch.utils.testing import make_qkv

    q, k, v = make_qkv(1, HEADS, sq, D, kv_heads=KV_HEADS, seq_kv=skv, seed=seed)
    return [torch.from_numpy(x).to("cuda", torch.bfloat16) for x in (q, k, v)]


def phase_flash_cases() -> float:
    """K1 vs its plain version: every case passes the tolerance rule."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward_plain, flash_forward_with_lse)
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        row_bands, sliced_tolerance_check)

    cases = []
    for s in FLASH_CASE_SEQS:
        cases += [(f"causal s{s}", s, s, dict(causal=True), False),
                  (f"full s{s}", s, s, dict(), False)]
    cases += [
        ("q_offset 512 s512/1024", 512, 1024, dict(causal=True, q_offset=512), False),
        ("window 512 s2048", 2048, 2048, dict(causal=True, window=512), False),
        ("softcap 50 s1024", 1024, 1024, dict(causal=True, attn_softcap=50.0), False),
        ("sinks s1024", 1024, 1024, dict(causal=True), True),
    ]
    worst = 0.0
    for i, (name, sq, skv, kw, with_sinks) in enumerate(cases):
        q, k, v = _cuda_qkv(sq, skv, seed=i)
        sinks = (torch.from_numpy(np.random.default_rng(100 + i).standard_normal(
            HEADS).astype(np.float32) * 2).cuda() if with_sinks else None)
        cfg = KernelConfig(**kw)
        out, lse = flash_forward_with_lse(q, k, v, cfg, sinks=sinks)
        torch.cuda.synchronize()
        ref16, _ = flash_forward_plain(q, k, v, cfg, sinks)
        ref32, lse32 = flash_forward_plain(q.float(), k.float(), v.float(),
                                           _fp32(cfg), sinks)
        # The rule in each (batch, head, 64-row band) on its own.
        ok, ratio, where = sliced_tolerance_check(
            row_bands(out), row_bands(ref16), row_bands(ref32), lead=3)
        lse_err = float((lse - lse32).abs().max())
        err = float((out.float() - ref16.float()).abs().max())
        worst = max(worst, err)
        print(f"flash_forward {name}: max|kernel-plain| {err:.3e}, worst "
              f"err/bound {ratio:.3f} in (batch, head, band) {where}, lse err "
              f"{lse_err:.3e} {'ok' if ok and lse_err <= 1e-3 else 'FAIL'}",
              flush=True)
        if not (ok and lse_err <= 1e-3) or not torch.isfinite(out).all():
            raise AssertionError(f"flash_forward {name} disagrees with its plain version")
        torch.cuda.synchronize()
    return worst


def _fp32(cfg):
    import dataclasses

    from flash_attention_from_scratch_tpu_torch.ops.configs import DType

    return dataclasses.replace(cfg, dtype=DType.FP32)


def make_paged_pool(lengths, page_size, num_pages, seed, pages_per_seq,
                    device="cuda"):
    """A bf16 page pool holding each sequence's K/V under shuffled page ids.

    Pages no sequence owns, and each last page's slots past the length, hold
    NaN: the kernel must never read them. Returns (k_pages, v_pages,
    lengths, page_tables) on ``device``.
    """
    rng = np.random.default_rng(seed)
    need = [-(-n // page_size) for n in lengths]
    if sum(need) > num_pages:
        raise ValueError("pool too small")
    perm = rng.permutation(num_pages)
    k = np.full((KV_HEADS, num_pages, page_size, D), np.nan, np.float32)
    v = np.full_like(k, np.nan)
    tables = -np.ones((len(lengths), pages_per_seq), np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        for i in range(need[b]):
            page = perm[nxt]
            nxt += 1
            tables[b, i] = page
            rows = min(page_size, n - i * page_size)
            k[:, page, :rows] = rng.standard_normal((KV_HEADS, rows, D))
            v[:, page, :rows] = rng.standard_normal((KV_HEADS, rows, D))
    to = dict(device=device)
    return (torch.from_numpy(k).to(dtype=torch.bfloat16, **to),
            torch.from_numpy(v).to(dtype=torch.bfloat16, **to),
            torch.tensor(lengths, dtype=torch.int32, **to),
            torch.from_numpy(tables).to(**to))


def phase_paged_cases() -> float:
    """K4/K5 vs its plain version on a ragged, shuffled, NaN-poisoned pool."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        sliced_tolerance_check)

    lengths = [1, 17, 64, 65, 1000, 0, 2047, 3001, 4000]
    kp, vp, lens, tables = make_paged_pool(lengths, 64, 320, seed=7,
                                           pages_per_seq=64)
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((len(lengths), HEADS, D)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    worst = 0.0
    for name, kw in (("dense", {}), ("window 1000", dict(window=1000)),
                     ("softcap 30", dict(softcap=30.0))):
        out = paged_decode_attention(q, kp, vp, lens, tables, **kw)
        torch.cuda.synchronize()
        scale = D ** -0.5
        ref16 = paged_decode_attention_plain(q, kp, vp, lens, tables,
                                             scale=scale, **kw)
        ref32 = paged_decode_attention_plain(q.float(), kp.float(), vp.float(),
                                             lens, tables, scale=scale, **kw)
        # The rule for each sequence on its own.
        ok, ratio, where = sliced_tolerance_check(out, ref16, ref32, lead=1)
        zero_row = float(out[lengths.index(0)].float().abs().max())
        err = float((out.float() - ref16.float()).abs().max())
        worst = max(worst, err)
        good = ok and zero_row == 0.0 and bool(torch.isfinite(out).all())
        print(f"paged_decode_attention {name}: max|kernel-plain| {err:.3e}, "
              f"worst err/bound {ratio:.3f} at length {lengths[where[0]]}, "
              f"length-0 row {zero_row} {'ok' if good else 'FAIL'}", flush=True)
        if not good:
            raise AssertionError(
                f"paged_decode_attention {name} disagrees with its plain version")
        torch.cuda.synchronize()
    return worst


SERVE_PROMPT_LENS = (200, 513, 1024, 1500, 2048, 2500, 3000, 4000)
SERVE_NEW_TOKENS = 32
SERVE_PAGE_SIZE, SERVE_PAGES, SERVE_PAGES_PER_SEQ = 64, 257, 64
TEACHER_FORCED = (513, 2048)  # prompt lengths checked against forward()
SLACK = 0.05  # a served token's logit may sit this far below the row max


def _teacher_forced_check(params, cfg, prompt, generated):
    """Each served token must be a top-scoring choice of the full-recompute
    model: its logit within SLACK of the row max (random bf16 weights tie
    within an ulp, so exact argmax equality is too strict)."""
    from flash_attention_from_scratch_tpu_torch import forward

    toks = list(prompt) + list(generated[:-1])
    pad = len(toks) + (-len(toks)) % 64
    arr = torch.zeros((1, pad), dtype=torch.int64, device="cuda")
    arr[0, :len(toks)] = torch.tensor(toks, device="cuda")
    logits = forward(params, arr, cfg)[0]
    rows = logits[len(prompt) - 1:len(prompt) - 1 + len(generated)]
    if not torch.isfinite(rows).all():
        raise AssertionError("non-finite logits in the full-recompute forward")
    gen = torch.tensor(generated, device="cuda")
    gaps = rows.max(-1).values - rows.gather(1, gen[:, None])[:, 0]
    worst = float(gaps.max())
    if worst > SLACK:
        raise AssertionError(f"served token {int(gaps.argmax())} of a "
                             f"{len(prompt)}-token prompt is {worst} below the max")
    return worst


def phase_serve(smi: str) -> dict:
    """Serve LLAMA3_8B at full width and depth; check counts and tokens."""
    from flash_attention_from_scratch_tpu_torch import (
        LLAMA3_8B, GenerationServer, init_params)
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP
    from flash_attention_from_scratch_tpu_torch.serving import generate

    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    server = GenerationServer(params, cfg, num_pages=SERVE_PAGES,
                              page_size=SERVE_PAGE_SIZE, max_batch=8,
                              pages_per_seq=SERVE_PAGES_PER_SEQ)
    torch.cuda.synchronize()
    print(f"serve: LLAMA3_8B params {sum(p.numel() for p in _leaves(params)) / 1e9:.2f} B, "
          f"KV pool {server.cache.nbytes() / 1e9:.2f} GB, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # Every logit the server picks from must be finite; summed on the card
    # and read once after the run.
    nonfinite = torch.zeros((), dtype=torch.int64, device="cuda")
    plain_greedy = generate.greedy_token

    def greedy_checked(logits):
        nonfinite.add_((~torch.isfinite(logits)).sum())
        return plain_greedy(logits)

    generate.greedy_token = greedy_checked
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(SERVE_PROMPT_LENS)}
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()  # counts start at 0 just before the main path
    t_start = time.perf_counter()
    for sid, prompt in prompts.items():
        server.submit(sid, prompt, SERVE_NEW_TOKENS)
    prefill_s = decode_s = 0.0
    decode_tokens = 0
    try:
        while server.has_work:
            before = server.stats()
            t = time.perf_counter()
            server.step()  # ends in a device-to-host copy of the tokens
            dt = time.perf_counter() - t
            after = server.stats()
            if after["prefill_tokens"] > before["prefill_tokens"]:
                prefill_s += dt
            else:
                decode_s += dt
                decode_tokens += after["decode_tokens"] - before["decode_tokens"]
    finally:
        generate.greedy_token = plain_greedy
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = dict(_build.launch_counts)  # read just after the main path
    stats = server.stats()

    got = {sid: st.generated for sid, st in server.seqs.items()}
    if any(len(g) != SERVE_NEW_TOKENS for g in got.values()):
        raise AssertionError(f"token counts {[len(g) for g in got.values()]}")
    if int(nonfinite) != 0:
        raise AssertionError(f"{int(nonfinite)} non-finite logits while serving")
    if stats["preemptions"] != 0:
        raise AssertionError(f"{stats['preemptions']} preemptions")
    want_k1 = cfg.n_layers * len(prompts)
    want_kp = cfg.n_layers * stats["decode_steps"]
    print(f"serve: launches {counts}; expected {K1} {want_k1}, {KP} "
          f"{cfg.n_layers} x {stats['decode_steps']} decode steps = {want_kp}",
          flush=True)
    if counts.get(K1, 0) != want_k1 or counts.get(KP, 0) != want_kp:
        raise AssertionError("a kernel of the main path ran the wrong number of times")

    for n in TEACHER_FORCED:
        sid = SERVE_PROMPT_LENS.index(n)
        gap = _teacher_forced_check(params, cfg, prompts[sid], got[sid])
        print(f"serve: teacher-forced prompt {n}: {len(got[sid])} tokens, worst gap {gap:.4f} "
              f"<= {SLACK} ok", flush=True)

    ttft = sorted(st.first_t - st.submit_t for st in server.seqs.values())
    serve = {
        "model": "LLAMA3_8B", "layers": cfg.n_layers, "requests": len(prompts),
        "prompt_tokens": stats["prefill_tokens"],
        "new_tokens_per_request": SERVE_NEW_TOKENS,
        "prefill_tok_s": stats["prefill_tokens"] / prefill_s,
        "decode_tok_s": decode_tokens / decode_s,
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
        "wall_s": wall, "steps": stats["steps"],
        "decode_steps": stats["decode_steps"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "gpu": smi,
    }
    print(json.dumps({"serve": serve}), flush=True)
    return {"server": server, "prompts": prompts, "counts": counts}


def phase_profile(server, prompts, steps: int = 4) -> None:
    """Where a full-width decode step's time goes, from torch.profiler.

    Serves the same prompts again (after the counted main-path run) and
    traces ``steps`` decode-only steps: device time per step by kernel, and
    the device's busy share of the wall time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for sid, prompt in prompts.items():
        server.submit(1000 + sid, prompt, steps + 1)
    server.step()  # the prefills
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            server.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps({"profile": {
        "decode_steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / wall_ms,
        "launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels_ms_per_step": {
            e.key[:80]: e.self_device_time_total / 1e3 / steps for e in top},
    }}), flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _padded(n: int) -> int:
    from flash_attention_from_scratch_tpu_torch.serving.generate import (
        PROMPT_QUANTUM)

    return n + (-n) % PROMPT_QUANTUM


def time_flash() -> dict:
    """K1 at the serving run's prefill shapes: one layer, all 8 prompts."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import (
        KernelConfig, calc_causal_attn_flop)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward, flash_forward_plain)

    cfg = KernelConfig(causal=True)
    ms = plain_ms = lib_ms = bound_ms = 0.0
    for i, n in enumerate(SERVE_PROMPT_LENS):
        s = _padded(n)
        q, k, v = _cuda_qkv(s, s, seed=50 + i)
        ms += _time_ms(lambda: flash_forward(q, k, v, cfg))
        lib_ms += _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        plain_ms += _time_ms(lambda: flash_forward_plain(q, k, v, cfg), iters=3,
                             warmup=1)
        flops = calc_causal_attn_flop(s, D, HEADS, 1)
        nbytes = 2 * (2 * s * HEADS * D + 2 * s * KV_HEADS * D)  # q, o, k, v
        bound_ms += 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
        del q, k, v
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": "operations",
            "shape": "sum over the 8 padded prompts "
                     f"{[_padded(n) for n in SERVE_PROMPT_LENS]}: causal, "
                     f"b 1, {HEADS}/{KV_HEADS} heads, d {D}, bf16 (one layer)"}


def time_paged() -> dict:
    """K4/K5 at the serving run's first decode step: 8 sequences."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    lengths = [n + 1 for n in SERVE_PROMPT_LENS]
    kp, vp, lens, tables = make_paged_pool(
        lengths, SERVE_PAGE_SIZE, SERVE_PAGES, seed=60,
        pages_per_seq=SERVE_PAGES_PER_SEQ)
    q = torch.from_numpy(np.random.default_rng(61).standard_normal(
        (len(lengths), HEADS, D)).astype(np.float32)).to("cuda", torch.bfloat16)
    ms = _time_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables),
                  iters=50, warmup=5)
    plain_ms = _time_ms(lambda: paged_decode_attention_plain(
        q, kp, vp, lens, tables, scale=D ** -0.5), iters=3, warmup=1)
    nbytes = sum(lengths) * KV_HEADS * D * 2 * 2 + 2 * q.numel() * 2
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
            "shape": f"first decode step: lengths {lengths}, page {SERVE_PAGE_SIZE}, "
                     f"{HEADS}/{KV_HEADS} heads, d {D}, bf16 (one layer)"}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only",
              file=sys.stderr)
        return 2
    # Without the package beside this script, fail before printing anything.
    import flash_attention_from_scratch_tpu_torch  # noqa: F401

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    flash_err = phase_flash_cases()
    paged_err = phase_paged_cases()
    served = phase_serve(smi)
    counts = served["counts"]
    phase_profile(served["server"], served["prompts"])
    del served  # frees the 16 GB of weights before the timing phase
    torch.cuda.empty_cache()

    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP

    pkg = "flash_attention_from_scratch_tpu_torch/csrc/"
    kernels = [
        {"name": K1, "route": "cuda", "source": pkg + "flash_forward.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_forward.py:284",
         "launches": counts.get(K1, 0), "max_abs_err": flash_err, **time_flash()},
        {"name": KP, "route": "cuda", "source": pkg + "paged_attention.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/paged_attention.py:280",
         "also_replaces": "flash_attention_from_scratch_tpu/ops/paged_attention.py:69",
         "launches": counts.get(KP, 0), "max_abs_err": paged_err, **time_paged()},
    ]
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
