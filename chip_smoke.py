#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check, serve, train, measure.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases: (1) print the card's name and power limit; (2) build every kernel
from ``flash_attention_from_scratch_tpu_torch/csrc`` with nvcc for sm_90a,
in parallel; (3) hold each kernel against its plain PyTorch version on the
card, in bf16, by the adaptive tolerance rule in each sequence or 64-row
band on its own: the flash forward (K1), paged decode (K4/K5) on dense,
int8, fp8 and int4 pages, the quantized matmuls (K6-K9) at every weight
shape of Llama-3-8B at 16, 32, 64 and 1024 rows and K6/K7 at 1000 (K8/K9
also within one bf16 ulp of the plain int32 path), and the flash backward, fused (K2) and split
(K3), each also at the training run's shape and strided layout, plus
autograd with sinks against autograd of the reference; (4) serve
Llama-3-8B at full width and depth (random bf16 weights from a seed)
through ``GenerationServer``: 8 requests, 32 greedy tokens each, with the
launch counts of both kernels checked and two requests teacher-forced
through the full-recompute ``forward``; (5) profile a few decode steps of
the same server (device time by kernel, the card's busy share), then serve
again on the same weights with speculative decoding (``spec_k=3``: prompts
that repeat a 37-token phrase, drafts by prompt lookup, verify steps on the
multi-token K4/K5; ``serve_spec`` line); (6) train
Llama-3-8B at full width and 8 layers (AdamW, batch 2 x 2048 tokens) for 3
steps with the fused backward, checking the loss falls and the launch
counts, profile one more step, then take one step in PyTorch's
deterministic mode, which runs the split backward, with its counts
checked, the loss after it falling, and K2 and K3 held against the plain
backward on every layer's recorded attention inputs; (7) serve quantized
Llama-3-8B at full width (``init_quantized_params`` from a seed), runs A-D
of ``QUANT_RUNS``: A int8 weights (K6) and int8 KV, B W4A8 (K9) and int8
KV, both at full depth with 16 requests of 1024 tokens; C W8A8 (K8) and
fp8 KV, D int4 weights (K7) and int4 KV, both at 4 layers with 4 requests;
**E** run A with int8-compute attention (``attn_int8``) and **F** int8
KV, ``attn_int8`` and ``spec_k=3`` at 4 layers with 4 requests; each checks
every token, finite logits, each kernel's launch count and two requests
teacher-forced through ``forward``, and run A's decode steps are
profiled; (8) drive the attention bench tools, the path of quantized
prefill attention (K10) and of the K/V-ring forward (K11):
``tools/bench_quant.py`` at its default shapes with its numerics check,
and ``tools/bench_attention.py --fori``, each with its kernel's launches
counted, then hold K10 (every variant) and K11 (depth 2) against their
plain versions on the tools' own inputs at those shapes; (9) time each kernel at its path's shapes beside its bound, its
plain version and the library call, with K6-K9's registers and spills
from the build (K4/K5 also per page format, with
t = 4 query tokens at the speculative run's first verify step and with
int8 compute at run E's step, each beside the single-token call; K10 per
variant and K11 per ring depth at b 4, s 4096, with their registers
and spills from the build). Phase (3) also holds
K4/K5's multi-token q (t = 2, 4, 8 on every page format, with a window and
a softcap) and int8 compute (t = 1 and 4) per (sequence, token), K11
at ring depths 1-4 on every K1 case, and K10 for every variant (int8
compute, int8/fp8/int4 K/V, bf16/int8/fp8 Q), non-causal and causal, with
windows, a softcap and strided Q, against its plain version. Prints
``serve``, ``profile``, ``serve_spec``, ``train``, ``serve_quant``, ``bench_quant``,
``bench_attention`` and ``kernels`` JSON lines and, last, one JSON object
with ``"ok": true``. Any failure raises, so the exit code is not 0.
Without a CUDA device it exits with code 2 before it does anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import sys
import time
import warnings

import numpy as np
import torch

# Without the package beside this script, fail here, before printing anything.
from flash_attention_from_scratch_tpu_torch.dispatch import median_runtime, sync
from flash_attention_from_scratch_tpu_torch.tools import bench_attention, bench_quant

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores and HBM3 bandwidth. The bound of a kernel is the larger of its
# operations over the first and its bytes over the second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FLASH_CASE_SEQS = (512, 2048, 4096)
HEADS, KV_HEADS, D = 32, 8, 128
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 2048, 3
SPEC_K = 3  # the speculative runs' draft length: verify calls at t = 4
PAGED_TOKENS = (2, 4, 8)  # multi-token q cases: t = spec_k + 1 for spec_k 1, 3, 7


def _time_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """Median milliseconds per call (``dispatch.median_runtime``)."""
    return 1e3 * median_runtime(fn, warmup=warmup, iters=iters)


def _attn_ops(seq: int, heads: int, batch: int, causal: bool, window: int = 0) -> int:
    """Tensor-core operations of an attention forward: the two tile
    products, S = Q K^T and P V, 2 * d each per visible (q, kv) pair. The
    softmax's elementwise work runs on the CUDA cores beside them."""
    if not causal:
        pairs = seq * seq
    elif window and window < seq:
        pairs = window * seq - window * (window - 1) // 2
    else:
        pairs = seq * (seq + 1) // 2
    return 4 * D * pairs * heads * batch


def phase_device() -> str:
    from flash_attention_from_scratch_tpu_torch.utils.chip import device_kind

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = device_kind()
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return smi


def _ptxas_by_kernel(log: str) -> dict:
    """{mangled kernel name: its registers and spills} from ``nvcc
    -Xptxas=-v`` output."""
    found, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            found[name] = []
        elif name and ("registers" in line or "spill" in line):
            found[name].append(line.split(":", 1)[-1].strip())
    return {n: "; ".join(v) for n, v in found.items()}


def phase_build() -> dict:
    """Build every source; returns {source: compiler output}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(["flash_forward.cu", "paged_attention.cu",
                         "flash_backward.cu", "quant_matmul.cu",
                         "flash_quant.cu", "flash_forward_fori.cu",
                         "paged_runtime.cpp"])
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"build {name}: {line.strip()}", flush=True)
            elif "entry function" in line:  # the template arguments name it
                print(f"build {name}: {line.strip()[:150]}", flush=True)
    print(f"build: {sorted(logs)} in {secs:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    return logs


def _as_model_rows(x, strided):
    """x (b, h, s, d); with ``strided``, the same values laid out as the
    model hands them to the kernels: a transposed view of contiguous
    (b, s, h, d) rows."""
    return x.transpose(1, 2).contiguous().transpose(1, 2) if strided else x


def _cuda_qkv(sq, skv, seed, batch=1, strided=False):
    from flash_attention_from_scratch_tpu_torch.utils.testing import make_qkv

    q, k, v = make_qkv(batch, HEADS, sq, D, kv_heads=KV_HEADS, seq_kv=skv,
                       seed=seed)
    return [_as_model_rows(torch.from_numpy(x).to("cuda", torch.bfloat16), strided)
            for x in (q, k, v)]


def _cuda_normal(shape, seed, strided=False):
    return _as_model_rows(torch.from_numpy(np.random.default_rng(
        seed).standard_normal(shape).astype(np.float32)).to(
            "cuda", torch.bfloat16), strided)


# The training run's attention: causal, b 2, 32/8 heads, s 2048, with q,
# k, v and dO as transposed views (``_as_model_rows``).
TRAIN_CASE = (f"train shape b{TRAIN_BATCH} s{TRAIN_SEQ} strided", TRAIN_SEQ,
              TRAIN_SEQ, dict(causal=True), dict(batch=TRAIN_BATCH, strided=True))


FLASH_CASES = [(f"{kind} s{s}", s, s, kw, {})
               for s in FLASH_CASE_SEQS
               for kind, kw in (("causal", dict(causal=True)), ("full", {}))] + [
    ("q_offset 512 s512/1024", 512, 1024, dict(causal=True, q_offset=512), {}),
    ("window 512 s2048", 2048, 2048, dict(causal=True, window=512), {}),
    ("softcap 50 s1024", 1024, 1024, dict(causal=True, attn_softcap=50.0), {}),
    ("sinks s1024", 1024, 1024, dict(causal=True), dict(sinks=True)),
    # Ragged for K11's 128-row Q tiles and 128-key slots: the last Q tile's
    # second warpgroup past seq_q, the last KV tile half zero-filled.
    ("ragged s192/320 q_offset 128 window 70", 192, 320,
     dict(causal=True, q_offset=128, window=70), {}),
    TRAIN_CASE,
]
FORI_DEPTHS = (1, 2, 3, 4)  # K11 ring depths the cases and timings cover


def _flash_cases(loops: dict) -> dict:
    """Each forward kernel of ``loops`` ({label: KernelConfig fields that
    pick it}) vs the plain version on every case of FLASH_CASES, by the
    tolerance rule in each (batch, head, 64-row band); each call must
    launch its kernel once. Returns {label: (max |kernel - plain|, worst
    err/bound)}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig, KVLoop
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL, KERNEL_FORI, flash_forward_plain, flash_forward_with_lse)

    worst = {label: (0.0, 0.0) for label in loops}
    for i, (name, sq, skv, kw, extra) in enumerate(FLASH_CASES):
        q, k, v = _cuda_qkv(sq, skv, seed=i, batch=extra.get("batch", 1),
                            strided=extra.get("strided", False))
        sinks = (torch.from_numpy(np.random.default_rng(100 + i).standard_normal(
            HEADS).astype(np.float32) * 2).cuda() if extra.get("sinks") else None)
        base = KernelConfig(**kw)
        ref16, _ = flash_forward_plain(q, k, v, base, sinks)
        ref32, lse32 = flash_forward_plain(q.float(), k.float(), v.float(),
                                           _fp32(base), sinks)
        for label, loop in loops.items():
            cfg = dataclasses.replace(base, **loop)
            kernel = KERNEL_FORI if cfg.kv_loop == KVLoop.FORI else KERNEL
            before = _build.launch_counts[kernel]
            out, lse = flash_forward_with_lse(q, k, v, cfg, sinks=sinks)
            sync()
            launched = _build.launch_counts[kernel] - before
            lse_err = float((lse - lse32).abs().max())
            got = _hold(f"{label} {name}", out, ref16, ref32, launched,
                        good=lse_err <= 1e-3, note=f", lse err {lse_err:.3e}")
            worst[label] = tuple(map(max, worst[label], got))
        del q, k, v, ref16, ref32
    return worst


def phase_flash_cases() -> tuple[float, float]:
    """K1 vs its plain version: every case passes the tolerance rule.
    Returns (max |kernel - plain|, worst err/bound)."""
    return _flash_cases({"flash_forward": {}})["flash_forward"]


def phase_fori_cases() -> tuple[float, float]:
    """K11 at every ring depth (1-4) on K1's cases, by the same rule.
    Returns (max |kernel - plain|, worst err/bound) over the depths."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KVLoop

    worst = _flash_cases({f"flash_forward_fori nb{n}": dict(
        kv_loop=KVLoop.FORI, num_kv_buffers=n) for n in FORI_DEPTHS})
    return tuple(max(w[i] for w in worst.values()) for i in (0, 1))


def _fp32(cfg):
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType

    return dataclasses.replace(cfg, dtype=DType.FP32)


BACKWARD_CASES = (
    ("causal s512", 512, 512, dict(causal=True), {}),
    ("causal s2048", 2048, 2048, dict(causal=True), {}),
    ("full s1024", 1024, 1024, dict(), {}),
    ("q_offset 512 s512/1024", 512, 1024, dict(causal=True, q_offset=512), {}),
    ("window 512 s2048", 2048, 2048, dict(causal=True, window=512), {}),
    ("softcap 50 s1024", 1024, 1024, dict(causal=True, attn_softcap=50.0), {}),
    TRAIN_CASE,
)


def _check_grads(what, got, ref16, ref32):
    """dq by (batch, head, 64-row band), dk/dv by (batch, kv_head, band):
    the sliced rule on each. Returns (max |kernel - plain|, worst ratio)."""
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        row_bands, sliced_tolerance_check)

    err = ratio_max = 0.0
    for name, g, r16, r32 in zip(("dq", "dk", "dv"), got, ref16, ref32):
        ok, ratio, where = sliced_tolerance_check(
            row_bands(g), row_bands(r16), row_bands(r32), lead=3)
        if not ok or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} {name}: err/bound {ratio:.3f} in "
                                 f"(batch, head, band) {where}")
        err = max(err, float((g.float() - r16.float()).abs().max()))
        ratio_max = max(ratio_max, ratio)
    return err, ratio_max


def phase_backward_cases() -> dict:
    """K2 and K3 vs their plain version, on K1's O and LSE; then autograd
    through ``flash_attention`` with sinks vs autograd of the reference.
    Returns {kernel: max |kernel - plain|}."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_FUSED, flash_backward, flash_backward_plain)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward_with_lse)

    worst = {"fused": 0.0, "split": 0.0}
    for i, (name, sq, skv, kw, extra) in enumerate(BACKWARD_CASES):
        layout = dict(strided=extra.get("strided", False))
        q, k, v = _cuda_qkv(sq, skv, seed=200 + i, batch=extra.get("batch", 1),
                            **layout)
        do = _cuda_normal(q.shape, seed=300 + i, **layout)
        cfg = KernelConfig(**kw)
        o, lse = flash_forward_with_lse(q, k, v, cfg)
        ref16 = flash_backward_plain(q, k, v, o, lse, do, cfg)
        ref32 = flash_backward_plain(q.float(), k.float(), v.float(), o.float(),
                                     lse, do.float(), _fp32(cfg))
        for mode in ("fused", "split"):
            got = flash_backward(q, k, v, o, lse, do, cfg, fused=mode == "fused")
            again = flash_backward(q, k, v, o, lse, do, cfg, fused=mode == "fused")
            sync()
            err, ratio = _check_grads(f"flash_backward {mode} {name}", got,
                                      ref16, ref32)
            # dK/dV sum in a fixed order in both; dQ only in the split pair.
            same = [torch.equal(a, b) for a, b in zip(got, again)]
            if not all(same[1:]) or (mode == "split" and not same[0]):
                raise AssertionError(f"flash_backward {mode} {name}: a rerun "
                                     f"differs (dq, dk, dv equal: {same})")
            worst[mode] = max(worst[mode], err)
            print(f"flash_backward {mode} {name}: max|kernel-plain| {err:.3e}, "
                  f"worst err/bound {ratio:.3f}, rerun dq equal {same[0]} ok",
                  flush=True)
        del q, k, v, do, o, lse, ref16, ref32, got, again
    _backward_sinks_case()
    return {KERNEL_FUSED: worst["fused"], "split": worst["split"]}


def _backward_sinks_case() -> None:
    """flash_attention with sinks (causal, s 1024) through autograd vs
    autograd of reference_attention in bf16 and fp32. d(sink) per head
    within the JAX package's rule: 2x the bf16-vs-fp32 baseline, or 2% of
    the gradient's scale (D is rebuilt from the saved bf16 O, which the
    reference never rounds)."""
    from flash_attention_from_scratch_tpu_torch.ops.autodiff import flash_attention
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.reference import (
        reference_attention)

    q, k, v = _cuda_qkv(1024, 1024, seed=400)
    do = _cuda_normal(q.shape, seed=401)
    sinks = torch.from_numpy(np.random.default_rng(402).standard_normal(
        HEADS).astype(np.float32)).cuda()

    def grads(fn, dtype):
        leaves = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        z = sinks.clone().requires_grad_()
        return torch.autograd.grad(fn(*leaves, z), (*leaves, z), do.to(dtype))

    got = grads(lambda q, k, v, z: flash_attention(
        q, k, v, KernelConfig(causal=True), z), torch.bfloat16)
    sync()
    refs = [grads(lambda q, k, v, z: reference_attention(
        q, k, v, causal=True, q_offset=0, sinks=z), dt)
        for dt in (torch.bfloat16, torch.float32)]
    err, ratio = _check_grads("flash_attention sinks", got[:3], refs[0][:3],
                              refs[1][:3])
    z_err = (got[3] - refs[0][3]).abs()
    z_bound = torch.maximum(2 * (refs[0][3] - refs[1][3]).abs(),
                            0.02 * refs[1][3].abs().max().expand(HEADS))
    ok = bool((z_err <= z_bound).all())
    print(f"flash_attention sinks s1024: max|kernel-ref| {err:.3e}, worst "
          f"err/bound {ratio:.3f}; d(sinks) worst err/bound "
          f"{float((z_err / z_bound).max()):.3f} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("flash_attention sink gradient disagrees")


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
        sync()
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
        sync()
    return worst


SERVE_PROMPT_LENS = (200, 513, 1024, 1500, 2048, 2500, 3000, 4000)
SERVE_NEW_TOKENS = 32
SERVE_PAGE_SIZE, SERVE_PAGES, SERVE_PAGES_PER_SEQ = 64, 257, 64
TEACHER_FORCED = (513, 2048)  # prompt lengths checked against forward()
SLACK = 0.05  # a served token's logit may sit this far below the row max


def _teacher_forced_gaps(params, cfg, prompt, generated):
    """Teacher-force ``generated`` through the full-recompute ``forward``:
    per served token, the row max minus the served token's logit, and each
    row's standard deviation over the vocabulary."""
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
    return gaps, rows.std(-1)


def _teacher_forced_check(params, cfg, prompt, generated):
    """Each served token must be a top-scoring choice of the full-recompute
    model: its logit within SLACK of the row max (random bf16 weights tie
    within an ulp, so exact argmax equality is too strict)."""
    gaps, _ = _teacher_forced_gaps(params, cfg, prompt, generated)
    worst = float(gaps.max())
    if worst > SLACK:
        raise AssertionError(f"served token {int(gaps.argmax())} of a "
                             f"{len(prompt)}-token prompt is {worst} below the max")
    return worst


def _drive(server, prompts, new_tokens: int) -> dict:
    """Serve ``prompts`` to the end, the launch counts set to 0 just before
    and read just after. Every logit the server picks from must be finite:
    the non-finite ones are summed on the card and read once at the end.
    Steps that prefill count as prefill time, the others as decode time."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.serving import generate

    nonfinite = torch.zeros((), dtype=torch.int64, device="cuda")
    plain_greedy, plain_accept = generate.greedy_token, generate.spec_accept_sample

    def greedy_checked(logits):
        nonfinite.add_((~torch.isfinite(logits)).sum())
        return plain_greedy(logits)

    def accept_checked(logits, *args, **kw):
        nonfinite.add_((~torch.isfinite(logits)).sum())
        return plain_accept(logits, *args, **kw)

    generate.greedy_token = greedy_checked
    generate.spec_accept_sample = accept_checked
    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()  # counts start at 0 just before the main path
    t_start = time.perf_counter()
    for sid, prompt in prompts.items():
        server.submit(sid, prompt, new_tokens)
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
        generate.greedy_token, generate.spec_accept_sample = plain_greedy, plain_accept
    sync()
    wall = time.perf_counter() - t_start
    counts = dict(_build.launch_counts)  # read just after the main path
    return {"prefill_s": prefill_s, "decode_s": decode_s,
            "decode_tokens": decode_tokens, "wall_s": wall, "counts": counts,
            "nonfinite": int(nonfinite),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_serve(smi: str) -> dict:
    """Serve LLAMA3_8B at full width and depth; check counts and tokens."""
    from flash_attention_from_scratch_tpu_torch import (
        LLAMA3_8B, GenerationServer, init_params)
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import KERNEL as KP

    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    server = GenerationServer(params, cfg, num_pages=SERVE_PAGES,
                              page_size=SERVE_PAGE_SIZE, max_batch=8,
                              pages_per_seq=SERVE_PAGES_PER_SEQ)
    sync()
    print(f"serve: LLAMA3_8B params {sum(p.numel() for p in param_leaves(params)) / 1e9:.2f} B, "
          f"KV pool {server.cache.nbytes() / 1e9:.2f} GB, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate(SERVE_PROMPT_LENS)}
    run = _drive(server, prompts, SERVE_NEW_TOKENS)
    prefill_s, decode_s = run["prefill_s"], run["decode_s"]
    decode_tokens, wall = run["decode_tokens"], run["wall_s"]
    nonfinite = run["nonfinite"]
    counts = run["counts"]
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
        "peak_mem_gb": run["peak_mem_gb"],
        "launches": counts, "gpu": smi,
    }
    print(json.dumps({"serve": serve}), flush=True)
    return {"server": server, "prompts": prompts, "counts": counts}


def phase_profile(server, prompts, steps: int = 4, run: str = "bf16") -> None:
    """Where a full-width decode step's time goes, from torch.profiler.

    Serves the same prompts again (after the counted main-path run) and
    traces ``steps`` decode-only steps: device time per step by kernel, and
    the device's busy share of the wall time.
    """
    for sid, prompt in prompts.items():
        server.submit(1000 + sid, prompt, steps + 1)
    server.step()  # the prefills
    prof = _profile(lambda: [server.step() for _ in range(steps)], top=8)
    print(json.dumps({"profile": {
        "run": run, "decode_steps": steps, "wall_ms_per_step": prof["wall_ms"] / steps,
        "device_ms_per_step": prof["device_ms"] / steps,
        "device_busy_share": prof["device_busy_share"],
        "launches_per_step": prof["launches"] / steps,
        "device_ms_per_step_by_class": {
            k: ms / steps for k, ms in prof["device_ms_by_class"].items()},
        "top_kernels_ms_per_step": {
            k: ms / steps for k, ms in prof["top_kernels_ms"].items()},
    }}), flush=True)


SPEC_PHRASE = 37  # tokens of the phrase a speculative run's prompts repeat


def _phrase_prompts(lengths, vocab: int, seed: int) -> dict:
    """One prompt per length, each a random 37-token phrase repeated up to
    that length, so prompt lookup finds drafts."""
    rng = np.random.default_rng(seed)
    prompts = {}
    for i, n in enumerate(lengths):
        phrase = rng.integers(0, vocab, SPEC_PHRASE).tolist()
        prompts[i] = (phrase * (n // SPEC_PHRASE + 1))[:n]
    return prompts


def _spec_line(stats, run) -> dict:
    """The speculative counters of a run, and its tokens per verify step."""
    verify = stats["verify_steps"]
    return {"verify_steps": verify, "decode_steps": stats["decode_steps"],
            "spec_proposed": stats["spec_proposed"], "spec_accepted": stats["spec_accepted"],
            "spec_acceptance_rate": stats["spec_acceptance_rate"],
            "tokens_per_verify_step": (run["decode_tokens"] / verify) if verify else None}


def phase_serve_spec(params, smi: str) -> dict:
    """Speculative serving of LLAMA3_8B at full width and depth on phase
    (4)'s bf16 parameters: spec_k = 3, 8 requests of phrase-repeating
    prompts at SERVE_PROMPT_LENS, 32 greedy tokens each. Checks the token
    counts, finite logits, that drafts were proposed, the launch counts
    (K1 per prefill, the multi-token K4/K5 per verify step and layer, the
    single-token one per plain decode step) and two requests teacher-forced
    through ``forward``. The acceptance rate of a random-weight model is
    reported, not asserted."""
    from flash_attention_from_scratch_tpu_torch import LLAMA3_8B, GenerationServer
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        KERNEL as KP, KERNEL_MULTI)

    cfg = LLAMA3_8B
    server = GenerationServer(params, cfg, num_pages=SERVE_PAGES,
                              page_size=SERVE_PAGE_SIZE, max_batch=8,
                              pages_per_seq=SERVE_PAGES_PER_SEQ, spec_k=SPEC_K)
    prompts = _phrase_prompts(SERVE_PROMPT_LENS, cfg.vocab_size, seed=1)
    run = _drive(server, prompts, SERVE_NEW_TOKENS)
    counts, stats = run["counts"], server.stats()
    got = {sid: st.generated for sid, st in server.seqs.items()}
    if any(len(g) != SERVE_NEW_TOKENS for g in got.values()):
        raise AssertionError(f"serve_spec: token counts {[len(g) for g in got.values()]}")
    if run["nonfinite"] or stats["preemptions"]:
        raise AssertionError(f"serve_spec: {run['nonfinite']} non-finite logits, "
                             f"{stats['preemptions']} preemptions")
    if stats["verify_steps"] == 0 or stats["spec_proposed"] == 0:
        raise AssertionError(f"serve_spec: nothing was speculated: {stats}")
    want = {K1: cfg.n_layers * len(prompts),
            KERNEL_MULTI: cfg.n_layers * stats["verify_steps"]}
    if stats["decode_steps"]:
        want[KP] = cfg.n_layers * stats["decode_steps"]
    print(f"serve_spec: launches {counts}; expected {want} ({cfg.n_layers} layers x "
          f"{stats['verify_steps']} verify + {stats['decode_steps']} decode steps)",
          flush=True)
    if counts != want:
        raise AssertionError("serve_spec: a kernel of the path ran the wrong number of times")
    for n in TEACHER_FORCED:
        sid = SERVE_PROMPT_LENS.index(n)
        gap = _teacher_forced_check(params, cfg, prompts[sid], got[sid])
        print(f"serve_spec: teacher-forced prompt {n}: {len(got[sid])} tokens, worst gap "
              f"{gap:.4f} <= {SLACK} ok", flush=True)
    line = {
        "model": "LLAMA3_8B", "layers": cfg.n_layers, "requests": len(prompts),
        "spec_k": SPEC_K, "prompt_tokens": stats["prefill_tokens"],
        "new_tokens_per_request": SERVE_NEW_TOKENS,
        "decode_tok_s": run["decode_tokens"] / run["decode_s"],
        "prefill_tok_s": stats["prefill_tokens"] / run["prefill_s"],
        "wall_s": run["wall_s"], **_spec_line(stats, run),
        "peak_mem_gb": run["peak_mem_gb"], "launches": counts, "gpu": smi,
    }
    print(json.dumps({"serve_spec": line}), flush=True)
    return {"counts": counts, "verify_lengths": [n + 1 + SPEC_K for n in SERVE_PROMPT_LENS]}


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (forward and backward): 6 * matmul
    params * tokens, plus causal attention at 3.5x its forward (the forward
    and a backward of 2.5x). The formula of the JAX package's
    ``tools/bench_train.py::train_flops``."""
    n_params = cfg.vocab_size * cfg.dim + cfg.n_layers * (
        cfg.dim * cfg.n_heads * cfg.d_head * 2
        + cfg.dim * cfg.n_kv_heads * cfg.d_head * 2
        + 3 * cfg.dim * cfg.hidden_dim)
    attn_fwd = 2 * 2 * seq * seq * cfg.d_head * cfg.n_heads * batch / 2
    return 6 * n_params * batch * seq + attn_fwd * 3.5 * cfg.n_layers


# Kernel classes of a profile, by substrings of the kernel's name; the rest
# is elementwise work, reductions and copies.
KERNEL_CLASSES = (
    ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass")),
    ("quantized matmul (K6-K9)", ("quant_matmul_",)),
    ("flash forward (K1)", ("flash_forward_kernel",)),
    ("flash backward (K2/K3)", ("flash_backward_",)),
    ("paged decode (K4/K5)", ("paged_decode_kernel",)),
    ("optimizer (foreach AdamW)", ("multi_tensor_apply",)),
)


def _kernel_class(name: str) -> str:
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "elementwise, reductions, copies"


def _profile(fn, top: int = 10) -> dict:
    """Device time by kernel and the device's busy share over one call of
    ``fn``, from torch.profiler. GPU ranges of user annotations (such as
    the optimizer's step) span kernels and are left out of the sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms > 1.01 * wall_ms:
        raise AssertionError(f"profile: {busy_ms} ms of kernels in {wall_ms} ms")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    by_class: dict = {}
    for e in kernels:
        label = _kernel_class(e.key)
        by_class[label] = by_class.get(label, 0.0) + e.self_device_time_total / 1e3
    return {"wall_ms": wall_ms, "device_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "launches": sum(e.count for e in kernels), "device_ms_by_class": by_class,
            "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                               for e in ranked}}

@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic mode, which picks the split backward (K3).
    Without ``CUBLAS_WORKSPACE_CONFIG`` cuBLAS would refuse it; warn_only
    lets the matmuls run, and their warnings are not printed."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Deterministic behavior")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def _check_model_backward(seen) -> dict:
    """K2 and K3 against the plain backward on each layer's attention
    inputs as a training step handed them over (strided q/k/v/dO, the
    model's activations). dO is first scaled by a power of two to a max
    of about 1: the gradients scale exactly with it, and the rule's 1e-6
    floor would otherwise pass gradients this small (a mean loss over
    4096 tokens) whatever they were. Returns {mode: worst err/bound}."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        flash_backward, flash_backward_plain)

    worst = {"fused": 0.0, "split": 0.0}
    for i, (*tensors, cfg) in enumerate(seen):
        layer = len(seen) - 1 - i  # the backward runs the last layer first
        q, k, v, o, lse, do = (t.detach() for t in tensors)
        do = do * 2.0 ** -math.floor(math.log2(float(do.abs().max())))
        ref16 = flash_backward_plain(q, k, v, o, lse, do, cfg)
        ref32 = flash_backward_plain(q.float(), k.float(), v.float(), o.float(),
                                     lse, do.float(), _fp32(cfg))
        for mode in ("fused", "split"):
            got = flash_backward(q, k, v, o, lse, do, cfg, fused=mode == "fused")
            _, ratio = _check_grads(f"train layer {layer} {mode}", got, ref16, ref32)
            worst[mode] = max(worst[mode], ratio)
        del ref16, ref32, got
    print(f"train: K2 and K3 vs plain on the {len(seen)} layers' recorded "
          f"attention inputs, worst err/bound {worst} ok", flush=True)
    return worst


def phase_train(smi: str) -> dict:
    """Train LLAMA3_8B at full width, 8 layers: 3 AdamW steps on one batch
    with the fused backward (K2), launch counts and a falling loss checked;
    one more step profiled; then one step in deterministic mode, which runs
    the split backward (K3), with the loss after it checked and K2/K3 held
    against the plain backward on its recorded attention inputs. Returns
    the launch counts of both runs."""
    from flash_attention_from_scratch_tpu_torch import (
        LLAMA3_8B, init_params, loss_fn, make_optimizer, make_train_step)
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
    from flash_attention_from_scratch_tpu_torch.ops import _build, autodiff
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1

    cfg = dataclasses.replace(LLAMA3_8B, n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = make_optimizer(params)
    step = make_train_step(cfg, opt)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).to("cuda")
    sync()
    n_params = sum(p.numel() for p in param_leaves(params))
    print(f"train: LLAMA3_8B x {TRAIN_LAYERS} layers, params {n_params / 1e9:.3f} B, "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    _build.launch_counts.clear()  # counts start at 0 just before the main path
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses.append(float(step(params, tokens)))
        sync()
        step_s.append(time.perf_counter() - t)
    counts = dict(_build.launch_counts)  # read just after the main path
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = cfg.n_layers * TRAIN_STEPS
    print(f"train: losses {losses}, step s {[round(x, 4) for x in step_s]}, "
          f"launches {counts}; expected {K1} {want}, {KERNEL_FUSED} {want}",
          flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses} are not finite and falling")
    if counts.get(K1, 0) != want or counts.get(KERNEL_FUSED, 0) != want \
            or counts.get(KERNEL_DKV, 0) or counts.get(KERNEL_DQ, 0):
        raise AssertionError("a kernel of the training path ran the wrong number of times")

    prof = _profile(lambda: step(params, tokens))

    # The split backward (K3), which deterministic mode selects: one step,
    # keeping each layer's attention-backward inputs.
    seen = []
    real_backward = autodiff.flash_backward

    def recording(*args, **kw):
        seen.append(args)
        return real_backward(*args, **kw)

    autodiff.flash_backward = recording
    _build.launch_counts.clear()
    t = time.perf_counter()
    try:
        with _deterministic():
            split_loss = float(step(params, tokens))
        sync()
    finally:
        autodiff.flash_backward = real_backward
    split_s = time.perf_counter() - t
    split_counts = dict(_build.launch_counts)
    with torch.no_grad():
        after_loss = float(loss_fn(params, tokens, cfg))
    print(f"train split: loss {split_loss}, then {after_loss}; step s {split_s:.4f}, "
          f"launches {split_counts}; expected {K1}, {KERNEL_DKV}, {KERNEL_DQ} "
          f"{cfg.n_layers} each", flush=True)
    if not np.isfinite(after_loss) or not after_loss < split_loss < losses[0]:
        raise AssertionError(f"split-backward losses {losses[0]}, {split_loss}, "
                             f"{after_loss} are not finite and falling")
    if any(split_counts.get(n, 0) != cfg.n_layers for n in (K1, KERNEL_DKV, KERNEL_DQ)) \
            or split_counts.get(KERNEL_FUSED, 0):
        raise AssertionError("a kernel of the split training path ran the wrong "
                             "number of times")
    model_err = _check_model_backward(seen)
    del seen

    step_ms = 1e3 * float(np.median(step_s[1:]))
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    print(json.dumps({"train": {
        "model": "LLAMA3_8B", "layers": cfg.n_layers, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms, "step_ms_all": [1e3 * x for x in step_s],
        "train_tok_s": tokens_per_step / (step_ms / 1e3),
        "model_tflop_s": flops / (step_ms / 1e3) / 1e12,
        "model_tflop_per_step": flops / 1e12,
        "peak_mem_gb": peak_gb, "launches": counts,
        "split_step_ms": 1e3 * split_s, "split_launches": split_counts,
        "split_loss": split_loss, "loss_after_split": after_loss,
        "layers_backward_worst_err_bound": model_err,
        "profile": prof, "gpu": smi,
    }}), flush=True)
    return {"fused": counts, "split": split_counts}


def _padded(n: int) -> int:
    from flash_attention_from_scratch_tpu_torch.serving.generate import (
        PROMPT_QUANTUM)

    return n + (-n) % PROMPT_QUANTUM


def time_flash() -> dict:
    """K1 at the serving run's prefill shapes: one layer, all 8 prompts."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
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
        ops = _attn_ops(s, HEADS, 1, causal=True)
        nbytes = 2 * (2 * s * HEADS * D + 2 * s * KV_HEADS * D)  # q, o, k, v
        bound_ms += 1e3 * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
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
    ms = _time_ms(lambda: paged_decode_attention(q, kp, vp, lens, tables))
    plain_ms = _time_ms(lambda: paged_decode_attention_plain(
        q, kp, vp, lens, tables, scale=D ** -0.5), iters=3, warmup=1)
    nbytes = sum(lengths) * KV_HEADS * D * 2 * 2 + 2 * q.numel() * 2
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
            "shape": f"first decode step: lengths {lengths}, page {SERVE_PAGE_SIZE}, "
                     f"{HEADS}/{KV_HEADS} heads, d {D}, bf16 (one layer)"}


def time_backward() -> tuple[dict, dict]:
    """K2 and K3 at the training run's attention shape, one layer: causal,
    b 2, 32/8 heads, s 2048. Each time is of the whole ``flash_backward``
    call (D = rowsum(dO * O), the dQ workspace and its cast included).
    Library: PyTorch SDPA's backward, K/V repeated to 32 heads, timed as
    forward + ``torch.autograd.grad`` minus the same forward."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        flash_backward, flash_backward_plain)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward_with_lse)

    b, s = TRAIN_BATCH, TRAIN_SEQ
    cfg = KernelConfig(causal=True)
    q, k, v = _cuda_qkv(s, s, seed=70, batch=b)
    do = _cuda_normal(q.shape, seed=71)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    fused_ms = _time_ms(lambda: flash_backward(q, k, v, o, lse, do, cfg, fused=True))
    split_ms = _time_ms(lambda: flash_backward(q, k, v, o, lse, do, cfg, fused=False))
    plain_ms = _time_ms(lambda: flash_backward_plain(q, k, v, o, lse, do, cfg),
                        iters=3, warmup=1)

    group = HEADS // KV_HEADS
    qg = q.clone().requires_grad_()
    kg = k.repeat_interleave(group, 1).requires_grad_()
    vg = v.repeat_interleave(group, 1).requires_grad_()

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=True)

    fwd_ms = _time_ms(sdpa)
    lib_ms = _time_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do)) - fwd_ms

    # Five tile products per visible (q, kv) pair, 2 * d operations each:
    # S, dP, dV, dK, dQ (2.5x the forward's two). The softmax and dS
    # elementwise work runs on the CUDA cores beside the tensor cores.
    flops = 5 * 2 * D * (s * (s + 1) // 2) * HEADS * b
    # q, o, do, dq and k, v, dk, dv in bf16, lse in fp32: each once.
    nbytes = 2 * (4 * b * HEADS * s * D + 4 * b * KV_HEADS * s * D) + 4 * b * HEADS * s
    bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
    shape = (f"causal, b {b}, {HEADS}/{KV_HEADS} heads, s {s}, d {D}, bf16 "
             "(one layer of the training run)")
    common = {"plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
              "bound_by": "operations", "shape": shape}
    return {"ms": fused_ms, **common}, {"ms": split_ms, **common}


# ---------------------------------------------------------------------------
# Quantized serving: K6-K9 and the quantized page formats of K4/K5.

PEAK_INT8_OPS = 1979e12  # H100 SXM int8 tensor cores, dense
# Llama-3-8B's projection shapes (K, N), and each one's count per layer.
LAYER_SHAPES = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wv", 4096, 1024),
                ("wo", 4096, 4096), ("w_gate", 4096, 14336),
                ("w_up", 4096, 14336), ("w_down", 14336, 4096))
LM_HEAD_SHAPE = (4096, 128256)
# (weight mode, activation-quantized) of K6, K7, K8, K9.
QMM_RECIPES = (("int8", False), ("int4", False), ("int8", True), ("int4", True))
# Serve runs: weights, activations, KV pages, layers, requests; E and F
# also int8-compute attention, F speculative decoding too.
QUANT_RUNS = {
    "A": dict(wmode="int8", act="bf16", kv="int8", layers=32, requests=16),
    "B": dict(wmode="int4", act="int8", kv="int8", layers=32, requests=16),
    "C": dict(wmode="int8", act="int8", kv="fp8", layers=4, requests=4),
    "D": dict(wmode="int4", act="bf16", kv="int4", layers=4, requests=4),
    "E": dict(wmode="int8", act="bf16", kv="int8", layers=32, requests=16,
              attn_int8=True),
    "F": dict(wmode="int8", act="bf16", kv="int8", layers=4, requests=4,
              attn_int8=True, spec_k=SPEC_K),
}
QUANT_PROMPT, QUANT_PAGE, QUANT_NEW = 1024, 128, 32
# A served token's logit may sit this many row standard deviations below the
# full-recompute row max: the served path reads quantized K/V (and, for a8,
# quantized activations at every projection), the recompute reads K/V
# unquantized. A wrong kernel puts served tokens several row standard
# deviations below the max (the max of 128256 normal logits sits ~4.5 above
# the mean).
QUANT_SLACK_STD = 0.25


def _random_qweight(k, n, mode, act_quant, gen):
    """init_quantized_params' recipe for one (K, N) weight, with every
    column's scale multiplied by its own draw from [0.5, 1.5): a kernel that
    applies a scale to the wrong column then disagrees with its plain
    version."""
    from flash_attention_from_scratch_tpu_torch.models.llama import (
        random_quantized_weight)

    wq = random_quantized_weight((k, n), mode, "int8" if act_quant else "bf16",
                                 gen, device="cuda")
    wq.scales.mul_(0.5 + torch.rand(n, generator=gen, device="cuda"))
    return wq


def _check_qmm(got, x, wq, act_quant):
    """The adaptive rule in each 64-row band against the plain version (cast
    to bf16, and in fp32); for a8 also the plain int32 path within one bf16
    ulp of each value. Returns (ok, worst err/bound, worst ulps, max err)."""
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        quant_matmul_plain)
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        row_bands, sliced_tolerance_check)

    plain = quant_matmul_plain(x, wq, act_quant)
    ref32 = quant_matmul_plain(x, wq, act_quant, out_dtype=torch.float32)
    pad = -x.shape[0] % 64

    def bands(t):
        return row_bands(torch.nn.functional.pad(t.float(), (0, 0, 0, pad))[None], 64)

    ok, ratio, _ = sliced_tolerance_check(bands(got), bands(plain).bfloat16(),
                                          bands(ref32), lead=2)
    err = (got.float() - plain.float()).abs()
    ulps = 0.0
    if act_quant:
        ulp = torch.exp2(torch.floor(torch.log2(plain.float().abs().clamp_min(1e-30))) - 7)
        ulps = float((err / ulp).max())
        ok = ok and ulps <= 1.0
    return ok and bool(torch.isfinite(got).all()), ratio, ulps, float(err.max())


def phase_quant_matmul_cases() -> dict:
    """K6-K9 vs their plain version at every weight shape of Llama-3-8B, at
    decode m = 16, the verify steps' m = 32, m = 64 and prefill m = 1024,
    and at m = 1000 (no tile multiple): on every shape for K6/K7, on w_down
    for K8/K9. Returns {kernel: max |kernel - plain|}."""
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        KERNELS, quant_matmul)

    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {}
    shapes = [(k, n) for _, k, n in LAYER_SHAPES[:2]] + [
        (4096, 14336), (14336, 4096), LM_HEAD_SHAPE]
    for mode, act_quant in QMM_RECIPES:
        name = KERNELS[(mode, act_quant)]
        cases = [(m, k, n) for k, n in shapes for m in (16, 32, 64, 1024)]
        cases += ([(1000, k, n) for k, n in shapes] if not act_quant
                  else [(1000, 14336, 4096)])
        line = []
        for m, k, n in cases:
            wq = _random_qweight(k, n, mode, act_quant, gen)
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            got = quant_matmul(x, wq, act_quant=act_quant)
            sync()
            ok, ratio, ulps, err = _check_qmm(got, x, wq, act_quant)
            worst[name] = max(worst.get(name, 0.0), err)
            line.append(f"m{m} {k}x{n} {ratio:.3f}" + (f"/{ulps:.2f}ulp" if act_quant else ""))
            if not ok:
                raise AssertionError(f"{name} m {m} K {k} N {n}: err/bound {ratio}, "
                                     f"ulps {ulps}: disagrees with its plain version")
            del wq, x, got
        print(f"{name}: worst err/bound per case: {', '.join(line)}; max|kernel-plain| "
              f"{worst[name]:.3e} ok", flush=True)
        torch.cuda.empty_cache()
    return worst


def _quantized_pool(kp, vp, mode):
    """A bf16 pool (NaN where no sequence owns a slot) as quantized pages:
    NaN slots quantize as 0, then fp8 pages get the e4m3 NaN byte there."""
    from flash_attention_from_scratch_tpu_torch.ops.quant import quantize_kv_pages

    out = []
    for p in (kp, vp):
        vals, scales = quantize_kv_pages(torch.nan_to_num(p), mode)
        if mode == "fp8":
            vals.view(torch.uint8)[torch.isnan(p)] = 0x7F
        out += [vals, scales]
    return out


def _run_a_pool():
    """One layer of run A's first decode step: 16 sequences of 1025 tokens,
    page 128, 32/8 heads. Returns (lengths, k_pages, v_pages, lengths
    tensor, page tables, q)."""
    lengths = [QUANT_PROMPT + 1] * 16
    pages_per_seq = -(-(QUANT_PROMPT + QUANT_NEW) // QUANT_PAGE)
    kp, vp, lens, tables = make_paged_pool(lengths, QUANT_PAGE, 16 * pages_per_seq + 1,
                                           seed=62, pages_per_seq=pages_per_seq)
    q = torch.from_numpy(np.random.default_rng(63).standard_normal(
        (len(lengths), HEADS, D)).astype(np.float32)).to("cuda", torch.bfloat16)
    return lengths, kp, vp, lens, tables, q


def phase_quant_paged_cases() -> float:
    """K4/K5 on int8, fp8 and int4 pages vs the plain version, with a window
    and a softcap: on the same ragged, shuffled pool as the dense cases
    (page 64), and on run A's pool at the serve runs' page size (128; int4
    pages hold 64 byte rows, so the high nibbles start at slot 64). The
    run-A window (600) starts at page 3, so whole pages lie below it."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        sliced_tolerance_check)

    lengths = [1, 17, 64, 65, 1000, 0, 2047, 3001, 4000]
    kp, vp, lens, tables = make_paged_pool(lengths, 64, 320, seed=17,
                                           pages_per_seq=64)
    q = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (len(lengths), HEADS, D)).astype(np.float32)).to("cuda", torch.bfloat16)
    pools = (("page 64", 1000, (lengths, kp, vp, lens, tables, q)),
             (f"page {QUANT_PAGE} (run A)", 600, _run_a_pool()))
    worst = 0.0
    for pool, window, (lengths, kp, vp, lens, tables, q) in pools:
        for mode in ("int8", "fp8", "int4"):
            qk, ks, qv, vs = _quantized_pool(kp, vp, mode)
            for name, kw in (("plain", {}), (f"window {window}", dict(window=window)),
                             ("softcap 30", dict(softcap=30.0))):
                kw = dict(kw, mode=mode, k_scales=ks, v_scales=vs)
                out = paged_decode_attention(q, qk, qv, lens, tables, **kw)
                sync()
                ref16 = paged_decode_attention_plain(q, qk, qv, lens, tables,
                                                     scale=D ** -0.5, **kw)
                ref32 = paged_decode_attention_plain(q.float(), qk, qv, lens, tables,
                                                     scale=D ** -0.5, **kw)
                ok, ratio, where = sliced_tolerance_check(out, ref16, ref32, lead=1)
                err = float((out.float() - ref16.float()).abs().max())
                worst = max(worst, err)
                good = (ok and bool(torch.isfinite(out).all()) and (
                    0 not in lengths or float(out[lengths.index(0)].abs().max()) == 0.0))
                print(f"paged_decode_attention {pool} {mode} {name}: max|kernel-plain| "
                      f"{err:.3e}, worst err/bound {ratio:.3f} at length "
                      f"{lengths[where[0]]} {'ok' if good else 'FAIL'}", flush=True)
                if not good:
                    raise AssertionError(f"paged_decode_attention {pool} {mode} {name} "
                                         "disagrees with its plain version")
    return worst


def _hold_paged(label, out, native, ref32, lengths, launched) -> tuple[float, float]:
    """The tolerance rule in each (sequence, token) on its own; finite
    values, zeros for a length-0 row, one launch. Returns (max |kernel -
    plain|, worst err/bound); raises on a failure."""
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        sliced_tolerance_check)

    def by_token(x):
        return x.transpose(1, 2) if x.ndim == 4 else x[:, None]

    ok, ratio, where = sliced_tolerance_check(by_token(out), by_token(native),
                                              by_token(ref32), lead=2)
    err = float((out.float() - native.float()).abs().max())
    good = (ok and launched == 1 and bool(torch.isfinite(out).all()) and (
        0 not in lengths or float(out[lengths.index(0)].abs().max()) == 0.0))
    print(f"{label}: max|kernel-plain| {err:.3e}, worst err/bound {ratio:.3f} at "
          f"(length, token) ({lengths[where[0]]}, {where[1]}), {launched} launch "
          f"{'ok' if good else 'FAIL'}", flush=True)
    if not good:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err, ratio


def _paged_call(q, k, v, lens, tables, i8c, kw):
    """One kernel call and its references: (out, launches, native, fp32).
    The native reference is the plain version on the same inputs (with
    int8_compute when the kernel has it), the fp32 one the plain version
    with q in fp32 (and dense pages in fp32), without int8_compute."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        kernel_name, paged_decode_attention, paged_decode_attention_plain)

    name = kernel_name(q.shape[2] if q.ndim == 4 else 1, i8c)
    before = _build.launch_counts[name]
    out = paged_decode_attention(q, k, v, lens, tables, int8_compute=i8c, **kw)
    sync()
    launched = _build.launch_counts[name] - before
    native = paged_decode_attention_plain(q, k, v, lens, tables, int8_compute=i8c, **kw)
    pages32 = (k.float(), v.float()) if k.dtype == torch.bfloat16 else (k, v)
    ref32 = paged_decode_attention_plain(q.float(), *pages32, lens, tables, **kw)
    return out, launched, native, ref32


def phase_paged_multi_cases() -> tuple[float, float]:
    """K4/K5's multi-token q (t = 2, 4, 8 on dense, int8, fp8 and int4
    pages, each with a window and with a softcap) and int8_compute (int8
    pages, t = 1 and 4: plain, window, softcap) vs the plain version in
    each (sequence, token), on the ragged page-64 pool of the dense cases
    (lengths 0 to 4000) and on run A's page-128 pool. Returns (max |kernel -
    plain|, worst err/bound)."""
    lengths = [1, 17, 64, 65, 1000, 0, 2047, 3001, 4000]
    pools = (("page 64", 1000, (lengths, *make_paged_pool(lengths, 64, 320, seed=27,
                                                          pages_per_seq=64))),
             (f"page {QUANT_PAGE} (run A)", 600, _run_a_pool()[:5]))
    worst = (0.0, 0.0)
    for pool, window, (lengths, kp, vp, lens, tables) in pools:
        formats = {"dense": (kp, vp, {})}
        for mode in ("int8", "fp8", "int4"):
            qk, ks, qv, vs = _quantized_pool(kp, vp, mode)
            formats[mode] = (qk, qv, dict(mode=mode, k_scales=ks, v_scales=vs))
        options = {"plain": {}, f"window {window}": dict(window=window),
                   "softcap 30": dict(softcap=30.0)}
        cases = [(mode, t, False, opt) for mode in formats for t in PAGED_TOKENS
                 for opt in list(options)[1:]]
        cases += [("int8", t, True, opt) for t in (1, SPEC_K + 1) for opt in options]
        rng = np.random.default_rng(29)
        for mode, t, i8c, opt in cases:
            k, v, kw = formats[mode]
            shape = (len(lengths), HEADS) + ((t,) if t > 1 else ()) + (D,)
            q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
                "cuda", torch.bfloat16)
            kw = dict(kw, scale=D ** -0.5, **options[opt])
            out, launched, native, ref32 = _paged_call(q, k, v, lens, tables, i8c, kw)
            label = (f"paged_decode_attention {pool} {'int8c' if i8c else mode} t{t} "
                     f"{opt}")
            worst = tuple(map(max, worst, _hold_paged(label, out, native, ref32,
                                                      lengths, launched)))
        del formats
    torch.cuda.empty_cache()
    return worst


def _param_bytes(params) -> int:
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import QuantizedWeight

    def walk(x):
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, list):
            return sum(walk(v) for v in x)
        if isinstance(x, QuantizedWeight):
            return walk(x.values) + walk(x.scales)
        return x.numel() * x.element_size()

    return walk(params)


def phase_serve_quant(run: str, smi: str, profile: bool = False) -> dict:
    """One quantized serve run of LLAMA3_8B at full width (QUANT_RUNS): the
    launch counts of its quantized kernel, K1 and K4/K5 (the int8-compute
    and multi-token entries for runs E and F), every token and finite
    logits, and two requests teacher-forced through ``forward``. A
    speculative run's prompts repeat a phrase, and it must have verified
    drafts."""
    from flash_attention_from_scratch_tpu_torch import (
        LLAMA3_8B, GenerationServer, init_quantized_params)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL as K1
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import kernel_name
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS

    spec = QUANT_RUNS[run]
    i8c, spec_k = spec.get("attn_int8", False), spec.get("spec_k", 0)
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=spec["layers"])
    kernel = KERNELS[(spec["wmode"], spec["act"] == "int8")]
    t0 = time.perf_counter()
    params = init_quantized_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   spec["wmode"], act=spec["act"])
    pages_per_seq = -(-(QUANT_PROMPT + QUANT_NEW) // QUANT_PAGE)
    # Each request's pages, one page of admission headroom (the scheduler
    # admits a prompt only with a page to spare) and the scratch page.
    server = GenerationServer(params, cfg, num_pages=spec["requests"] * pages_per_seq + 2,
                              page_size=QUANT_PAGE, max_batch=spec["requests"],
                              pages_per_seq=pages_per_seq, mode=spec["kv"],
                              attn_int8=i8c, spec_k=spec_k)
    sync()
    weight_gb, kv_gb = _param_bytes(params) / 1e9, server.cache.nbytes() / 1e9
    print(f"serve {run}: {spec}, weights {weight_gb:.2f} GB, KV pool {kv_gb:.3f} GB, "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)

    if spec_k:
        prompts = _phrase_prompts([QUANT_PROMPT] * spec["requests"], cfg.vocab_size, 2)
    else:
        rng = np.random.default_rng(0)
        prompts = {i: rng.integers(0, cfg.vocab_size, QUANT_PROMPT).tolist()
                   for i in range(spec["requests"])}
    result = _drive(server, prompts, QUANT_NEW)
    counts, stats = result["counts"], server.stats()
    got = {sid: st.generated for sid, st in server.seqs.items()}
    if any(len(g) != QUANT_NEW for g in got.values()):
        raise AssertionError(f"serve {run}: token counts {[len(g) for g in got.values()]}")
    if result["nonfinite"] or stats["preemptions"]:
        raise AssertionError(f"serve {run}: {result['nonfinite']} non-finite logits, "
                             f"{stats['preemptions']} preemptions")
    if spec_k and (stats["verify_steps"] == 0 or stats["spec_proposed"] == 0):
        raise AssertionError(f"serve {run}: nothing was speculated: {stats}")
    steps = stats["decode_steps"] + stats["verify_steps"]
    calls = len(prompts) + steps  # prefills + decode and verify steps
    want = {kernel: (7 * cfg.n_layers + 1) * calls, K1: cfg.n_layers * len(prompts)}
    for t, n in ((1, stats["decode_steps"]), (spec_k + 1, stats["verify_steps"])):
        if n:
            want[kernel_name(t, i8c)] = cfg.n_layers * n
    print(f"serve {run}: launches {counts}; expected {want} ((7 x {cfg.n_layers} + 1) "
          f"x ({len(prompts)} prefills + {stats['decode_steps']} decode + "
          f"{stats['verify_steps']} verify steps))", flush=True)
    if counts != want:
        raise AssertionError(f"serve {run}: a kernel of the path ran the wrong number of times")

    worst = 0.0
    for sid in (0, 1):
        gaps, std = _teacher_forced_gaps(params, cfg, prompts[sid], got[sid])
        rel = float((gaps / std).max())
        worst = max(worst, rel)
        print(f"serve {run}: teacher-forced request {sid}: worst gap {float(gaps.max()):.4f} "
              f"= {rel:.4f} row std (row std {float(std.mean()):.3f}), limit "
              f"{QUANT_SLACK_STD}", flush=True)
        if rel > QUANT_SLACK_STD:
            raise AssertionError(f"serve {run}: a served token sits {rel} row std "
                                 "below the full-recompute max")
    ttft = sorted(st.first_t - st.submit_t for st in server.seqs.values())
    line = {
        "run": run, "model": "LLAMA3_8B", **spec, "prompt_tokens": QUANT_PROMPT,
        "new_tokens_per_request": QUANT_NEW, "page_size": QUANT_PAGE,
        "prefill_tok_s": stats["prefill_tokens"] / result["prefill_s"],
        "decode_tok_s": result["decode_tokens"] / result["decode_s"],
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
        "wall_s": result["wall_s"], "decode_steps": stats["decode_steps"],
        **(_spec_line(stats, result) if spec_k else {}),
        "weight_gb": weight_gb, "kv_cache_gb": kv_gb,
        "peak_mem_gb": result["peak_mem_gb"], "launches": counts,
        "teacher_forced_worst_gap_std": worst, "gpu": smi,
    }
    print(json.dumps({"serve_quant": line}), flush=True)
    if profile:
        phase_profile(server, prompts, run=run)
    return {"kernel": kernel, "launches": counts[kernel], "counts": counts}


def _device_ms(fn, calls: int) -> dict:
    """Device time of one call of ``fn`` from torch.profiler, the mean over
    ``calls`` calls after one warm-up: "all" kernels it launches, and the
    "kernel" share of the quantized matmul's own (``quant_matmul_*``).
    Device time, not a host clock: at decode the host enqueues these small
    launches more slowly than the card runs them."""
    fn()
    prof = _profile(lambda: [fn() for _ in range(calls)], top=10_000)
    own = sum(ms for name, ms in prof["top_kernels_ms"].items()
              if "quant_matmul_" in name)
    return {"all": prof["device_ms"] / calls, "kernel": own / calls}


def _host_us_per_call(fn, calls: int = 200) -> float:
    """Wall microseconds per call of ``fn``, called back to back. Where the
    call's kernels are shorter than the host's work for it (decode's small
    weights), this is the host's cost of a call, which the card waits on."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def _shape_work(m, k, n, wq, out_bytes=2):
    """Bytes (weight values + scales, x, out, each once) and operations."""
    x_bytes = m * k * (1 if wq.act == "int8" else 2)
    return (wq.values.numel() + 4 * n + x_bytes + out_bytes * m * n, 2 * m * k * n)


def time_quant_matmul(mode: str, act_quant: bool, ptxas: dict) -> dict:
    """One recipe at a decode step's matmuls (m = 16: 7 x 32 projections,
    timed over 4 distinct layers so each weight streams from memory, plus
    the lm_head) and at one 1024-row prefill layer, as device time summed
    over the kernels each call launches (for a8 the activation quantization
    included; ``kernel_only_ms`` counts K6-K9's own kernels). Library: cuBLAS
    ``x @ w`` on the dequantized bf16 weight (the same function up to
    rounding) for weight-only; ``torch._int_mm`` plus the scale epilogue
    for a8, where its shape rules allow, timed in the same call, with the
    kernel's factor to it. At decode also the host's cost of one wrapper
    call and of one library call (``_host_us_per_call`` on w_k, whose
    kernel is the shortest). ``ptxas``: the build's registers and spills
    per mangled kernel name; the recipe's own kernels go into the result."""
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
        KERNELS, quant_matmul, quant_matmul_plain, quantize_activations)

    gen = torch.Generator(device="cuda").manual_seed(23)
    layers = [[(name, _random_qweight(k, n, mode, act_quant, gen)) for name, k, n in LAYER_SHAPES]
              for _ in range(4)]
    lm = _random_qweight(*LM_HEAD_SHAPE, mode, act_quant, gen)
    peak = PEAK_INT8_OPS if act_quant else PEAK_BF16_FLOPS

    def inputs(m):
        ks = {k for _, k, _ in LAYER_SHAPES} | {LM_HEAD_SHAPE[0]}
        return {k: torch.randn(m, k, generator=gen, device="cuda").bfloat16()
                for k in ks}

    def run_layer(fn, xs, ws):
        return [fn(xs[w.k_dim], w) for _, w in ws]

    def kernel(x, w):
        return quant_matmul(x, w, act_quant=act_quant)

    def plain(x, w):
        return quant_matmul_plain(x, w, act_quant)

    # The library's operands for one layer: the unscaled int8 values, or the
    # dequantized bf16 weight.
    lib_ws = [w.stored_columns(torch.int8) if act_quant else w.dequantize()
              for _, w in layers[0]]

    def library(x, w_lib, scales):
        if not act_quant:
            return x @ w_lib
        xq, xs = quantize_activations(x)
        return (torch._int_mm(xq, w_lib).float() * xs * scales).to(x.dtype)

    def lib_layer(xs):
        return [library(xs[w.shape[0]], w, q.scales)
                for w, (_, q) in zip(lib_ws, layers[0])]

    out = {}
    for phase, m in (("decode", 16), ("prefill", 1024)):
        xs = inputs(m)
        reps = 32 if phase == "decode" else 1
        if phase == "decode":
            per_layer = _device_ms(lambda: [run_layer(kernel, xs, ws) for ws in layers],
                                   calls=5)
            per_layer = {k: v / len(layers) for k, v in per_layer.items()}
            lm_t = _device_ms(lambda: kernel(xs[LM_HEAD_SHAPE[0]], lm), calls=5)
        else:
            per_layer = _device_ms(lambda: run_layer(kernel, xs, layers[0]), calls=3)
            lm_t = {"all": 0.0, "kernel": 0.0}
        ms, kernel_only = (reps * per_layer[k] + lm_t[k] for k in ("all", "kernel"))
        plain_ms = reps * _device_ms(lambda: run_layer(plain, xs, layers[0]),
                                     calls=1)["all"]
        if phase == "decode":
            plain_ms += _device_ms(lambda: plain(xs[LM_HEAD_SHAPE[0]], lm), calls=1)["all"]
        nbytes = ops = 0
        for _, w in layers[0]:
            b, o = _shape_work(m, w.k_dim, w.shape[1], w)
            nbytes, ops = nbytes + reps * b, ops + reps * o
        if phase == "decode":
            b, o = _shape_work(m, *LM_HEAD_SHAPE, lm)
            nbytes, ops = nbytes + b, ops + o
        bound_b, bound_o = nbytes / PEAK_BYTES_PER_S, ops / peak
        lib_note = ("torch._int_mm + the scale epilogue" if act_quant else
                    "cuBLAS x @ w on the dequantized bf16 weight")
        try:
            lib_ms = reps * _device_ms(lambda: lib_layer(xs), calls=5)["all"]
            if phase == "decode":
                lm_lib = lm.stored_columns(torch.int8) if act_quant else lm.dequantize()
                lib_ms += _device_ms(lambda: library(xs[LM_HEAD_SHAPE[0]], lm_lib,
                                                     lm.scales), calls=5)["all"]
                del lm_lib
        except RuntimeError as e:  # torch._int_mm's shape rules
            lib_ms, lib_note = None, f"refused: {str(e).splitlines()[0][:160]}"
        if phase == "decode":
            (_, wk), wk_lib = next((nw, w) for nw, w in zip(layers[0], lib_ws)
                                   if nw[0] == "wk")
            host = {"host_us_per_call": _host_us_per_call(lambda: kernel(xs[wk.k_dim], wk))}
            if lib_ms is not None:
                host["library_host_us_per_call"] = _host_us_per_call(
                    lambda: library(xs[wk.k_dim], wk_lib, wk.scales))
        else:
            host = {}
        out[phase] = {
            **host,
            "ms": ms, "kernel_only_ms": kernel_only, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_note": lib_note,
            "library_factor": ms / lib_ms if lib_ms else None,
            "bound_ms": 1e3 * max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations",
            "shape": (f"one decode step: m 16, 7 x 32 projections + lm_head, "
                      f"{nbytes / 1e9:.3f} GB" if phase == "decode" else
                      "one prefill layer: m 1024, the 7 projections"),
        }
        del xs
    del layers, lm, lib_ws
    torch.cuda.empty_cache()
    # The kernel templates of this recipe: K6/K7 quant_matmul_wonly_kernel<W4,
    # BT>, K8/K9 quant_matmul_a8_kernel<W4, MI> (Itanium-mangled bool W4).
    own = "quant_matmul_a8_kernel" if act_quant else "quant_matmul_wonly_kernel"
    w4 = f"ILb{int(mode == 'int4')}E"
    regs = {name: v for name, v in ptxas.items() if own + w4 in name}
    for name, v in regs.items():
        print(f"ptxas {KERNELS[(mode, act_quant)]}: {name}: {v}", flush=True)
    return {**out["decode"], "prefill": out["prefill"], "ptxas": regs}


def time_paged_formats() -> dict:
    """K4/K5 per page format at run A's first decode step: 16 sequences of
    1025 tokens, page 128, 32/8 heads."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    lengths, kp, vp, lens, tables, q = _run_a_pool()
    used_pages = sum(-(-n // QUANT_PAGE) for n in lengths)
    out = {}
    for mode, elem in (("dense", 2.0), ("int8", 1.0), ("fp8", 1.0), ("int4", 0.5)):
        if mode == "dense":
            k, v, kw = kp, vp, {}
        else:
            k, ks, v, vs = _quantized_pool(kp, vp, mode)
            kw = dict(mode=mode, k_scales=ks, v_scales=vs)
        ms = _time_ms(lambda: paged_decode_attention(q, k, v, lens, tables, **kw))
        plain_ms = _time_ms(lambda: paged_decode_attention_plain(
            q, k, v, lens, tables, scale=D ** -0.5, **kw), iters=3, warmup=1)
        nbytes = (sum(lengths) * KV_HEADS * D * 2 * elem + 2 * q.numel() * 2
                  + (2 * 4 * KV_HEADS * used_pages if mode != "dense" else 0))
        out[mode] = {"ms": ms, "plain_ms": plain_ms,
                     "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes"}
    return {"shape": f"lengths 16 x {QUANT_PROMPT + 1}, page {QUANT_PAGE}, "
                     f"{HEADS}/{KV_HEADS} heads, d {D} (one layer)", **out}


def _time_paged_pair(q, k, v, lens, tables, kw, i8c, lengths, nbytes, shape) -> dict:
    """K4/K5 on ``q`` (int8_compute when ``i8c``) beside the single-token
    call without int8_compute at the same lengths (the last token of a
    multi-token q): times, the byte bound, the plain version's time and the
    call's worst err/bound against the plain version."""
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)

    q1 = q[:, :, -1].contiguous() if q.ndim == 4 else q
    ms = _time_ms(lambda: paged_decode_attention(q, k, v, lens, tables,
                                                 int8_compute=i8c, **kw))
    single_ms = _time_ms(lambda: paged_decode_attention(q1, k, v, lens, tables, **kw))
    plain_ms = _time_ms(lambda: paged_decode_attention_plain(
        q, k, v, lens, tables, int8_compute=i8c, **kw), iters=3, warmup=1)
    out, launched, native, ref32 = _paged_call(q, k, v, lens, tables, i8c, kw)
    _, ratio = _hold_paged(f"timed {shape}", out, native, ref32, lengths, launched)
    return {"ms": ms, "single_token_ms": single_ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S, "bound_by": "bytes",
            "library_ms": None, "worst_err_bound": ratio, "shape": shape}


def time_paged_verify(lengths) -> dict:
    """K4/K5 with t = 4 query tokens at the speculative run's first verify
    step (``lengths``: prompt + 1 + spec_k, page 64, 32/8 heads, bf16 pages,
    one layer) beside the single-token call at the same lengths. Bytes: K/V
    once, q and out (t rows each)."""
    kp, vp, lens, tables = make_paged_pool(lengths, SERVE_PAGE_SIZE, SERVE_PAGES,
                                           seed=64, pages_per_seq=SERVE_PAGES_PER_SEQ)
    q = torch.from_numpy(np.random.default_rng(65).standard_normal(
        (len(lengths), HEADS, SPEC_K + 1, D)).astype(np.float32)).to("cuda", torch.bfloat16)
    nbytes = sum(lengths) * KV_HEADS * D * 2 * 2 + 2 * q.numel() * 2
    return _time_paged_pair(q, kp, vp, lens, tables, dict(scale=D ** -0.5), False,
                            lengths, nbytes, f"verify t {SPEC_K + 1}: lengths {lengths}, "
                            f"page {SERVE_PAGE_SIZE}, {HEADS}/{KV_HEADS} heads, bf16")


def time_paged_int8c() -> dict:
    """K4/K5 with int8_compute at run E's first decode step (run A's pool:
    16 x 1025 tokens, int8 pages, page 128) beside the int8-page call
    without it."""
    lengths, kp, vp, lens, tables, q = _run_a_pool()
    qk, ks, qv, vs = _quantized_pool(kp, vp, "int8")
    used_pages = sum(-(-n // QUANT_PAGE) for n in lengths)
    nbytes = sum(lengths) * KV_HEADS * D * 2 + 2 * 4 * KV_HEADS * used_pages + 2 * q.numel() * 2
    kw = dict(mode="int8", k_scales=ks, v_scales=vs, scale=D ** -0.5)
    return _time_paged_pair(q, qk, qv, lens, tables, kw, True, lengths, nbytes,
                            f"int8c: lengths 16 x {QUANT_PROMPT + 1}, page {QUANT_PAGE}, "
                            f"{HEADS}/{KV_HEADS} heads, int8 pages")


# ---------------------------------------------------------------------------
# Quantized prefill attention (K10), the K/V-ring forward (K11) and the
# bench tools that drive them.

# variant: (K/V mode, Q kind, int8_compute): the bench tool's four and
# bf16 Q over int4 K/V.
QUANT_VARIANTS = bench_quant.CHECK_VARIANTS
QUANT_CASE_SEQS, QUANT_CASE_BATCH = (1024, 2048), 2
PERF_BATCH, PERF_SEQ = 4, 4096  # the K10 and K11 timing shape


def _quant_qkv(variant, seq, seed, batch, strided=False):
    """Seeded bf16 Q, K, V (32/8 heads) quantized as ``variant`` gives them;
    with ``strided``, Q (its values, when quantized) as a transposed view
    of (b, s, h, d) rows."""
    qq, kq, vq = bench_quant.quantize_inputs(*_cuda_qkv(seq, seq, seed, batch=batch),
                                             variant)
    if strided:
        if QUANT_VARIANTS[variant][1] == "bf16":
            qq = _as_model_rows(qq, True)
        else:
            qq.values = _as_model_rows(qq.values, True)
    return qq, kq, vq


def _dequantized(x, dtype):
    """A QTensor's values times its scales in ``dtype`` (a dense tensor
    cast to it)."""
    from flash_attention_from_scratch_tpu_torch.ops.quant import QTensor, dequantize

    if isinstance(x, QTensor):
        return dequantize(dataclasses.replace(x, orig_dtype=dtype))
    return x.to(dtype)


def _per_batch(fn, *xs):
    """``fn`` on one batch element of the dense tensors ``xs`` at a time,
    concatenated: a plain version's scores at the tools' shapes would need
    tens of GB at once."""
    return torch.cat([fn(*(x[i:i + 1] for x in xs)) for i in range(xs[0].shape[0])])


def _hold(label, out, native, ref32, launched, good=True, note="") -> tuple[float, float]:
    """The tolerance rule in each (batch, head, 64-row band) on its own; the
    call must have launched its kernel once and given finite values, and
    ``good`` must hold (``note`` says what it checked). Returns (max
    |kernel - plain|, worst err/bound); raises on a failure."""
    from flash_attention_from_scratch_tpu_torch.utils.testing import (
        row_bands, sliced_tolerance_check)

    ok, ratio, where = sliced_tolerance_check(
        row_bands(out), row_bands(native), row_bands(ref32), lead=3)
    err = float((out.float() - native.float()).abs().max())
    good = good and ok and launched == 1 and bool(torch.isfinite(out).all())
    print(f"{label}: max|kernel-plain| {err:.3e}, worst err/bound {ratio:.3f} in "
          f"(batch, head, band) {where}{note}, {launched} launch "
          f"{'ok' if good else 'FAIL'}",
          flush=True)
    if not good:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err, ratio


def _flash_quant_case(label, qq, kq, vq, cfg, i8c) -> tuple[float, float]:
    """K10 on (qq, kq, vq) vs its plain version (for int8c its int8-compute
    path, which rounds P as the kernel does) and reference attention in fp32
    on the inputs dequantized in fp32; the output keeps Q's strides."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
        KERNEL, flash_forward_quantized, flash_forward_quantized_plain)
    from flash_attention_from_scratch_tpu_torch.ops.quant import QTensor
    from flash_attention_from_scratch_tpu_torch.ops.reference import reference_attention

    before = _build.launch_counts[KERNEL]
    out = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c)
    sync()
    launched = _build.launch_counts[KERNEL] - before
    native = flash_forward_quantized_plain(qq, kq, vq, cfg, scale=D ** -0.5,
                                           int8_compute=i8c)
    ref32 = _per_batch(lambda *x: reference_attention(
        *x, causal=cfg.causal, q_offset=0 if cfg.causal else None, window=cfg.window,
        softcap=cfg.attn_softcap), *(_dequantized(x, torch.float32) for x in (qq, kq, vq)))
    q_vals = qq.values if isinstance(qq, QTensor) else qq
    return _hold(f"flash_quant {label}", out, native, ref32, launched,
                 good=out.stride() == q_vals.stride())


def phase_flash_quant_cases() -> tuple[float, float]:
    """K10 vs its plain version for every variant, non-causal and causal at
    s 1024 and 2048, plus windows, a softcap and strided Q: b 2, 32/8 heads.
    Returns (max |kernel - plain|, worst err/bound)."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig

    cases = [(f"{variant} {'causal' if causal else 'full'} s{seq}", variant, seq,
              dict(causal=causal), False)
             for seq in QUANT_CASE_SEQS for variant in QUANT_VARIANTS
             for causal in (False, True)]
    cases += [("int8c window 512 s2048", "int8c", 2048, dict(causal=True, window=512), False),
              ("int8kv window 300 s2048", "int8kv", 2048, dict(causal=True, window=300), False),
              ("fp8 softcap 50 s2048", "fp8", 2048, dict(causal=True, attn_softcap=50.0), False),
              ("int8kv strided q s2048", "int8kv", 2048, dict(causal=True), True),
              ("int8c strided q s2048", "int8c", 2048, {}, True)]
    worst = (0.0, 0.0)
    for i, (name, variant, seq, kw, strided) in enumerate(cases):
        qq, kq, vq = _quant_qkv(variant, seq, seed=500 + i, batch=QUANT_CASE_BATCH,
                                strided=strided)
        got = _flash_quant_case(name, qq, kq, vq, KernelConfig(**kw),
                                QUANT_VARIANTS[variant][2])
        worst = tuple(map(max, worst, got))
        del qq, kq, vq
    return worst


def phase_bench_tool_cases() -> dict:
    """Each kernel of the tools' path vs its plain version on the tools' own
    inputs (``bench_inputs``) at their default lengths, as the tools call
    them: K10 for every variant of ``bench_quant`` (non-causal; 16/16
    heads, b 16 at s 2048 and 4096, b 8 at s 8192), K11 at ring depth 2
    (``bench_attention --fori``: non-causal, 16/16 heads, b 16, s 512-4096),
    its plain versions run one batch element at a time. Returns {kernel:
    (max |kernel - plain|, worst err/bound)}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig, KVLoop
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL_FORI, flash_forward, flash_forward_plain)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import KERNEL as KQ

    worst = {KQ: (0.0, 0.0), KERNEL_FORI: (0.0, 0.0)}
    for seq in bench_quant.DEFAULT_SEQ_LENS:
        q, k, v = bench_quant.bench_inputs(seq)
        for variant, (_, _, i8c) in bench_quant.VARIANTS.items():
            qq, kq, vq = bench_quant.quantize_inputs(q, k, v, variant)
            got = _flash_quant_case(
                f"bench_quant {variant} b{q.shape[0]} h{q.shape[1]} s{seq}",
                qq, kq, vq, KernelConfig(), i8c)
            worst[KQ] = tuple(map(max, worst[KQ], got))
            del qq, kq, vq
        del q, k, v
        torch.cuda.empty_cache()
    cfg = KernelConfig(kv_loop=KVLoop.FORI)  # the tool's default depth, 2
    for seq in bench_attention.DEFAULT_SEQ_LENS:
        q, k, v = bench_attention.bench_inputs(seq)
        before = _build.launch_counts[KERNEL_FORI]
        out = flash_forward(q, k, v, cfg)
        sync()
        launched = _build.launch_counts[KERNEL_FORI] - before
        native = _per_batch(lambda *x: flash_forward_plain(*x, cfg)[0], q, k, v)
        ref32 = _per_batch(lambda *x: flash_forward_plain(*x, _fp32(cfg))[0],
                           q.float(), k.float(), v.float())
        got = _hold(f"bench_attention --fori nb{cfg.num_kv_buffers} b{q.shape[0]} "
                    f"h{q.shape[1]} s{seq}", out, native, ref32, launched)
        worst[KERNEL_FORI] = tuple(map(max, worst[KERNEL_FORI], got))
        del q, k, v, out, native, ref32
    torch.cuda.empty_cache()
    return worst


def _attn_bytes(q, k, v, out) -> int:
    """Bytes of the inputs (values and scales) and the output, each once."""
    from flash_attention_from_scratch_tpu_torch.ops.quant import QTensor

    total = out.numel() * out.element_size()
    for x in (q, k, v):
        for t in ((x.values, x.scales) if isinstance(x, QTensor) else (x,)):
            total += t.numel() * t.element_size()
    return total


def _kernel_ptxas(ptxas: dict, kernels: tuple) -> dict:
    """{kernel and its mangled template arguments: registers and spills} of
    the kernels named in ``kernels`` (empty when this run built nothing)."""
    pattern = re.compile(r"\d(" + "|".join(kernels) + r")(I(?:Li\d+E)+E)?")
    found = {}
    for name, v in ptxas.items():
        m = pattern.search(name)
        if m:
            found[m.group(1) + (m.group(2) or "")] = v
    return found


def time_flash_quant(ptxas: dict | None = None) -> dict:
    """K10 per variant, non-causal, at b 4, s 4096, 32/8 heads, d 128:
    time, bound (the two products' operations at the bf16 rate, or the
    int8 rate for int8c, against bytes), its share (bound / time) and the
    products' TFLOP/s (TOP/s for int8c), the plain version, and SDPA on the
    dequantized bf16 tensors. The top-level numbers are sums over the five
    variants. ``ptxas``: the build's registers and spills of
    ``flash_quant.cu``'s kernels (``flash_quant_kernelILi<Q>ELi<KV>``: Q 0
    bf16, 1 int8, 2 fp8; KV 1 int8, 2 fp8, 3 int4)."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import (
        KernelConfig, calc_self_attn_flop)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
        flash_forward_quantized, flash_forward_quantized_plain)

    cfg = KernelConfig()
    ops = _attn_ops(PERF_SEQ, HEADS, PERF_BATCH, causal=False)
    flops = calc_self_attn_flop(PERF_SEQ, D, HEADS, PERF_BATCH)  # the tools' model
    by_variant = {}
    for i, (variant, (_, _, i8c)) in enumerate(QUANT_VARIANTS.items()):
        qq, kq, vq = _quant_qkv(variant, PERF_SEQ, seed=80 + i, batch=PERF_BATCH)
        out = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c)
        ms = _time_ms(lambda: flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c))
        plain_ms = _time_ms(lambda: flash_forward_quantized_plain(
            qq, kq, vq, cfg, scale=D ** -0.5, int8_compute=i8c), iters=1, warmup=1)
        dq, dk, dv = (_dequantized(x, torch.bfloat16) for x in (qq, kq, vq))
        lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            dq, dk, dv, enable_gqa=True))
        bound_o = ops / (PEAK_INT8_OPS if i8c else PEAK_BF16_FLOPS)
        bound_b = _attn_bytes(qq, kq, vq, out) / PEAK_BYTES_PER_S
        bound_ms = 1e3 * max(bound_o, bound_b)
        by_variant[variant] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if bound_o >= bound_b else "bytes",
            "bound_share": bound_ms / ms, "product_tflops": ops / ms / 1e9,
            "tflops": flops / ms / 1e9}
        del qq, kq, vq, out, dq, dk, dv
    total = {key: sum(r[key] for r in by_variant.values())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {**total, "bound_by": "operations", "by_variant": by_variant,
            "ptxas": _kernel_ptxas(ptxas or {}, ("flash_quant_kernel", "flash_quant_i8_kernel")),
            "shape": f"sum over the variants {list(QUANT_VARIANTS)}: non-causal, "
                     f"b {PERF_BATCH}, {HEADS}/{KV_HEADS} heads, s {PERF_SEQ}, d {D}; "
                     "library: SDPA on the dequantized bf16 tensors"}


def time_fori(ptxas: dict | None = None) -> dict:
    """K11 at ring depths 1-4, non-causal and causal, with K1 and SDPA at
    the same shape (b 4, s 4096, 32/8 heads, d 128, bf16), each depth's
    share of the bound (bound / time) and TFLOP/s of the two products. The
    top-level numbers are the default depth's (2), summed over the two
    masks; the plain version runs one batch element at a time (its scores
    would need 8.6 GB at once). ``ptxas``: the build's registers and
    spills of ``flash_forward_fori.cu``'s kernels (``ILi<depth>``)."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig, KVLoop
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        flash_forward, flash_forward_plain)

    q, k, v = _cuda_qkv(PERF_SEQ, PERF_SEQ, seed=90, batch=PERF_BATCH)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())  # q, o, k, v in bf16
    by_mask = {}
    for causal in (False, True):
        cfg = KernelConfig(causal=causal)
        ops = _attn_ops(PERF_SEQ, HEADS, PERF_BATCH, causal)
        row = {f"nb{n}_ms": _time_ms(lambda: flash_forward(q, k, v, dataclasses.replace(
            cfg, kv_loop=KVLoop.FORI, num_kv_buffers=n))) for n in FORI_DEPTHS}
        row["flash_forward_k1_ms"] = _time_ms(lambda: flash_forward(q, k, v, cfg))
        row["library_ms"] = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
        row["plain_ms"] = _time_ms(lambda: _per_batch(
            lambda *x: flash_forward_plain(*x, cfg)[0], q, k, v), iters=1, warmup=1)
        row["bound_ms"] = 1e3 * max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)
        for n in FORI_DEPTHS:
            row[f"nb{n}_bound_share"] = row["bound_ms"] / row[f"nb{n}_ms"]
            row[f"nb{n}_tflops"] = ops / row[f"nb{n}_ms"] / 1e9
        by_mask["causal" if causal else "full"] = row
    total = {key: sum(r[src] for r in by_mask.values()) for key, src in (
        ("ms", "nb2_ms"), ("plain_ms", "plain_ms"), ("library_ms", "library_ms"),
        ("bound_ms", "bound_ms"))}
    del q, k, v
    return {**total, "bound_by": "operations", "by_mask": by_mask,
            "ptxas": _kernel_ptxas(ptxas or {}, ("flash_forward_fori_kernel",)),
            "shape": f"num_kv_buffers 2, non-causal + causal: b {PERF_BATCH}, "
                     f"{HEADS}/{KV_HEADS} heads, s {PERF_SEQ}, d {D}, bf16"}


def phase_bench_tools(smi: str) -> dict:
    """The slice's main path: ``tools/bench_quant.py`` (every variant at its
    default shapes, then its numerics check) and ``tools/bench_attention.py
    --fori`` at its defaults, each with the launch counts set to 0 just
    before and read just after. K10 must have run, and K11 without K1.
    Returns {kernel: launches}."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, KERNEL_FORI)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import KERNEL as KQ

    _build.launch_counts.clear()  # counts start at 0 just before the path
    rows = bench_quant.bench_quant(bench_quant.DEFAULT_SEQ_LENS)
    numerics = bench_quant.numerics_check()
    quant_counts = dict(_build.launch_counts)  # read just after
    print(json.dumps({"bench_quant": {"rows": rows, "numerics": numerics,
                                      "launches": quant_counts, "gpu": smi}}), flush=True)
    if quant_counts.get(KQ, 0) == 0 or not all(r["adaptive_ok"] for r in numerics):
        raise AssertionError(f"bench_quant: launches {quant_counts}, numerics {numerics}")

    _build.launch_counts.clear()
    results = bench_attention.bench(bench_attention.DEFAULT_SEQ_LENS, fori=True)
    fori_counts = dict(_build.launch_counts)
    print(json.dumps({"bench_attention": {"args": "--fori", "results": {
        name: {str(s): r for s, r in per_seq.items()} for name, per_seq in results.items()},
        "launches": fori_counts, "gpu": smi}}), flush=True)
    if fori_counts.get(KERNEL_FORI, 0) == 0 or fori_counts.get(K1, 0):
        raise AssertionError(f"bench_attention --fori: launches {fori_counts}")
    return {KQ: quant_counts[KQ], KERNEL_FORI: fori_counts[KERNEL_FORI]}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = phase_device()
    logs = phase_build()
    ptxas = _ptxas_by_kernel(logs.get("quant_matmul.cu", ""))
    flash_err, flash_ratio = phase_flash_cases()
    fori_err, fori_ratio = phase_fori_cases()
    quant_err, quant_ratio = phase_flash_quant_cases()
    paged_err = max(phase_paged_cases(), phase_quant_paged_cases())
    multi_err, multi_ratio = phase_paged_multi_cases()
    qmm_err = phase_quant_matmul_cases()
    backward_err = phase_backward_cases()
    served = phase_serve(smi)
    counts = served["counts"]
    phase_profile(served["server"], served["prompts"])
    spec = phase_serve_spec(served["server"].params, smi)  # the same weights
    del served  # frees the 16 GB of weights before training
    torch.cuda.empty_cache()
    trained = phase_train(smi)
    torch.cuda.empty_cache()
    quant_runs = {}
    for run in QUANT_RUNS:
        quant_runs[run] = phase_serve_quant(run, smi, profile=run == "A")
        torch.cuda.empty_cache()
    tools = phase_bench_tools(smi)
    torch.cuda.empty_cache()
    tool_cases = phase_bench_tool_cases()

    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
        KERNEL as K1, KERNEL_FORI)
    from flash_attention_from_scratch_tpu_torch.ops.flash_quant import KERNEL as KQ
    from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
        KERNEL as KP, KERNEL_INT8C, KERNEL_MULTI, KERNEL_MULTI_INT8C)
    from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import KERNELS

    pkg = "flash_attention_from_scratch_tpu_torch/csrc/"
    kernels = [
        {"name": K1, "route": "cuda", "source": pkg + "flash_forward.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_forward.py:284",
         "launches": counts.get(K1, 0), "max_abs_err": flash_err,
         "worst_err_bound": flash_ratio, **time_flash()},
        {"name": KP, "route": "cuda", "source": pkg + "paged_attention.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/paged_attention.py:280",
         "also_replaces": "flash_attention_from_scratch_tpu/ops/paged_attention.py:69",
         "launches": counts.get(KP, 0), "max_abs_err": max(paged_err, multi_err),
         "worst_err_bound_multi_int8c": multi_ratio, **time_paged(),
         "launches_by_entry": {
             KP: counts.get(KP, 0), KERNEL_MULTI: spec["counts"].get(KERNEL_MULTI, 0),
             KERNEL_INT8C: quant_runs["E"]["counts"].get(KERNEL_INT8C, 0),
             KERNEL_MULTI_INT8C: quant_runs["F"]["counts"].get(KERNEL_MULTI_INT8C, 0)},
         "launches_path": "bf16 serving; multi: the speculative run; int8c: run E; "
                          "multi_int8c: run F",
         "by_format": time_paged_formats(),
         "verify_t4": time_paged_verify(spec["verify_lengths"]),
         "int8c": time_paged_int8c()},
    ]
    fused_t, split_t = time_backward()
    split = trained["split"]
    kernels += [
        {"name": KERNEL_FUSED, "route": "cuda", "source": pkg + "flash_backward.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_backward.py:278",
         "launches": trained["fused"].get(KERNEL_FUSED, 0),
         "max_abs_err": backward_err[KERNEL_FUSED], **fused_t},
        {"name": "flash_backward_split", "route": "cuda",
         "source": pkg + "flash_backward.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_backward.py:118",
         "also_replaces": "flash_attention_from_scratch_tpu/ops/flash_backward.py:198",
         "launches": split.get(KERNEL_DKV, 0) + split.get(KERNEL_DQ, 0),
         "launches_by_entry": {n: split.get(n, 0) for n in (KERNEL_DKV, KERNEL_DQ)},
         "launches_path": "one training step in deterministic mode",
         "max_abs_err": backward_err["split"], **split_t},
    ]
    tpu_lines = {("int8", False): 159, ("int4", False): 135, ("int8", True): 178,
                 ("int4", True): 206}
    by_kernel = {}  # each kernel's launches from the first run that takes it
    for name, r in quant_runs.items():
        by_kernel.setdefault(r["kernel"], (name, r["launches"]))
    for mode, act_quant in QMM_RECIPES:
        name = KERNELS[(mode, act_quant)]
        run, launches = by_kernel[name]
        kernels.append({
            "name": name, "route": "cuda", "source": pkg + "quant_matmul.cu",
            "replaces": "flash_attention_from_scratch_tpu/ops/quant_matmul.py:"
                        f"{tpu_lines[(mode, act_quant)]}",
            "launches": launches, "launches_path": f"serve run {run}",
            "max_abs_err": qmm_err[name], **time_quant_matmul(mode, act_quant, ptxas)})
        if name == KERNELS[("int8", False)]:
            kernels[-1]["also_replaces"] = ("flash_attention_from_scratch_tpu/ops/"
                                            "quant_matmul.py:247")
    kernels += [
        {"name": KQ, "route": "cuda", "source": pkg + "flash_quant.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_quant.py:129",
         "also_replaces": "flash_attention_from_scratch_tpu/ops/flash_quant.py:46",
         "launches": tools[KQ],
         "launches_path": "tools/bench_quant.py: bench_quant and numerics_check "
                          "at their defaults",
         "max_abs_err": max(quant_err, tool_cases[KQ][0]),
         "worst_err_bound": max(quant_ratio, tool_cases[KQ][1]),
         **time_flash_quant(_ptxas_by_kernel(logs.get("flash_quant.cu", "")))},
        {"name": KERNEL_FORI, "route": "cuda", "source": pkg + "flash_forward_fori.cu",
         "replaces": "flash_attention_from_scratch_tpu/ops/flash_forward.py:578",
         "launches": tools[KERNEL_FORI],
         "launches_path": "tools/bench_attention.py --fori at its defaults",
         "max_abs_err": max(fori_err, tool_cases[KERNEL_FORI][0]),
         "worst_err_bound": max(fori_ratio, tool_cases[KERNEL_FORI][1]),
         **time_fori(_ptxas_by_kernel(logs.get("flash_forward_fori.cu", "")))},
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
