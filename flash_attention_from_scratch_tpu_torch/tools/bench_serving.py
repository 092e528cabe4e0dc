"""End-to-end serving benchmark: scheduler + prefill + (chunked) decode.

Counterpart of ``flash_attention_from_scratch_tpu/tools/bench_serving.py``.
Unlike ``bench_decode`` (the decode step alone), this drives the whole
``GenerationServer`` loop (admission, paged prefill, continuous batching,
decode loops, stop-token bookkeeping) and reports decode tokens per
wall-second, the number a serving deployment sees, with TTFT and TPOT
percentiles. Two warm-up requests of the same shape first capture every
graph the measured run replays. ``--temperature`` and ``--top-k`` pass
through to the server (the JAX tool serves greedily only).

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.bench_serving \\
        --model tiny --requests 32 --prompt 256 --new 64 --chunk 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.llama import init_params, init_quantized_params
from ..serving.generate import GenerationServer
from ..utils.chip import device_kind
from ..utils.device import resolve_device
from .bench_decode import MODELS

__all__ = ["parser", "run", "main"]

WARMUP_IDS = 10 ** 9  # warm-up requests' ids start here; the measured ones below


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="tiny", choices=sorted(MODELS))
    ap.add_argument("--weights", default="int8", choices=["int8", "int4", "bf16"])
    ap.add_argument("--kv", default="int8", choices=["dense", "int8", "fp8"])
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--new", type=int, default=64, help="tokens to generate per request")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode tokens per scheduler step when stable")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding with k prompt-lookup draft tokens "
                         "per step (exclusive with --chunk)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-hash prefix caching (shared prompt pages)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of prompt shared across all requests "
                         "(exercises the prefix cache)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0: greedy)")
    ap.add_argument("--top-k", type=int, default=0, help="top-k filter (0: none)")
    return ap


def run(args, device="cuda", cfg=None, log=print) -> dict:
    """One benchmark run of the parsed ``args`` on ``device``: builds the
    server (weights from seed 0), serves two warm-up requests, then
    ``args.requests`` measured ones; prints and returns the JSON result.
    ``cfg`` overrides ``MODELS[args.model]`` (the CPU tests' tiny models)."""
    dev = resolve_device(device)
    cfg = cfg or MODELS[args.model]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = (init_params(cfg, gen, dev) if args.weights == "bf16"
              else init_quantized_params(cfg, gen, args.weights, device=dev))

    pages_per_seq = -(-(args.prompt + args.new + 1) // args.page_size)
    num_pages = args.max_batch * pages_per_seq * 2 + 1
    server = GenerationServer(
        params, cfg, num_pages=num_pages, page_size=args.page_size,
        max_batch=args.max_batch, pages_per_seq=pages_per_seq, mode=args.kv,
        chunk=1 if args.spec_k else args.chunk, spec_k=args.spec_k,
        prefix_cache=args.prefix_cache, temperature=args.temperature,
        top_k=args.top_k, device=dev)

    rng = np.random.default_rng(0)
    shared = rng.integers(1, cfg.vocab_size, args.shared_prefix).tolist()

    def make_prompt():
        return shared + rng.integers(1, cfg.vocab_size,
                                     args.prompt - args.shared_prefix).tolist()

    # Warm-up: same-shaped requests capture every graph the measured run
    # replays (the step at max_batch, each power-of-two loop, the verify
    # step) and, with the prefix cache, publish the shared pages.
    for sid in range(2):
        server.submit(WARMUP_IDS + sid, make_prompt(), args.new)
    server.run()

    for sid in range(args.requests):
        server.submit(sid, make_prompt(), args.new)
    t0 = time.perf_counter()
    tps = server.throughput()
    wall = time.perf_counter() - t0

    measured = [st for sid, st in server.seqs.items() if sid < WARMUP_IDS]
    total_new = sum(len(st.generated) for st in measured)
    if total_new != args.requests * args.new:
        raise RuntimeError(f"the run did not drain: {total_new} of "
                           f"{args.requests * args.new} tokens")
    # TTFT = submit to first token (queueing included: the serving-level
    # number); TPOT = time per output token after the first.
    ttft = np.array([st.first_t - st.submit_t for st in measured])
    tpot = np.array([(st.done_t - st.first_t) / max(len(st.generated) - 1, 1)
                     for st in measured if st.done_t > 0])

    def pct(a, q):
        return round(float(np.percentile(a, q)) * 1e3, 1) if len(a) else None

    line = {
        "metric": (f"serving_tokens_per_s_{args.model}_w{args.weights}_kv{args.kv}"
                   + (f"_spec{args.spec_k}" if args.spec_k else "")),
        "value": round(tps, 2),
        "unit": "decode tokens/s (wall)",
        "requests": args.requests,
        "prompt_len": args.prompt,
        "new_tokens": args.new,
        "chunk": args.chunk if not args.spec_k else 1,
        "spec_k": args.spec_k,
        "temperature": args.temperature,
        "top_k": args.top_k,
        "spec_proposed": server.spec_proposed,
        "spec_accepted": server.spec_accepted,
        "prefix_hits_pages": server.engine.prefix_hits if args.prefix_cache else 0,
        "max_batch": args.max_batch,
        "scheduler_steps": server.steps,
        "preemptions": server.engine.preempt_count,
        "wall_s": round(wall, 2),
        "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
        "tpot_ms_p50": pct(tpot, 50), "tpot_ms_p99": pct(tpot, 99),
        "total_new_tokens": total_new,
        "device": device_kind() if dev.type == "cuda" else str(dev),
    }
    log(json.dumps(line))
    return line


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.shared_prefix > args.prompt:
        ap.error(f"--shared-prefix ({args.shared_prefix}) cannot exceed "
                 f"--prompt ({args.prompt})")
    run(args, device="cuda")  # times the card only: raises without one
    return 0


if __name__ == "__main__":
    sys.exit(main())
