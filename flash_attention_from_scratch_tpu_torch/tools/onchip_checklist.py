"""One-command validation on the card of the JAX checklist's items, run on the port.

Counterpart of ``flash_attention_from_scratch_tpu/tools/onchip_checklist.py``,
with its ``CHECKS`` names in its order and its output: one PASS/FAIL line an
item on stderr, one JSON summary on stdout, exit 1 on any FAIL. Each item
runs the port on the card at the JAX item's shapes (the inputs are torch's
draws, not ``jax.random``'s):

- ``offset_causal_kernel``, ``sliding_window_kernel``, ``attn_softcap_kernel``:
  K1 held by ``adaptive_tolerance_check`` to ``reference_pair``;
- ``multi_token_paged``: a t = 4 K4/K5 call whose last token matches the
  single-token call within 5e-3;
- ``windowed_paged_dma_skip``: window 256, a finite output, with every page
  that lies wholly below a sequence's window (never read) and every page
  past its length filled with NaN;
- ``serving_spec_prefix_chunked``: the JAX item's tiny ``GenerationServer``
  under its four option sets, 8 tokens for each of 3 requests;
- ``decode_8b_w4a8_regression``: ``tools/bench_decode.py`` with the JAX
  item's flags, its tokens/s at least :data:`DECODE_FLOOR_TOKENS_PER_S`.
  The JAX floor (1,500) is a TPU's figure; this one is set from this
  card's own runs (see the constant).

On the card only: raises without one.

    python -m flash_attention_from_scratch_tpu_torch.tools.onchip_checklist
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import traceback

import torch

from ..utils.chip import device_kind
from ..utils.device import resolve_device

__all__ = ["CHECKS", "DECODE_ARGS", "DECODE_FLOOR_TOKENS_PER_S", "main"]

# bench_decode with DECODE_ARGS read 1,946.18 tokens/s (8.221 ms a step) on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit; host-bound decode rates
# have moved by up to 48% between runs on such a card, so the floor is about
# half of that.
DECODE_FLOOR_TOKENS_PER_S = 1000.0
DECODE_ARGS = ["--model", "8b", "--weights", "int4", "--act", "int8", "--kv", "int8",
               "--attn-int8", "--fuse", "--scan", "--steps", "32", "--batch", "16"]


def _normal(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def _check_k1(q, k, v, cfg, **ref_kw):
    from ..ops.flash_forward import flash_forward
    from ..ops.reference import reference_pair
    from ..utils.testing import adaptive_tolerance_check

    out = flash_forward(q, k, v, cfg)
    ref_n, ref_f = reference_pair(q, k, v, **ref_kw)
    ok, kerr, berr = adaptive_tolerance_check(out, ref_n, ref_f)
    assert ok, (kerr, berr)
    return f"kerr={kerr:.3e} baseline={berr:.3e}"


def _check_offset_causal():
    from ..ops.configs import KernelConfig
    from ..utils.testing import generate_qkv

    qf, k, v = generate_qkv(1024, n_heads=4, batch=2)
    q = qf[:, :, 256:512]
    cfg = KernelConfig(block_q=128, block_kv=128, causal=True, q_offset=256)
    return _check_k1(q, k[:, :, :512], v[:, :, :512], cfg, causal=True, q_offset=256)


def _check_sliding_window():
    from ..ops.configs import KernelConfig
    from ..utils.testing import generate_qkv

    q, k, v = generate_qkv(2048, n_heads=4, batch=2)
    cfg = KernelConfig(block_q=128, block_kv=256, causal=True, window=512,
                       optimized_softmax=False)
    return _check_k1(q, k, v, cfg, causal=True, q_offset=0, window=512)


def _check_softcap():
    from ..ops.configs import KernelConfig
    from ..utils.testing import generate_qkv

    q, k, v = generate_qkv(1024, n_heads=4, batch=2)
    q = (q.float() * 8).bfloat16()
    cfg = KernelConfig(block_q=128, block_kv=128, causal=True, attn_softcap=50.0)
    return _check_k1(q, k, v, cfg, causal=True, q_offset=0, softcap=50.0)


def _check_multi_token_paged():
    from ..ops.paged_attention import paged_decode_attention

    batch, kv_heads, heads, d, ps, t = 4, 4, 16, 128, 128, 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    kp = _normal((kv_heads, 16, ps, d), gen)
    vp = _normal(kp.shape, gen)
    q = _normal((batch, heads, t, d), gen)
    pt = torch.arange(batch * 4, dtype=torch.int32, device="cuda").reshape(batch, 4)
    lengths = torch.tensor([512, 300, 130, 17], dtype=torch.int32, device="cuda")
    out = paged_decode_attention(q, kp, vp, lengths, pt)
    single = paged_decode_attention(q[:, :, -1].contiguous(), kp, vp, lengths, pt)
    drift = float((out[:, :, -1].float() - single.float()).abs().max())
    assert drift < 5e-3, drift
    return f"drift={drift:.3e}"


def _check_windowed_paged():
    from ..ops.paged_attention import paged_decode_attention

    batch, kv_heads, heads, d, ps, window = 4, 4, 16, 128, 128, 256
    gen = torch.Generator(device="cuda").manual_seed(1)
    kp = _normal((kv_heads, 32, ps, d), gen)
    vp = _normal(kp.shape, gen)
    q = _normal((batch, heads, d), gen)
    pt = torch.arange(batch * 8, dtype=torch.int32, device="cuda").reshape(batch, 8)
    lengths = [1024, 700, 300, 64]
    poisoned = 0
    for b, length in enumerate(lengths):
        for j in range(8):
            start = j * ps
            if start + ps <= length - window or start >= length:  # never read
                kp[:, b * 8 + j] = float("nan")
                vp[:, b * 8 + j] = float("nan")
                poisoned += 1
    out = paged_decode_attention(q, kp, vp, torch.tensor(lengths, dtype=torch.int32,
                                                         device="cuda"), pt, window=window)
    assert bool(torch.isfinite(out.float()).all()), "non-finite output"
    return f"{poisoned} pages poisoned"


def _check_serving_tiny():
    from ..models.llama import LlamaConfig, init_params
    from ..models.lora import init_lora_adapters
    from ..serving.generate import GenerationServer

    cfg = LlamaConfig(vocab_size=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      d_head=128, hidden_dim=1024)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    lora = init_lora_adapters(cfg, 2, 8, torch.Generator(device="cuda").manual_seed(1),
                              zero_b=False)
    for kwargs in ({"spec_k": 4}, {"prefix_cache": True}, {"prefill_chunk_tokens": 128},
                   {"lora": lora, "chunk": 4}):
        server = GenerationServer(params, cfg, num_pages=64, page_size=128, max_batch=4,
                                  pages_per_seq=8, **kwargs)
        for sid in range(3):
            server.submit(sid, [(sid * 31 + i) % 512 for i in range(200)], 8,
                          adapter=sid % 2 if "lora" in kwargs else -1)
        got = server.run()
        assert all(len(got[sid]) == 8 for sid in range(3)), kwargs


def _check_decode_regression():
    """8B W4A8 decode at or above this card's floor."""
    from .bench_decode import main as bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench(list(DECODE_ARGS))
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert row["value"] >= DECODE_FLOOR_TOKENS_PER_S, (row["value"], DECODE_FLOOR_TOKENS_PER_S)
    return {"value": row["value"], "floor": DECODE_FLOOR_TOKENS_PER_S,
            "ms_per_step": row["ms_per_step"]}


CHECKS = [
    ("offset_causal_kernel", _check_offset_causal),
    ("sliding_window_kernel", _check_sliding_window),
    ("attn_softcap_kernel", _check_softcap),
    ("multi_token_paged", _check_multi_token_paged),
    ("windowed_paged_dma_skip", _check_windowed_paged),
    ("serving_spec_prefix_chunked", _check_serving_tiny),
    ("decode_8b_w4a8_regression", _check_decode_regression),
]


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    resolve_device("cuda")
    print(f"device: {device_kind()}", file=sys.stderr)
    results = {}
    for name, fn in CHECKS:
        try:
            extra = fn()
            results[name] = "PASS"
            print(f"  {name}: PASS" + (f" {extra}" if extra else ""), file=sys.stderr)
        except Exception as e:  # noqa: BLE001 -- report, keep going
            results[name] = f"FAIL: {e}"
            traceback.print_exc()
            print(f"  {name}: FAIL {e}", file=sys.stderr)
        torch.cuda.empty_cache()
    print(json.dumps(results))
    return 0 if all(v == "PASS" for v in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
