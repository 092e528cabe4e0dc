"""The port's MoE serving path (``models/decode.py::_mlp``) vs the JAX package's.

The JAX tests' tiny MoE (``tests/test_moe.py``'s config), its parameters
carried over by ``params_from_jax``; token ids from seeded numpy generators.

- ``prefill`` and ``decode_step`` in fp32 at batch 2 on the same padded
  inputs and pages: logits within 1e-4 of the row scale (fp32 products in
  another summation order; the routing of the padded prompt and of the
  decode batch agrees exactly, so no expert choice can differ).
- ``GenerationServer`` in bf16, every mode the serving path has for a MoE
  model (chunk 1 and 4, ``spec_k``, ``prefix_cache`` with
  ``prefill_chunk_tokens``, an int8 KV cache), 6 tokens a request: the
  served tokens equal the JAX server's in the same mode, and each is
  teacher-forced through the port's ``moe_forward`` on the prompt and the
  tokens before it, padded to 128 as the server pads. Its logit must lie
  within 0.25 of the row max, the JAX test's slack
  (``tests/test_moe.py::test_moe_decode_matches_forward``, 4 tokens): a
  decode batch routes under another capacity than a single-prompt
  recompute. Where the JAX server's own token misses that slack under the
  JAX ``moe_forward`` (the fifth token of prompt 2 here: 0.297), the
  port's gap must be the JAX gap within 1/32 (two bf16 ulps of these
  logits). Chunk 1 and chunk 4 serve equal tokens (a decode batch of at
  most 8 rows routes with 8 slots an expert, so nothing is dropped and
  rows are independent).
- ``fuse_projections`` on MoE params raises ``ValueError`` (the JAX
  function fails with ``KeyError('w_gate')``); ``quantize_params`` leaves
  the experts and the router as they are and quantizes the rest to the
  JAX package's bytes, and the quantized MoE model serves the JAX
  server's tokens.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import decode as jax_decode
from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.models import moe as jax_moe
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.serving.generate import (
    GenerationServer as JaxGenerationServer,
)
from flash_attention_from_scratch_tpu_torch.models import decode, llama, moe
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

SHAPE = dict(vocab_size=128, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=128, n_experts=4, expert_top_k=2)
PROMPTS = {1: list(range(10, 30)), 2: list(range(40, 45))}
SLACK = 0.25


def _configs(dtype):
    jcfg = jax_moe.MoEConfig(**SHAPE, block_q=128, block_kv=128, dtype=getattr(JaxDType, dtype))
    return jcfg, moe.MoEConfig(**SHAPE, dtype=getattr(DType, dtype))


@functools.lru_cache(maxsize=None)
def _jax_params(dtype):
    return jax_moe.init_moe_params(_configs(dtype)[0], jax.random.PRNGKey(0))


def _port_params(dtype):
    return llama.params_from_jax(jax.device_get(_jax_params(dtype)), device="cpu")


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def test_moe_prefill_and_decode_match_jax_fp32():
    """Two prompts (70 and 20 tokens, zero-padded to 128: the padding rows
    route too) into shuffled pages, then two decode steps at batch 2."""
    jcfg, cfg = _configs("FP32")
    jparams, params = _jax_params("FP32"), _port_params("FP32")
    num_pages, ps = 16, 64
    jcache = jax_decode.init_cache(jcfg, num_pages, ps)
    cache = decode.init_cache(cfg, num_pages, ps, device="cpu")
    rng = np.random.default_rng(1)
    prompt_lens = [70, 20]
    tables = np.array([[3, 7, -1, -1], [5, -1, -1, -1]], np.int32)
    for row, n in enumerate(prompt_lens):
        toks = np.zeros((1, 128), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        want, jcache = jax_decode.prefill(jparams, jnp.asarray(toks), jcfg, jcache,
                                          jnp.asarray(tables[row]), prompt_len=n)
        with torch.no_grad():
            got, cache = decode.prefill(params, torch.from_numpy(toks).long(), cfg, cache,
                                        torch.from_numpy(tables[row]), prompt_len=n)
        _close(got, want)
    for step in range(2):
        toks = rng.integers(0, cfg.vocab_size, 2).astype(np.int32)
        lens = np.array([n + 1 + step for n in prompt_lens], np.int32)
        want, jcache = jax_decode.decode_step(jparams, jnp.asarray(toks), jcfg, jcache,
                                              jnp.asarray(lens), jnp.asarray(tables))
        with torch.no_grad():
            got, cache = decode.decode_step(params, torch.from_numpy(toks).long(), cfg,
                                            cache, torch.from_numpy(lens),
                                            torch.from_numpy(tables))
        assert got.shape == (2, cfg.vocab_size)
        _close(got, want)


def _teacher_forced_gaps(forward, prompt, generated):
    """Per served token, the row max minus its logit under ``forward(tokens
    (1, n)) -> logits (1, n, vocab)`` on the tokens before it, padded to 128
    (the JAX test's recompute)."""
    gaps, toks = [], list(prompt)
    for g in generated:
        arr = np.zeros((1, len(toks) + (-len(toks)) % 128), np.int64)
        arr[0, :len(toks)] = toks
        logits = np.asarray(forward(arr)[0, len(toks) - 1], np.float32)
        gaps.append(float(logits.max() - logits[g]))
        toks.append(g)
    return gaps


def _port_forward(params, cfg):
    def forward(arr):
        with torch.no_grad():
            return moe.moe_forward(params, torch.from_numpy(arr), cfg)[0].numpy()
    return forward


@functools.lru_cache(maxsize=None)
def _jax_gaps(prompt: tuple, generated: tuple):
    jcfg, _ = _configs("BF16")
    return _teacher_forced_gaps(
        lambda arr: jax_moe.moe_forward(_jax_params("BF16"), jnp.asarray(arr, jnp.int32),
                                        jcfg)[0], prompt, generated)


SERVER_MODES = {
    "chunk1": {}, "chunk4": dict(chunk=4), "spec_k": dict(spec_k=3),
    "prefix_cache": dict(prefix_cache=True, prefill_chunk_tokens=128),
    "int8_kv": dict(mode="int8"),
}


def _prompts(mode):
    if mode == "spec_k":  # a repeated phrase, so prompt lookup drafts
        return {sid: (p * 4)[:40] for sid, p in PROMPTS.items()}
    return PROMPTS


@functools.lru_cache(maxsize=None)
def _serve(mode):
    _, cfg = _configs("BF16")
    server = GenerationServer(_port_params("BF16"), cfg, num_pages=32, page_size=64,
                              max_batch=2, pages_per_seq=8, device="cpu",
                              **SERVER_MODES[mode])
    for sid, p in _prompts(mode).items():
        server.submit(sid, p, 6)
    return server.run(), server.stats()


def _jax_serve(mode):
    jcfg, _ = _configs("BF16")
    server = JaxGenerationServer(_jax_params("BF16"), jcfg, num_pages=32, page_size=64,
                                 max_batch=2, pages_per_seq=8, **SERVER_MODES[mode])
    for sid, p in _prompts(mode).items():
        server.submit(sid, p, 6)
    return server.run()


@pytest.mark.parametrize("mode", sorted(SERVER_MODES))
def test_moe_server_matches_jax_server_and_forward(mode):
    _, cfg = _configs("BF16")
    got, stats = _serve(mode)
    assert got == _jax_serve(mode)
    forward = _port_forward(_port_params("BF16"), cfg)
    for sid, p in _prompts(mode).items():
        assert len(got[sid]) == 6, (sid, got[sid])
        gaps = _teacher_forced_gaps(forward, p, got[sid])
        jgaps = _jax_gaps(tuple(p), tuple(got[sid]))
        for gap, jgap in zip(gaps, jgaps):
            assert gap <= SLACK if jgap <= SLACK else abs(gap - jgap) <= 1 / 32, (
                mode, sid, gaps, jgaps)
    if mode == "chunk4":
        assert stats["decode_loops"] > 0
    if mode == "spec_k":
        assert stats["verify_steps"] > 0
    if mode == "prefix_cache":
        assert stats["prefill_tokens"] == sum(map(len, PROMPTS.values()))


def test_moe_chunk4_serves_the_stepwise_tokens():
    assert _serve("chunk4")[0] == _serve("chunk1")[0]


def test_fuse_projections_refuses_moe_params():
    params = _port_params("BF16")
    with pytest.raises(ValueError, match="MoE"):
        llama.fuse_projections(params)
    with pytest.raises(KeyError, match="w_gate"):  # the JAX package's failure
        jax_llama.fuse_projections(_jax_params("BF16"))


def test_quantize_params_leaves_the_experts_and_serves_as_jax():
    qparams = llama.quantize_params(_port_params("BF16"), "int8")
    jq = jax.device_get(jax_llama.quantize_params(_jax_params("BF16"), "int8"))
    for layer, jlayer in zip(qparams["layers"], jq["layers"]):
        for k in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(layer["experts"][k].float().numpy(),
                                          np.asarray(jlayer["experts"][k], np.float32))
        assert layer["router"].dtype == torch.float32
        np.testing.assert_array_equal(layer["wq"].values.numpy(), np.asarray(jlayer["wq"].values))
        np.testing.assert_array_equal(layer["wq"].scales.numpy(), np.asarray(jlayer["wq"].scales))
    jcfg, cfg = _configs("BF16")
    server = GenerationServer(qparams, cfg, num_pages=32, page_size=64, max_batch=2,
                              pages_per_seq=8, device="cpu", mode="int8")
    jserver = JaxGenerationServer(jq, jcfg, num_pages=32, page_size=64, max_batch=2,
                                  pages_per_seq=8, mode="int8")
    for s in (server, jserver):
        for sid, p in PROMPTS.items():
            s.submit(sid, p, 4)
    assert server.run() == jserver.run()
