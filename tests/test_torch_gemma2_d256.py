"""Gemma-2 at head width 256 on the CPU: the port against the JAX package.

A tiny Gemma-2-shaped config at d_head 256: 2 layers (a 64-token window on
layer 0, layer 1 global), attention and final softcaps 50 / 30, the
attention scale 256^-0.5, the sqrt(dim) embedding scale, the sandwich
norms and the GeLU MLP. JAX parameters from a PRNG key are carried across
by ``params_from_jax``; token ids are fixed lists. The port runs its plain
kernel versions (CPU tensors), the JAX package its Pallas kernels in
interpret mode, at these tiny shapes only.

- The port's server: every served token teacher-forced through the JAX
  ``forward`` lies within 0.05 of its row max (tests/test_torch_serving.py's
  rule: random-model bf16 logits tie within an ulp), with a prompt past the
  window.
- The int8-cache servers on the same quantized fp32 model (where logits do
  not tie) serve equal tokens.
- ``prefill``'s logits against the JAX ``prefill`` by the adaptive rule
  (``utils/testing.py::adaptive_tolerance_check``): the port in bf16 against
  JAX in bf16, with JAX in fp32 on the same bf16 weights as the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import decode as jax_decode
from flash_attention_from_scratch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, forward as jax_forward, init_params as jax_init_params,
    quantize_params as jax_quantize_params,
)
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.serving.generate import (
    GenerationServer as JaxGenerationServer,
)
from flash_attention_from_scratch_tpu_torch.models import decode
from flash_attention_from_scratch_tpu_torch.models.llama import LlamaConfig, params_from_jax
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer
from flash_attention_from_scratch_tpu_torch.utils.testing import adaptive_tolerance_check

WINDOW = 64
SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, d_head=256,
             hidden_dim=256, window_pattern=(WINDOW, 0), mlp_act="gelu", post_norms=True,
             embed_scale=True, attn_softcap=50.0, final_softcap=30.0,
             attn_scale=256 ** -0.5)
JCFG = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128)
CFG = LlamaConfig(**SHAPE)
# The first prompt is past the window.
PROMPTS = {1: [(7 * i + 3) % 256 for i in range(100)], 2: list(range(40, 60))}
SLACK = 0.05
SERVER = dict(num_pages=32, page_size=64, max_batch=4, pages_per_seq=8)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, jax.random.PRNGKey(0))


def _row_logits(params, cfg, seq):
    toks = np.zeros((1, 128), np.int32)
    toks[0, :len(seq)] = seq
    return np.asarray(jax_forward(params, jnp.asarray(toks), cfg)[0])


def test_config_is_gemma2_at_d256():
    assert CFG.d_head == JCFG.d_head == 256
    assert [CFG.layer_window(i) for i in range(2)] == [WINDOW, 0]
    assert len(PROMPTS[1]) > WINDOW


def test_server_matches_jax_forward(jax_params):
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    server = GenerationServer(params, CFG, device="cpu", **SERVER)
    n_new = 4
    for sid, prompt in PROMPTS.items():
        server.submit(sid, prompt, n_new)
    got = server.run()
    for sid, prompt in PROMPTS.items():
        assert len(got[sid]) == n_new, (sid, got[sid])
        logits = _row_logits(jax_params, JCFG, prompt + got[sid][:-1])
        for i, tok in enumerate(got[sid]):
            row = logits[len(prompt) - 1 + i]
            assert row.max() - row[tok] <= SLACK, (sid, i, tok, row.argmax())


def test_int8_cache_server_matches_jax_server():
    """Both servers on the same int8-weight fp32 model with int8 KV pages
    serve the same greedy tokens."""
    jcfg = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    cfg = LlamaConfig(**SHAPE, dtype=DType.FP32)
    jparams = jax_quantize_params(jax_init_params(jcfg, jax.random.PRNGKey(1)), "int8")
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    servers = [JaxGenerationServer(jparams, jcfg, mode="int8", **SERVER),
               GenerationServer(params, cfg, device="cpu", mode="int8", **SERVER)]
    for server in servers:
        for sid, prompt in PROMPTS.items():
            server.submit(sid, prompt, 3)
    want, got = (server.run() for server in servers)
    assert got == want
    assert servers[1].cache.mode == "int8"
    assert servers[1].cache.k_pages[0].shape[-1] == 256


def test_prefill_matches_jax_prefill(jax_params):
    """Each prompt's prefill logits, the port in bf16 against the JAX
    package in bf16 and in fp32 (the bf16 weights upcast), by the adaptive
    rule."""
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    jcfg32 = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    jparams32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jax_params)
    got, want16, want32 = [], [], []
    for prompt in PROMPTS.values():
        n = len(prompt)
        toks = np.zeros((1, 128), np.int32)
        toks[0, :n] = prompt
        table = np.array([0, 1, -1, -1], np.int32)
        for out, params_, cfg in ((want16, jax_params, JCFG), (want32, jparams32, jcfg32)):
            cache = jax_decode.init_cache(cfg, 4, 64)
            logits, _ = jax_decode.prefill(params_, jnp.asarray(toks), cfg, cache,
                                           jnp.asarray(table), prompt_len=n)
            out.append(np.asarray(logits, np.float32))
        cache = decode.init_cache(CFG, 4, 64, device="cpu")
        logits, _ = decode.prefill(params, torch.from_numpy(toks).long(), CFG, cache,
                                   torch.from_numpy(table), prompt_len=n)
        got.append(logits.float())
    ok, err, base = adaptive_tolerance_check(
        torch.stack(got), torch.from_numpy(np.stack(want16)), torch.from_numpy(np.stack(want32)))
    assert ok, (err, base)
