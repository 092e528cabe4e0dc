"""A model served in fp16 on the CPU: the port against the JAX package.

A tiny Llama-shaped config in fp16 (``LlamaConfig.dtype`` FP16: 2 layers,
dim 256, 2/1 heads of 128, vocab 256). JAX parameters from a PRNG key are
carried across by ``params_from_jax``; token ids are fixed lists. The port
runs its plain kernel versions (CPU tensors), the JAX package its Pallas
kernels in interpret mode. On the card the same model runs K1, K4/K5 and
K6-K9 from their fp16 libraries (``chip_smoke.py``'s ``serve_fp16``).

- ``prefill``'s logits for each prompt and one ``decode_step``'s for the
  batch against the JAX ``prefill`` and ``decode_step`` by the adaptive
  rule (``utils/testing.py::adaptive_tolerance_check``): the port in fp16
  against JAX in fp16, with JAX in fp32 on the same fp16 weights as the
  reference; the pages written in fp16.
- The port's server serves the JAX server's greedy tokens with a dense fp16
  cache, and with int8 weights (K6) and an int8 cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import decode as jax_decode
from flash_attention_from_scratch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, init_params as jax_init_params,
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

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, d_head=128,
             hidden_dim=256)
JCFG = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP16)
JCFG32 = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
CFG = LlamaConfig(**SHAPE, dtype=DType.FP16)
PROMPTS = {1: [(7 * i + 3) % 256 for i in range(100)], 2: list(range(40, 60))}
SERVER = dict(num_pages=32, page_size=64, max_batch=4, pages_per_seq=4)
TABLES = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, jax.random.PRNGKey(0))


def test_config_is_fp16(jax_params):
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    assert {p.dtype for p in jax.tree_util.tree_leaves(params)} == {torch.float16}
    assert decode.init_cache(CFG, 4, 64, device="cpu").k_pages[0].dtype == torch.float16


def _jax_steps(params, cfg):
    """JAX: each prompt's prefill logits, then one decode step of the batch
    on the next token (the prompt's last plus one, mod the vocabulary)."""
    cache = jax_decode.init_cache(cfg, 8, 64)
    rows = []
    for b, prompt in enumerate(PROMPTS.values()):
        toks = np.zeros((1, 128), np.int32)
        toks[0, :len(prompt)] = prompt
        logits, cache = jax_decode.prefill(params, jnp.asarray(toks), cfg, cache,
                                           jnp.asarray(TABLES[b]), prompt_len=len(prompt))
        rows.append(np.asarray(logits, np.float32))
    nxt = np.array([(p[-1] + 1) % 256 for p in PROMPTS.values()], np.int32)
    lens = np.array([len(p) + 1 for p in PROMPTS.values()], np.int32)
    step, _ = jax_decode.decode_step(params, jnp.asarray(nxt), cfg, cache, jnp.asarray(lens),
                                     jnp.asarray(TABLES))
    return np.stack(rows), np.asarray(step, np.float32)


def test_prefill_and_decode_step_match_jax(jax_params):
    """The port in fp16 against JAX in fp16 by the adaptive rule, JAX in fp32
    on the same fp16 weights the reference: each prompt's prefill logits,
    then a decode step over both sequences' fp16 pages."""
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    want16 = _jax_steps(jax_params, JCFG)
    want32 = _jax_steps(jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jax_params),
                        JCFG32)
    cache = decode.init_cache(CFG, 8, 64, device="cpu")
    rows = []
    for b, prompt in enumerate(PROMPTS.values()):
        toks = torch.zeros((1, 128), dtype=torch.long)
        toks[0, :len(prompt)] = torch.tensor(prompt)
        logits, cache = decode.prefill(params, toks, CFG, cache, torch.from_numpy(TABLES[b]),
                                       prompt_len=len(prompt))
        rows.append(logits.float())
    assert cache.k_pages[0].dtype == torch.float16
    nxt = torch.tensor([(p[-1] + 1) % 256 for p in PROMPTS.values()])
    lens = torch.tensor([len(p) + 1 for p in PROMPTS.values()], dtype=torch.int32)
    step, _ = decode.decode_step(params, nxt, CFG, cache, lens, torch.from_numpy(TABLES))
    for got, w16, w32 in ((torch.stack(rows), *(w[0] for w in (want16, want32))),
                          (step, want16[1], want32[1])):
        ok, err, base = adaptive_tolerance_check(got.float(), torch.from_numpy(w16).half(),
                                                 torch.from_numpy(w32))
        assert ok, (err, base)


@pytest.mark.parametrize("quant", ["dense", "int8"])
def test_server_serves_the_jax_servers_tokens(jax_params, quant):
    """Both servers on the same fp16 model (dense: a dense fp16 cache; int8:
    int8 weights and an int8 cache) serve the same greedy tokens."""
    jparams = jax_params if quant == "dense" else jax_quantize_params(jax_params, "int8")
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    servers = [JaxGenerationServer(jparams, JCFG, mode=quant, **SERVER),
               GenerationServer(params, CFG, device="cpu", mode=quant, **SERVER)]
    for server in servers:
        for sid, prompt in PROMPTS.items():
            server.submit(sid, prompt, 4)
    want, got = (server.run() for server in servers)
    assert got == want
    assert servers[1].cache.mode == quant
    if quant == "dense":
        assert servers[1].cache.k_pages[0].dtype == torch.float16
