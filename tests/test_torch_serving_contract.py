"""GenerationServer's public contract against the JAX server, on the CPU.

``throughput()`` drives the submitted requests to the end and returns decode
tokens per wall-second: both servers decode the same number of tokens (the
rate itself is a host-clock number and is not compared). ``stats()`` has
``prefix_hit_pages`` (0: neither server has a prefix cache here). ``chunk``
outside [1, page_size] raises ``ValueError`` in both, and a chunk inside it
serves. Attention sinks:
the paged kernel has no sink term in either package, so the port refuses
a sink config in ``prefill``, ``decode_step``, ``verify_step`` and the
server; ``forward`` and training keep their sinks.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, init_params as jax_init_params,
)
from flash_attention_from_scratch_tpu.serving.generate import (
    GenerationServer as JaxGenerationServer,
)
from flash_attention_from_scratch_tpu_torch.models import decode
from flash_attention_from_scratch_tpu_torch.models.llama import (
    LlamaConfig, forward, init_params, params_from_jax,
)
from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=256)
JCFG = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128)
CFG = LlamaConfig(**SHAPE)
PROMPTS = {1: list(range(10, 30)), 2: list(range(40, 45))}
SERVE = dict(num_pages=16, page_size=64, max_batch=2, pages_per_seq=4)


@pytest.fixture(scope="module")
def servers():
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    return (JaxGenerationServer(jparams, JCFG, **SERVE),
            GenerationServer(params, CFG, device="cpu", **SERVE))


def test_throughput_and_stats_match_jax(servers):
    """The same requests through throughput(): the same decode tokens and
    the same stats keys and counters (prefix_hit_pages 0 in both)."""
    rates, stats = [], []
    for server in servers:
        for sid, prompt in PROMPTS.items():
            server.submit(sid, prompt, 4)
        rates.append(server.throughput())
        stats.append(server.stats())
        assert not server.has_work
    want, got = stats
    assert got["decode_tokens"] == want["decode_tokens"] == len(PROMPTS) * 3
    assert rates[1] > 0 and np.isfinite(rates[1])
    assert got["prefix_hit_pages"] == want["prefix_hit_pages"] == 0
    assert set(want) <= set(got), set(want) - set(got)
    for key in ("decode_tokens", "running", "waiting", "free_pages", "preemptions"):
        assert got[key] == want[key], key
    # Nothing left to run: a second call decodes nothing.
    assert servers[1].throughput() == 0.0
    assert servers[1].stats()["decode_tokens"] == got["decode_tokens"]


@pytest.mark.parametrize("chunk", [0, -1, 65])
def test_chunk_outside_page_raises_as_in_jax(chunk):
    """chunk outside [1, page_size] is a ValueError in both servers."""
    jparams = {"embed": jax.numpy.zeros((4, 4))}
    with pytest.raises(ValueError, match="chunk"):
        JaxGenerationServer(jparams, JCFG, num_pages=8, page_size=64, max_batch=2,
                            chunk=chunk)
    with pytest.raises(ValueError, match="chunk"):
        GenerationServer({"embed": torch.zeros((4, 4))}, CFG, num_pages=8,
                         page_size=64, max_batch=2, chunk=chunk, device="cpu")


def test_chunk_in_range_serves():
    """chunk = page_size, the largest allowed: the same decode tokens and
    the same counters as the JAX server with that chunk."""
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    pair = (JaxGenerationServer(jparams, JCFG, chunk=64, **SERVE),
            GenerationServer(params, CFG, device="cpu", chunk=64, **SERVE))
    stats = []
    for server in pair:
        for sid, prompt in PROMPTS.items():
            server.submit(sid, prompt, 9)
        server.run()
        stats.append(server.stats())
    want, got = stats
    for key in ("decode_tokens", "steps", "free_pages", "preemptions"):
        assert got[key] == want[key], key
    assert got["decode_loops"] >= 1


@pytest.fixture(scope="module")
def sink_model():
    cfg = dataclasses.replace(CFG, attn_sinks=True)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_serving_refuses_sinks(sink_model):
    cfg, params = sink_model
    with pytest.raises(ValueError, match="attn_sinks"):
        GenerationServer(params, cfg, device="cpu", **SERVE)
    cache = decode.init_cache(cfg, 4, 64, "dense", "cpu")
    tokens = torch.zeros((1, 128), dtype=torch.int64)
    table = torch.tensor([0, 1, -1], dtype=torch.int32)
    with pytest.raises(ValueError, match="attn_sinks"):
        decode.prefill(params, tokens, cfg, cache, table, 5)
    lengths = torch.tensor([6], dtype=torch.int32)
    tables = table[None]
    with pytest.raises(ValueError, match="attn_sinks"):
        decode.decode_step(params, torch.zeros(1, dtype=torch.int64), cfg, cache,
                           lengths, tables)
    with pytest.raises(ValueError, match="attn_sinks"):
        decode.verify_step(params, torch.zeros((1, 2), dtype=torch.int64), cfg, cache,
                           lengths, tables)


def test_forward_keeps_sinks(sink_model):
    """The same model without serving: forward runs, and its sinks move the
    logits (a sink of +5 in every layer against one of -inf-like -30)."""
    cfg, params = sink_model
    tokens = torch.arange(128, dtype=torch.int64)[None] % cfg.vocab_size
    for layer in params["layers"]:
        layer["attn_sinks"].fill_(5.0)
    with_sinks = forward(params, tokens, cfg)
    for layer in params["layers"]:
        layer["attn_sinks"].fill_(-30.0)
    without = forward(params, tokens, cfg)
    assert bool(torch.isfinite(with_sinks).all())
    assert float((with_sinks.float() - without.float()).abs().max()) > 0
