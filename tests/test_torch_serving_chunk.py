"""GenerationServer's chunked decode and chunked prefill vs the JAX server.

``chunk`` decodes up to that many greedy tokens a step in one
``decode_loop`` (rounded down to a power of two, and only while the batch
cannot change); ``prefill_chunk_tokens`` prefills each prompt through
``prefill_chunked``. Both servers run on the CPU (the JAX one in interpret
mode) with the same options: on the fp32 quantized models of
``tests/test_torch_serving.py`` (int8 weights with an int8 cache, W4A8 with
an int4 cache; logits do not tie) the served tokens are equal; on the bf16
model every served token is teacher-forced through the JAX ``forward`` and
must lie within 0.05 of the row max (``tests/test_generate.py``'s rule).
A stop token inside a chunk ends the sequence there, and budgets that end
inside a chunk shorten it, as in the JAX server on the fp32 model
(``tests/test_generate.py``'s cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, forward as jax_forward,
    fuse_projections as jax_fuse_projections, init_params as jax_init_params,
    quantize_params as jax_quantize_params,
)
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.serving.generate import (
    GenerationServer as JaxGenerationServer,
)
from flash_attention_from_scratch_tpu_torch.models.llama import (
    LlamaConfig, params_from_jax,
)
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=256)
JCFG = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128)
CFG = LlamaConfig(**SHAPE)
# A 300-token prompt spans three 128-token prefill chunks.
PROMPTS = {1: list(range(10, 30)), 2: list(range(40, 45)),
           3: [(7 * i + 3) % 256 for i in range(300)]}
SERVE = dict(num_pages=32, page_size=64, max_batch=4, pages_per_seq=8)
OPTIONS = {"chunk4": dict(chunk=4), "prefill_chunk128": dict(prefill_chunk_tokens=128),
           "both": dict(chunk=8, prefill_chunk_tokens=128)}
SLACK = 0.05


def _serve(servers, prompts, budgets, stop=None):
    for server in servers:
        for sid, prompt in prompts.items():
            server.submit(sid, prompt, budgets[sid], stop=(stop or {}).get(sid, ()))
    return [server.run() for server in servers]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("wmode,act,kv_mode", [("int8", "bf16", "int8"),
                                               ("int4", "int8", "int4")],
                         ids=["int8-weights-int8-cache", "W4A8-int4-cache"])
def test_quantized_server_options_match_jax_server(wmode, act, kv_mode, option, fused):
    """The same greedy tokens as the JAX server with the same option, on
    the fp32 quantized model, its projections fused or not in both."""
    jcfg = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    cfg = LlamaConfig(**SHAPE, dtype=DType.FP32)
    jparams = jax_quantize_params(jax_init_params(jcfg, jax.random.PRNGKey(1)),
                                  wmode, act=act)
    if fused:
        jparams = jax_fuse_projections(jparams)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    assert ("wqkv" in params["layers"][0]) == fused
    kw = dict(SERVE, mode=kv_mode, **OPTIONS[option])
    servers = [JaxGenerationServer(jparams, jcfg, **kw),
               GenerationServer(params, cfg, device="cpu", **kw)]
    want, got = _serve(servers, PROMPTS, {sid: 9 for sid in PROMPTS})
    assert got == want
    assert all(len(toks) == 9 for toks in got.values())
    stats = servers[1].stats()
    if "chunk" in OPTIONS[option]:
        assert stats["decode_loops"] > 0 and stats["decode_steps"] > stats["steps"] - 3
    assert stats["prefill_tokens"] == sum(map(len, PROMPTS.values()))


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, jax.random.PRNGKey(0))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_bf16_server_options_match_jax_forward(jax_params, option):
    """bf16: every served token within 0.05 of the JAX forward's row max."""
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    server = GenerationServer(params, CFG, device="cpu", **SERVE, **OPTIONS[option])
    got = _serve([server], PROMPTS, {sid: 9 for sid in PROMPTS})[0]
    for sid, prompt in PROMPTS.items():
        assert len(got[sid]) == 9
        seq = prompt + got[sid][:-1]
        toks = np.zeros((1, 384), np.int32)
        toks[0, :len(seq)] = seq
        logits = np.asarray(jax_forward(jax_params, jnp.asarray(toks), JCFG)[0])
        for i, tok in enumerate(got[sid]):
            row = logits[len(prompt) - 1 + i]
            assert row.max() - row[tok] <= SLACK, (sid, i, tok, row.argmax())


def _fp32_models(seed):
    jcfg = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    cfg = LlamaConfig(**SHAPE, dtype=DType.FP32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, jcfg, params_from_jax(jax.device_get(jparams), device="cpu"), cfg


def test_stop_token_inside_a_chunk():
    """A stop token at the fourth token of an 8-token chunk, on the fp32
    model: the port's server with chunk 8 serves the JAX server's tokens
    with chunk 8 (through the stop, the rest dropped) and frees the same
    pages (``tests/test_generate.py::test_stop_tokens_in_chunked_decode``)."""
    jparams, jcfg, params, cfg = _fp32_models(4)
    kw = dict(num_pages=32, page_size=64, max_batch=1, pages_per_seq=8)
    probe = JaxGenerationServer(jparams, jcfg, **kw)
    probe.submit(1, PROMPTS[1], 8)
    full = probe.run()[1]
    stop = full[3]
    servers = [JaxGenerationServer(jparams, jcfg, chunk=8, **kw),
               GenerationServer(params, cfg, device="cpu", chunk=8, **kw)]
    want, got = _serve(servers, {1: PROMPTS[1]}, {1: 8}, stop={1: [stop]})
    assert got == want
    assert got[1] == full[:full.index(stop) + 1] and len(got[1]) < 8, (got, full)
    assert servers[1].stats()["decode_loops"] >= 1
    assert servers[1].engine.free_pages == servers[0].engine.free_pages == 31


def test_uneven_budgets_shorten_the_chunk():
    """Budgets 3, 9 and 1 with chunk 8: each request gets exactly its
    budget, and the tokens are the JAX server's with chunk 8
    (``tests/test_generate.py::test_chunked_uneven_budgets``)."""
    jparams, jcfg, params, cfg = _fp32_models(4)
    kw = dict(num_pages=32, page_size=64, max_batch=3, pages_per_seq=8, chunk=8)
    servers = [JaxGenerationServer(jparams, jcfg, **kw),
               GenerationServer(params, cfg, device="cpu", **kw)]
    prompts = {1: list(range(10, 30)), 2: list(range(40, 45)), 3: list(range(7, 20))}
    want, got = _serve(servers, prompts, {1: 3, 2: 9, 3: 1})
    assert [len(got[s]) for s in (1, 2, 3)] == [3, 9, 1], got
    assert got == want
    assert servers[1].engine.free_pages == 31


@pytest.mark.parametrize("kw", [dict(prefill_chunk_tokens=100),
                                dict(prefill_chunk_tokens=128, page_size=256),
                                dict(chunk=4, spec_k=2)],
                         ids=["not_128", "not_page", "spec_k"])
def test_options_refuse_what_jax_refuses(kw):
    kw = dict(dict(num_pages=8, page_size=64, max_batch=2), **kw)
    with pytest.raises(ValueError):
        JaxGenerationServer({"embed": jnp.zeros((4, 4))}, JCFG, **kw)
    with pytest.raises(ValueError):
        GenerationServer({"embed": torch.zeros((4, 4))}, CFG, device="cpu", **kw)


def test_chunked_prefill_refuses_a_mesh():
    """As the JAX server does (its check follows its mesh set-up, which
    needs a real mesh): chunked prefill is single-chip."""
    with pytest.raises(ValueError, match="single-chip"):
        GenerationServer({"embed": torch.zeros((4, 4))}, CFG, num_pages=8,
                         page_size=64, max_batch=2, prefill_chunk_tokens=128,
                         mesh=object(), device="cpu")
