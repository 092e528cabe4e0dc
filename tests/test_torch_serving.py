"""The port's scheduler binding and GenerationServer vs the JAX package.

The scheduler is the same C++ source built twice, once per package: for the
same request stream both bindings must produce identical batches, finished
ids and counters, preemption included. The server runs on the CPU (plain
kernel versions) in bf16 with the JAX parameters, and every served token is
teacher-forced through the JAX ``forward``: its logit must lie within 0.05
of the row max (tests/test_generate.py's rule; random-model bf16 logits tie
within an ulp, so exact argmax equality is too strict). Quantized serving
(int8 weights with an int8 cache; W4A8 weights with an int4 cache) runs
both servers on the same quantized fp32 model, where logits do not tie, and
the served tokens must be equal; so does int8-compute attention
(``attn_int8``), against the JAX server on its per-page kernel (K5), whose
rounding of P the port's plain version follows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, forward as jax_forward,
    init_params as jax_init_params,
)
from flash_attention_from_scratch_tpu.models.llama import (
    quantize_params as jax_quantize_params,
)
import flash_attention_from_scratch_tpu.ops.paged_attention as jax_pa
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.serving.generate import (
    GenerationServer as JaxGenerationServer,
)
from flash_attention_from_scratch_tpu.serving.runtime import (
    PagedEngine as JaxPagedEngine,
)
from flash_attention_from_scratch_tpu_torch.models.llama import (
    LlamaConfig, params_from_jax,
)
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
    QuantizedWeight,
)
from flash_attention_from_scratch_tpu_torch.serving.generate import (
    GenerationServer,
)
from flash_attention_from_scratch_tpu_torch.serving.runtime import PagedEngine

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=256)
JCFG = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128)
CFG = LlamaConfig(**SHAPE)
PROMPTS = {1: list(range(10, 30)), 2: list(range(40, 45)), 3: list(range(7, 40))}
SLACK = 0.05

# (engine args, requests (id, prompt_len, max_new), early finishes {step:
# id}, speculative steps {step: n}: grow_batch(n), then commit_n of a
# different count per sequence in place of commit)
STREAMS = {
    "preemption": ((6, 4, 4), [(1, 4, 12), (2, 4, 12)], {}, {}),
    "admission": ((8, 16, 8), [(i, 17, 8) for i in range(5)], {}, {}),
    "early_finish": ((32, 8, 4), [(10, 30, 6), (11, 9, 6), (12, 3, 2)], {2: 10}, {}),
    "speculative": ((9, 4, 4), [(1, 5, 14), (2, 9, 14), (3, 3, 9)], {},
                    {1: 3, 2: 2, 3: 3, 5: 3, 6: 3, 8: 2}),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_engine_matches_jax_engine(name):
    args, requests, finishes, spec = STREAMS[name]
    grown = []
    engines = [PagedEngine(*args), JaxPagedEngine(*args)]
    for eng in engines:
        for req in requests:
            eng.add_request(*req)
    for step in range(200):
        got, want = (eng.step() for eng in engines)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        np.testing.assert_array_equal(got.page_tables, want.page_tables)
        if step in finishes:
            for eng in engines:
                eng.finish(finishes[step])
        if step in spec:
            ok = [eng.grow_batch(spec[step]) for eng in engines]
            assert ok[0] == ok[1]
            grown.append(ok[0])
            if ok[0]:
                for sid in got.ids.tolist():
                    n = 1 + (sid + step) % (spec[step] + 1)
                    assert engines[0].commit_n(sid, n) == engines[1].commit_n(sid, n)
                continue
        assert engines[0].commit() == engines[1].commit()
        for attr in ("running", "waiting", "free_pages", "preempt_count"):
            assert getattr(engines[0], attr) == getattr(engines[1], attr), attr
        if len(got.ids) == 0 and engines[0].waiting == 0:
            break
    if name == "preemption":
        assert engines[0].preempt_count >= 1
    if name == "speculative":  # grow_batch both granted and refused
        assert True in grown and False in grown, grown
    assert engines[0].free_pages == args[0]


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(JCFG, jax.random.PRNGKey(0))


def test_server_matches_jax_forward(jax_params):
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    server = GenerationServer(params, CFG, num_pages=32, page_size=64,
                              max_batch=4, pages_per_seq=8, device="cpu")
    n_new = 4
    for sid, prompt in PROMPTS.items():
        server.submit(sid, prompt, n_new)
    got = server.run()
    stats = server.stats()
    assert stats["decode_tokens"] == len(PROMPTS) * (n_new - 1)
    assert stats["prefill_tokens"] == sum(map(len, PROMPTS.values()))
    assert stats["running"] == stats["waiting"] == 0
    for sid, prompt in PROMPTS.items():
        assert len(got[sid]) == n_new, (sid, got[sid])
        # Causal: one forward over prompt + generated[:-1] scores every step.
        toks = np.zeros((1, 128), np.int32)
        seq = prompt + got[sid][:-1]
        toks[0, :len(seq)] = seq
        logits = np.asarray(jax_forward(jax_params, jnp.asarray(toks), JCFG)[0])
        for i, tok in enumerate(got[sid]):
            row = logits[len(prompt) - 1 + i]
            assert row.max() - row[tok] <= SLACK, (sid, i, tok, row.argmax())


def test_server_stop_token(jax_params):
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    server = GenerationServer(params, CFG, num_pages=32, page_size=64,
                              max_batch=4, pages_per_seq=8, device="cpu")
    server.submit(1, PROMPTS[1], 4)
    first = server.run()[1]
    server.submit(2, PROMPTS[1], 4, stop=(first[1],))
    assert server.run()[2] == first[:2]
    assert server.engine.free_pages == 31


@pytest.mark.parametrize("wmode,act,kv_mode", [("int8", "bf16", "int8"),
                                               ("int4", "int8", "int4")],
                         ids=["int8-weights-int8-cache", "W4A8-int4-cache"])
def test_quantized_server_matches_jax_server(wmode, act, kv_mode):
    """Both servers on the same quantized fp32 model (the JAX package's
    ``quantize_params``, carried over by ``params_from_jax``) give the same
    greedy tokens for every request."""
    jcfg = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    cfg = LlamaConfig(**SHAPE, dtype=DType.FP32)
    jparams = jax_quantize_params(jax_init_params(jcfg, jax.random.PRNGKey(1)),
                                  wmode, act=act)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    assert isinstance(params["layers"][0]["w_up"], QuantizedWeight)
    kw = dict(num_pages=32, page_size=64, max_batch=4, pages_per_seq=8,
              mode=kv_mode, seed=3)  # seed: accepted, greedy ignores it
    servers = [JaxGenerationServer(jparams, jcfg, **kw),
               GenerationServer(params, cfg, device="cpu", **kw)]
    for server in servers:
        for sid, prompt in PROMPTS.items():
            server.submit(sid, prompt, 5)
    want, got = (server.run() for server in servers)
    assert got == want
    assert servers[1].cache.mode == kv_mode
    assert all(len(toks) == 5 for toks in got.values())


def test_attn_int8_server_matches_jax_server(monkeypatch):
    """int8-compute attention (int8 weights, int8 cache, fp32 model): the
    port's tokens equal the JAX server's on K5 (``_FULL_VARIANT_VMEM_CAP``
    0, its per-page rounding of P), and every token lies within 0.5 of the
    JAX ``forward``'s row max (tests/test_generate.py's attn_int8 slack)."""
    jcfg = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    cfg = LlamaConfig(**SHAPE, dtype=DType.FP32)
    jparams = jax_quantize_params(jax_init_params(jcfg, jax.random.PRNGKey(2)), "int8")
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    kw = dict(num_pages=32, page_size=64, max_batch=2, pages_per_seq=8, mode="int8",
              attn_int8=True)
    prompts = {1: PROMPTS[1], 2: PROMPTS[2]}
    monkeypatch.setattr(jax_pa, "_FULL_VARIANT_VMEM_CAP", 0)
    jax_pa._build_decode_call.cache_clear()
    jax.clear_caches()
    try:
        servers = [JaxGenerationServer(jparams, jcfg, **kw),
                   GenerationServer(params, cfg, device="cpu", **kw)]
        for server in servers:
            for sid, prompt in prompts.items():
                server.submit(sid, prompt, 5)
        want, got = (server.run() for server in servers)
    finally:
        jax_pa._build_decode_call.cache_clear()
        jax.clear_caches()
    assert got == want
    for sid, prompt in prompts.items():
        toks = np.zeros((1, 128), np.int32)
        seq = prompt + got[sid][:-1]
        toks[0, :len(seq)] = seq
        logits = np.asarray(jax_forward(jparams, jnp.asarray(toks), jcfg)[0])
        for i, tok in enumerate(got[sid]):
            row = logits[len(prompt) - 1 + i]
            assert row.max() - row[tok] <= 0.5, (sid, i, tok, row.argmax())


@pytest.mark.parametrize("mode", ["dense", "fp8", "int4"])
def test_attn_int8_needs_an_int8_cache(mode):
    with pytest.raises(ValueError, match="attn_int8"):
        GenerationServer({"embed": torch.zeros((4, 4))}, CFG, num_pages=8,
                         page_size=64, max_batch=2, mode=mode, attn_int8=True,
                         device="cpu")


@pytest.mark.parametrize("option", [
    dict(temperature=0.7), dict(prefix_cache=True), dict(lora={}),
    dict(mesh=object()), dict(top_k=5)])
def test_server_unported_options_raise(jax_params, option):
    """``mesh`` with MoE params is not ported (expert parallelism) and
    raises; tensor-parallel serving itself is tested against the JAX
    package in ``tests/test_torch_sharded_decode.py``. ``temperature``,
    ``prefix_cache``, ``top_k`` and ``lora`` (here two adapters of zero B,
    every request on the base model) are: each serves every request all its
    tokens, in-vocabulary."""
    if "lora" in option:
        from flash_attention_from_scratch_tpu_torch.models.lora import init_lora_adapters

        option = dict(lora=init_lora_adapters(CFG, 2, 4, torch.Generator().manual_seed(0),
                                              device="cpu"))
    if "mesh" in option:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            GenerationServer({"embed": torch.zeros((4, 4)), "layers": [{"experts": {}}]},
                             CFG, num_pages=8, page_size=64, max_batch=2, device="cpu",
                             **option)
        return
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    server = GenerationServer(params, CFG, num_pages=32, page_size=64, max_batch=4,
                              pages_per_seq=8, device="cpu", **option)
    for sid, prompt in PROMPTS.items():
        server.submit(sid, prompt, 6)
    got = server.run()
    assert {sid: len(t) for sid, t in got.items()} == {sid: 6 for sid in PROMPTS}
    assert all(0 <= tok < SHAPE["vocab_size"] for t in got.values() for tok in t)


@pytest.mark.parametrize("option", [dict(chunk=4), dict(prefill_chunk_tokens=128)],
                         ids=["chunk", "prefill_chunk_tokens"])
def test_server_ported_options_serve(jax_params, option):
    """``chunk`` and ``prefill_chunk_tokens`` now serve: every request gets
    its tokens, as many as without the option."""
    params = params_from_jax(jax.device_get(jax_params), device="cpu")
    kw = dict(num_pages=32, page_size=64, max_batch=4, pages_per_seq=8, device="cpu")
    servers = [GenerationServer(params, CFG, **kw),
               GenerationServer(params, CFG, **kw, **option)]
    for server in servers:
        for sid, prompt in PROMPTS.items():
            server.submit(sid, prompt, 6)
    plain, got = (server.run() for server in servers)
    assert {sid: len(t) for sid, t in got.items()} == {sid: 6 for sid in PROMPTS}
    assert servers[1].stats()["decode_tokens"] == servers[0].stats()["decode_tokens"]


def test_server_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationServer({"embed": torch.zeros((4, 4))}, CFG, num_pages=8,
                         page_size=64, max_batch=2)
