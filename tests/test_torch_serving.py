"""The port's scheduler binding and GenerationServer vs the JAX package.

The scheduler is the same C++ source built twice, once per package: for the
same request stream both bindings must produce identical batches, finished
ids and counters, preemption included. The server runs on the CPU (plain
kernel versions) in bf16 with the JAX parameters, and every served token is
teacher-forced through the JAX ``forward``: its logit must lie within 0.05
of the row max (tests/test_generate.py's rule; random-model bf16 logits tie
within an ulp, so exact argmax equality is too strict).
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
from flash_attention_from_scratch_tpu.serving.runtime import (
    PagedEngine as JaxPagedEngine,
)
from flash_attention_from_scratch_tpu_torch.models.llama import (
    LlamaConfig, params_from_jax,
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

# (engine args, requests (id, prompt_len, max_new), early finishes {step: id})
STREAMS = {
    "preemption": ((6, 4, 4), [(1, 4, 12), (2, 4, 12)], {}),
    "admission": ((8, 16, 8), [(i, 17, 8) for i in range(5)], {}),
    "early_finish": ((32, 8, 4), [(10, 30, 6), (11, 9, 6), (12, 3, 2)], {2: 10}),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_engine_matches_jax_engine(name):
    args, requests, finishes = STREAMS[name]
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
        assert engines[0].commit() == engines[1].commit()
        for attr in ("running", "waiting", "free_pages", "preempt_count"):
            assert getattr(engines[0], attr) == getattr(engines[1], attr), attr
        if len(got.ids) == 0 and engines[0].waiting == 0:
            break
    if name == "preemption":
        assert engines[0].preempt_count >= 1
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


@pytest.mark.parametrize("option", [
    dict(temperature=0.7), dict(chunk=4), dict(spec_k=2),
    dict(prefix_cache=True), dict(prefill_chunk_tokens=128), dict(lora={}),
    dict(mesh=object()), dict(attn_int8=True), dict(mode="int8")])
def test_server_unported_options_raise(option):
    params = {"embed": torch.zeros((4, 4))}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GenerationServer(params, CFG, num_pages=8, page_size=64, max_batch=2,
                         device="cpu", **option)


def test_server_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationServer({"embed": torch.zeros((4, 4))}, CFG, num_pages=8,
                         page_size=64, max_batch=2)
