"""The port's prefix cache vs the JAX package's, on the CPU.

The two packages bind the same C++ scheduler (``csrc/paged_runtime.cpp``),
so driven through the same claims, publishes, finishes and evictions the
port's ``PagedEngine`` must report the JAX one's cached pages, hits, LRU
pages and free pages at every step; ``_page_hashes`` must give the JAX
hashes. A prefix-cached server (its suffix prefill through
``prefill_chunked(start_tokens=)``) on an fp32 model serves the JAX
prefix-cached server's greedy tokens and hit count, and the tokens of the
port's server without the cache.
"""

import jax
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.serving.generate import (
    GenerationServer as JaxGenerationServer, _page_hashes as jax_page_hashes,
)
from flash_attention_from_scratch_tpu.serving.runtime import PagedEngine as JaxPagedEngine
from flash_attention_from_scratch_tpu_torch.models import llama
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.serving.generate import (
    GenerationServer, _page_hashes,
)
from flash_attention_from_scratch_tpu_torch.serving.runtime import PagedEngine

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=256)
JCFG = jax_llama.LlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
CFG = llama.LlamaConfig(**SHAPE, dtype=DType.FP32)


@pytest.mark.parametrize("page_size", [16, 64, 128])
def test_page_hashes_match_jax(page_size):
    rng = np.random.default_rng(page_size)
    for n in (0, page_size - 1, page_size, 3 * page_size + 5):
        prompt = rng.integers(0, 128256, n).tolist()
        assert _page_hashes(prompt, page_size) == jax_page_hashes(prompt, page_size)
        assert len(_page_hashes(prompt, page_size)) == n // page_size
    a = list(range(200))
    b = a[:64] + [7] + a[65:]  # differs in page 1: pages 1.. hash apart
    ha, hb = _page_hashes(a, 64), _page_hashes(b, 64)
    assert ha[0] == hb[0] and ha[1] != hb[1] and ha[2] != hb[2]


def _observe(engine, ids):
    return (engine.prefix_hits, engine.lru_pages, engine.free_pages,
            engine.running, engine.waiting,
            tuple(engine.cached_pages(i) for i in ids))


def test_engine_prefix_calls_match_jax_engine():
    """Claim, publish, refcounted sharing, retirement to the LRU, reuse
    from it and eviction by a large uncached request (the sequence of
    ``tests/test_prefix_cache.py``): the same observations after every
    call, in both bindings."""
    engines = [JaxPagedEngine(8, 64, 4, max_pages_per_seq=4),
               PagedEngine(8, 64, 4, max_pages_per_seq=4)]
    h = _page_hashes(list(range(128)), 64)  # two full pages
    script = [
        ("add", 1), ("step",), ("publish", 1), ("add", 2), ("step",),
        ("finish", 1), ("step",), ("step",), ("finish", 2), ("add", 3), ("step",),
        ("finish", 3), ("big", 4), ("step",), ("finish", 4), ("add", 5), ("step",),
        ("commit",), ("step",), ("publish", 5), ("finish", 5),
    ]
    live = []
    seen = []
    for op in script:
        per_engine = []
        for eng in engines:
            if op[0] == "add":
                eng.add_request_cached(op[1], 130, 4, h)
            elif op[0] == "big":
                eng.add_request(op[1], 250, 2)
            elif op[0] == "step":
                b = eng.step()
                per_engine.append(b.ids.tolist())
            elif op[0] == "publish":
                eng.publish(op[1])
            elif op[0] == "finish":
                eng.finish(op[1])
            elif op[0] == "commit":
                per_engine.append(eng.commit())
        if op[0] == "add":
            live.append(op[1])
        elif op[0] == "finish" and op[1] in live:
            live.remove(op[1])
        obs = [_observe(eng, live) for eng in engines]
        assert obs[0] == obs[1], op
        if per_engine:
            assert per_engine[0] == per_engine[1], op
        seen.append(obs[1])
    hits = [o[0] for o in seen]
    assert hits[-1] >= 4 and max(o[1] for o in seen) > 0  # claims, and a retired LRU


def test_engine_prefix_errors():
    eng = PagedEngine(8, 64, 4, max_pages_per_seq=4)
    eng.add_request_cached(1, 130, 4, _page_hashes(list(range(130)), 64))
    with pytest.raises(ValueError, match="rejected"):
        eng.add_request_cached(1, 130, 4, [])
    for call in (eng.cached_pages, eng.publish):
        with pytest.raises(KeyError):
            call(99)


def test_prefix_cache_with_mesh_raises():
    with pytest.raises(ValueError, match="prefix_cache"):
        GenerationServer({"embed": torch.zeros((4, 4))}, CFG, num_pages=8, page_size=64,
                         max_batch=2, prefix_cache=True, mesh=object(), device="cpu")


SHARED = np.random.default_rng(0).integers(1, 256, 192).tolist()  # 3 pages of 64
TAILS = {1: 20, 2: 70, 3: 1}


def test_prefix_server_matches_jax_server():
    """A publisher, then three prompts sharing its first 192 tokens (with a
    1-token tail the suffix prefill starts inside the cached pages, at the
    chunk edge 128, so the last prompt token is computed): the port's
    prefix-cached server gives the JAX one's greedy tokens and hit pages
    (3 a request), and the tokens of the port's server without the cache."""
    jparams = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
    params = llama.params_from_jax(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(1)
    prompts = {sid: SHARED + rng.integers(1, 256, n).tolist() for sid, n in TAILS.items()}
    publisher = SHARED + [5, 6, 7]
    kw = dict(num_pages=40, page_size=64, max_batch=3, pages_per_seq=8)
    servers = [JaxGenerationServer(jparams, JCFG, prefix_cache=True, **kw),
               GenerationServer(params, CFG, prefix_cache=True, device="cpu", **kw),
               GenerationServer(params, CFG, device="cpu", **kw)]
    runs, hits = [], []
    for server in servers:
        server.submit(0, publisher, 3)
        server.run()  # admits, prefills and publishes before the others arrive
        for sid, prompt in prompts.items():
            server.submit(sid, prompt, 5)
        runs.append(server.run())
        hits.append(server.stats()["prefix_hit_pages"])
    assert runs[1] == runs[0] == runs[2]
    assert hits == [3 * len(TAILS), 3 * len(TAILS), 0]
