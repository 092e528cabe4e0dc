"""Chunked prefill and the greedy decode loop vs the JAX package, on the CPU.

``prefill_chunked`` (128-token chunks over a paged cache; the JAX side in
interpret mode, as ``tests/test_chunked_prefill.py`` runs it) on an fp32
model: the logits within 1e-4 of the JAX package's. With the projections
and RoPE replaced by fixed rows on both sides (each call of ``_qkv`` its
own seeded rows, later chunks' four times larger, so that they round with
chunk 0's scale and saturate), every page byte and scale is equal in the
dense, int8 and int4 caches: a real model's rows differ between the two
packages in their last bits, which flips a rounding now and then. Prompt
lengths end mid-chunk (300) and on a chunk edge (384).

``decode_loop`` (greedy) gives the JAX ``decode_loop``'s tokens on an fp32
model, and exactly the port's own ``decode_step`` run four times, pages
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import decode as jax_decode
from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu_torch.models import decode, llama
from flash_attention_from_scratch_tpu_torch.ops.configs import DType

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=256)
JCFG = jax_llama.LlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
CFG = llama.LlamaConfig(**SHAPE, dtype=DType.FP32)
PAGE, PAGES = 64, 8
TABLE = np.arange(6, dtype=np.int32)
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jparams = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, llama.params_from_jax(jax.device_get(jparams), device="cpu")


def _prompt(prompt_len, pad_to=384):
    arr = np.zeros((1, pad_to), np.int32)
    arr[0, :prompt_len] = (np.arange(prompt_len) * 7 + 3) % 256
    return arr


def _both_chunked(models, mode, prompt_len, jcfg=JCFG, cfg=CFG):
    jparams, params = models
    toks = _prompt(prompt_len)
    want, jcache = jax_decode.prefill_chunked(
        jparams, jnp.asarray(toks), jcfg, jax_decode.init_cache(jcfg, PAGES, PAGE, mode),
        jnp.asarray(TABLE), prompt_len=prompt_len, chunk_tokens=128)
    got, cache = decode.prefill_chunked(
        params, torch.from_numpy(toks).long(), cfg,
        decode.init_cache(cfg, PAGES, PAGE, mode, device="cpu"),
        torch.from_numpy(TABLE), prompt_len=prompt_len, chunk_tokens=128)
    return np.asarray(want), jcache, got, cache


@pytest.mark.parametrize("prompt_len", [300, 384])
def test_prefill_chunked_matches_jax(models, prompt_len):
    """A dense cache: logits and every page within 1e-4 of the JAX
    package's, and the logits those of the port's one-shot prefill."""
    want, jcache, got, cache = _both_chunked(models, "dense", prompt_len)
    assert got.shape == (SHAPE["vocab_size"],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    for li in range(SHAPE["n_layers"]):
        for pool, jpool in ((cache.k_pages[li], jcache.k_pages[li]),
                            (cache.v_pages[li], jcache.v_pages[li])):
            np.testing.assert_allclose(pool.numpy(), np.asarray(jpool), atol=LOGIT_ATOL,
                                       rtol=0)
    one_shot, _ = decode.prefill(
        models[1], torch.from_numpy(_prompt(prompt_len)).long(), CFG,
        decode.init_cache(CFG, PAGES, PAGE, device="cpu"), torch.from_numpy(TABLE),
        prompt_len=prompt_len)
    torch.testing.assert_close(got, one_shot, atol=LOGIT_ATOL, rtol=0)


# Fixed rows: a SHAPE of its own, so no earlier trace of the JAX chunk
# function (its trace calls _qkv) is reused.
FIXED_SHAPE = dict(SHAPE, vocab_size=264)
FIXED_JCFG = jax_llama.LlamaConfig(**FIXED_SHAPE, block_q=128, block_kv=128,
                                   dtype=JaxDType.FP32)
FIXED_CFG = llama.LlamaConfig(**FIXED_SHAPE, dtype=DType.FP32)


def _fixed_qkv():
    """_qkv replaced by seeded rows, one set per call in call order (the JAX
    chunk function is traced once per chunk, layer by layer, as the port
    runs); chunks after the first (calls >= n_layers) four times larger."""
    calls = {"n": 0}
    q_dim = FIXED_SHAPE["n_heads"] * FIXED_SHAPE["d_head"]
    kv_dim = FIXED_SHAPE["n_kv_heads"] * FIXED_SHAPE["d_head"]

    def qkv(layer, h, cfg=None):
        i = calls["n"]
        calls["n"] += 1
        rng = np.random.default_rng(100 + i)
        scale = 1.0 if i < FIXED_SHAPE["n_layers"] else 4.0
        rows = [(rng.standard_normal((*h.shape[:2], n)) * scale).astype(np.float32)
                for n in (q_dim, kv_dim, kv_dim)]
        if isinstance(h, torch.Tensor):
            return tuple(torch.from_numpy(a) for a in rows)
        return tuple(jnp.asarray(a) for a in rows)

    return qkv, calls


def _bytes(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("prompt_len", [300, 384])
@pytest.mark.parametrize("mode", ["dense", "int8", "int4"])
def test_prefill_chunked_pages_match_jax_bytes(mode, prompt_len, monkeypatch):
    """The same K/V rows on both sides: every page byte and scale equal
    (dense: the rows themselves), and the logits within 1e-4."""
    jqkv, jcalls = _fixed_qkv()
    qkv, calls = _fixed_qkv()
    monkeypatch.setattr(jax_decode, "_qkv", jqkv)
    monkeypatch.setattr(jax_decode, "apply_rope", lambda x, cos, sin: x)
    monkeypatch.setattr(decode, "_qkv", qkv)
    monkeypatch.setattr(decode, "apply_rope", lambda x, cos, sin: x)
    jax.clear_caches()  # each chunk traced anew, its _qkv calls in order
    jparams = jax_llama.init_params(FIXED_JCFG, jax.random.PRNGKey(3))
    params = llama.params_from_jax(jax.device_get(jparams), device="cpu")
    try:
        want, jcache, got, cache = _both_chunked((jparams, params), mode, prompt_len,
                                                 FIXED_JCFG, FIXED_CFG)
    finally:
        jax.clear_caches()
    chunks = -(-prompt_len // 128)
    assert calls["n"] == jcalls["n"] == chunks * FIXED_SHAPE["n_layers"]
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    for li in range(FIXED_SHAPE["n_layers"]):
        pairs = [(cache.k_pages[li], jcache.k_pages[li]),
                 (cache.v_pages[li], jcache.v_pages[li])]
        if mode != "dense":
            pairs += [(cache.k_scales[li], jcache.k_scales[li]),
                      (cache.v_scales[li], jcache.v_scales[li])]
        for a, b in pairs:
            np.testing.assert_array_equal(_bytes(a), _bytes(b))


@pytest.mark.parametrize("kw,match", [
    (dict(chunk_tokens=96), "multiple of 128"),
    (dict(chunk_tokens=128, page=256), "page_size"),
    (dict(chunk_tokens=128, start_tokens=64), "start_tokens"),
    (dict(chunk_tokens=128, start_tokens=384), "leave at least"),
], ids=["not_128", "not_page", "start_not_chunk", "start_past_prompt"])
def test_prefill_chunked_refuses_what_jax_refuses(models, kw, match):
    jparams, params = models
    kw = dict(kw)
    page = kw.pop("page", PAGE)
    toks = _prompt(300)
    with pytest.raises(ValueError, match=match):
        jax_decode.prefill_chunked(
            jparams, jnp.asarray(toks), JCFG, jax_decode.init_cache(JCFG, 4, page),
            jnp.asarray(TABLE), prompt_len=300, **kw)
    with pytest.raises(ValueError, match=match):
        decode.prefill_chunked(
            params, torch.from_numpy(toks).long(), CFG,
            decode.init_cache(CFG, 4, page, device="cpu"), torch.from_numpy(TABLE),
            prompt_len=300, **kw)


STEPS = 4
LOOP_PROMPTS = (list(range(16, 48)), list(range(70, 81)))
LOOP_TABLES = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)


def test_decode_loop_matches_jax_and_decode_steps(models):
    """Two prompts prefilled in both packages, then ``decode_loop(steps=4)``:
    the JAX loop's tokens and lengths, and exactly four port decode steps
    (tokens and every page)."""
    jparams, params = models
    jcache = jax_decode.init_cache(JCFG, 8, PAGE)
    cache = decode.init_cache(CFG, 8, PAGE, device="cpu")
    first, jfirst = [], []
    for row, prompt in enumerate(LOOP_PROMPTS):
        padded = np.zeros(128, np.int32)
        padded[:len(prompt)] = prompt
        jlogits, jcache = jax_decode.prefill(
            jparams, jnp.asarray(padded)[None], JCFG, jcache,
            jnp.asarray(LOOP_TABLES[row]), prompt_len=len(prompt))
        logits, cache = decode.prefill(
            params, torch.from_numpy(padded).long()[None], CFG, cache,
            torch.from_numpy(LOOP_TABLES[row]), prompt_len=len(prompt))
        jfirst.append(int(jnp.argmax(jlogits)))
        first.append(int(torch.argmax(logits)))
    assert first == jfirst
    lengths = np.array([len(p) for p in LOOP_PROMPTS], np.int32)
    jout, _, jlens = jax_decode.decode_loop(
        jparams, jnp.asarray(jfirst, jnp.int32), JCFG, jcache, jnp.asarray(lengths),
        jnp.asarray(LOOP_TABLES), STEPS)
    stepped = decode.PagedKVCache([p.clone() for p in cache.k_pages],
                                  [p.clone() for p in cache.v_pages], [], [])
    out, cache, lens = decode.decode_loop(
        params, torch.tensor(first), CFG, cache, torch.from_numpy(lengths),
        torch.from_numpy(LOOP_TABLES), STEPS)
    assert out.shape == (2, STEPS)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    toks, lens = torch.tensor(first), torch.from_numpy(lengths)
    for i in range(STEPS):
        lens = lens + 1
        logits, stepped = decode.decode_step(params, toks, CFG, stepped, lens,
                                             torch.from_numpy(LOOP_TABLES))
        toks = torch.argmax(logits, -1)
        assert torch.equal(toks, out[:, i])
    for a, b in zip(cache.k_pages + cache.v_pages, stepped.k_pages + stepped.v_pages):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(temperature=0.8), dict(temperature=0.8, top_k=5),
                                dict(temperature=1.3)],
                         ids=["temperature", "top_k", "row_keys"])
def test_decode_loop_sampling_is_not_ported(models, kw):
    """Sampling in ``decode_loop`` (``temperature``, ``top_k``, keyed by
    ``row_keys`` and ``pos0``), once refused, now samples: the loop's
    tokens are those of ``steps`` single decode steps each picking by
    ``sample_token`` on the Gumbels of (row key, pos0 + i), pages included;
    and they are not the greedy loop's."""
    params = models[1]
    keys = decode.row_keys(7, torch.tensor([3, 11]))
    pos0 = torch.tensor([0, 5])
    first, lengths = torch.tensor([5, 9]), torch.tensor([20, 9], dtype=torch.int32)
    tables = torch.from_numpy(LOOP_TABLES)
    caches = [decode.init_cache(CFG, 8, PAGE, device="cpu") for _ in range(3)]
    out, _, lens = decode.decode_loop(params, first, CFG, caches[0], lengths, tables,
                                      STEPS, row_keys=keys, pos0=pos0, **kw)
    greedy, _, _ = decode.decode_loop(params, first, CFG, caches[2], lengths, tables,
                                      STEPS)
    toks, lens_s = first, lengths
    for i in range(STEPS):
        lens_s = lens_s + 1
        logits, _ = decode.decode_step(params, toks, CFG, caches[1], lens_s, tables)
        _, gumbel = decode.sample_noise(keys, pos0 + i, 0, CFG.vocab_size)
        toks = decode.sample_token(logits, gumbel, kw["temperature"], kw.get("top_k", 0))
        assert torch.equal(toks, out[:, i]), i
    assert torch.equal(lens, lens_s)
    for a, b in zip(caches[0].k_pages + caches[0].v_pages,
                    caches[1].k_pages + caches[1].v_pages):
        assert torch.equal(a, b)
    assert not torch.equal(out, greedy)
    with pytest.raises(ValueError, match="pos0"):
        decode.decode_loop(params, first, CFG, caches[0], lengths, tables, STEPS,
                           row_keys=keys, **kw)
