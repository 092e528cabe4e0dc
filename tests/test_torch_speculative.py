"""The port's speculative decoding vs the JAX package.

Prompt-lookup drafts, ``verify_step`` (t tokens per sequence in one pass),
greedy ``spec_accept_sample`` and ``GenerationServer(spec_k=...)``. The model
comparisons run in fp32 on the JAX parameters (``params_from_jax``), where
the two sides differ only in summation order: logits within 1e-3 of the
logit scale (tests/test_torch_llama.py's rule). ``verify_step`` starts
from a copy of the JAX side's prefilled cache, so the pages it writes can
be compared: quantized pages and scales byte for byte (the rows round fp32
values that agree to a few ulps, and none of these seeded rows sits on a
rounding boundary), dense fp32 pages within 1e-4 (values of order 1). Servers on a quantized
fp32 model, where logits do not tie, must serve equal tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import decode as jax_decode
from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.serving import generate as jax_generate
from flash_attention_from_scratch_tpu_torch.models import decode, llama
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.serving import generate

GEN = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
           d_head=128, hidden_dim=256)
REPEAT = [10, 11, 12, 13] * 6  # prompt lookup finds drafts in it


def _configs(dtype="FP32", **extra):
    jcfg = jax_llama.LlamaConfig(**GEN, block_q=128, block_kv=128,
                                 dtype=getattr(JaxDType, dtype), **extra)
    return jcfg, llama.LlamaConfig(**GEN, dtype=getattr(DType, dtype), **extra)


def _close(got, want, rel=1e-3):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def test_prompt_lookup_draft_matches_jax():
    """The JAX test's cases (tests/test_speculative.py), then seeded random
    contexts over a small vocabulary, so n-grams recur."""
    draft = generate._prompt_lookup_draft
    assert draft([1, 2, 3, 4, 9, 9, 1, 2], 3) == [3, 4, 9]
    assert draft([5, 6, 7], 3) == []
    assert draft([1, 2], 3) == []
    assert draft([7, 8, 9, 7, 8], 5) == [9, 7, 8]
    rng = np.random.default_rng(0)
    for _ in range(200):
        ctx = rng.integers(0, 5, int(rng.integers(0, 30))).tolist()
        k, ngram = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        assert draft(ctx, k, ngram) == jax_generate._prompt_lookup_draft(ctx, k, ngram)


def _prefilled(jcfg, jparams, mode, ps, num_pages, tables, prompt_lens, rng):
    """The JAX side's cache with each prompt prefilled into its pages, and
    the port's copy of it."""
    jcache = jax_decode.init_cache(jcfg, num_pages, ps, mode)
    for row, n in enumerate(prompt_lens):
        toks = np.zeros((1, 128), np.int32)
        toks[0, :n] = rng.integers(0, jcfg.vocab_size, n)
        _, jcache = jax_decode.prefill(jparams, jnp.asarray(toks), jcfg, jcache,
                                       jnp.asarray(tables[row]), prompt_len=n)

    def copy(xs):
        return [torch.from_numpy(np.array(x)) for x in xs]

    cache = decode.PagedKVCache(
        copy(jcache.k_pages), copy(jcache.v_pages),
        copy(jcache.k_scales) if mode != "dense" else [],
        copy(jcache.v_scales) if mode != "dense" else [], mode=mode)
    return jcache, cache


def _as_numpy(t):
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()


# (KV mode, page size, t, prompt lengths): dense and int8 at page 64; int4 at
# page 8 with t = 6 > page/2, so tokens j and j + 4 share a byte row (a
# one-pass nibble writer loses one of them).
VERIFY_CASES = {"dense": ("dense", 64, 4, [70, 20]), "int8": ("int8", 64, 4, [70, 20]),
                "int4-page8-t6": ("int4", 8, 6, [19, 8])}


@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_verify_step_matches_jax(name):
    """Prefill two prompts, then one verify_step of t tokens (a padding row
    on the scratch page, length t): logits (batch, t, vocab) within the
    module's rule, and every page and scale equal to the JAX package's."""
    mode, ps, t, prompt_lens = VERIFY_CASES[name]
    jcfg, cfg = _configs()
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    params = llama.params_from_jax(jax.device_get(jparams), device="cpu")
    per_seq = -(-(max(prompt_lens) + t) // ps)
    num_pages = 2 * per_seq + 1
    scratch = num_pages - 1
    tables = -np.ones((3, per_seq), np.int32)
    order = np.random.default_rng(7).permutation(scratch)
    tables[:2] = order[:2 * per_seq].reshape(2, per_seq)
    tables[2, 0] = scratch
    rng = np.random.default_rng(1)
    jcache, cache = _prefilled(jcfg, jparams, mode, ps, num_pages, tables,
                               prompt_lens, rng)
    toks = rng.integers(0, cfg.vocab_size, (3, t)).astype(np.int32)
    lens = np.array([prompt_lens[0] + t, prompt_lens[1] + t, t], np.int32)
    want, jcache = jax_decode.verify_step(jparams, jnp.asarray(toks), jcfg, jcache,
                                          jnp.asarray(lens), jnp.asarray(tables))
    got, cache = decode.verify_step(params, torch.from_numpy(toks).long(), cfg, cache,
                                    torch.from_numpy(lens), torch.from_numpy(tables))
    assert got.shape == (3, t, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)
    for li in range(cfg.n_layers):
        pools = [(cache.k_pages[li], jcache.k_pages[li]),
                 (cache.v_pages[li], jcache.v_pages[li])]
        if mode != "dense":
            pools += [(cache.k_scales[li], jcache.k_scales[li]),
                      (cache.v_scales[li], jcache.v_scales[li])]
        for mine, theirs in pools:
            theirs = np.asarray(theirs)
            if mode == "dense":  # fp32 values, summed in another order
                np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-4, atol=1e-4)
            else:
                np.testing.assert_array_equal(_as_numpy(mine), theirs)


def test_verify_step_rows_equal_decode_steps_with_embed_scale():
    """A Gemma-2-style ``embed_scale`` config (the JAX ``verify_step``
    skips the scale): verify_step's row j equals the port's decode_step
    after the same tokens one at a time, the last row included."""
    _, cfg = _configs(embed_scale=True)
    params = llama.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))
    table = torch.tensor([[4, 1, -1, -1]], dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 4)))
    caches = []
    for _ in range(2):
        cache = decode.init_cache(cfg, 8, 64, device="cpu")
        decode.prefill(params, prompt, cfg, cache, table[0])
        caches.append(cache)
    rows, _ = decode.verify_step(params, toks, cfg, caches[0],
                                 torch.tensor([68], dtype=torch.int32), table)
    for j in range(4):
        one, _ = decode.decode_step(params, toks[:, j], cfg, caches[1],
                                    torch.tensor([65 + j], dtype=torch.int32), table)
        torch.testing.assert_close(rows[:, j], one, atol=1e-4, rtol=1e-4)


def test_spec_accept_sample_matches_jax():
    """Greedy acceptance on logits whose argmax the drafts follow for a
    random number of steps, with ragged draft lengths (0 included); past a
    row's draft length the argmax is the pad token 0, which must still not
    be accepted."""
    rng = np.random.default_rng(4)
    batch, t, vocab = 12, 4, 16
    logits = rng.standard_normal((batch, t, vocab)).astype(np.float32)
    preds = logits.argmax(-1)
    drafts = rng.integers(0, vocab, (batch, t - 1)).astype(np.int32)
    for i in range(batch):
        n = i % t  # follow the argmax for n steps
        drafts[i, :n] = preds[i, :n]
    draft_lens = np.array([3, 3, 3, 3, 0, 1, 2, 3, 2, 3, 1, 2], np.int32)
    pad = np.arange(t - 1)[None, :] >= draft_lens[:, None]
    drafts[pad] = 0
    logits[:, :t - 1][pad, 0] += 10.0  # the pad token 0 is the argmax there
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    want_toks, want_n = jax_decode.spec_accept_sample(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(draft_lens), keys,
        temperature=0.0)
    got_toks, got_n = decode.spec_accept_sample(
        torch.from_numpy(logits), torch.from_numpy(drafts), torch.from_numpy(draft_lens))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
    assert int(got_n.max()) == t and int(got_n.min()) == 1
    # Sampled acceptance, once refused, now runs: rows emit their accepted
    # drafts and then one in-vocabulary token.
    gumbel = decode.sample_noise(decode.row_keys(0, torch.arange(batch))[:, None],
                                 torch.arange(t)[None, :], 0, vocab)[1]
    toks, n_emit = decode.spec_accept_sample(
        torch.from_numpy(logits), torch.from_numpy(drafts), torch.from_numpy(draft_lens),
        temperature=0.8, gumbel=gumbel)
    assert ((n_emit >= 1) & (n_emit <= torch.from_numpy(draft_lens) + 1)).all()
    for i, n in enumerate(n_emit.tolist()):
        assert toks[i, :n - 1].tolist() == drafts[i, :n - 1].tolist()
        assert 0 <= int(toks[i, n - 1]) < vocab


SERVE = dict(num_pages=32, page_size=64, pages_per_seq=8)


def test_spec_server_matches_jax_server():
    """spec_k = 3 on both servers (int8 weights, int8 cache, fp32 model):
    the same tokens and the same drafts proposed and accepted."""
    jcfg, cfg = _configs()
    jparams = jax_llama.quantize_params(
        jax_llama.init_params(jcfg, jax.random.PRNGKey(1)), "int8")
    params = llama.params_from_jax(jax.device_get(jparams), device="cpu")
    kw = dict(SERVE, max_batch=2, mode="int8", spec_k=3)
    servers = [jax_generate.GenerationServer(jparams, jcfg, **kw),
               generate.GenerationServer(params, cfg, device="cpu", **kw)]
    for server in servers:
        server.submit(1, REPEAT, 8)
        server.submit(2, list(range(40, 60)), 8)
    want, got = (server.run() for server in servers)
    assert got == want
    stats = servers[1].stats()
    assert stats["verify_steps"] > 0 and stats["spec_proposed"] > 0
    for key in ("spec_proposed", "spec_accepted"):
        assert stats[key] == servers[0].stats()[key], key
    assert stats["decode_tokens"] == 2 * 7


def test_spec_server_with_padding_rows_matches_jax_server():
    """Two requests in a batch of four: the padding rows verify their t
    tokens at positions 0..spec_k of the scratch page, and the tokens are
    the JAX server's."""
    jcfg, cfg = _configs()
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(2))
    params = llama.params_from_jax(jax.device_get(jparams), device="cpu")
    kw = dict(SERVE, max_batch=4, spec_k=3)
    servers = [jax_generate.GenerationServer(jparams, jcfg, **kw),
               generate.GenerationServer(params, cfg, device="cpu", **kw)]
    for server in servers:
        server.submit(1, REPEAT, 8)
        server.submit(2, list(range(40, 60)), 8)
    want, got = (server.run() for server in servers)
    assert got == want
    assert servers[1].stats()["verify_steps"] > 0


@pytest.fixture(scope="module")
def bf16_params():
    jcfg, _ = _configs("BF16")
    return llama.params_from_jax(
        jax.device_get(jax_llama.init_params(jcfg, jax.random.PRNGKey(0))), device="cpu")


def test_spec_server_matches_plain_greedy(bf16_params):
    """The port's spec_k = 3 server serves the tokens of its own plain
    greedy server (tests/test_speculative.py's fixture), and speculates."""
    _, cfg = _configs("BF16")
    runs = {}
    for k in (0, 3):
        server = generate.GenerationServer(bf16_params, cfg, max_batch=1, spec_k=k,
                                           device="cpu", **SERVE)
        server.submit(1, REPEAT, 10)
        runs[k] = server.run()
        if k:
            assert server.stats()["spec_accepted"] > 0
            assert server.engine.free_pages == SERVE["num_pages"] - 1
    assert runs[0] == runs[3], runs


def test_spec_server_stop_token_inside_a_draft(bf16_params):
    """A stop token inside an accepted draft ends the sequence there."""
    _, cfg = _configs("BF16")
    probe = generate.GenerationServer(bf16_params, cfg, max_batch=1, device="cpu",
                                      **SERVE)
    probe.submit(1, REPEAT, 6)
    greedy = probe.run()[1]
    server = generate.GenerationServer(bf16_params, cfg, max_batch=1, spec_k=3,
                                       device="cpu", **SERVE)
    server.submit(1, REPEAT, 6, stop=(greedy[3],))
    got = server.run()[1]
    assert got == greedy[:greedy.index(greedy[3]) + 1]
    assert server.engine.free_pages == SERVE["num_pages"] - 1


@pytest.mark.parametrize("kw,match", [(dict(spec_k=2, chunk=4), "exclusive"),
                                      (dict(spec_k=64), "page_size"),
                                      (dict(spec_k=-1), "page_size")])
def test_spec_k_validation(kw, match):
    _, cfg = _configs()
    with pytest.raises(ValueError, match=match):
        generate.GenerationServer({"embed": torch.zeros((4, 4))}, cfg, num_pages=8,
                                  page_size=64, max_batch=1, device="cpu", **kw)
    ok = generate.GenerationServer({"embed": torch.zeros((4, 4))}, cfg, num_pages=8,
                                   page_size=64, max_batch=1, device="cpu", spec_k=63)
    assert ok.spec_k == 63
