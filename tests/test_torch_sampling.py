"""The port's samplers vs the JAX package's, and sampled serving, on the CPU.

torch cannot reproduce ``jax.random``, so the parity tests hand the port
JAX's own noise: ``sample_token`` with ``jax.random.gumbel(key,
logits.shape)`` gives the JAX ``sample_token``'s tokens (``categorical`` is
the Gumbel-max draw), and sampled ``spec_accept_sample`` with the JAX
acceptance uniforms (``uniform(fold_in(key, 0), (k,))``) and tail Gumbels
(``gumbel(fold_in(key, 1), (vocab,))``) gives its tokens and counts. The
port's own noise (``sample_noise``) is held by distribution: 20,000 draws
of a 16-token distribution within 0.015 of each probability (4 standard
errors at p = 0.5), and the delta-proposal's first emitted token within
the same bound of p_0, with JAX's uniform rule and with the coupled rule
the server uses. A sampled server gives the same tokens whatever the path
(chunk 1 or 4, a preempting pool, spec_k 0 or 3), and at top_k = 1 the
JAX greedy server's tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import decode as jax_decode
from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.serving.generate import (
    GenerationServer as JaxGenerationServer,
)
from flash_attention_from_scratch_tpu_torch.models import decode, llama
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.serving import generate
from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=256)
JCFG = jax_llama.LlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
CFG = llama.LlamaConfig(**SHAPE, dtype=DType.FP32)
DRAWS, FREQ_BOUND = 20_000, 0.015


def _tied_logits(seed, shape):
    """Normal logits rounded to 0.25: many ties, at the k-th value too."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 2
    return np.round(x * 4) / 4


@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_token_matches_jax(temperature, top_k):
    logits = _tied_logits(0, (12, 64))
    kth = np.sort(logits, -1)[:, -5]
    assert ((logits == kth[:, None]).sum(-1) > 1).any()  # ties at the 5th value
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jax_decode.sample_token(jnp.asarray(logits), key, temperature, top_k)
        gumbel = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
        got = decode.sample_token(torch.from_numpy(logits), torch.from_numpy(gumbel),
                                  temperature, top_k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _spec_inputs(seed, batch=12, t=4, vocab=32):
    """Verify logits, drafts following the argmax for a varying count, short
    and empty drafts zero-padded, and the pad token 0 the argmax there."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((batch, t, vocab)).astype(np.float32) * 2
    preds = logits.argmax(-1)
    drafts = rng.integers(0, vocab, (batch, t - 1)).astype(np.int32)
    for i in range(batch):
        drafts[i, :i % t] = preds[i, :i % t]
    draft_lens = np.array([3, 3, 3, 3, 0, 1, 2, 3, 2, 3, 1, 0][:batch], np.int32)
    pad = np.arange(t - 1)[None, :] >= draft_lens[:, None]
    drafts[pad] = 0
    logits[:, :t - 1][pad, 0] += 10.0
    return logits, drafts, draft_lens


@pytest.mark.parametrize("top_k", [0, 5])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_sampled_spec_accept_matches_jax(temperature, top_k):
    """The port's delta-proposal rule under JAX's uniforms and tail Gumbels
    gives the JAX function's tokens and n_emit exactly."""
    logits, drafts, draft_lens = _spec_inputs(1)
    batch, t, vocab = logits.shape
    for seed in range(3):
        keys = jax.random.split(jax.random.PRNGKey(seed), batch)
        want_toks, want_n = jax_decode.spec_accept_sample(
            jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(draft_lens), keys,
            temperature=temperature, top_k=top_k)
        u = jax.vmap(lambda kk: jax.random.uniform(jax.random.fold_in(kk, 0), (t - 1,)))(keys)
        g = jax.vmap(lambda kk: jax.random.gumbel(jax.random.fold_in(kk, 1), (vocab,)))(keys)
        got_toks, got_n = decode.spec_accept_sample(
            torch.from_numpy(logits), torch.from_numpy(drafts),
            torch.from_numpy(draft_lens), temperature, top_k,
            uniforms=torch.from_numpy(np.asarray(u)), gumbel=torch.from_numpy(np.asarray(g)))
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
        np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))


def test_spec_accept_needs_noise_to_sample():
    logits, drafts, draft_lens = (torch.from_numpy(a) for a in _spec_inputs(2))
    with pytest.raises(ValueError, match="gumbel"):
        decode.spec_accept_sample(logits, drafts, draft_lens, 0.8)
    with pytest.raises(ValueError, match="gumbel"):
        decode.spec_accept_sample(logits, drafts, draft_lens, 0.8,
                                  gumbel=torch.zeros(logits.shape[0], logits.shape[2]))


def _noise(n_rows, vocab, seed=0, positions=None):
    keys = decode.row_keys(seed, torch.zeros(n_rows, dtype=torch.int64))
    pos = torch.arange(n_rows) if positions is None else positions
    return decode.sample_noise(keys, pos, decode.STREAM_SAMPLE, vocab)


def test_noise_is_a_pure_function_of_its_counters():
    """The same (key, position, stream, index) gives the same bits whatever
    the batch around it; any counter changed gives other bits; uniforms lie
    in (0, 1)."""
    keys = decode.row_keys(3, torch.tensor([0, 1, -1, 2 ** 40]))
    pos = torch.tensor([0, 5, 5, 9])
    bits = decode.noise_bits(keys, pos, 0, 1000)
    assert bits.shape == (4, 1000) and bits.dtype == torch.int64
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    for i in range(4):
        assert torch.equal(decode.noise_bits(keys[i:i + 1], pos[i:i + 1], 0, 1000)[0], bits[i])
    assert len({tuple(r.tolist()) for r in bits}) == 4
    for other in (decode.noise_bits(keys, pos + 1, 0, 1000),
                  decode.noise_bits(keys, pos, 1, 1000),
                  decode.noise_bits(decode.row_keys(4, torch.tensor([0, 1, -1, 2 ** 40])),
                                    pos, 0, 1000)):
        assert (other != bits).float().mean() > 0.99
    u, g = decode.sample_noise(keys, pos, 0, 1000)
    assert float(u.min()) > 0 and float(u.max()) < 1
    assert torch.equal(g, -torch.log(-torch.log(u)))
    assert abs(float(u.mean()) - 0.5) < 0.02


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 5)])
def test_sample_token_frequencies(temperature, top_k):
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(16).astype(np.float32))
    _, gumbel = _noise(DRAWS, 16)
    toks = decode.sample_token(logits.expand(DRAWS, 16), gumbel, temperature, top_k)
    freq = torch.bincount(toks, minlength=16).double() / DRAWS
    want = torch.softmax(decode.top_k_filter(logits, top_k).double() / temperature, -1)
    assert float((freq - want).abs().max()) < FREQ_BOUND
    if top_k:
        assert int((freq > 0).sum()) == top_k


@pytest.mark.parametrize("rule", ["uniforms", "coupled"])
def test_delta_proposal_first_token_follows_p0(rule):
    """One draft token, accepted with probability p_0(d) or replaced from the
    residual: the first emitted token is distributed as p_0 (the draft d is
    a likely token, so both branches carry weight)."""
    vocab, temperature = 16, 0.9
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal((2, vocab)).astype(
        np.float32))
    d = int(torch.argsort(logits[0])[-2])  # the second most likely token
    batch_logits = logits.expand(DRAWS, 2, vocab)
    drafts = torch.full((DRAWS, 1), d)
    lens = torch.ones(DRAWS, dtype=torch.int64)
    keys = decode.row_keys(5, torch.arange(DRAWS))
    if rule == "uniforms":
        # Two streams apart from the server's 0, as JAX keeps these draws
        # apart (fold_in(key, 0) and fold_in(key, 1)).
        u, _ = decode.sample_noise(keys, 0, 1, 1)
        _, g = decode.sample_noise(keys, 0, 2, vocab)
        toks, _ = decode.spec_accept_sample(batch_logits, drafts, lens, temperature,
                                            uniforms=u, gumbel=g)
    else:
        _, g = decode.sample_noise(keys[:, None], torch.arange(2)[None, :], 0, vocab)
        toks, _ = decode.spec_accept_sample(batch_logits, drafts, lens, temperature,
                                            gumbel=g)
    freq = torch.bincount(toks[:, 0], minlength=vocab).double() / DRAWS
    p0 = torch.softmax(logits[0].double() / temperature, -1)
    assert float((freq - p0).abs().max()) < FREQ_BOUND


@pytest.mark.parametrize("top_k", [0, 5])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_pick_keyed_of_a_decode_step_is_sample_token(temperature, top_k):
    """The server's pick of a decode step (``pick_keyed`` at t = 1, no
    drafts) is ``sample_token`` on the Gumbels of (row key, position), one
    token a row."""
    logits = torch.from_numpy(np.random.default_rng(7).standard_normal((6, 1, 64)).astype(
        np.float32))
    keys, pos = decode.row_keys(2, torch.arange(6) - 2), torch.arange(6) * 4
    toks, n_emit = decode.pick_keyed(logits, torch.zeros((6, 0), dtype=torch.int64),
                                     torch.zeros(6, dtype=torch.int64), keys, pos,
                                     temperature, top_k)
    _, gumbel = decode.sample_noise(keys, pos, 0, 64)
    want = decode.sample_token(logits[:, 0], gumbel, temperature, top_k)
    assert torch.equal(toks[:, 0], want) and n_emit.tolist() == [1] * 6


def test_coupled_acceptance_emits_the_plain_samples():
    """Without uniforms, a verify step emits exactly the tokens
    ``sample_token`` draws at each position from the same Gumbels."""
    logits, drafts, draft_lens = (torch.from_numpy(a) for a in _spec_inputs(6))
    batch, t, vocab = logits.shape
    _, g = decode.sample_noise(decode.row_keys(1, torch.arange(batch))[:, None],
                               torch.arange(t)[None, :], 0, vocab)
    toks, n_emit = decode.spec_accept_sample(logits, drafts, draft_lens, 0.8, 3, gumbel=g)
    plain = decode.sample_token(logits, g, 0.8, 3)  # (batch, t)
    for i, n in enumerate(n_emit.tolist()):
        assert toks[i, :n].tolist() == plain[i, :n].tolist()


@pytest.fixture(scope="module")
def models():
    jparams = jax_llama.init_params(JCFG, jax.random.PRNGKey(0))
    return jparams, llama.params_from_jax(jax.device_get(jparams), device="cpu")


def _phrase_prompts(seed=0):
    """Prompts repeating a short phrase, so prompt lookup drafts tokens."""
    rng = np.random.default_rng(seed)
    out = {}
    for sid, n in enumerate((61, 62, 63, 64, 60)):
        phrase = rng.integers(1, SHAPE["vocab_size"], 7).tolist()
        out[sid] = (phrase * 10)[:n]
    return out


SAMPLED = dict(page_size=64, pages_per_seq=4, temperature=0.9, top_k=20, seed=5,
               device="cpu")


def _serve(params, prompts, new=8, **kw):
    server = GenerationServer(params, CFG, **{**SAMPLED, **kw})
    for sid, prompt in prompts.items():
        server.submit(sid, prompt, new)
    return server.run(), server.stats()


def test_sampled_tokens_do_not_depend_on_the_path(models, monkeypatch):
    """The same sampled tokens at chunk 1 and 4, from a pool that preempts
    and from one that does not, and with spec_k 3 as with spec_k 0. A
    random model's own tokens seldom repeat its context, so the drafts come
    from a stand-in for prompt lookup: the tokens spec_k 0 sampled (all
    accepted), then the same with every second token wrong (refused there,
    the correction drawn from the residual)."""
    params = models[1]
    prompts = _phrase_prompts()
    want, stats = _serve(params, prompts, num_pages=40, max_batch=3)
    assert stats["preemptions"] == 0
    greedy, _ = _serve(params, prompts, num_pages=40, max_batch=3, temperature=0.0)
    assert greedy != want
    got, stats = _serve(params, prompts, num_pages=40, max_batch=3, chunk=4)
    assert got == want and stats["decode_loops"] > 0
    got, stats = _serve(params, prompts, num_pages=6, max_batch=3)
    assert got == want and stats["preemptions"] > 0

    def drafter(corrupt):
        def draft(ctx, k):
            sid = next(s for s, p in prompts.items() if ctx[:len(p)] == p)
            done = len(ctx) - len(prompts[sid])
            d = list(want[sid][done:done + k])
            return [(t + 1) % SHAPE["vocab_size"] if corrupt and i % 2 else t
                    for i, t in enumerate(d)]
        return draft

    for corrupt in (False, True):
        monkeypatch.setattr(generate, "_prompt_lookup_draft", drafter(corrupt))
        got, stats = _serve(params, prompts, num_pages=40, max_batch=5, spec_k=3)
        assert got == want, corrupt
        assert stats["verify_steps"] > 0 and stats["spec_accepted"] > 0
        rate = stats["spec_acceptance_rate"]
        assert rate == 1.0 if not corrupt else 0.0 < rate < 0.8, (corrupt, rate)


def test_top_k_one_serves_the_jax_greedy_tokens(models):
    """top_k = 1 leaves one token a row, so at any temperature the sampled
    server gives the greedy JAX server's tokens (an fp32 model: no ties)."""
    jparams, params = models
    prompts = _phrase_prompts(1)
    kw = dict(num_pages=40, page_size=64, max_batch=5, pages_per_seq=4)
    jax_server = JaxGenerationServer(jparams, JCFG, **kw)
    for sid, prompt in prompts.items():
        jax_server.submit(sid, prompt, 6)
    want = jax_server.run()
    for temperature in (0.5, 2.0):
        server = GenerationServer(params, CFG, temperature=temperature, top_k=1,
                                  device="cpu", **kw)
        for sid, prompt in prompts.items():
            server.submit(sid, prompt, 6)
        assert server.run() == want
