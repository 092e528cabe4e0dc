"""The port's Llama model and decode path vs the JAX package.

JAX parameters (``init_params`` from a PRNG key) are handed to the port
through ``params_from_jax``; token ids come from a seeded numpy generator.
The model comparisons run in fp32, where both sides compute the same
products and differ only in summation order. Tolerance: max |logit
difference| <= 1e-3 * max |logit|, three orders of magnitude above fp32
rounding of the ~10^3-term sums and far below what a wrong mask, RoPE
position or cache slot produces (order 10^-1 of the logit scale).
"""

import dataclasses

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

# __graft_entry__._small_cfg shapes, and tests/test_generate.py's CFG.
SMALL = dict(vocab_size=512, dim=1024, n_layers=2, n_heads=8, n_kv_heads=4,
             d_head=128, hidden_dim=1024)
GEN = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
           d_head=128, hidden_dim=256)


def _configs(shape, dtype):
    jcfg = jax_llama.LlamaConfig(**shape, block_q=128, block_kv=128,
                                 dtype=getattr(JaxDType, dtype))
    return jcfg, llama.LlamaConfig(**shape, dtype=getattr(DType, dtype))


def _params(jcfg, seed=0):
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, llama.params_from_jax(jax.device_get(jparams), device="cpu")


def _close(got, want):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= 1e-3 * float(np.abs(want).max()), err


def test_params_from_jax_round_trips_exactly():
    jcfg, _ = _configs(GEN, "BF16")
    jparams, params = _params(jcfg)
    jleaves, treedef = jax.tree_util.tree_flatten(jparams)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(jleaves)
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    back = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in leaves])
    for a, b in zip(jleaves, jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and bool(jnp.array_equal(a, b))


def test_forward_matches_jax_fp32():
    jcfg, cfg = _configs(SMALL, "FP32")
    jparams, params = _params(jcfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 256))
    want = jax_llama.forward(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    got = llama.forward(params, torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 256, cfg.vocab_size)
    _close(got, want)


def test_prefill_and_decode_match_jax_fp32():
    """Two prompts prefilled into shuffled pages, then two decode steps with
    a padding row on the scratch page, logits compared at every call."""
    jcfg, cfg = _configs(GEN, "FP32")
    jparams, params = _params(jcfg)
    num_pages, ps, scratch = 16, 64, 15
    jcache = jax_decode.init_cache(jcfg, num_pages, ps)
    cache = decode.init_cache(cfg, num_pages, ps, device="cpu")
    rng = np.random.default_rng(1)
    prompt_lens = [70, 20]
    tables = np.array([[3, 7, -1, -1], [5, -1, -1, -1], [scratch, -1, -1, -1]],
                      np.int32)
    for row, n in enumerate(prompt_lens):
        toks = np.zeros((1, 128), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        want, jcache = jax_decode.prefill(jparams, jnp.asarray(toks), jcfg,
                                          jcache, jnp.asarray(tables[row]),
                                          prompt_len=n)
        got, cache = decode.prefill(params, torch.from_numpy(toks).long(), cfg,
                                    cache, torch.from_numpy(tables[row]),
                                    prompt_len=n)
        _close(got, want)
    for step in range(2):
        toks = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
        lens = np.array([prompt_lens[0] + 1 + step, prompt_lens[1] + 1 + step, 1],
                        np.int32)
        want, jcache = jax_decode.decode_step(
            jparams, jnp.asarray(toks), jcfg, jcache, jnp.asarray(lens),
            jnp.asarray(tables))
        got, cache = decode.decode_step(
            params, torch.from_numpy(toks).long(), cfg, cache,
            torch.from_numpy(lens), torch.from_numpy(tables))
        assert got.shape == (3, cfg.vocab_size)
        _close(got, want)


def test_decode_step_matches_full_recompute():
    """Write before attend, RoPE at position lengths - 1, the logits row:
    one decode step after a prefill equals the full forward's last row."""
    cfg = llama.LlamaConfig(**GEN, dtype=DType.FP32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    cache = decode.init_cache(cfg, 8, 64, device="cpu")
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, 64)
    nxt = int(rng.integers(0, cfg.vocab_size))
    table = torch.tensor([2, 6, -1, -1], dtype=torch.int32)
    first, cache = decode.prefill(params, torch.from_numpy(prompt)[None], cfg,
                                  cache, table)
    logits, _ = decode.decode_step(
        params, torch.tensor([nxt]), cfg, cache,
        torch.tensor([65], dtype=torch.int32), table[None])
    full = np.zeros((1, 128), np.int64)
    full[0, :64], full[0, 64] = prompt, nxt
    want = llama.forward(params, torch.from_numpy(full), cfg)[0]
    torch.testing.assert_close(first, want[63], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(logits[0], want[64], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("preset", ["LLAMA3_8B", "LLAMA31_8B", "MISTRAL_7B"])
def test_rope_tables_match_jax(preset):
    """fp32 tables, including the Llama-3.1 frequency scaling, within 1e-6:
    the same fp32 operations on the same values."""
    jcfg = getattr(jax_llama, preset)
    cfg = getattr(llama, preset)
    assert dataclasses.asdict(cfg).keys() <= dataclasses.asdict(jcfg).keys()
    np.testing.assert_allclose(llama.rope_inv_freq(cfg).numpy(),
                               np.asarray(jax_llama.rope_inv_freq(jcfg)),
                               rtol=1e-6, atol=0)
    jcos, jsin = jax_llama.rope_tables(64, jcfg.d_head, jcfg.rope_theta, cfg=jcfg)
    cos, sin = llama.rope_tables(64, cfg)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6, rtol=0)


def test_default_device_is_the_card(monkeypatch):
    """Without a card, entry points raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig(**GEN)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        decode.init_cache(cfg, 4, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode.init_cache(cfg, 4, 64, mode="int8", device="cpu")
