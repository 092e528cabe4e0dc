"""A model's prefill in fp32 on the CPU: the port against the JAX package.

Two tiny configs in fp32 (``LlamaConfig.dtype`` FP32): Llama-shaped (2
layers, dim 256, 2/1 heads of 128) and Gemma-2-shaped at d 256 (a 64-token
window on layer 0, softcaps 50 / 30, sandwich norms, GeLU). JAX parameters
from a PRNG key are carried across by ``params_from_jax`` (fp32 stays
fp32); token ids are fixed lists. The port runs its plain kernel versions
(CPU tensors), the JAX package its Pallas kernels in fp32 in interpret mode
(products at ``Precision.HIGHEST``). On the card the same path runs K1 from
its fp32 library (``chip_smoke.py``'s ``prefill_fp32``).

- ``prefill``'s logits for two prompts (one past the window) and the K/V
  pages it writes, and ``forward``'s logits at every row, against JAX's
  ``prefill`` and ``forward`` in fp32: each row within 1e-4 of the JAX
  row's largest |logit| (pages: of the page pool's largest |value|). XLA
  and PyTorch sum their matmuls in different orders; the two agree to
  about 3e-6 of the row's largest logit here.
- ``prefill_chunked`` (K1 at ``q_offset`` > 0 over the pages read back)
  gives ``prefill``'s last-row logits within the same bound.
- A planted fault in attention, P rounded through TF32 once before P V (a
  kernel that fed P to one TF32 product), moves the logits past the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import decode as jax_decode
from flash_attention_from_scratch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, forward as jax_forward, init_params as jax_init_params,
)
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu_torch.models import decode, llama
from flash_attention_from_scratch_tpu_torch.models.llama import LlamaConfig, params_from_jax
from flash_attention_from_scratch_tpu_torch.ops import flash_forward as ff
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from test_torch_fp32_kernels import _plain_p_through_tf32

SHAPES = {
    "llama": dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, d_head=128,
                  hidden_dim=256),
    "gemma2": dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, d_head=256,
                   hidden_dim=256, window_pattern=(64, 0), mlp_act="gelu", post_norms=True,
                   embed_scale=True, attn_softcap=50.0, final_softcap=30.0,
                   attn_scale=256 ** -0.5),
}
# The first prompt is past the Gemma-2 window.
PROMPTS = [[(7 * i + 3) % 256 for i in range(100)], list(range(40, 60))]
TABLES = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)
PAGES, PAGE = 8, 64
REL = 1e-4  # of the JAX row's largest |logit|


def _tokens(prompt, width=128):
    toks = np.zeros((1, width), np.int32)
    toks[0, :len(prompt)] = prompt
    return toks


@pytest.fixture(scope="module", params=sorted(SHAPES))
def model(request):
    """(name, port config, port params, JAX results): JAX's prefill logits a
    prompt, its pages, and its forward logits over each padded prompt."""
    shape = SHAPES[request.param]
    jcfg = JaxLlamaConfig(**shape, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    cache = jax_decode.init_cache(jcfg, PAGES, PAGE)
    logits = []
    for b, prompt in enumerate(PROMPTS):
        row, cache = jax_decode.prefill(jparams, jnp.asarray(_tokens(prompt)), jcfg, cache,
                                        jnp.asarray(TABLES[b]), prompt_len=len(prompt))
        logits.append(np.asarray(row))
    forward = [np.asarray(jax_forward(jparams, jnp.asarray(_tokens(p)), jcfg))[0]
               for p in PROMPTS]
    want = dict(prefill=np.stack(logits), forward=forward,
                k_pages=[np.asarray(x) for x in cache.k_pages],
                v_pages=[np.asarray(x) for x in cache.v_pages])
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    return request.param, LlamaConfig(**shape, dtype=DType.FP32), params, want


def _port(params, cfg):
    """The port's prefill logits a prompt, its cache, and its forward
    logits over each padded prompt."""
    cache = decode.init_cache(cfg, PAGES, PAGE, device="cpu")
    rows = []
    for b, prompt in enumerate(PROMPTS):
        row, cache = decode.prefill(params, torch.from_numpy(_tokens(prompt)).long(), cfg,
                                    cache, torch.from_numpy(TABLES[b]), prompt_len=len(prompt))
        rows.append(row)
    forward = [llama.forward(params, torch.from_numpy(_tokens(p)).long(), cfg)[0]
               for p in PROMPTS]
    return torch.stack(rows), cache, forward


def _worst(got, want):
    """The largest |got - want| a row over the JAX row's largest |value|."""
    got = got.detach().numpy() if torch.is_tensor(got) else got
    return float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())


def test_params_and_cache_are_fp32(model):
    _, cfg, params, _ = model
    assert {p.dtype for p in jax.tree_util.tree_leaves(params)} == {torch.float32}
    cache = decode.init_cache(cfg, PAGES, PAGE, device="cpu")
    assert cache.mode == "dense" and cache.k_pages[0].dtype == torch.float32


def test_prefill_and_forward_match_jax(model):
    """Each prompt's prefill logits, the pages it wrote and the forward
    logits at every row, within 1e-4 of the JAX row's largest value."""
    name, cfg, params, want = model
    rows, cache, forward = _port(params, cfg)
    assert rows.dtype == torch.float32
    assert _worst(rows, want["prefill"]) <= REL, name
    for got, ref in zip(forward, want["forward"]):
        assert got.dtype == torch.float32 and _worst(got, ref) <= REL, name
    for pools, refs in ((cache.k_pages, want["k_pages"]), (cache.v_pages, want["v_pages"])):
        for got, ref in zip(pools, refs):
            used = TABLES[TABLES >= 0]
            err = np.abs(got.numpy()[:, used] - ref[:, used]).max()
            assert err <= REL * np.abs(ref[:, used]).max(), (name, err)


def test_prefill_chunked_matches_prefill(model):
    """``prefill_chunked`` in 128-token chunks (K1 at q_offset 128 over the
    pages it read back) gives ``prefill``'s last-row logits."""
    _, cfg, params, _ = model
    prompt = [(5 * i + 1) % 256 for i in range(300)]
    table = torch.arange(5, dtype=torch.int32)
    toks = torch.from_numpy(_tokens(prompt, 384)).long()
    whole, _ = decode.prefill(params, toks, cfg, decode.init_cache(cfg, 6, PAGE, device="cpu"),
                              table, prompt_len=len(prompt))
    chunked, _ = decode.prefill_chunked(params, toks, cfg,
                                        decode.init_cache(cfg, 6, PAGE, device="cpu"), table,
                                        prompt_len=len(prompt), chunk_tokens=128)
    assert _worst(chunked, whole.numpy()) <= REL


def test_planted_attention_fault_fails_the_bound(model, monkeypatch):
    """P rounded through TF32 before P V moves prefill's or forward's
    logits past 1e-4 of the row's largest."""
    name, cfg, params, want = model

    def faulty(q, k, v, cfg, sinks=None):
        return _plain_p_through_tf32(q, k, v, cfg, sinks), None

    monkeypatch.setattr(ff, "flash_forward_plain", faulty)
    rows, _, forward = _port(params, cfg)
    worst = max(_worst(rows, want["prefill"]),
                *(_worst(got, ref) for got, ref in zip(forward, want["forward"])))
    assert worst > REL, (name, worst)
