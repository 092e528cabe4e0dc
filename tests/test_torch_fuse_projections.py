"""fuse_projections vs the JAX package, on the CPU.

Each layer's wq|wk|wv and w_gate|w_up become one weight each (``wqkv``,
``w_gate_up``), dense or quantized (int8, int4 and W8A8 weights: the
per-column scales concatenate). On an fp32 model the fused model's logits
are the unfused port's within 1e-5 (one product over the concatenated
columns in place of three; the same sums, blocked differently by the CPU's
matmul) and the JAX package's fused forward's within 1e-4 (W8A8: 3e-2 of
the logit scale, the rule of ``tests/test_torch_llama.py``: an activation
the two packages compute a few ulps apart can round to the next int8 step,
and the unfused models differ as much);
``params_from_jax`` of a fused JAX tree equals ``fuse_projections`` of the
converted unfused tree exactly. A decode step through the fused weights
gives the unfused step's logits, pages included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu_torch.models import decode, llama
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import QuantizedWeight

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=256)
JCFG = jax_llama.LlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
CFG = llama.LlamaConfig(**SHAPE, dtype=DType.FP32)
RECIPES = {"dense": None, "int8": ("int8", "bf16"), "int4": ("int4", "bf16"),
           "w8a8": ("int8", "int8")}


def _trees(recipe):
    jparams = jax_llama.init_params(JCFG, jax.random.PRNGKey(5))
    if RECIPES[recipe]:
        mode, act = RECIPES[recipe]
        jparams = jax_llama.quantize_params(jparams, mode, act=act)
    return jparams, llama.params_from_jax(jax.device_get(jparams), device="cpu")


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, QuantizedWeight):
        assert (a.mode, a.act, a.orig_dtype) == (b.mode, b.act, b.orig_dtype)
        _same(a.values, b.values)
        _same(a.scales, b.scales)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_fused_model_matches_unfused_and_jax(recipe):
    jparams, params = _trees(recipe)
    fused = llama.fuse_projections(params)
    layer = fused["layers"][0]
    assert "wqkv" in layer and "w_gate_up" in layer
    assert not {"wq", "wk", "wv", "w_gate", "w_up"} & layer.keys()
    assert "wq" in params["layers"][0]  # the unfused tree is left as it was
    assert layer["wqkv"].shape == (256, 512) and layer["w_gate_up"].shape == (256, 512)
    tokens = (np.arange(128, dtype=np.int32) * 5 + 1)[None] % 256
    got = llama.forward(fused, torch.from_numpy(tokens).long(), CFG)
    unfused = llama.forward(params, torch.from_numpy(tokens).long(), CFG)
    torch.testing.assert_close(got, unfused, atol=1e-5, rtol=0)
    want = np.asarray(jax_llama.forward(jax_llama.fuse_projections(jparams),
                                        jnp.asarray(tokens), JCFG))
    atol = 3e-2 * float(np.abs(want).max()) if recipe == "w8a8" else 1e-4
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_params_from_jax_takes_a_fused_tree(recipe):
    jparams, params = _trees(recipe)
    converted = llama.params_from_jax(
        jax.device_get(jax_llama.fuse_projections(jparams)), device="cpu")
    _same(converted, llama.fuse_projections(params))


@pytest.mark.parametrize("recipe", ["dense", "w8a8"])
def test_fused_decode_step_matches_unfused(recipe):
    """A prefill and one decode step of two sequences through each tree:
    the same logits within 1e-5 and the same pages within 1e-5."""
    _, params = _trees(recipe)
    results = []
    for tree in (params, llama.fuse_projections(params)):
        cache = decode.init_cache(CFG, 8, 64, device="cpu")
        tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
        for row, n in enumerate((20, 70)):
            toks = torch.zeros((1, 128), dtype=torch.long)
            toks[0, :n] = torch.arange(n) % 256
            decode.prefill(tree, toks, CFG, cache, tables[row], prompt_len=n)
        logits, cache = decode.decode_step(
            tree, torch.tensor([3, 9]), CFG, cache,
            torch.tensor([21, 71], dtype=torch.int32), tables)
        results.append((logits, cache))
    (a, ca), (b, cb) = results
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    for x, y in zip(ca.k_pages + ca.v_pages, cb.k_pages + cb.v_pages):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


def test_fuse_projections_refuses_qkv_biases():
    _, params = _trees("dense")
    params["layers"][0]["bq"] = torch.zeros(256)
    with pytest.raises(NotImplementedError, match="biases"):
        llama.fuse_projections(params)
