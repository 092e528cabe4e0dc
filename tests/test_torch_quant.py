"""The port's quantized K/V formats and cache writers vs the JAX package.

Bytes must be equal, not close: the same seeded numpy values go through the
JAX package's ``quantize_kv``, ``quantize_kv_pages`` and cache writers and
through the port's, and the stored int8 bytes (fp8 as uint8 bit patterns;
numpy has no fp8 type) and fp32 scales must match exactly. Both sides round
half to even and copy each reference's own operation (multiply by
``1 / scale`` in ``quant.py``, divide by the scale in the writers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import decode as jax_decode
from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops import quant as jax_quant
from flash_attention_from_scratch_tpu_torch.models import decode, llama
from flash_attention_from_scratch_tpu_torch.ops import quant
from flash_attention_from_scratch_tpu_torch.ops.configs import DType

MODES = ["int8", "fp8", "int4"]


def _bytes(x):
    """Stored values as comparable numpy bytes (fp8 as its bit patterns)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if str(x.dtype).startswith("float8") else x


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_kv_bytes_match_jax(mode):
    x = _normal((2, 3, 40, 128), seed=0)
    x[0, 1] *= 1e-3  # a small head: its own scale
    xb = torch.from_numpy(x).bfloat16()
    want = jax_quant.quantize_kv(jnp.asarray(x, jnp.bfloat16), mode)
    got = quant.quantize_kv(xb, mode)
    np.testing.assert_array_equal(_bytes(got.values), _bytes(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert got.orig_dtype == torch.bfloat16 and got.seq_len == 40
    if mode == "int4":
        assert got.shape == (2, 3, 40, 64)
    # Dequantized values: the same fp32 products, rounded to bf16.
    np.testing.assert_array_equal(
        quant.dequantize(got).float().numpy(),
        np.asarray(jax_quant.dequantize(want), np.float32))


@pytest.mark.parametrize("mode", MODES)
def test_quantize_kv_pages_bytes_match_jax(mode):
    pages = _normal((2, 6, 16, 128), seed=1, scale=3.0)
    pages[1, 2] = 0.0  # an all-zero page: the 1e-12 scale floor
    vals, scales = quant.quantize_kv_pages(torch.from_numpy(pages).bfloat16(), mode)
    jvals, jscales = jax_quant.quantize_kv_pages(jnp.asarray(pages, jnp.bfloat16),
                                                 mode)
    np.testing.assert_array_equal(_bytes(vals), _bytes(jvals))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    rows = 8 if mode == "int4" else 16
    assert vals.shape == (2, 6, rows, 128)


def test_unpack_int4_every_byte():
    """All 256 byte values, -8 nibbles included, as the JAX unpack gives."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    lo, hi = quant.unpack_int4_halves(torch.from_numpy(packed))
    jlo, jhi = jax_quant.unpack_int4_halves(jnp.asarray(packed))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(quant.unpack_int4(torch.from_numpy(packed)).numpy(),
                                  np.asarray(jax_quant.unpack_int4(jnp.asarray(packed))))
    assert lo.min() == -8 and hi.min() == -8 and lo.max() == 7


# Cache writers: a small fp32 model whose K/V rows are fixed arrays, so both
# sides write the same values (the projections and RoPE are replaced by
# fixed rows, identically on both sides).
SHAPE = dict(vocab_size=136, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
             d_head=128, hidden_dim=256)
PS, NUM_PAGES, SCRATCH = 16, 12, 11
PROMPTS = (21, 9)
TABLES = np.array([[3, 7, -1, -1], [5, -1, -1, -1], [SCRATCH, -1, -1, -1]],
                  np.int32)


def _fixed_qkv(rows_by_shape):
    def qkv(layer, h, cfg=None):
        q, k, v = rows_by_shape[tuple(h.shape[:2])]
        if isinstance(h, torch.Tensor):
            return tuple(torch.from_numpy(a) for a in (q, k, v))
        return tuple(jnp.asarray(a) for a in (q, k, v))
    return qkv


def _rows(n_tokens, batch, seed, scale):
    kv = SHAPE["n_kv_heads"] * SHAPE["d_head"]
    return (_normal((batch, n_tokens, SHAPE["n_heads"] * SHAPE["d_head"]), seed),
            _normal((batch, n_tokens, kv), seed + 1, scale),
            _normal((batch, n_tokens, kv), seed + 2, scale))


@pytest.mark.parametrize("mode", MODES)
def test_cache_writers_match_jax_bytes(mode, monkeypatch):
    """Prefill of two prompts, then two decode steps with a padding row on
    the scratch page (the second step grows sequence 1 onto a new page),
    through both packages: every stored byte and scale is equal. Decode
    rows are 4x larger than the prompts', so fp8 values pass the e4m3
    range and exercise the clamp, and int4 nibbles saturate."""
    rows = {(1, 128): _rows(128, 1, 10, 1.0), (3, 1): _rows(1, 3, 20, 4.0)}
    fixed = _fixed_qkv(rows)
    monkeypatch.setattr(jax_decode, "_qkv", fixed)
    monkeypatch.setattr(jax_decode, "apply_rope", lambda x, cos, sin: x)
    for module in (decode, llama):  # port: decode steps, prefill
        monkeypatch.setattr(module, "_qkv", fixed)
        monkeypatch.setattr(module, "apply_rope", lambda x, cos, sin: x)
    # K1's prefill attention and its JAX counterpart see the fixed rows too;
    # their outputs do not reach the cache.
    jcfg = jax_llama.LlamaConfig(**SHAPE, block_q=128, block_kv=128,
                                 dtype=jax_llama.DType.FP32)
    cfg = llama.LlamaConfig(**SHAPE, dtype=DType.FP32)
    jparams = jax_llama.init_params(jcfg, jax.random.PRNGKey(0))
    params = llama.params_from_jax(jax.device_get(jparams), device="cpu")
    jcache = jax_decode.init_cache(jcfg, NUM_PAGES, PS, mode)
    cache = decode.init_cache(cfg, NUM_PAGES, PS, mode, device="cpu")
    toks = np.zeros((1, 128), np.int32)
    for row, n in enumerate(PROMPTS):
        _, jcache = jax_decode.prefill(jparams, jnp.asarray(toks), jcfg, jcache,
                                       jnp.asarray(TABLES[row]), prompt_len=n)
        decode.prefill(params, torch.from_numpy(toks).long(), cfg, cache,
                       torch.from_numpy(TABLES[row]), prompt_len=n)
    for step in range(2):
        lens = np.array([PROMPTS[0] + 1 + step, PROMPTS[1] + 7 * step + 1, 1],
                        np.int32)
        _, jcache = jax_decode.decode_step(
            jparams, jnp.zeros(3, jnp.int32), jcfg, jcache, jnp.asarray(lens),
            jnp.asarray(TABLES if step == 0 else _grown()))
        decode.decode_step(params, torch.zeros(3, dtype=torch.long), cfg, cache,
                           torch.from_numpy(lens),
                           torch.from_numpy(TABLES if step == 0 else _grown()))
    assert cache.mode == mode and cache.page_size == PS
    assert cache.num_pages == NUM_PAGES
    for li in range(SHAPE["n_layers"]):
        for got, want in ((cache.k_pages[li], jcache.k_pages[li]),
                          (cache.v_pages[li], jcache.v_pages[li]),
                          (cache.k_scales[li], jcache.k_scales[li]),
                          (cache.v_scales[li], jcache.v_scales[li])):
            np.testing.assert_array_equal(_bytes(got), _bytes(want))
    jbytes = sum(np.asarray(x).nbytes for x in jcache.k_pages + jcache.v_pages
                 + jcache.k_scales + jcache.v_scales)
    assert cache.nbytes() == jbytes


def _grown():
    """Sequence 1 at length 16 crosses into its second page (page 9)."""
    tables = TABLES.copy()
    tables[1, 1] = 9
    return tables


def test_init_cache_layouts():
    cfg = llama.LlamaConfig(**SHAPE)
    for mode, dtype, rows in (("dense", torch.bfloat16, 16), ("int8", torch.int8, 16),
                              ("fp8", torch.float8_e4m3fn, 16), ("int4", torch.int8, 8)):
        cache = decode.init_cache(cfg, 4, 16, mode, device="cpu")
        assert cache.k_pages[0].dtype == dtype
        assert cache.k_pages[0].shape == (2, 4, rows, 128)
        assert cache.page_size == 16
        if mode == "dense":  # no scales: nothing reads them, nbytes = page bytes
            assert cache.k_scales == cache.v_scales == []
            assert cache.layer_scales(0) == (None, None)
            pool = cache.k_pages[0]
            assert cache.nbytes() == 2 * SHAPE["n_layers"] * pool.numel() * pool.element_size()
        else:
            assert cache.k_scales[0].shape == (2, 4)
    with pytest.raises(ValueError):
        decode.init_cache(cfg, 4, 16, "int2", device="cpu")
    assert dataclasses.fields(decode.PagedKVCache)[-1].name == "mode"
