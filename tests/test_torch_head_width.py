"""Head width 256 in the port's plain versions vs the JAX package.

The JAX package takes any head width that is a multiple of 128; the port's
plain versions (the CPU path of ``flash_forward``, ``paged_decode_attention``
and ``flash_forward_quantized``) take the same widths. Same seeded numpy
inputs at d 256 go to the port and to the JAX Pallas kernels in interpret
mode. Tolerance: the adaptive tolerance rule with both references from the
JAX side (the JAX kernel in bf16, the JAX ``reference_attention`` in fp32 on
the same bf16-rounded or dequantized inputs), in each (batch, head, 64-row
band) of a flash output and each sequence of a paged one; ``int8_compute``
by the rule of ``tests/test_torch_flash_quant.py::test_int8_compute_matches_jax``
(within 2e-2 of the JAX int8 kernel, within 4e-2 of the fp32 reference
causal). The CUDA kernels take d 128 and 256 (``tests/test_torch_cuda_kernels.py``
holds them to these plain versions on the card and checks that their
wrappers refuse other widths).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.ops import quant as jax_quant
from flash_attention_from_scratch_tpu.ops.configs import (
    DType as JaxDType, KernelConfig as JaxKernelConfig,
)
from flash_attention_from_scratch_tpu.ops.flash_forward import (
    flash_forward as jax_flash_forward,
)
from flash_attention_from_scratch_tpu.ops.flash_quant import (
    flash_forward_quantized as jax_flash_quant,
)
import flash_attention_from_scratch_tpu.ops.paged_attention as jax_pa
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import flash_forward
from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
    flash_forward_quantized,
)
from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
)
from flash_attention_from_scratch_tpu_torch.ops.quant import quantize_kv
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    make_qkv, row_bands, sliced_tolerance_check,
)

D = 256


def _bands_ok(got, jax_kernel, ref32):
    ok, ratio, where = sliced_tolerance_check(
        row_bands(got), row_bands(torch.from_numpy(np.asarray(jax_kernel, np.float32))
                                  .bfloat16()),
        row_bands(torch.from_numpy(np.array(ref32, np.float32))), lead=3)
    assert ok, (ratio, where)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=64)],
                         ids=["causal", "window"])
def test_flash_forward_d256_matches_jax(kw):
    q, k, v = make_qkv(1, 4, 128, D, kv_heads=2, seed=31)
    jcfg = JaxKernelConfig(block_q=128, block_kv=128, dtype=JaxDType.BF16, d_head=D,
                           scale_q=False, optimized_softmax=not kw.get("window"), **kw)
    want = jax_flash_forward(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jcfg)
    ref32 = jax_reference(*(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
                            for x in (q, k, v)),
                          causal=True, q_offset=0, window=kw.get("window", 0))
    got = flash_forward(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                        KernelConfig(d_head=D, **kw))
    assert got.shape == (1, 4, 128, D) and got.dtype == torch.bfloat16
    _bands_ok(got, want, ref32)


@pytest.mark.parametrize("mode,q_kind,causal", [("int8", "bf16", True),
                                                ("int4", "fp8", False)])
def test_flash_forward_quantized_d256_matches_jax(mode, q_kind, causal):
    q, k, v = make_qkv(1, 4, 128, D, kv_heads=2, seed=32)

    def quantized(x, kind, side):
        if side == "jax":
            xb = jnp.asarray(x, jnp.bfloat16)
            return xb if kind == "bf16" else jax_quant.quantize_kv(xb, kind)
        xb = torch.from_numpy(x).bfloat16()
        return xb if kind == "bf16" else quantize_kv(xb, kind)

    def fp32(x):
        if isinstance(x, jax_quant.QTensor):
            return jax_quant.dequantize(dataclasses.replace(x, orig_dtype=jnp.float32))
        return x.astype(jnp.float32)

    jq, jk, jv = quantized(q, q_kind, "jax"), quantized(k, mode, "jax"), quantized(v, mode, "jax")
    jcfg = JaxKernelConfig(block_q=128, block_kv=128, d_head=D, scale_q=False,
                           causal=causal)
    want = jax_flash_quant(jq, jk, jv, jcfg, int8_compute=False)
    ref32 = jax_reference(*(fp32(x) for x in (jq, jk, jv)), causal=causal,
                          q_offset=0 if causal else None)
    got = flash_forward_quantized(quantized(q, q_kind, "port"), quantized(k, mode, "port"),
                                  quantized(v, mode, "port"),
                                  KernelConfig(d_head=D, causal=causal), int8_compute=False)
    assert got.shape == (1, 4, 128, D)
    _bands_ok(got, want, ref32)


# K10 at d 256 on every path of its kernel: (K/V mode, Q kind, config
# fields). int8_compute causal and with a window; fp8 K/V with Gemma-2's
# softcap; int8 K/V with an fp8 Q (the upcast of a quantized Q).
QUANT_D256_CASES = {
    "int8c-causal": ("int8", "int8", dict(causal=True)),
    "int8c-window": ("int8", "int8", dict(causal=True, window=100)),
    "fp8-softcap": ("fp8", "bf16", dict(causal=True, attn_softcap=50.0)),
    "int8kv-fp8q": ("int8", "fp8", dict(causal=True)),
}


@pytest.mark.parametrize("name", sorted(QUANT_D256_CASES))
def test_flash_forward_quantized_d256_variants_match_jax(name):
    mode, q_kind, kw = QUANT_D256_CASES[name]
    i8c = q_kind == "int8" and mode == "int8"
    q, k, v = make_qkv(1, 4, 256, D, kv_heads=2, seed=34)

    def quantized(x, kind, side):
        if side == "jax":
            xb = jnp.asarray(x, jnp.bfloat16)
            return xb if kind == "bf16" else jax_quant.quantize_kv(xb, kind)
        xb = torch.from_numpy(x).bfloat16()
        return xb if kind == "bf16" else quantize_kv(xb, kind)

    def fp32(x):
        if isinstance(x, jax_quant.QTensor):
            return jax_quant.dequantize(dataclasses.replace(x, orig_dtype=jnp.float32))
        return x.astype(jnp.float32)

    jq, jk, jv = quantized(q, q_kind, "jax"), quantized(k, mode, "jax"), quantized(v, mode, "jax")
    jcfg = JaxKernelConfig(block_q=128, block_kv=128, d_head=D, scale_q=False,
                           optimized_softmax=not kw.get("window"), **kw)
    want = jax_flash_quant(jq, jk, jv, jcfg, int8_compute=i8c)
    ref32 = jax_reference(*(fp32(x) for x in (jq, jk, jv)), causal=True, q_offset=0,
                          window=kw.get("window", 0), softcap=kw.get("attn_softcap", 0.0))
    got = flash_forward_quantized(quantized(q, q_kind, "port"), quantized(k, mode, "port"),
                                  quantized(v, mode, "port"), KernelConfig(d_head=D, **kw),
                                  int8_compute=i8c)
    assert got.shape == (1, 4, 256, D) and bool(torch.isfinite(got).all())
    if i8c:
        got = got.float().numpy()
        assert np.abs(got - np.asarray(want, np.float32)).max() <= 2e-2
        assert np.abs(got - np.asarray(ref32, np.float32)).max() <= 4e-2
    else:
        _bands_ok(got, want, ref32)


def test_paged_decode_d256_matches_jax():
    """Three sequences (lengths 1, 40, 90) over shuffled pages of 32 rows;
    slots no sequence owns hold NaN."""
    page, heads, kv_heads, lengths = 32, 4, 2, [1, 40, 90]
    rng = np.random.default_rng(33)
    num_pages, per_seq = 8, 3
    k = np.full((kv_heads, num_pages, page, D), np.nan, np.float32)
    v = np.full_like(k, np.nan)
    tables = -np.ones((len(lengths), per_seq), np.int32)
    perm, nxt = rng.permutation(num_pages), 0
    for b, n in enumerate(lengths):
        for i in range(-(-n // page)):
            tables[b, i], nxt = perm[nxt], nxt + 1
            rows = min(page, n - i * page)
            k[:, tables[b, i], :rows] = rng.standard_normal((kv_heads, rows, D))
            v[:, tables[b, i], :rows] = rng.standard_normal((kv_heads, rows, D))
    q = rng.standard_normal((len(lengths), heads, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    jax_pa._build_decode_call.cache_clear()
    want = np.asarray(jax_pa.paged_decode_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jnp.asarray(lens),
        jnp.asarray(tables)), np.float32)
    jax_pa._build_decode_call.cache_clear()
    qr, kr, vr = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in (q, k, v))
    ref32 = np.zeros_like(qr)
    for b, n in enumerate(lengths):
        pages = tables[b, :-(-n // page)]
        kb = kr[:, pages].reshape(kv_heads, -1, D)[None, :, :n]
        vb = vr[:, pages].reshape(kv_heads, -1, D)[None, :, :n]
        ref32[b] = np.asarray(jax_reference(
            jnp.asarray(qr[b][None, :, None]), jnp.asarray(kb), jnp.asarray(vb),
            causal=True, q_offset=n - 1))[0, :, 0]
    got = paged_decode_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                                 torch.from_numpy(lens), torch.from_numpy(tables))
    assert got.shape == (len(lengths), heads, D) and bool(torch.isfinite(got).all())
    ok, ratio, where = sliced_tolerance_check(
        got, torch.from_numpy(want).bfloat16(), torch.from_numpy(ref32), lead=1)
    assert ok, (ratio, where)


@pytest.mark.parametrize("d", [64, 192])
def test_plain_versions_refuse_other_widths(d):
    x = torch.zeros((1, 2, 128, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        flash_forward(x, x, x, KernelConfig(d_head=d))
    with pytest.raises(ValueError, match="multiple of 128"):
        paged_decode_attention(x[:, :, 0], x[0][:, None, :32].expand(2, 2, 32, d).contiguous(),
                               x[0][:, None, :32].expand(2, 2, 32, d).contiguous(),
                               torch.ones(1, dtype=torch.int32),
                               torch.zeros((1, 1), dtype=torch.int32))
