"""The port's flash_forward_quantized (plain path on the CPU) vs the JAX kernel.

The same seeded numpy inputs in bf16 (b 1, 4 Q / 2 KV heads, s 256, d 128)
are quantized by both packages, whose bytes must be equal, and go through
the port's ``flash_forward_quantized`` and the JAX package's Pallas kernel
in interpret mode (``KernelConfig(block_q=128, block_kv=128,
scale_q=False)``: the port, like that path, scales the fp32 scores).

Tolerances. Upcast modes: the adaptive rule in each (batch, head, 64-row
band), with both references from the JAX side: the JAX kernel is the
native reference, the JAX ``reference_attention`` in fp32 on the inputs
dequantized in fp32 the fp32 one. ``int8_compute``: within 2e-2 of the
JAX int8 kernel (both round P to int8 against the same group max; the
rare rounding that differs moves a weight by 1/127), and within the JAX
test's own bounds of the bf16 reference on the dequantized inputs (2.5e-2
non-causal, 4e-2 causal: P is rounded to 1/254 of each row's max weight,
``tests/test_quant.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.ops import quant as jax_quant
from flash_attention_from_scratch_tpu.ops.configs import KernelConfig as JaxKernelConfig
from flash_attention_from_scratch_tpu.ops.flash_quant import (
    flash_forward_quantized as jax_flash_quant,
)
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
    I8_P_GROUP, flash_forward_quantized,
)
from flash_attention_from_scratch_tpu_torch.ops.quant import QTensor, quantize_kv
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    make_qkv, row_bands, sliced_tolerance_check,
)

MODES = ["int8", "fp8", "int4"]
Q_KINDS = ["bf16", "int8", "fp8"]


def _bytes(x):
    """Stored values as comparable numpy bytes (fp8 as its bit patterns)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if str(x.dtype).startswith("float8") else x


def _inputs(heads=4, kv_heads=2, seed=21, seq=256):
    return make_qkv(1, heads, seq, kv_heads=kv_heads, seed=seed)


def _quantized(x, kind, side):
    """x (numpy fp32) in bf16, quantized as ``kind`` by one package."""
    if side == "jax":
        xb = jnp.asarray(x, jnp.bfloat16)
        return xb if kind == "bf16" else jax_quant.quantize_kv(xb, kind)
    xb = torch.from_numpy(x).bfloat16()
    return xb if kind == "bf16" else quantize_kv(xb, kind)


def _jax_fp32(x):
    """A JAX QTensor dequantized in fp32 (a dense input: upcast)."""
    if isinstance(x, jax_quant.QTensor):
        return jax_quant.dequantize(dataclasses.replace(x, orig_dtype=jnp.float32))
    return x.astype(jnp.float32)


@pytest.mark.parametrize("mode", MODES)
def test_qtensor_bytes_match_jax(mode):
    """Q, K and V of the parity cases quantize to the JAX package's bytes."""
    for x in _inputs():
        got, want = _quantized(x, mode, "port"), _quantized(x, mode, "jax")
        np.testing.assert_array_equal(_bytes(got.values), _bytes(want.values))
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


# name: (K/V mode, Q kind, mask and score options, heads, kv_heads)
CASES = {f"{mode}-q{qk}-{'causal' if causal else 'full'}": (mode, qk, dict(causal=causal), 4, 2)
         for mode in MODES for qk in Q_KINDS for causal in (False, True)}
CASES.update({
    "int8-qbf16-window": ("int8", "bf16", dict(causal=True, window=64), 4, 2),
    "int4-qfp8-window": ("int4", "fp8", dict(causal=True, window=100), 4, 2),
    "fp8-qbf16-softcap": ("fp8", "bf16", dict(causal=True, attn_softcap=5.0), 4, 2),
    "int4-qint8-softcap": ("int4", "int8", dict(attn_softcap=3.0), 4, 2),
    "int8-qfp8-gqa4": ("int8", "fp8", dict(causal=True), 8, 2),
    "int4-qbf16-mha": ("int4", "bf16", {}, 2, 2),
})
# s 640: five 128-key tiles (an odd count of the CUDA kernel's 128-row Q
# tiles), causal, 4 Q heads on one KV head.
CASES.update({f"{mode}-q{qk}-s640-gqa4": (mode, qk, dict(causal=True), 4, 1, 640)
              for mode, qk in (("int8", "bf16"), ("fp8", "int8"), ("int4", "fp8"))})


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_forward_quantized_matches_jax(name):
    mode, qk, kw, heads, kv_heads, *seq = CASES[name]
    q, k, v = _inputs(heads, kv_heads, seq=seq[0] if seq else 256)
    jq, jk, jv = _quantized(q, qk, "jax"), _quantized(k, mode, "jax"), _quantized(v, mode, "jax")
    jcfg = JaxKernelConfig(block_q=128, block_kv=128, scale_q=False,
                           optimized_softmax=not kw.get("window"), **kw)
    want = jax_flash_quant(jq, jk, jv, jcfg, int8_compute=False)
    causal = kw.get("causal", False)
    ref32 = jax_reference(*(_jax_fp32(x) for x in (jq, jk, jv)), causal=causal,
                          q_offset=0 if causal else None, window=kw.get("window", 0),
                          softcap=kw.get("attn_softcap", 0.0))
    got = flash_forward_quantized(_quantized(q, qk, "port"), _quantized(k, mode, "port"),
                                  _quantized(v, mode, "port"), KernelConfig(**kw),
                                  int8_compute=False)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ok, ratio, where = sliced_tolerance_check(
        row_bands(got), row_bands(torch.from_numpy(np.asarray(want, np.float32)).bfloat16()),
        row_bands(torch.from_numpy(np.asarray(ref32))), lead=3)
    assert ok, (name, ratio, where)


@pytest.mark.parametrize("kw", [{}, dict(causal=True), dict(causal=True, window=100),
                                dict(causal=True, seq=640, heads=(4, 1))],
                         ids=["full", "causal", "window", "s640-gqa4"])
def test_int8_compute_matches_jax(kw):
    kw = dict(kw)
    seq, (heads, kv_heads) = kw.pop("seq", 256), kw.pop("heads", (4, 2))
    q, k, v = _inputs(heads, kv_heads, seq=seq)
    jq, jk, jv = (_quantized(x, "int8", "jax") for x in (q, k, v))
    jcfg = JaxKernelConfig(block_q=128, block_kv=I8_P_GROUP, scale_q=False,
                           optimized_softmax=not kw.get("window"), **kw)
    want = np.asarray(jax_flash_quant(jq, jk, jv, jcfg), np.float32)  # int8 auto-on
    causal = kw.get("causal", False)
    oracle = np.asarray(jax_reference(
        *(jax_quant.dequantize(x) for x in (jq, jk, jv)), causal=causal,
        q_offset=0 if causal else None, window=kw.get("window", 0)), np.float32)
    pq, pk, pv = (_quantized(x, "int8", "port") for x in (q, k, v))
    got = flash_forward_quantized(pq, pk, pv, KernelConfig(**kw))  # int8 auto-on
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2e-2
    assert np.abs(got - oracle).max() <= (4e-2 if causal else 2.5e-2)
    # The upcast path on the same tensors is another function: it differs.
    up = flash_forward_quantized(pq, pk, pv, KernelConfig(**kw), int8_compute=False)
    assert not torch.equal(up.float(), torch.from_numpy(got))


def _small(mode, heads=2, seq=128, d=128):
    x = torch.zeros((1, heads, seq, d), dtype=torch.bfloat16)
    return x if mode == "bf16" else quantize_kv(x, mode)


BAD = {
    "kv_modes_differ": (lambda: (_small("bf16"), _small("int8"), _small("int4")), {}),
    "int4_q": (lambda: (_small("int4"), _small("int8"), _small("int8")), {}),
    "int8_compute_bf16_q": (lambda: (_small("bf16"), _small("int8"), _small("int8")),
                            dict(int8_compute=True)),
    "int8_compute_fp8_kv": (lambda: (_small("int8"), _small("fp8"), _small("fp8")),
                            dict(int8_compute=True)),
    "gqa_indivisible": (lambda: (_small("bf16", heads=3), _small("int8"), _small("int8")), {}),
    "seq_q": (lambda: (_small("bf16", seq=64), _small("int8"), _small("int8")), {}),
    "seq_kv": (lambda: (_small("bf16"), _small("int8", seq=192), _small("int8", seq=192)), {}),
    "d_head": (lambda: (_small("bf16", d=64), _small("int8", d=64), _small("int8", d=64)), {}),
    "q_offset": (lambda: (_small("bf16"), _small("int8"), _small("int8")),
                 dict(cfg=KernelConfig(causal=True, q_offset=128))),
    "int8_compute_softcap": (lambda: (_small("int8"), _small("int8"), _small("int8")),
                             dict(cfg=KernelConfig(attn_softcap=30.0))),
    "q_dtype": (lambda: (_small("bf16").float(), _small("int8"), _small("int8")),
                dict(cfg=KernelConfig())),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_flash_forward_quantized_rejects(name):
    make, kw = BAD[name]
    q, k, v = make()
    with pytest.raises(ValueError):
        flash_forward_quantized(q, k, v, kw.get("cfg"), int8_compute=kw.get("int8_compute"))


def test_quantized_q_keeps_its_strides():
    """A quantized Q given as a transposed view: the output has its strides."""
    q, k, v = _inputs()
    qq = quantize_kv(torch.from_numpy(q).bfloat16(), "int8")
    strided = QTensor(qq.values.transpose(1, 2).contiguous().transpose(1, 2), qq.scales,
                      "int8")
    kq, vq = (quantize_kv(torch.from_numpy(x).bfloat16(), "int8") for x in (k, v))
    out = flash_forward_quantized(strided, kq, vq, int8_compute=False)
    assert out.stride() == strided.values.stride()
    assert torch.equal(out, flash_forward_quantized(qq, kq, vq, int8_compute=False))
