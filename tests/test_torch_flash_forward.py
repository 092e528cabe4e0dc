"""The port's flash_forward (plain path on the CPU) vs the JAX kernel.

Same seeded numpy inputs in bf16 go to the port's ``flash_forward`` /
``flash_forward_with_lse`` and to the JAX package's Pallas kernel in
interpret mode. Tolerance: the output passes the adaptive tolerance rule
with both references from the JAX side: the port's error vs the JAX kernel
is at most 2x the JAX kernel's own error vs the JAX ``reference_attention``
in fp32 on the same bf16-rounded inputs, with an ulp floor. The rule holds
in each (batch, head, 64-row band) on its own, so a large row elsewhere
cannot lift the bound of a band of small averages. The LSE (fp32 softmax
statistics of the same fp32 scores) agrees within 1e-3. The JAX kernel runs with
``scale_q=False``: its default rounds ``Q * scale * log2(e)`` to bf16 before
QK^T, which moves its LSE by up to ~1.3e-3; the port, like the JAX
kernel's ``scale_q=False`` path, scales the fp32 scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.ops.configs import (
    DType as JaxDType, KernelConfig as JaxKernelConfig,
)
from flash_attention_from_scratch_tpu.ops.flash_forward import (
    flash_forward as jax_flash_forward,
    flash_forward_with_lse as jax_flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
    flash_forward, flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    make_qkv, row_bands, sliced_tolerance_check,
)

# name: (batch, heads, kv_heads, seq_q, seq_kv, mask/score options, sinks)
CASES = {
    "full": (1, 4, 4, 128, 128, {}, False),
    "causal_gqa": (2, 4, 2, 256, 256, dict(causal=True), False),
    "q_offset": (1, 4, 2, 128, 256, dict(causal=True, q_offset=128), False),
    "window": (1, 4, 2, 256, 256, dict(causal=True, window=64), False),
    "softcap": (1, 2, 2, 128, 128, dict(causal=True, attn_softcap=5.0), False),
    "sinks": (1, 4, 2, 128, 128, dict(causal=True), True),
}


def _inputs(name):
    b, h, kvh, sq, skv, kw, with_sinks = CASES[name]
    q, k, v = make_qkv(b, h, sq, kv_heads=kvh, seq_kv=skv, seed=11)
    sinks = (np.random.default_rng(12).standard_normal(h).astype(np.float32)
             if with_sinks else None)
    return (q, k, v), kw, sinks


def _jax(name, with_lse):
    (q, k, v), kw, sinks = _inputs(name)
    cfg = JaxKernelConfig(block_q=128, block_kv=128, dtype=JaxDType.BF16,
                          scale_q=False, optimized_softmax=not kw.get("window"),
                          **kw)
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    s = None if sinks is None else jnp.asarray(sinks)
    if with_lse:
        out, lse = jax_flash_forward_with_lse(*args, cfg, sinks=s)
        return np.asarray(out, np.float32), np.asarray(lse)
    return np.asarray(jax_flash_forward(*args, cfg, sinks=s), np.float32), None


def _jax_fp32(name):
    """The JAX reference in fp32 on the bf16-rounded inputs, with an
    explicit q_offset (its default aligns causal masks bottom-right)."""
    (q, k, v), kw, sinks = _inputs(name)
    args = [jnp.asarray(x, jnp.bfloat16).astype(jnp.float32) for x in (q, k, v)]
    causal = kw.get("causal", False)
    out = jax_reference(
        *args, causal=causal, q_offset=kw.get("q_offset", 0) if causal else None,
        window=kw.get("window", 0), softcap=kw.get("attn_softcap", 0.0),
        sinks=None if sinks is None else jnp.asarray(sinks))
    return torch.from_numpy(np.array(out))


def _port(name):
    (q, k, v), kw, sinks = _inputs(name)
    cfg = KernelConfig(**kw)
    args = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    s = None if sinks is None else torch.from_numpy(sinks)
    out, lse = flash_forward_with_lse(*args, cfg, sinks=s)
    out_only = flash_forward(*args, cfg, sinks=s)
    return out, lse, out_only


def _check(name, out, jax_out):
    ok, ratio, where = sliced_tolerance_check(
        row_bands(out), row_bands(torch.from_numpy(jax_out).bfloat16()),
        row_bands(_jax_fp32(name)), lead=3)
    assert ok, (name, ratio, where)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_forward_with_lse_matches_jax(name):
    jax_out, jax_lse = _jax(name, with_lse=True)
    out, lse, out_only = _port(name)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, out_only)
    _check(name, out, jax_out)
    np.testing.assert_allclose(lse.numpy(), jax_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", ["causal_gqa", "sinks"])
def test_flash_forward_matches_jax(name):
    jax_out, _ = _jax(name, with_lse=False)
    _, _, out = _port(name)
    _check(name, out, jax_out)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


BAD_INPUTS = {
    "ndim": ((_bf16(4, 64, 128),) * 3, {}),
    "kv_mismatch": ((_bf16(1, 2, 64, 128), _bf16(1, 2, 64, 128),
                     _bf16(1, 2, 128, 128)), {}),
    "qk_batch": ((_bf16(2, 2, 64, 128), _bf16(1, 2, 64, 128),
                  _bf16(1, 2, 64, 128)), {}),
    "gqa_indivisible": ((_bf16(1, 3, 64, 128), _bf16(1, 2, 64, 128),
                         _bf16(1, 2, 64, 128)), {}),
    "d_head_vs_config": ((_bf16(1, 2, 64, 128),) * 3,
                         dict(cfg=KernelConfig(d_head=64))),
    "d_head_not_128": ((_bf16(1, 2, 64, 64),) * 3,
                       dict(cfg=KernelConfig(d_head=64))),
    "dtype": ((_bf16(1, 2, 64, 128),) * 3,
              dict(cfg=KernelConfig(dtype=DType.FP32))),
    "seq_q": ((_bf16(1, 2, 96, 128), _bf16(1, 2, 128, 128),
               _bf16(1, 2, 128, 128)), {}),
    "seq_kv": ((_bf16(1, 2, 64, 128), _bf16(1, 2, 96, 128),
                _bf16(1, 2, 96, 128)), {}),
    "sinks_shape": ((_bf16(1, 2, 64, 128),) * 3,
                    dict(sinks=torch.zeros(3))),
}


@pytest.mark.parametrize("name", sorted(BAD_INPUTS))
def test_flash_forward_rejects(name):
    args, kw = BAD_INPUTS[name]
    with pytest.raises(ValueError):
        flash_forward(*args, kw.get("cfg"), sinks=kw.get("sinks"))
    with pytest.raises(ValueError):
        flash_forward_with_lse(*args, kw.get("cfg"), sinks=kw.get("sinks"))


@pytest.mark.parametrize("kw", [dict(q_offset=64), dict(window=16),
                                dict(causal=True, window=-1),
                                dict(attn_softcap=-1.0),
                                dict(causal=True, q_offset=-1)])
def test_kernel_config_rejects(kw):
    with pytest.raises(ValueError):
        KernelConfig(**kw)
