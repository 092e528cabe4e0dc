"""The port's flash backward at head width 256 (plain path on the CPU) vs the
JAX kernels.

The JAX package's backward kernels take any head width that is a multiple
of 128; the port's K2 and K3 take 128 and 256 on the card, and its plain
version, which they are held to there, any multiple of 128. Same seeded
numpy inputs at d 256 in bf16 (b 1, 2 Q heads over 1 KV head, 128-256 rows:
causal, a window of 64, softcap 50, a q_offset). The JAX side runs
``flash_forward_with_lse`` (``scale_q=False``) for O and the LSE, then its
backward kernels in interpret mode, fused (K2) and split (K3); the port's
``flash_backward`` gets the same O and LSE. Tolerance: the adaptive rule with
both references from the JAX side (the JAX kernel in bf16, ``jax.grad`` of
the JAX ``reference_attention`` in fp32 on the same bf16-rounded inputs), in
each 64-row band on its own: dQ by (batch, head, band), dK/dV by (batch,
kv_head, band).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.ops.configs import (
    DType as JaxDType, KernelConfig as JaxKernelConfig,
)
from flash_attention_from_scratch_tpu.ops.flash_backward import (
    flash_backward as jax_flash_backward,
)
from flash_attention_from_scratch_tpu.ops.flash_forward import (
    flash_forward_with_lse as jax_flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_backward import flash_backward
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    make_qkv, row_bands, sliced_tolerance_check,
)

D = 256
# name: (seq_q, seq_kv, mask/score options), b 1, 2/1 heads
CASES = {
    "causal": (256, 256, dict(causal=True)),
    "window": (256, 256, dict(causal=True, window=64)),
    "softcap": (128, 128, dict(causal=True, attn_softcap=50.0)),
    "q_offset": (128, 256, dict(causal=True, q_offset=128)),
}


def _jax_cfg(kw):
    return JaxKernelConfig(block_q=128, block_kv=128, dtype=JaxDType.BF16, d_head=D,
                           scale_q=False, optimized_softmax=not kw.get("window"), **kw)


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def _inputs(name):
    sq, skv, kw = CASES[name]
    q, k, v = make_qkv(1, 2, sq, D, kv_heads=1, seq_kv=skv, seed=41)
    do = np.random.default_rng(42).standard_normal(q.shape).astype(np.float32)
    return (q, k, v, do), kw


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    (q, k, v, _), kw = _inputs(name)
    return jax_flash_forward_with_lse(_bf16(q), _bf16(k), _bf16(v), _jax_cfg(kw))


@functools.lru_cache(maxsize=None)
def _jax_fp32_grads(name):
    """jax.grad of the JAX reference in fp32 on the bf16-rounded inputs."""
    (q, k, v, do), kw = _inputs(name)
    do32 = _bf16(do).astype(jnp.float32)
    causal = kw.get("causal", False)
    ref_kw = dict(causal=causal, q_offset=kw.get("q_offset", 0) if causal else None,
                  window=kw.get("window", 0), softcap=kw.get("attn_softcap", 0.0))

    def loss(q, k, v):
        return jnp.sum(jax_reference(q, k, v, **ref_kw) * do32)

    args = [_bf16(x).astype(jnp.float32) for x in (q, k, v)]
    return [torch.from_numpy(np.array(g)) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_backward_d256_matches_jax(name, fused):
    (q, k, v, do), kw = _inputs(name)
    out, lse = _jax_forward(name)
    want16 = jax_flash_backward(_bf16(q), _bf16(k), _bf16(v), out, lse, _bf16(do),
                                _jax_cfg(kw), fused=fused)
    got = flash_backward(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(np.asarray(out, np.float32)).bfloat16(),
        torch.from_numpy(np.array(lse)), torch.from_numpy(do).bfloat16(),
        KernelConfig(d_head=D, **kw), fused=fused)
    for which, g, w16, w32 in zip(("dq", "dk", "dv"), got, want16, _jax_fp32_grads(name)):
        assert g.shape == w32.shape and g.dtype == torch.bfloat16, which
        ok, ratio, where = sliced_tolerance_check(
            row_bands(g), row_bands(torch.from_numpy(np.asarray(w16, np.float32)).bfloat16()),
            row_bands(w32), lead=3)
        assert ok, (name, which, ratio, where)
