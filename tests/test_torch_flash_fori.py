"""The port's FORI forward (``KernelConfig(kv_loop=KVLoop.FORI)``) vs the
JAX package's FORI kernel.

On the CPU the port runs the plain version, which is the same function for
both kernels; the JAX side runs its ``_fori_kernel`` (manual K/V copies
through ``num_kv_buffers`` slots) in interpret mode at block 128 with
``scale_q=False``. Tolerance as in ``test_torch_flash_forward.py``: the
adaptive rule in each (batch, head, 64-row band), the JAX kernel the
native reference and the JAX ``reference_attention`` in fp32 on the same
bf16-rounded inputs the fp32 one; the LSE within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.ops.configs import (
    DType as JaxDType, KernelConfig as JaxKernelConfig, KVLoop as JaxKVLoop,
)
from flash_attention_from_scratch_tpu.ops.flash_forward import (
    flash_forward_with_lse as jax_flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu_torch.ops.autodiff import flash_attention
from flash_attention_from_scratch_tpu_torch.ops.configs import (
    MAX_KV_BUFFERS, KernelConfig, KVLoop,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
    flash_forward, flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    make_qkv, row_bands, sliced_tolerance_check,
)

# name: (heads, kv_heads, seq_q, seq_kv, mask options, sinks)
CASES = {
    "causal": (4, 2, 256, 256, dict(causal=True), False),
    "q_offset": (4, 2, 128, 256, dict(causal=True, q_offset=128), False),
    "window": (4, 2, 256, 256, dict(causal=True, window=100), False),
    "sinks": (4, 2, 256, 256, dict(causal=True), True),
    "full": (4, 4, 256, 256, {}, False),
    # seq_q 192: the CUDA kernel's second 64-row warpgroup of the last
    # 128-row Q tile lies past the end (the JAX kernel runs 64-row blocks).
    "ragged": (4, 2, 192, 256, {}, False),
    "ragged-q_offset": (4, 2, 192, 256, dict(causal=True, q_offset=64), False),
}


def _inputs(name):
    h, kvh, sq, skv, kw, with_sinks = CASES[name]
    q, k, v = make_qkv(1, h, sq, kv_heads=kvh, seq_kv=skv, seed=31)
    sinks = (np.random.default_rng(32).standard_normal(h).astype(np.float32)
             if with_sinks else None)
    return (q, k, v), kw, sinks


@pytest.mark.parametrize("nbuf", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fori_matches_jax_fori_kernel(name, nbuf):
    (q, k, v), kw, sinks = _inputs(name)
    jcfg = JaxKernelConfig(block_q=64 if q.shape[2] % 128 else 128, block_kv=128,
                           dtype=JaxDType.BF16,
                           scale_q=False, kv_loop=JaxKVLoop.FORI, num_kv_buffers=nbuf,
                           optimized_softmax=not kw.get("window"), **kw)
    js = None if sinks is None else jnp.asarray(sinks)
    jout, jlse = jax_flash_forward_with_lse(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jcfg, sinks=js)
    causal = kw.get("causal", False)
    ref32 = jax_reference(
        *(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32) for x in (q, k, v)),
        causal=causal, q_offset=kw.get("q_offset", 0) if causal else None,
        window=kw.get("window", 0), sinks=js)

    cfg = KernelConfig(kv_loop=KVLoop.FORI, num_kv_buffers=nbuf, **kw)
    args = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    s = None if sinks is None else torch.from_numpy(sinks)
    out, lse = flash_forward_with_lse(*args, cfg, sinks=s)
    assert torch.equal(out, flash_forward(*args, cfg, sinks=s))
    ok, ratio, where = sliced_tolerance_check(
        row_bands(out), row_bands(torch.from_numpy(np.asarray(jout, np.float32)).bfloat16()),
        row_bands(torch.from_numpy(np.array(ref32))), lead=3)
    assert ok, (name, nbuf, ratio, where)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-3, rtol=0)


@pytest.mark.parametrize("nbuf", [0, MAX_KV_BUFFERS + 1, -1])
def test_num_kv_buffers_out_of_range_raises(nbuf):
    with pytest.raises(ValueError, match="num_kv_buffers"):
        KernelConfig(kv_loop=KVLoop.FORI, num_kv_buffers=nbuf)


def test_kv_loop_must_be_a_kvloop():
    with pytest.raises(ValueError, match="kv_loop"):
        KernelConfig(kv_loop="fori")


@pytest.mark.parametrize("with_sinks", [False, True], ids=["plain", "sinks"])
def test_flash_attention_gradients_with_fori_config(with_sinks):
    """flash_attention with a FORI config: the same outputs and gradients as
    with the default config (on the CPU both run the plain version; on the
    card the forward runs K11 instead of K1)."""
    q, k, v = make_qkv(1, 4, 128, kv_heads=2, seed=33)
    do = torch.from_numpy(np.random.default_rng(34).standard_normal(q.shape).astype(
        np.float32)).bfloat16()
    z = torch.linspace(-1, 1, 4) if with_sinks else None

    def grads(cfg):
        leaves = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
        sinks = z.clone().requires_grad_() if with_sinks else None
        out = flash_attention(*leaves, cfg, sinks)
        wrt = leaves + ([sinks] if with_sinks else [])
        return [out, *torch.autograd.grad(out, wrt, do)]

    base = grads(KernelConfig(causal=True, window=50))
    for nbuf in (1, 3):
        got = grads(KernelConfig(causal=True, window=50, kv_loop=KVLoop.FORI,
                                 num_kv_buffers=nbuf))
        for a, b in zip(got, base):
            assert torch.equal(a, b)
