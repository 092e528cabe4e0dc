"""The port's flash backward (plain path on the CPU) vs the JAX kernels.

Same seeded numpy inputs in bf16. The JAX side runs ``flash_forward_with_lse``
(``scale_q=False``, see tests/test_torch_flash_forward.py) for O and the LSE,
then its backward kernels in interpret mode, fused (K2) and split (K3); the
port's ``flash_backward`` gets the same O and LSE. Tolerance: each gradient
passes the adaptive tolerance rule with both references from the JAX side:
the port's error vs the JAX kernel is at most 2x the JAX kernel's own error
vs ``jax.grad`` of the JAX ``reference_attention`` in fp32 on the same
bf16-rounded inputs (with an explicit ``q_offset``), with an ulp floor. The
rule holds in each 64-row band on its own: dQ by (batch, head, band), dK/dV
by (batch, kv_head, band), so the large rows of one band cannot lift the
bound of another.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.ops.autodiff import (
    flash_attention as jax_flash_attention,
)
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
from flash_attention_from_scratch_tpu_torch.ops.autodiff import flash_attention
from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
    flash_backward, fused_choice,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
    flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    adaptive_tolerance_check, make_qkv, row_bands, sliced_tolerance_check,
)

# name: (batch, heads, kv_heads, seq_q, seq_kv, mask/score options)
CASES = {
    "full": (1, 4, 4, 128, 128, {}),
    "causal_gqa": (2, 4, 2, 256, 256, dict(causal=True)),
    "q_offset": (1, 4, 2, 128, 256, dict(causal=True, q_offset=128)),
    "window": (1, 4, 2, 256, 256, dict(causal=True, window=64)),
    "softcap": (1, 2, 2, 128, 128, dict(causal=True, attn_softcap=5.0)),
}


def _jax_cfg(kw):
    return JaxKernelConfig(block_q=128, block_kv=128, dtype=JaxDType.BF16,
                           scale_q=False, optimized_softmax=not kw.get("window"),
                           **kw)


def _inputs(name):
    b, h, kvh, sq, skv, kw = CASES[name]
    q, k, v = make_qkv(b, h, sq, kv_heads=kvh, seq_kv=skv, seed=21)
    do = np.random.default_rng(22).standard_normal(q.shape).astype(np.float32)
    return (q, k, v, do), kw


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    (q, k, v, _), kw = _inputs(name)
    out, lse = jax_flash_forward_with_lse(_bf16(q), _bf16(k), _bf16(v),
                                          _jax_cfg(kw))
    return out, lse


def _jax_grads(name, fused):
    (q, k, v, do), kw = _inputs(name)
    out, lse = _jax_forward(name)
    return [np.array(g, np.float32) for g in jax_flash_backward(
        _bf16(q), _bf16(k), _bf16(v), out, lse, _bf16(do), _jax_cfg(kw),
        fused=fused)]


def _reference_kw(kw):
    causal = kw.get("causal", False)
    return dict(causal=causal,
                q_offset=kw.get("q_offset", 0) if causal else None,
                window=kw.get("window", 0), softcap=kw.get("attn_softcap", 0.0))


@functools.lru_cache(maxsize=None)
def _jax_fp32_grads(name):
    """jax.grad of the JAX reference in fp32 on the bf16-rounded inputs."""
    (q, k, v, do), kw = _inputs(name)
    args = [_bf16(x).astype(jnp.float32) for x in (q, k, v)]
    do32 = _bf16(do).astype(jnp.float32)

    def loss(q, k, v):
        return jnp.sum(jax_reference(q, k, v, **_reference_kw(kw)) * do32)

    return [torch.from_numpy(np.array(g)) for g in
            jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _check_bands(name, got, want16, want32):
    for which, g, w16, w32 in zip(("dq", "dk", "dv"), got, want16, want32):
        assert g.shape == w32.shape and g.dtype == torch.bfloat16, which
        ok, ratio, where = sliced_tolerance_check(
            row_bands(g), row_bands(torch.from_numpy(w16).bfloat16()),
            row_bands(w32), lead=3)
        assert ok, (name, which, ratio, where)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_backward_matches_jax(name, fused):
    (q, k, v, do), kw = _inputs(name)
    out, lse = _jax_forward(name)
    got = flash_backward(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(np.asarray(out, np.float32)).bfloat16(),
        torch.from_numpy(np.array(lse)), torch.from_numpy(do).bfloat16(),
        KernelConfig(**kw), fused=fused)
    _check_bands(name, got, _jax_grads(name, fused), _jax_fp32_grads(name))


def _check_sink_grad(got, ref16, ref32):
    """The JAX package's rule for d(sink) (tests/test_backward.py): the
    adaptive rule, or within 2% of the gradient's scale. Both sides rebuild
    D = rowsum(dO * O) from the saved bf16 O, which the fp32 reference never
    rounds, so the baseline alone can sit below that noise floor."""
    ok, kerr, berr = adaptive_tolerance_check(got, ref16, ref32)
    assert ok or kerr <= max(2 * berr, 0.02 * float(ref32.abs().max())), (
        kerr, berr)


def test_flash_attention_autograd_with_sinks_matches_jax():
    """dq, dk, dv and d(sinks) through autograd vs jax.grad of the JAX
    custom_vjp, causal GQA with per-head sinks."""
    b, h, kvh, s = 1, 4, 2, 256
    q, k, v = make_qkv(b, h, s, kv_heads=kvh, seed=31)
    do = np.random.default_rng(32).standard_normal(q.shape).astype(np.float32)
    z = np.linspace(-0.5, 1.5, h).astype(np.float32)

    jcfg = _jax_cfg(dict(causal=True))
    jdo = _bf16(do)

    def jax_loss(q, k, v, z):
        return jnp.sum(jax_flash_attention(q, k, v, jcfg, None, z) * jdo)

    want16 = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        _bf16(q), _bf16(k), _bf16(v), jnp.asarray(z))

    def ref_loss(q, k, v, z):
        out = jax_reference(q, k, v, causal=True, q_offset=0, sinks=z)
        return jnp.sum(out * jdo.astype(jnp.float32))

    want32 = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        *(_bf16(x).astype(jnp.float32) for x in (q, k, v)), jnp.asarray(z))

    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    tz = torch.from_numpy(z).requires_grad_()
    out = flash_attention(tq, tk, tv, KernelConfig(causal=True), tz)
    grads = torch.autograd.grad(out, (tq, tk, tv, tz),
                                torch.from_numpy(do).bfloat16())
    w16 = [np.array(g, np.float32) for g in want16]
    w32 = [torch.from_numpy(np.array(g)) for g in want32]
    _check_bands("sinks", grads[:3], w16[:3], w32[:3])
    assert grads[3].dtype == torch.float32 and grads[3].shape == (h,)
    _check_sink_grad(grads[3], torch.from_numpy(w16[3]), w32[3])


def test_flash_attention_without_sinks_matches_backward():
    """Autograd through flash_attention gives flash_backward's gradients on
    the forward's own O and LSE."""
    (q, k, v, do), kw = _inputs("causal_gqa")
    cfg = KernelConfig(**kw)
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    tdo = torch.from_numpy(do).bfloat16()
    out = flash_attention(tq, tk, tv, cfg)
    got = torch.autograd.grad(out, (tq, tk, tv), tdo)
    o, lse = flash_forward_with_lse(tq.detach(), tk.detach(), tv.detach(), cfg)
    want = flash_backward(tq.detach(), tk.detach(), tv.detach(), o, lse, tdo, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _t(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


_LSE = _t(1, 2, 64, dtype=torch.float32)

# name: (o, lse, do) for q, k, v of shape (1, 2, 64, 128)
BAD_INPUTS = {
    "o_shape": (_t(1, 2, 128, 128), _LSE, _t(1, 2, 64, 128)),
    "do_shape": (_t(1, 2, 64, 128), _LSE, _t(1, 2, 128, 128)),
    "lse_shape": (_t(1, 2, 64, 128), _t(1, 2, 32, dtype=torch.float32),
                  _t(1, 2, 64, 128)),
    "lse_dtype": (_t(1, 2, 64, 128), _t(1, 2, 64), _t(1, 2, 64, 128)),
}


@pytest.mark.parametrize("name", sorted(BAD_INPUTS))
def test_flash_backward_rejects(name):
    qkv = _t(1, 2, 64, 128)
    with pytest.raises(ValueError):
        flash_backward(qkv, qkv, qkv, *BAD_INPUTS[name])


def test_fused_choice_follows_deterministic_mode():
    """K3 while deterministic mode is on; otherwise the faster by
    measurement, K3 with the causal mask and K2 without; an explicit
    ``fused`` wins either way."""
    was = torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(False)
        assert [fused_choice(f) for f in (None, True, False)] == [False, True, False]
        assert [fused_choice(f, causal=False) for f in (None, True, False)] == [
            True, True, False]
        torch.use_deterministic_algorithms(True)
        for causal in (True, False):
            assert [fused_choice(f, causal) for f in (None, True, False)] == [
                False, True, False]
    finally:
        torch.use_deterministic_algorithms(was)


def test_flash_backward_bands_not_ported():
    """``bands`` is ported since the banded backward
    (tests/test_torch_banded_backward.py): off the JAX guard (here without
    the causal mask) it changes nothing, and a count that does not divide
    the rows raises."""
    x = _t(1, 2, 64, 128)
    want = flash_backward(x, x, x, x, _LSE, x)
    got = flash_backward(x, x, x, x, _LSE, x, bands=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="bands"):
        flash_backward(x, x, x, x, _LSE, x, bands=3)
