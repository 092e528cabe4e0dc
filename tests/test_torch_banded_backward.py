"""The banded causal backward, ``flash_backward(..., bands=n)``, on the CPU.

The same numpy-seeded inputs in bf16 go to the JAX package's banded
backward (its fused kernel per call, in interpret mode) and to the port's
(K2's plain version per call), both from the JAX forward's O and LSE. Each
gradient passes the adaptive rule in each 64-row band against the JAX
banded gradients, with ``jax.grad`` of the JAX ``reference_attention`` in
fp32 on the same bf16-rounded inputs as the fp32 reference; the same rule
holds against the port's monolithic backward. The calls the JAX guard
sends elsewhere (a window, ``q_offset``, ``fused=False``, one band) equal
the path without ``bands`` bit for bit; a band count that does not divide
the sequence raises; a call makes 2 bands - 1 K2 calls, on the shapes
``banded_calls`` names.
"""

import dataclasses
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
from flash_attention_from_scratch_tpu_torch.ops import flash_backward as fb
from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    make_qkv, row_bands, sliced_tolerance_check,
)

BATCH, HEADS, KV_HEADS, SEQ = 1, 2, 1, 512
JAX_CFG = JaxKernelConfig(block_q=128, block_kv=128, dtype=JaxDType.BF16, scale_q=False,
                          causal=True)
CFG = KernelConfig(causal=True)


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _inputs():
    q, k, v = make_qkv(BATCH, HEADS, SEQ, kv_heads=KV_HEADS, seed=31)
    do = np.random.default_rng(32).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv, jdo = (_bf16(x) for x in (q, k, v, do))
    o, lse = jax_flash_forward_with_lse(jq, jk, jv, JAX_CFG)
    return (jq, jk, jv, jdo, o, lse)


def _torch(x):
    x = np.array(jnp.asarray(x, jnp.float32))
    return torch.from_numpy(x)


def _port_inputs():
    jq, jk, jv, jdo, o, lse = _inputs()
    return [_torch(x).bfloat16() for x in (jq, jk, jv, o)] + [
        _torch(lse), _torch(jdo).bfloat16()]


@functools.lru_cache(maxsize=None)
def _jax_banded(bands):
    jq, jk, jv, jdo, o, lse = _inputs()
    grads = jax_flash_backward(jq, jk, jv, o, lse, jdo,
                               dataclasses.replace(JAX_CFG, decompose=True), bands=bands)
    return [torch.from_numpy(np.array(g, np.float32)).bfloat16() for g in grads]


@functools.lru_cache(maxsize=None)
def _jax_fp32():
    jq, jk, jv, jdo, _, _ = _inputs()
    args = [x.astype(jnp.float32) for x in (jq, jk, jv)]
    do32 = jdo.astype(jnp.float32)

    def loss(q, k, v):
        return jnp.sum(jax_reference(q, k, v, causal=True, q_offset=0) * do32)

    return [torch.from_numpy(np.array(g)) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port(cfg=CFG, **kw):
    q, k, v, o, lse, do = _port_inputs()
    return fb.flash_backward(q, k, v, o, lse, do, cfg, **kw)


def _check(got, want16, want32, what):
    for name, g, w16, w32 in zip(("dq", "dk", "dv"), got, want16, want32):
        assert g.shape == w32.shape and g.dtype == torch.bfloat16, (what, name)
        ok, ratio, where = sliced_tolerance_check(row_bands(g), row_bands(w16),
                                                  row_bands(w32), lead=3)
        assert ok, f"{what} d{name[1]}: err/bound {ratio:.3f} at (batch, head, band) {where}"


@pytest.mark.parametrize("bands", [2, 4])
def test_banded_backward_matches_jax(bands):
    """The port's banded backward against the JAX package's, and against
    the port's monolithic backward, by the per-band adaptive rule."""
    got = _port(bands=bands)
    _check(got, _jax_banded(bands), _jax_fp32(), f"bands {bands} vs JAX banded")
    _check(got, _port(), _jax_fp32(), f"bands {bands} vs the monolithic backward")


@pytest.mark.parametrize("bands", [2, 4])
def test_banded_backward_makes_2n_minus_1_k2_calls(monkeypatch, bands):
    """Each band runs K2 on its diagonal square (causal) and, past band 0,
    on its past keys (no mask): 2 bands - 1 calls, in ``banded_calls``'
    order and shapes."""
    seen = []
    real = fb._fused_call

    def counting(q, k, v, lse, dsum, do, cfg, scale):
        seen.append((q.shape[2], k.shape[2], cfg.causal))
        return real(q, k, v, lse, dsum, do, cfg, scale)

    monkeypatch.setattr(fb, "_fused_call", counting)
    _port(bands=bands)
    assert len(seen) == 2 * bands - 1
    assert seen == [(SEQ // bands, end - kv0, causal)
                    for _, kv0, end, causal in fb.banded_calls(SEQ, bands)]


@pytest.mark.parametrize("case", ["window", "q_offset", "split", "one band"])
def test_banded_guard_falls_through_bit_for_bit(monkeypatch, case):
    """Where the JAX guard does not band, ``bands`` changes nothing: the
    same gradients as without it, bit for bit, and no K2 call."""
    monkeypatch.setattr(fb, "_fused_call", lambda *a: pytest.fail("banded"))
    q, k, v, o, lse, do = _port_inputs()
    cfg, kw, bands = CFG, {}, 2
    if case == "window":
        cfg = KernelConfig(causal=True, window=64)
    elif case == "q_offset":  # the last 256 rows against all 512 keys
        cfg = KernelConfig(causal=True, q_offset=256)
        q, o, lse, do = (x[:, :, 256:] for x in (q, o, lse, do))
    elif case == "split":
        kw = dict(fused=False)
    else:
        bands = 1
    got = fb.flash_backward(q, k, v, o, lse, do, cfg, bands=bands, **kw)
    want = fb.flash_backward(q, k, v, o, lse, do, cfg, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("bands", [3, 0, 1024])
def test_bands_must_divide_the_sequence(bands):
    """The JAX package drops the last seq % bands rows' gradients; the port
    refuses the call."""
    with pytest.raises(ValueError, match="bands"):
        _port(bands=bands)


def test_band_count_is_jax():
    from flash_attention_from_scratch_tpu.ops.flash_backward import _bwd_band_count

    for seq in (512, 1024, 2048, 3072, 4096, 6144, 8192, 16384, 32768, 65536):
        for rows in (512, 1024, 2048):
            assert fb._bwd_band_count(seq, rows) == _bwd_band_count(seq, rows)
