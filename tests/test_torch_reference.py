"""The port's reference attention and tolerance rule vs the JAX package's.

Same numpy inputs (seeded) go to both packages in fp32. Tolerance: atol
1e-5 on outputs of magnitude ~1: both sides compute fp32 products of the
same values and differ only in summation order (~1e-6 over 128-256 terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu.utils.testing import (
    adaptive_tolerance_check as jax_rule,
)
from flash_attention_from_scratch_tpu_torch.ops.reference import (
    reference_attention, reference_pair,
)
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    adaptive_tolerance_check, error_stats, make_qkv, sliced_tolerance_check,
)

CASES = {
    "full": dict(seq_q=128, kw={}),
    "gqa_causal": dict(seq_q=128, kv_heads=2, kw=dict(causal=True)),
    "bottom_right": dict(seq_q=64, seq_kv=128, kw=dict(causal=True)),
    "q_offset": dict(seq_q=64, seq_kv=192, kw=dict(causal=True, q_offset=128)),
    "window": dict(seq_q=256, kv_heads=2, kw=dict(causal=True, window=48)),
    "softcap": dict(seq_q=128, kw=dict(causal=True, softcap=5.0)),
    "sinks": dict(seq_q=128, kv_heads=1, kw=dict(causal=True), sinks=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_fp32(name):
    case = CASES[name]
    q, k, v = make_qkv(2, 4, case["seq_q"], kv_heads=case.get("kv_heads"),
                       seq_kv=case.get("seq_kv"), seed=3)
    kw = dict(case["kw"])
    sinks = (np.random.default_rng(4).standard_normal(4).astype(np.float32)
             if case.get("sinks") else None)
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         sinks=None if sinks is None else jnp.asarray(sinks), **kw)
    got = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              sinks=None if sinks is None else torch.from_numpy(sinks),
                              **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_reference_pair_dtypes():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in make_qkv(1, 2, 64))
    native, fp32 = reference_pair(q, k, v, causal=True)
    assert native.dtype == torch.bfloat16 and fp32.dtype == torch.float32
    assert error_stats(native, fp32).max_abs_diff < 0.05


@pytest.mark.parametrize("noise", [0.0, 2e-3, 5e-2])
def test_tolerance_rule_matches_jax(noise):
    """Same arrays through both rules: same verdict and the same errors."""
    rng = np.random.default_rng(5)
    ref32 = rng.standard_normal((2, 4, 64, 128)).astype(np.float32)
    ref16 = np.asarray(jnp.asarray(ref32, jnp.bfloat16), np.float32)
    out = ref16 + noise * rng.standard_normal(ref16.shape).astype(np.float32)
    out16 = np.asarray(jnp.asarray(out, jnp.bfloat16), np.float32)
    want = jax_rule(jnp.asarray(out16, jnp.bfloat16),
                    jnp.asarray(ref16, jnp.bfloat16), jnp.asarray(ref32))
    got = adaptive_tolerance_check(torch.from_numpy(out16).bfloat16(),
                                   torch.from_numpy(ref16).bfloat16(),
                                   torch.from_numpy(ref32))
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)


def test_sliced_rule_holds_each_slice():
    """A slice of large values must not lift the bound of a slice of small
    ones: an error that one rule over the whole tensor lets pass fails in
    its own slice, and each slice alone gets the whole-tensor verdict."""
    rng = np.random.default_rng(6)
    ref32 = torch.from_numpy(rng.standard_normal((3, 64, 128)).astype(np.float32))
    ref32[1] *= 0.02  # the long-sequence average beside single V rows
    ref16 = ref32.bfloat16()
    out = ref16.clone()
    out[1, 5, 7] += 0.01
    assert adaptive_tolerance_check(out, ref16, ref32)[0]
    ok, ratio, where = sliced_tolerance_check(out, ref16, ref32, lead=1)
    assert not ok and where == (1,) and ratio > 1
    for i in range(3):
        alone = adaptive_tolerance_check(out[i], ref16[i], ref32[i])[0]
        assert sliced_tolerance_check(out[i:i + 1], ref16[i:i + 1],
                                      ref32[i:i + 1], lead=1)[0] == alone
