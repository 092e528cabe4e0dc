"""The port's quantized matmul (plain path on the CPU) vs the JAX package.

Weights and activations are seeded numpy arrays handed to both packages.
``quantize_weight``, ``quantize_activations`` (on rows that test each step
of its arithmetic: the scale floor, exact ties, an outlier, K 32 and 14336)
and ``concat_weights`` must give the same bytes and scales. The products are held against the JAX
``quant_matmul`` run through its Pallas kernels in interpret mode (K6, K7,
K8, K9), under ``jax.jit`` as the model runs them:

- a8 (W8A8, W4A8): both sides sum int8 x int8 products exactly and apply
  ``acc * xs * s`` in fp32, so the bf16 outputs may differ by at most one
  bf16 ulp of each value (the only rounding is the final cast);
- weight-only: the adaptive tolerance rule in each 16-row band, with both
  references from the JAX side: the JAX kernel's bf16 output, and the exact
  float64 product of the JAX package's quantized values and scales. The
  port's plain version and the JAX kernel sum in fp32 in different orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.ops import quant_matmul as jax_qm
from flash_attention_from_scratch_tpu_torch.ops import quant_matmul as qm
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    row_bands, sliced_tolerance_check,
)

RECIPES = [("int8", False), ("int4", False), ("int8", True), ("int4", True)]
SHAPES = [(16, 512, 256), (64, 256, 512)]  # (m, K, N)


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    w[:, 3] *= 40.0  # one column with a much larger scale
    return x, w


def _port_weight(jwq):
    return qm.QuantizedWeight(torch.from_numpy(np.array(jwq.values)),
                              torch.from_numpy(np.array(jwq.scales)),
                              jwq.mode, torch.bfloat16, jwq.act)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("act", ["bf16", "int8"])
def test_quantize_weight_bytes_match_jax(mode, act):
    _, w = _inputs(8, 256, 384, seed=0)
    w[:, 5] = 0.0  # an all-zero column: the 1e-12 scale floor
    jwq = jax_qm.quantize_weight(jnp.asarray(w, jnp.bfloat16), mode, act)
    wq = qm.quantize_weight(_bf16(w), mode, act)
    np.testing.assert_array_equal(wq.values.numpy(), np.asarray(jwq.values))
    np.testing.assert_array_equal(wq.scales.numpy(), np.asarray(jwq.scales))
    assert (wq.mode, wq.act, wq.k_dim, wq.shape) == (jwq.mode, jwq.act,
                                                     jwq.k_dim, jwq.shape)
    np.testing.assert_array_equal(wq.dequantize().float().numpy(),
                                  np.asarray(jwq.dequantize(), np.float32))


def _activation_rows(case):
    """Rows that test each step of the per-row quantization's arithmetic
    (the card's ``quantize_rows`` kernel is held to this oracle bit for
    bit)."""
    rng = np.random.default_rng(1)
    if case == "mixed":  # one row 1e-4 the others' size
        x, _ = _inputs(24, 512, 8, seed=1)
        x[2] *= 1e-4
        return x
    if case == "zero_row":  # absmax 0: the 1e-12 scale floor
        x = rng.standard_normal((4, 256)).astype(np.float32)
        x[1] = 0.0
        return x
    if case == "ties":
        # absmax 127 * 2^e gives the scale 2^e exactly (127 * fp32(1/127) is
        # 1 - 2^-28, which rounds to 1), so x = (n + 1/2) 2^e divides to
        # exact halves: half to even (rint), not away from zero (round).
        rows = []
        for e in (0, -3, 4):
            r = (rng.integers(-127, 127, 256) + 0.5) * 2.0 ** e
            r[0] = 127 * 2.0 ** e
            rows.append(r)
        return np.stack(rows).astype(np.float32)
    if case == "outlier":  # one value 1e4x the rest of its row
        x = rng.standard_normal((4, 512)).astype(np.float32)
        x[np.arange(4), [7, 100, 300, 511]] *= 1e4
        return x
    k = {"k32": 32, "k14336": 14336}[case]
    return rng.standard_normal((3, k)).astype(np.float32)


@pytest.mark.parametrize("case", ["mixed", "zero_row", "ties", "outlier", "k32", "k14336"])
def test_quantize_activations_match_jax(case):
    x = _activation_rows(case)
    xq, xs = qm.quantize_activations(_bf16(x))
    jxq, jxs = jax.jit(jax_qm.quantize_activations)(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    xb = _bf16(x).float().numpy()
    if case == "zero_row":
        assert xs[1, 0] == np.float32(1e-12) and not xq[1].any()
    if case == "ties":
        assert np.array_equal(xs.numpy()[:, 0], np.float32([1.0, 0.125, 16.0]))
        half = xb / xs.numpy()
        assert (np.abs(half) % 1 == 0.5).sum() > 700
        np.testing.assert_array_equal(xq.numpy(), np.rint(half))  # half to even
    if case == "outlier":
        assert np.abs(xq.numpy()).max(axis=1).tolist() == [127] * 4
    # The CPU path of the kernel's wrapper is this plain version.
    got = qm.quantize_rows(_bf16(x))
    assert torch.equal(got[0], xq) and torch.equal(got[1], xs)


def test_concat_weights_matches_jax():
    ws = [_inputs(8, 256, n, seed=2 + n)[1] for n in (128, 256)]
    jwqs = [jax_qm.quantize_weight(jnp.asarray(w, jnp.bfloat16), "int4") for w in ws]
    got = qm.concat_weights([qm.quantize_weight(_bf16(w), "int4") for w in ws])
    want = jax_qm.concat_weights(jwqs)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    with pytest.raises(ValueError):
        qm.concat_weights([got, qm.quantize_weight(_bf16(ws[0]), "int8")])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode,act_quant", RECIPES,
                         ids=["K6_int8", "K7_int4", "K8_int8_a8", "K9_int4_a8"])
def test_quant_matmul_matches_jax_kernel(mode, act_quant, shape):
    m, k, n = shape
    x, w = _inputs(m, k, n, seed=3)
    jwq = jax_qm.quantize_weight(jnp.asarray(w, jnp.bfloat16), mode,
                                 "int8" if act_quant else "bf16")
    jx = jnp.asarray(x, jnp.bfloat16)
    # Tiles that divide these shapes, so the JAX side runs its Pallas kernel
    # (in interpret mode on the CPU), not its XLA fallback.
    run = jax.jit(functools.partial(jax_qm.quant_matmul, act_quant=act_quant,
                                    block_m=16, block_k=128, block_n=128))
    want = np.asarray(run(jx, jwq), np.float32)
    got = qm.quant_matmul(_bf16(x), _port_weight(jwq), act_quant=act_quant)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got32 = got.float().numpy()
    if act_quant:
        # One bf16 ulp of each value: 2^(floor(log2|v|) - 7).
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got32 - want) <= ulp), float(np.abs(got32 - want).max())
        return
    stored = np.asarray(jax_qm._stored_int8_columns(jwq), np.float64)
    exact = np.asarray(jx, np.float64) @ (stored * np.asarray(jwq.scales, np.float64))
    ok, ratio, where = sliced_tolerance_check(
        row_bands(got[None], 16), row_bands(torch.from_numpy(want)[None], 16).bfloat16(),
        row_bands(torch.from_numpy(exact)[None], 16), lead=2)
    assert ok, (ratio, where)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_n_inner_is_the_same_function(mode):
    """The TPU kernel's K-outer / N-inner loop order: accepted, same output
    (tests/test_quant_matmul.py:89's rule, bit for bit)."""
    x, w = _inputs(8, 512, 256, seed=4)
    wq = qm.quantize_weight(_bf16(w), mode)
    base = qm.quant_matmul(_bf16(x), wq)
    swept = qm.quant_matmul(_bf16(x), wq, n_inner=True, block_n=128)
    assert torch.equal(base, swept)


def test_batched_and_empty_inputs():
    x, w = _inputs(8, 256, 384, seed=5)
    wq = qm.quantize_weight(_bf16(w), "int8")
    got = qm.quant_matmul(_bf16(x).reshape(2, 4, 256), wq)
    assert got.shape == (2, 4, 384)
    assert torch.equal(got.reshape(8, 384), qm.quant_matmul(_bf16(x), wq))
    assert qm.quant_matmul(torch.zeros((0, 256), dtype=torch.bfloat16), wq).shape == (0, 384)
    with pytest.raises(ValueError):
        qm.quant_matmul(_bf16(x)[:, :128], wq)


def test_plain_a8_is_the_exact_integer_product():
    """The a8 plain version's float64 product is the exact int32 sum (no
    rounding below 2**53), here at the model's widest K with the largest
    int8 values, where an fp32 sum would round."""
    k = 14336
    x = torch.full((2, k), 1.0, dtype=torch.bfloat16)
    wq = qm.QuantizedWeight(torch.full((k, 16), -127, dtype=torch.int8),
                            torch.ones(16), "int8", torch.bfloat16, "int8")
    out = qm.quant_matmul_plain(x, wq, act_quant=True, out_dtype=torch.float32)
    # x quantizes to 127 per element (scale 1/127): acc = -127 * 127 * k.
    assert float(out[0, 0]) == pytest.approx(-127 * 127 * k / 127, rel=1e-6)
