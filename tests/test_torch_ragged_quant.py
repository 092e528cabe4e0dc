"""K6-K9 at ragged K and N: the port (plain path on the CPU) vs the JAX package.

The JAX package's ``quantize_weight`` takes any (K, N) (int4: K even, for
its halves) and its ``quant_matmul`` fits a tile to the widths it gets, or
computes the exact math with XLA ops where no tile fits (the shapes here).
The port keeps every weight's logical (K, N) and stores a weight of N % 16
!= 0 once with its rows padded to 16 bytes (``tma_rows``: TMA's stride
rule); the kernels never copy a weight. Inputs are seeded numpy arrays
handed to both packages:

- the stored bytes and scales equal JAX's on the logical columns, the
  storage pad is zero, and a weight carried across from JAX
  (``params_from_jax``) at a ragged vocabulary keeps its bytes;
- the products at (K, N) of (4,000, 4,100), (4,004, 4,100), a 1,000-wide
  and a 32,002-wide head: a8 (W8A8, W4A8) within one bf16 ulp of each
  value of the JAX output (both sum int8 products exactly; the final cast
  is the only rounding); weight-only by the adaptive rule in each 16-row
  band, both references from the JAX side (its bf16 output and the exact
  float64 product of its quantized values and scales);
- ``quantize_rows`` at K % 8 != 0 equals JAX's ``quantize_activations`` bit
  for bit (under ``jax.jit``, as the model runs it);
- ``plan()`` at ragged shapes covers N and every K tile exactly once, as
  the kernel's grid and split walk take them;
- the wrapper's x helper pads K to TMA's quantum with the values intact.
"""

import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, init_params as jax_init_params,
    quantize_params as jax_quantize_params,
)
from flash_attention_from_scratch_tpu.ops import quant_matmul as jax_qm
from flash_attention_from_scratch_tpu_torch.models.llama import params_from_jax
from flash_attention_from_scratch_tpu_torch.ops import quant_matmul as qm
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    row_bands, sliced_tolerance_check,
)

RECIPES = [("int8", False), ("int4", False), ("int8", True), ("int4", True)]
RECIPE_IDS = ["K6", "K7", "K8", "K9"]
# (m, K, N): K % 32 != 0 (4,000) and K % 16 = 4 (4,004) at N % 16 = 4; a
# 1,000-wide and OpenHermes-2.5-Mistral-7B's 32,002-wide head (N % 8 = 2).
SHAPES = [(4, 4000, 4100), (3, 4004, 4100), (5, 512, 1000), (2, 256, 32002)]
SOURCE = pathlib.Path(qm.__file__).parent.parent / "csrc" / qm.SOURCE


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
@pytest.mark.parametrize("k,n", [(4004, 4100), (256, 32002), (64, 40)])
def test_ragged_weight_bytes_match_jax(mode, k, n):
    """quantize_weight at ragged N: JAX's bytes and scales on the logical
    (K, N), rows 16-byte strided over a zero pad, the same from the port's
    own quantize_weight and from JAX's weight carried across."""
    _, w = _inputs(2, k, n, seed=1)
    jwq = jax_qm.quantize_weight(jnp.asarray(w, jnp.bfloat16), mode, "bf16")
    for got in (qm.quantize_weight(_bf16(w), mode), _port_weight(jwq)):
        assert got.shape == (k, n) == tuple(jwq.shape)
        assert got.values.stride(0) % 16 == 0 and got.values.stride(1) == 1
        np.testing.assert_array_equal(got.values.numpy(), np.asarray(jwq.values))
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(jwq.scales))
        rows = got.values.shape[0]
        pad = got.values.as_strided((rows, got.values.stride(0)), (got.values.stride(0), 1))
        assert not pad[:, n:].any()


def test_tma_rows_lays_out_only_what_tma_cannot_read():
    """A weight TMA reads as it lies is kept (no copy); a ragged or a
    transposed one becomes a view of padded rows with the same values."""
    dense = torch.randint(-127, 128, (64, 48), dtype=torch.int8)
    assert qm.tma_rows(dense) is dense
    for vals in (torch.randint(-127, 128, (64, 41), dtype=torch.int8),
                 torch.randint(-127, 128, (48, 64), dtype=torch.int8).t()):
        got = qm.tma_rows(vals)
        assert got.shape == vals.shape and torch.equal(got, vals)
        assert got.stride(1) == 1 and got.stride(0) % 16 == 0 and got.data_ptr() % 16 == 0
    assert qm.concat_weights([qm.quantize_weight(torch.randn(64, 20)),
                              qm.quantize_weight(torch.randn(64, 21))]).values.stride(0) == 48


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode,act_quant", RECIPES, ids=RECIPE_IDS)
def test_ragged_quant_matmul_matches_jax(mode, act_quant, shape):
    m, k, n = shape
    x, w = _inputs(m, k, n, seed=3)
    jwq = jax_qm.quantize_weight(jnp.asarray(w, jnp.bfloat16), mode,
                                 "int8" if act_quant else "bf16")
    jx = jnp.asarray(x, jnp.bfloat16)
    run = jax.jit(lambda a, b: jax_qm.quant_matmul(a, b, act_quant=act_quant))
    want = np.asarray(run(jx, jwq), np.float32)
    got = qm.quant_matmul(_bf16(x), _port_weight(jwq), act_quant=act_quant)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got32 = got.float().numpy()
    if act_quant:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got32 - want) <= ulp), float(np.abs(got32 - want).max())
        return
    stored = np.asarray(jax_qm._stored_int8_columns(jwq), np.float64)
    exact = np.asarray(jx, np.float64) @ (stored * np.asarray(jwq.scales, np.float64))
    pad = -m % 16

    def bands(t):
        return row_bands(torch.nn.functional.pad(t, (0, 0, 0, pad))[None], 16)

    ok, ratio, where = sliced_tolerance_check(
        bands(got.float()), bands(torch.from_numpy(want)).bfloat16(),
        bands(torch.from_numpy(exact).float()), lead=2)
    assert ok, (ratio, where)


@pytest.mark.parametrize("k", [13, 4000, 4004, 4100])
def test_quantize_rows_at_any_k_matches_jax(k):
    """Rows with an all-zero one (the 1e-12 floor), exact halves and an
    outlier, at K % 8 != 0 (13, 4,004, 4,100) and K % 16 != 0 (4,000)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((4, k)).astype(np.float32)
    x[0] = 0.0
    x[1] = (rng.integers(-127, 127, k) + 0.5) / 8
    x[1, 0] = 127.0 / 8
    x[2, k // 3] *= 1e4
    xb = jnp.asarray(x, jnp.bfloat16)
    want_q, want_s = jax.jit(jax_qm.quantize_activations)(xb)
    got_q, got_s = qm.quantize_rows(_bf16(np.asarray(xb, np.float32)))
    assert got_q.shape == (4, k) and got_s.shape == (4, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


RAGGED_PLAN = [(4096, 32002), (4000, 4100), (4004, 4100), (4096, 40), (260, 330),
               (14336, 4100)]


@pytest.mark.parametrize("w4,a8", [(False, False), (True, False), (False, True),
                                   (True, True)], ids=RECIPE_IDS)
@pytest.mark.parametrize("k,n", RAGGED_PLAN)
def test_ragged_plan_covers_n_and_k_once(k, n, w4, a8):
    """The grid's column tiles cover [0, N) once (the last one part past N,
    read as zeros); the kernel's split walk (``nt`` of its source, each
    split's tiles from ``blockIdx.z * per``) takes every stored-row tile of
    the K walk exactly once, none empty, and the tiles cover the stored
    rows (K, or K/2 for int4) with less than one tile past them."""
    src = SOURCE.read_text()
    assert "const int nt = max(min(k_tiles, t0 + k_tiles_per_split) - t0, 0);" in src
    assert "const int t0 = blockIdx.z * k_tiles_per_split;" in src
    rows = k // 2 if w4 else k
    for m in (1, 16, 32, 100, 1000, 1024):
        p = qm.plan(m, n, k, w4, 132, a8)
        col_tiles = math.ceil(n / p.cols)
        assert (col_tiles - 1) * p.cols < n <= col_tiles * p.cols
        assert (p.k_tiles - 1) * qm.STAGE_ROWS[a8] < rows <= p.k_tiles * qm.STAGE_ROWS[a8]
        walked = []
        for z in range(p.splits):
            t0 = z * p.per
            nt = max(min(p.k_tiles, t0 + p.per) - t0, 0)
            assert nt >= 1, (m, p)
            walked += range(t0, t0 + nt)
        assert walked == list(range(p.k_tiles)), (m, p)
        assert p.ctas == math.ceil(m / p.bt) * col_tiles * p.splits


def test_tma_x_pads_k_to_the_quantum():
    """x on the card: as it lies where TMA can read it, else rows padded to
    the quantum (8 bf16, 16 for the a8 recipe) with the logical values
    kept; for an int4 weight whose K/2 is off the quantum, each half in
    padded columns, the high half from the next multiple of it."""
    x = torch.randn(3, 4004).bfloat16()
    got, ld, hi = qm._tma_x(x, False, 8)
    assert (ld, hi) == (4008, 2002) and got.shape == (3, 4008)
    assert torch.equal(got[:, :4004], x)
    even = torch.randn(3, 4096).bfloat16()
    assert qm._tma_x(even, True, 8) == (even, 4096, 2048)
    wide = torch.randn(3, 4104).bfloat16()[:, :4096]  # rows 4,104 values apart
    assert qm._tma_x(wide, False, 8)[1] == 4104
    for quantum, hq in ((8, 2008), (16, 2016)):
        got, ld, hi = qm._tma_x(x, True, quantum)
        assert (ld, hi) == (2 * hq, hq) and got.shape == (3, 2 * hq)
        assert torch.equal(got[:, :2002], x[:, :2002])
        assert torch.equal(got[:, hq:hq + 2002], x[:, 2002:])
        assert not got[:, 2002:hq].any() and not got[:, hq + 2002:].any()


def test_params_from_jax_at_a_ragged_vocabulary():
    """A JAX int8 model with a 1,002-word head carried across: every
    quantized leaf keeps JAX's bytes and scales on its logical columns and
    lies in rows TMA reads."""
    shape = dict(vocab_size=1002, dim=256, n_layers=1, n_heads=2, n_kv_heads=1,
                 d_head=128, hidden_dim=512)
    jcfg = JaxLlamaConfig(**shape, block_q=128, block_kv=128)
    jparams = jax_quantize_params(jax_init_params(jcfg, jax.random.PRNGKey(4)), "int8")
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    head, jhead = params["lm_head"], jparams["lm_head"]
    assert head.shape == (256, 1002) and head.values.stride(0) == 1008
    np.testing.assert_array_equal(head.values.numpy(), np.asarray(jhead.values))
    np.testing.assert_array_equal(head.scales.numpy(), np.asarray(jhead.scales))
