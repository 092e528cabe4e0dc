"""The row-band causal forward (``decompose=True``) vs the JAX package's.

Same seeded numpy inputs in bf16 go to the port's ``causal_forward_banded``
(and ``flash_forward_with_lse`` with a ``decompose`` config, which folds
sinks in after the bands) and to the JAX package's, its bands on the Pallas
kernel in interpret mode. Tolerance: the adaptive tolerance rule with both
references from the JAX side, the JAX banded output in bf16 and the JAX
``reference_attention`` in fp32 on the same bf16-rounded inputs, in each
(batch, head, 64-row band) on its own; the LSE within 1e-3. The JAX configs
take ``scale_q=False`` (tests/test_torch_flash_forward.py says why).
Gradients through ``flash_attention`` with a ``decompose`` config hold to
the monolithic config's by the same rule (its bf16 and fp32 runs as the two
references).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.ops import causal_decomp as jax_decomp
from flash_attention_from_scratch_tpu.ops.configs import (
    DType as JaxDType, KernelConfig as JaxKernelConfig,
)
from flash_attention_from_scratch_tpu.ops.flash_forward import (
    flash_forward_with_lse as jax_flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu_torch.ops.autodiff import flash_attention
from flash_attention_from_scratch_tpu_torch.ops.causal_decomp import (
    band_count, causal_forward_banded,
)
from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import flash_forward_with_lse
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    make_qkv, row_bands, sliced_tolerance_check,
)

# name: (seq_q, bands, options, sinks); batch 1, 4 query heads over 2 KV heads.
CASES = {
    "plain": (512, 4, {}, False),
    "window": (384, 3, dict(window=200), False),
    "softcap": (256, 2, dict(attn_softcap=5.0), False),
    "q_offset": (256, 2, dict(q_offset=128), False),
    "window_q_offset": (256, 2, dict(q_offset=256, window=300), False),
    "sinks": (1024, 2, {}, True),
}


def _inputs(name):
    sq, _, kw, with_sinks = CASES[name]
    skv = sq + kw.get("q_offset", 0)
    q, k, v = make_qkv(1, 4, skv, kv_heads=2, seed=41)
    sinks = (np.random.default_rng(42).standard_normal(4).astype(np.float32)
             if with_sinks else None)
    return (q[:, :, skv - sq:], k, v), kw, sinks


def _jax(name):
    """The JAX banded forward (sinks folded in by its ``flash_forward``
    dispatch) and the fp32 reference."""
    (q, k, v), kw, sinks = _inputs(name)
    bands = CASES[name][1]
    cfg = JaxKernelConfig(block_q=128, block_kv=128, dtype=JaxDType.BF16, scale_q=False,
                          optimized_softmax=False, causal=True, decompose=True, **kw)
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    if sinks is None:
        out, lse = jax_decomp.causal_forward_banded(*args, cfg, bands=bands)
    else:  # the JAX dispatch folds the sinks in after band_count's bands
        assert jax_decomp.band_count(q.shape[2]) == band_count(q.shape[2]) == bands
        out, lse = jax_flash_forward_with_lse(*args, cfg, sinks=jnp.asarray(sinks))
    ref32 = jax_reference(
        *(a.astype(jnp.float32) for a in args), causal=True, q_offset=kw.get("q_offset", 0),
        window=kw.get("window", 0), softcap=kw.get("attn_softcap", 0.0),
        sinks=None if sinks is None else jnp.asarray(sinks))
    return (torch.from_numpy(np.array(out, np.float32)), np.array(lse),
            torch.from_numpy(np.array(ref32)))


def _port(name):
    (q, k, v), kw, sinks = _inputs(name)
    cfg = KernelConfig(causal=True, decompose=True, **kw)
    args = [torch.from_numpy(np.ascontiguousarray(x)).bfloat16() for x in (q, k, v)]
    if sinks is None:
        return causal_forward_banded(*args, cfg, bands=CASES[name][1])
    return flash_forward_with_lse(*args, cfg, sinks=torch.from_numpy(sinks))


@pytest.mark.parametrize("name", sorted(CASES))
def test_banded_forward_matches_jax(name):
    out, lse = _port(name)
    jax_out, jax_lse, ref32 = _jax(name)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ok, ratio, where = sliced_tolerance_check(
        row_bands(out), row_bands(jax_out.bfloat16()), row_bands(ref32), lead=3)
    assert ok, (name, ratio, where)
    np.testing.assert_allclose(lse.numpy(), jax_lse, atol=1e-3, rtol=0)


def test_decompose_config_routes_flash_forward_to_the_bands(monkeypatch):
    """``flash_forward_with_lse`` with ``decompose=True`` on a self-attention
    shape runs one forward call a band (band_count's); a cross-attention
    shape is not banded."""
    from flash_attention_from_scratch_tpu_torch.ops import flash_forward as ff

    calls = []
    single = ff._single
    monkeypatch.setattr(ff, "_single", lambda *a: calls.append(a[0].shape[2]) or single(*a))
    q, k, v = (torch.from_numpy(x).bfloat16() for x in make_qkv(1, 2, 1024, seed=43))
    flash_forward_with_lse(q, k, v, KernelConfig(causal=True, decompose=True))
    assert calls == [512, 512] and band_count(1024) == 2
    calls.clear()
    offset = KernelConfig(causal=True, decompose=True, q_offset=128)
    flash_forward_with_lse(q[:, :, :512], k, v, offset)  # 512 + 128 != 1024 keys
    assert calls == [512]


def test_band_count_equals_jax_up_to_16k_and_drops_the_cap():
    for seq in (64, 128, 512, 640, 1024, 1088, 3072, 4096, 8192, 12288, 16384):
        assert band_count(seq) == jax_decomp.band_count(seq), seq
    assert jax_decomp.band_count(32768) == 32 and band_count(32768) == 64
    assert band_count(65536) == 128


def test_banded_forward_refusals():
    q, k, v = (torch.zeros(1, 1, s, 128, dtype=torch.bfloat16) for s in (512, 512, 512))
    causal = KernelConfig(causal=True)
    with pytest.raises(ValueError, match="causal"):
        causal_forward_banded(q, k, v, KernelConfig())
    with pytest.raises(ValueError, match="q_offset"):
        causal_forward_banded(q[:, :, :256], k, v, causal)
    for bands in (3, 16, 0):  # 170.7, 32 and no rows a band
        with pytest.raises(ValueError, match="multiple of 64"):
            causal_forward_banded(q, k, v, causal, bands=bands)


def test_banded_forward_raises_where_jax_divides_by_zero():
    """One band over 16,448 keys (q_offset 64): past the S-tile budget and
    not a multiple of 128, JAX's block walk reaches 0 and divides by it;
    the port raises ValueError, before any attention is computed."""
    q = torch.zeros(1, 1, 16384, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 16448, 128, dtype=torch.bfloat16)
    cfg = KernelConfig(causal=True, q_offset=64)
    with pytest.raises(ValueError, match="q_offset must be a multiple of 128"):
        causal_forward_banded(q, k, k, cfg, bands=1)
    jcfg = JaxKernelConfig(causal=True, q_offset=64, decompose=True)
    jq, jk = (jnp.zeros(x.shape, jnp.bfloat16) for x in (q, k))
    with pytest.raises(ZeroDivisionError):
        jax_decomp.causal_forward_banded(jq, jk, jk, jcfg, bands=1)


@pytest.mark.parametrize("kw", [dict(), dict(window=300), dict(attn_softcap=5.0)],
                         ids=["plain", "window", "softcap"])
def test_decompose_gradients_equal_monolithic(kw):
    """``flash_attention`` with a ``decompose`` config (two bands): the
    forward's band LSEs are the whole problem's, so the standard backward
    gives the monolithic gradients. Each gradient (and the output) within
    the adaptive rule in each (batch, head, 64-row band) against the
    monolithic config's in bf16 and in fp32 (fp32 inputs), the sinks'
    gradient within 1e-2 of its largest magnitude (a sum over every row)."""
    from flash_attention_from_scratch_tpu_torch.ops.configs import DType

    q, k, v = (torch.from_numpy(x) for x in make_qkv(1, 4, 1024, kv_heads=2, seed=44))
    do = torch.from_numpy(np.random.default_rng(45).standard_normal(q.shape).astype(
        np.float32))
    runs = {}
    for name, dt, decompose in (("banded", torch.bfloat16, True),
                                ("native", torch.bfloat16, False),
                                ("fp32", torch.float32, False)):
        cfg = KernelConfig(causal=True, decompose=decompose, dtype=DType.from_torch(dt), **kw)
        args = [x.to(dt).float().to(dt).requires_grad_() for x in (q, k, v)]
        sinks = torch.linspace(-1, 1, 4).requires_grad_()
        out = flash_attention(*args, cfg, sinks)
        (out.float() * do.to(dt).float()).sum().backward()
        runs[name] = [out] + [x.grad for x in args] + [sinks.grad]
    for i in range(4):
        ok, ratio, where = sliced_tolerance_check(
            *(row_bands(runs[n][i]) for n in ("banded", "native", "fp32")), lead=3)
        assert ok, (i, ratio, where)
    ds = runs["fp32"][4]
    assert float((runs["banded"][4] - ds).abs().max()) <= 1e-2 * float(ds.abs().max())
