"""Four signatures of the port held to the JAX package's, on the CPU.

The package's ``forward`` is the attention forward (``flash_forward``) in
both packages; ``flash_forward`` and ``flash_forward_with_lse`` take a
keyword ``scale`` that overrides the config's; ``KernelConfig`` takes every
field of the JAX config, the TPU knobs as hints the Hopper kernels ignore,
and raises ``ValueError`` for the values the JAX config refuses; and
``rope_tables`` takes (seq_len, d_head, theta, cfg=None) positionally.
Outputs are held to JAX-side references (the JAX kernel in interpret mode
in bf16, ``reference_attention`` in fp32 on the same bf16-rounded inputs)
by the adaptive rule: in each 64-row band at the default scale; over the
whole output at another scale, where the JAX kernel's own error in one
band can be small enough that the port's P rounding passes twice it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attention_from_scratch_tpu as fa
import flash_attention_from_scratch_tpu_torch as ft
from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops.configs import (
    DType as JaxDType, KernelConfig as JaxKernelConfig,
)
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu_torch.models import llama
from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    adaptive_tolerance_check, make_qkv, row_bands, sliced_tolerance_check,
)


def _inputs(seed=41, heads=4, kv_heads=2, seq=128):
    q, k, v = make_qkv(1, heads, seq, kv_heads=kv_heads, seed=seed)
    return ([jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)],
            [torch.from_numpy(x).bfloat16() for x in (q, k, v)])


def _hold(out, jax_out, jargs, scale=None, causal=False):
    ref32 = torch.from_numpy(np.array(jax_reference(
        *[x.astype(jnp.float32) for x in jargs], causal=causal,
        q_offset=0 if causal else None, scale_override=scale)))
    native = torch.from_numpy(np.asarray(jax_out, np.float32))
    if scale is None:
        ok, ratio, where = sliced_tolerance_check(
            row_bands(out.float()), row_bands(native), row_bands(ref32), lead=3)
        assert ok, (ratio, where)
    else:
        ok, err, bound = adaptive_tolerance_check(out.float(), native, ref32)
        assert ok, (err, bound)


def test_forward_is_the_attention_forward():
    """``forward(q, k, v)`` in both packages: the default attention."""
    jargs, args = _inputs()
    assert ft.forward is ft.flash_forward
    _hold(ft.forward(*args), fa.forward(*jargs), jargs)


@pytest.mark.parametrize("with_lse", [False, True], ids=["out", "with_lse"])
def test_scale_keyword_overrides_the_config(with_lse):
    """``scale=`` replaces ``cfg.scale`` in the port, as the JAX keyword
    replaces the default 1/sqrt(d): the same output as a config carrying
    that scale, held to the JAX kernel at the same scale."""
    jargs, args = _inputs(seed=42)
    jcfg = JaxKernelConfig(block_q=128, block_kv=128, scale_q=False, causal=True)
    cfg = KernelConfig(causal=True, scale=0.7)
    if with_lse:
        out, lse = ft.flash_forward_with_lse(*args, cfg, scale=0.2)
        jout, jlse = fa.flash_forward_with_lse(*jargs, jcfg, scale=0.2)
        want, want_lse = ft.flash_forward_with_lse(
            *args, KernelConfig(causal=True, scale=0.2))
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-3, rtol=0)
        torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    else:
        out = ft.flash_forward(*args, cfg, scale=0.2)
        jout = fa.forward(*jargs, jcfg, scale=0.2)
        want = ft.flash_forward(*args, KernelConfig(causal=True, scale=0.2))
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    assert not torch.equal(out, ft.flash_forward(*args, cfg))
    _hold(out, jout, jargs, scale=0.2, causal=True)


def test_kernel_config_takes_the_jax_fields():
    """The JAX README's ``KernelConfig(block_q=512, block_kv=1024)`` and
    every other JAX field are accepted; the output is the same function
    whatever the hints, and ``out_dtype`` sets the output's type."""
    hints = dict(block_q=512, block_kv=1024, use_exp2=False, cast_p_to_dtype=False,
                 fused_scale=False, mxu_row_sum=True, scale_q=True, kv_splits=2,
                 q_splits=4, head_pack=2, fold_batch=True, mask_elide=True,
                 vmem_limit_mb=32, optimized_softmax=True)
    fields = set(JaxKernelConfig.__dataclass_fields__)
    assert fields <= set(KernelConfig.__dataclass_fields__)
    KernelConfig(block_q=512, block_kv=1024)
    JaxKernelConfig(**hints)
    _, args = _inputs(seed=43)
    want = ft.flash_forward(*args, KernelConfig(causal=True))
    torch.testing.assert_close(ft.flash_forward(*args, KernelConfig(causal=True, **hints)),
                               want, atol=0, rtol=0)
    out = ft.flash_forward(*args, KernelConfig(causal=True, out_dtype=DType.FP32))
    assert out.dtype == torch.float32
    torch.testing.assert_close(out.bfloat16(), want, atol=0, rtol=0)
    assert KernelConfig(out_dtype=DType.FP32).resolved_out_dtype == DType.FP32
    assert KernelConfig().resolved_out_dtype == DType.BF16


BAD_FIELDS = {
    "block_q": dict(block_q=100),
    "block_kv": dict(block_kv=100),
    "scale_q_fused_scale": dict(fused_scale=True),
    "causal_reverse_kv": dict(causal=True, reverse_kv=True),
    "decompose_not_causal": dict(decompose=True),
    "window_optimized_softmax": dict(causal=True, window=64, optimized_softmax=True),
    "softcap_fused_scale": dict(attn_softcap=5.0, fused_scale=True, scale_q=False),
    "kv_splits_zero": dict(kv_splits=0),
    "kv_splits_lanes": dict(block_kv=256, kv_splits=4),
    "q_splits_zero": dict(q_splits=0),
    "q_splits_sublanes": dict(block_q=128, q_splits=16),
    "head_pack_zero": dict(head_pack=0),
}


@pytest.mark.parametrize("name", sorted(BAD_FIELDS))
def test_kernel_config_refuses_what_jax_refuses(name):
    kw = BAD_FIELDS[name]
    with pytest.raises(ValueError):
        JaxKernelConfig(**kw)
    with pytest.raises(ValueError):
        KernelConfig(**kw)


def test_kernel_config_decompose_is_not_ported():
    """Ported since the row-band dispatch (``ops/causal_decomp.py``): the
    JAX package's decompose config is accepted, with the same short form."""
    want = JaxKernelConfig(causal=True, decompose=True, optimized_softmax=False)
    got = KernelConfig(causal=True, decompose=True)
    assert got.decompose and got.short_form() == want.short_form()


@pytest.mark.parametrize("with_cfg", [False, True], ids=["bare", "cfg"])
def test_rope_tables_positional_as_jax_calls_it(with_cfg):
    """``rope_tables(seq, cfg.d_head, cfg.rope_theta, cfg=cfg)``, as the JAX
    MoE model calls it, and the bare (d_head, theta) form: the JAX tables
    within 1e-6 (the same fp32 operations)."""
    jcfg, cfg = jax_llama.LLAMA31_8B, llama.LLAMA31_8B
    kw = ({"cfg": jcfg}, {"cfg": cfg}) if with_cfg else ({}, {})
    jcos, jsin = jax_llama.rope_tables(96, jcfg.d_head, jcfg.rope_theta, **kw[0])
    cos, sin = llama.rope_tables(96, cfg.d_head, cfg.rope_theta, **kw[1])
    assert cos.dtype == torch.float32 and cos.shape == (96, cfg.d_head // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6, rtol=0)
    if with_cfg:  # the scaling is applied: the bare tables differ
        bare, _ = llama.rope_tables(96, cfg.d_head, cfg.rope_theta)
        assert not torch.allclose(bare, cos)


def test_jax_dtype_names_match():
    assert {d.name for d in DType} <= {d.name for d in JaxDType}
