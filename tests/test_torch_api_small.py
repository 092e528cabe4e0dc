"""The public API's small functions vs the JAX package, on the CPU.

The config space (short forms, the FLOP and intensity models, the autotune
pruning and every ``get_*`` list) must equal the JAX package's exactly:
compared by short form and by value. The block-by-block oracle
``block_flash_attention`` and its trace agree with JAX's within 1e-5 of each
tensor's largest magnitude (both fp32 recurrences; summation order differs).
The bound kernels of ``make_flash_forward``, ``make_flash_backward`` and
``make_flash_backward_fused`` equal the port's ``flash_forward`` /
``flash_backward`` bit for bit and hold to the JAX ``make_*`` functions' calls (Pallas
in interpret mode) by the adaptive tolerance rule in each (batch, head,
64-row band), with those JAX calls fed fp32 inputs as the fp32 reference;
the LSE within 1e-3. ``generate_qkv``, ``entry()`` and the timers are
checked for shapes, dtypes and their refusal to time without a card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from flash_attention_from_scratch_tpu.ops import configs as jc
from flash_attention_from_scratch_tpu.ops.flash_backward import (
    make_flash_backward as jax_make_backward,
    make_flash_backward_fused as jax_make_backward_fused,
)
from flash_attention_from_scratch_tpu.ops.flash_forward import (
    make_flash_forward as jax_make_forward,
)
from flash_attention_from_scratch_tpu.ops.reference import (
    block_flash_attention as jax_block_flash_attention,
)
from flash_attention_from_scratch_tpu.utils.testing import (
    generate_qkv as jax_generate_qkv,
)
from flash_attention_from_scratch_tpu_torch import dispatch
from flash_attention_from_scratch_tpu_torch.entry import entry, small_config
from flash_attention_from_scratch_tpu_torch.ops import configs as pc
from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
    flash_backward, fused_backward_fits, make_flash_backward, make_flash_backward_fused,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
    flash_forward_with_lse, make_flash_forward,
)
from flash_attention_from_scratch_tpu_torch.ops.reference import block_flash_attention
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    generate_qkv, make_qkv, row_bands, sliced_tolerance_check,
)


def _forms(cfgs):
    return [c.short_form() for c in cfgs]


@pytest.mark.parametrize("kind", ["prog", "all", "tune", "256,512",
                                  "fa_bf16_q512_kv1024_d128_grid2_x2+os+cp+sq;"
                                  "fa_f32_q128_kv256_d128_fori3_cp+ca+qo128+wi64+sc30p5"])
def test_get_kernel_configs_equal_jax(kind):
    got, want = pc.get_kernel_configs(kind), jc.get_kernel_configs(kind)
    assert _forms(got) == _forms(want)
    assert all(pc.parse_short_form(c.short_form()) == c for c in got)


def test_short_forms_parse_as_jax_parses_them():
    """Every JAX config of the build set, and some with every flag, parse
    to the same short form; the port's own configs round-trip."""
    extra = [jc.KernelConfig(causal=True, decompose=True, window=300, q_offset=256,
                             attn_softcap=30.5, optimized_softmax=False, mask_elide=True,
                             fold_batch=True, scale_q=False,
                             mxu_row_sum=True, dtype=jc.DType.FP16)]
    for cfg in jc.get_kernels_to_build((jc.DType.BF16, jc.DType.FP16)) + extra:
        s = cfg.short_form()
        assert pc.parse_short_form(f"row {s} 1.23 ms").short_form() == s
        assert pc.parse_short_form(s).short_form() == jc.parse_short_form(s).short_form()
    port = pc.KernelConfig(causal=True, decompose=True, window=64, attn_softcap=5.0)
    assert pc.parse_short_form(port.short_form()) == port
    with pytest.raises(ValueError):
        pc.parse_short_form("not a config")


@pytest.mark.parametrize("dtypes", [("BF16",), ("BF16", "FP16")])
def test_config_lists_equal_jax(dtypes):
    jd = tuple(getattr(jc.DType, d) for d in dtypes)
    pd = tuple(getattr(pc.DType, d) for d in dtypes)
    assert _forms(pc.get_autotuning_kernel_configs(pd)) == _forms(
        jc.get_autotuning_kernel_configs(jd))
    assert _forms(pc.get_kernels_to_build(pd)) == _forms(jc.get_kernels_to_build(jd))
    for jdt, pdt in zip(jd, pd):
        got, want = (f(dt) for f, dt in ((pc.get_kernel_progression_configs, pdt),
                                         (jc.get_kernel_progression_configs, jdt)))
        assert [(n, c.short_form()) for n, c in got] == [(n, c.short_form()) for n, c in want]


def test_flop_models_and_pruning_equal_jax():
    """calc_tile_softmax_flop, calc_total_flop, calc_arithmetic_intensity,
    should_autotune_config and the VMEM model, on every candidate of the
    sweep (pruned or not) and the ladder, at three lengths."""
    cands = []
    for bq in (128, 256, 512, 1024):
        for bkv in (256, 1024, 4096, 16384):
            for kw in (dict(), dict(kv_splits=2, q_splits=2), dict(head_pack=4),
                       dict(use_exp2=False), dict(kv_loop="fori", num_kv_buffers=3)):
                cands.append(dict(block_q=bq, block_kv=bkv, **kw))
    for kw in cands:
        j = jc.KernelConfig(**{k: jc.KVLoop(v) if k == "kv_loop" else v for k, v in kw.items()})
        p = pc.parse_short_form(j.short_form())
        assert pc.should_autotune_config(p) == jc.should_autotune_config(j)
        assert p.vmem_bytes(4) == j.vmem_bytes(4) and p.fits_vmem() == j.fits_vmem()
        assert pc.calc_tile_softmax_flop(p) == jc.calc_tile_softmax_flop(j)
        for seq in (1024, 4096, 16384):
            assert pc.calc_total_flop(p, seq, 16, 2) == jc.calc_total_flop(j, seq, 16, 2)
            assert pc.calc_arithmetic_intensity(p, seq) == jc.calc_arithmetic_intensity(j, seq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse_kv,use_exp2", [(False, True), (True, False)])
def test_block_flash_attention_equals_jax(dtype, reverse_kv, use_exp2):
    q, k, v = make_qkv(1, 2, 256, seq_kv=384, seed=3)
    kw = dict(block_q=128, block_kv=128, reverse_kv=reverse_kv, use_exp2=use_exp2,
              collect_trace=True)
    out, trace = block_flash_attention(*(torch.from_numpy(x).to(getattr(torch, dtype))
                                         for x in (q, k, v)), **kw)
    jout, jtrace = jax_block_flash_attention(*(jnp.asarray(x, getattr(jnp, dtype))
                                               for x in (q, k, v)), **kw)

    def close(a, b):
        b = np.asarray(b, np.float32)
        return float(np.abs(a.float().numpy() - b).max()) <= 1e-5 * max(np.abs(b).max(), 1.0)

    assert out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        assert close(out, jout)
    else:  # the same fp32 result rounded once: at most one bf16 ulp apart
        assert float((out.float() - torch.from_numpy(np.asarray(jout, np.float32))).abs().max()) \
            <= 2 ** -7 * float(np.abs(np.asarray(jout, np.float32)).max())
    assert len(trace) == len(jtrace) == 2 * 3
    for got, want in zip(trace, jtrace):
        assert (got["q_block"], got["kv_block"]) == (want["q_block"], want["kv_block"])
        for name in ("S", "m", "l", "P", "O"):
            assert close(got[name], want[name]), name
    with pytest.raises(ValueError):
        block_flash_attention(*(torch.zeros(1, 1, 100, 128) for _ in range(3)))


def test_generate_qkv_shapes_match_jax():
    """JAX's shapes and dtype (batch from the benchmark table when not
    given), standard-normal draws from the seed."""
    from flash_attention_from_scratch_tpu.utils import testing as jt
    from flash_attention_from_scratch_tpu_torch.utils import testing as pt

    assert pt.BATCH_SIZE_FOR_SEQ_LEN == jt.BATCH_SIZE_FOR_SEQ_LEN
    for seq, kw in ((512, dict(n_heads=1)), (300, dict(d_head=256, n_heads=2, batch=1))):
        got, want = generate_qkv(seq, device="cpu", **kw), jax_generate_qkv(seq, **kw)
        for x, w in zip(got, want):
            assert tuple(x.shape) == tuple(w.shape) and x.dtype == torch.bfloat16
    q, k, _ = generate_qkv(128, n_heads=2, batch=1, dtype=torch.float32, seed=4, device="cpu")
    again = generate_qkv(128, n_heads=2, batch=1, dtype=torch.float32, seed=4, device="cpu")
    assert q.dtype == torch.float32 and torch.equal(q, again[0]) and not torch.equal(q, k)
    assert abs(float(q.std()) - 1.0) < 0.05


def test_entry_runs_on_the_cpu_when_asked():
    """The JAX entry's config and batch; the forward's logits finite."""
    fn, (params, tokens) = entry("cpu")
    jcfg = jax_entry._small_cfg()
    cfg = small_config()
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "d_head",
              "hidden_dim"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert tuple(tokens.shape) == (2, 256)
    logits = fn(params, tokens)
    assert tuple(logits.shape) == (2, 256, 512) and bool(torch.isfinite(logits).all())


def test_timers_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the timers run")
    q = torch.zeros(1, 1, 64, 128, dtype=torch.bfloat16)
    for call in (lambda: dispatch.forward_timed(q, q, q), dispatch.sync_overhead,
                 lambda: dispatch.chain_runtime(lambda x: x, q)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# The bound kernels: (batch, heads, kv_heads, seq_q, seq_kv, options).
BOUND = (1, 4, 2, 128, 256, dict(causal=True, q_offset=128))


def _bound_inputs():
    b, h, kvh, sq, skv, kw = BOUND
    q, k, v = make_qkv(b, h, sq, kv_heads=kvh, seq_kv=skv, seed=31)
    do = np.random.default_rng(32).standard_normal(q.shape).astype(np.float32)
    return q, k, v, do, kw


@functools.lru_cache(maxsize=None)
def _jax_bound(dtype):
    """The JAX ``make_*`` calls on the bound case: (out, lse, dq, dk, dv,
    fused dq, dk, dv) as fp32 numpy."""
    q, k, v, do, kw = _bound_inputs()
    b, h, kvh, sq, skv, _ = BOUND
    jdt = jc.DType.FP32 if dtype == "float32" else jc.DType.BF16
    cfg = jc.KernelConfig(block_q=128, block_kv=128, dtype=jdt, scale_q=False, **kw)
    args = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v, do)]
    out, lse = jax_make_forward(cfg, b, h, sq, skv, interpret=True, kv_heads=kvh,
                                return_lse=True)(*args[:3])
    lse = lse[..., 0]
    dsum = jnp.sum(args[3].astype(jnp.float32) * out.astype(jnp.float32), -1)
    rows = (lse[:, :, None, :], dsum[:, :, None, :])
    scale = 128 ** -0.5
    dq_call, dkv_call = jax_make_backward(cfg, b, h, sq, skv, kvh, scale, True)
    fused = jax_make_backward_fused(cfg, b, h, sq, skv, kvh, scale, True)
    grads = [dq_call(*args[:3], args[3], *rows), *dkv_call(*args[:3], args[3], *rows),
             *fused(*args[:3], args[3], *rows)]
    return [np.array(x, np.float32) for x in (out, lse, *grads)]


def _held(got, i):
    """``got`` against the JAX ``make_*`` calls' output i in bf16 (native) and fp32,
    in each (batch, head, 64-row band)."""
    native, fp32 = (torch.from_numpy(_jax_bound(d)[i]) for d in ("bfloat16", "float32"))
    ok, ratio, where = sliced_tolerance_check(
        row_bands(got), row_bands(native.bfloat16()), row_bands(fp32), lead=3)
    assert ok, (i, ratio, where)


def test_make_flash_forward_equals_jax():
    q, k, v, _, kw = _bound_inputs()
    b, h, kvh, sq, skv, _ = BOUND
    cfg = pc.KernelConfig(**kw)
    args = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    call = make_flash_forward(cfg, b, h, sq, skv, kv_heads=kvh, return_lse=True,
                              device="cpu", interpret=True, debug=True)
    out, lse = call(*args)
    want_out, want_lse = flash_forward_with_lse(*args, cfg)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    _held(out, 0)
    np.testing.assert_allclose(lse.numpy(), _jax_bound("bfloat16")[1], atol=1e-3, rtol=0)
    with pytest.raises(ValueError, match="bound to"):
        call(args[0][:, :2], *args[1:])
    with pytest.raises(ValueError, match="sinks"):
        call(*args, torch.zeros(h))


def test_make_flash_backward_calls_equal_jax():
    """K3's two calls and K2's call bound to the case: bit for bit the
    port's flash_backward, and each gradient by the rule against the JAX
    ``make_*`` calls; JAX's (b, h, 1, s) row statistics are taken."""
    q, k, v, do, kw = _bound_inputs()
    b, h, kvh, sq, skv, _ = BOUND
    cfg = pc.KernelConfig(**kw)
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    out, lse = flash_forward_with_lse(q, k, v, cfg)
    dsum = (do.float() * out.float()).sum(-1)
    want = flash_backward(q, k, v, out, lse, do, cfg)
    dq_call, dkv_call = make_flash_backward(cfg, b, h, sq, skv, kvh, device="cpu")
    fused = make_flash_backward_fused(cfg, b, h, sq, skv, kvh, device="cpu")
    split = (dq_call(q, k, v, do, lse, dsum), *dkv_call(q, k, v, do, lse[:, :, None], dsum))
    for got in (split, fused(q, k, v, do, lse, dsum[:, :, None])):
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    for i, g in enumerate(split + tuple(fused(q, k, v, do, lse, dsum))):
        _held(g, 2 + i)


def test_fused_backward_fits_answers_for_the_port_kernel():
    """The port's K2 keeps dK/dV a CTA, so any length fits (JAX's VMEM
    answer stops at seq_kv 32,768 for d 128); its tiles are 128 or 256
    wide."""
    from flash_attention_from_scratch_tpu.ops.flash_backward import fused_backward_fits as jax_fits

    assert jax_fits(32768, 128) and not jax_fits(65536, 128)
    assert fused_backward_fits(32768, 128) and fused_backward_fits(65536, 128)
    assert fused_backward_fits(1024, 256) and fused_backward_fits(65536, 256)
    assert not fused_backward_fits(1024, 384)
