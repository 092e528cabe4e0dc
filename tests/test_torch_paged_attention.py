"""The port's paged_decode_attention (plain path on the CPU) vs the JAX kernels.

Same seeded numpy pools and queries in bf16 go to the port and to the JAX
package's Pallas kernels in interpret mode, through both TPU variants: K4
(``_full_kernel``, the default at these sizes) and K5 (``_loop_kernel``,
forced by setting ``_FULL_VARIANT_VMEM_CAP`` to 0 on the JAX side only).
Tolerance: the adaptive tolerance rule with both references from the JAX
side: the port's error vs the JAX kernel is at most 2x the JAX kernel's own
error vs the JAX ``reference_attention`` in fp32 on each sequence's gathered
bf16 rows (explicit ``q_offset = length - 1``), with an ulp floor. The rule
holds for each sequence on its own, so a length-1 row (a single V row)
cannot lift the bound of the long ones.

Pool rows no sequence owns, and each last page's slots past the length,
hold NaN: neither side may let them reach an output.

Quantized pages (int8, fp8, int4 packed along tokens) are made by the JAX
package's ``quantize_kv_pages`` from the same pool, with every slot no
sequence owns overwritten after quantization: fp8 with the e4m3 NaN byte,
int8 and int4 with random bytes or nibbles. The fp32 reference is the JAX
``reference_attention`` on the JAX-dequantized values (value times its
page's scale), so it measures the kernels' error, not the quantization's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attention_from_scratch_tpu.ops.paged_attention as jax_pa
from flash_attention_from_scratch_tpu.ops.quant import (
    quantize_kv_pages as jax_quantize_kv_pages,
    unpack_int4_halves as jax_unpack_int4_halves,
)
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
)
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    sliced_tolerance_check,
)

PAGE, PAGES_PER_SEQ, NUM_PAGES, D = 32, 8, 40, 128

# name: (heads, kv_heads, lengths, options)
CASES = {
    "ragged_gqa4": (8, 2, [1, 17, 0, 200, 64], {}),
    "group1": (2, 2, [33, 256], {}),
    "window": (8, 2, [5, 100, 250], dict(window=50)),
    "softcap": (8, 2, [70, 129], dict(softcap=3.0)),
}


def _pool(kv_heads, lengths, seed):
    """NaN-poisoned pool with shuffled page ids and -1 padded tables."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(NUM_PAGES)
    k = np.full((kv_heads, NUM_PAGES, PAGE, D), np.nan, np.float32)
    v = np.full_like(k, np.nan)
    tables = -np.ones((len(lengths), PAGES_PER_SEQ), np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        for i in range(-(-n // PAGE)):
            page = perm[nxt]
            nxt += 1
            tables[b, i] = page
            rows = min(PAGE, n - i * PAGE)
            k[:, page, :rows] = rng.standard_normal((kv_heads, rows, D))
            v[:, page, :rows] = rng.standard_normal((kv_heads, rows, D))
    return k, v, np.asarray(lengths, np.int32), tables


def _inputs(name):
    heads, kv_heads, lengths, kw = CASES[name]
    k, v, lens, tables = _pool(kv_heads, lengths, seed=21)
    q = np.random.default_rng(22).standard_normal(
        (len(lengths), heads, D)).astype(np.float32)
    return q, k, v, lens, tables, kw


@functools.lru_cache(maxsize=None)
def _jax_fp32(name):
    """Each sequence's rows gathered from its pages, through the JAX
    reference in fp32 on the bf16-rounded values; length 0 gives zeros."""
    q, k, v, lens, tables, kw = _inputs(name)
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
               for x in (q, k, v))
    return _reference(q, k, v, lens, tables, kw)


def _reference(q, k, v, lens, tables, kw):
    """The JAX reference in fp32 on each sequence's gathered token rows."""
    out = np.zeros_like(q)
    for b, n in enumerate(lens.tolist()):
        if n == 0:
            continue
        pages = tables[b, :-(-n // PAGE)]
        kb = k[:, pages].reshape(k.shape[0], -1, D)[None, :, :n]
        vb = v[:, pages].reshape(v.shape[0], -1, D)[None, :, :n]
        out[b] = np.asarray(jax_reference(
            jnp.asarray(q[b][None, :, None]), jnp.asarray(kb), jnp.asarray(vb),
            causal=True, q_offset=n - 1, window=kw.get("window", 0),
            softcap=kw.get("softcap", 0.0)))[0, :, 0]
    return torch.from_numpy(out)


def _run(name, variant, monkeypatch):
    q, k, v, lens, tables, kw = _inputs(name)
    lengths = lens.tolist()

    if variant == "K5":
        monkeypatch.setattr(jax_pa, "_FULL_VARIANT_VMEM_CAP", 0)
    jax_pa._build_decode_call.cache_clear()
    try:
        jax_out = jax_pa.paged_decode_attention(
            jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
            jnp.asarray(v, jnp.bfloat16), jnp.asarray(lens), jnp.asarray(tables),
            **kw)
        jax_out = np.asarray(jax_out, np.float32)
    finally:
        jax_pa._build_decode_call.cache_clear()

    out = paged_decode_attention(
        *[torch.from_numpy(x).bfloat16() for x in (q, k, v)],
        torch.from_numpy(lens), torch.from_numpy(tables), **kw)
    return out, jax_out, lengths


@pytest.mark.parametrize("variant", ["K4", "K5"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_decode_matches_jax(name, variant, monkeypatch):
    out, jax_out, lengths = _run(name, variant, monkeypatch)
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out).all() and np.isfinite(jax_out).all()
    ok, ratio, where = sliced_tolerance_check(
        out, torch.from_numpy(jax_out).bfloat16(), _jax_fp32(name), lead=1)
    assert ok, (name, variant, ratio, where)
    for b, n in enumerate(lengths):
        if n == 0:  # a length-0 row is all zeros on both sides
            assert float(out[b].float().abs().max()) == 0.0
            assert float(np.abs(jax_out[b]).max()) == 0.0


QCASES = {"plain": {}, "window": dict(window=50), "softcap": dict(softcap=3.0)}
QLENGTHS = [1, 17, 0, 200, 64, 33]


def _poison_quantized(vals, nan, mode, rng):
    """Overwrite every slot no sequence owns (``nan``: (kvh, P, ps, d)) in
    the stored pages: the fp8 NaN byte, or random int8 bytes / nibbles."""
    if mode == "fp8":
        raw = np.asarray(vals).view(np.uint8).copy()
        raw[nan] = 0x7F
        return raw
    raw = np.asarray(vals).copy()
    if mode == "int8":
        raw[nan] = rng.integers(-128, 128, int(nan.sum()))
        return raw
    half = nan.shape[2] // 2
    lo, hi = raw & 0x0F, (raw >> 4) & 0x0F
    for nib, bad in ((lo, nan[:, :, :half]), (hi, nan[:, :, half:])):
        nib[bad] = rng.integers(0, 16, int(bad.sum()))
    return (lo | (hi << 4)).astype(np.uint8).view(np.int8)


@functools.lru_cache(maxsize=None)
def _quantized_inputs(mode, option):
    """(q, k/v stored pages as numpy, k/v scales, lens, tables, options,
    fp32 reference output)."""
    heads, kv_heads = 8, 2
    k, v, lens, tables = _pool(kv_heads, QLENGTHS, seed=31)
    rng = np.random.default_rng(32)
    q = rng.standard_normal((len(QLENGTHS), heads, D)).astype(np.float32)
    stored, scales, deq = [], [], []
    for x in (k, v):
        nan = np.isnan(x)
        vals, sc = jax_quantize_kv_pages(jnp.asarray(np.nan_to_num(x), jnp.bfloat16),
                                         mode)
        if mode == "int4":
            lo, hi = jax_unpack_int4_halves(vals, jnp.float32)
            dq = np.concatenate([np.asarray(lo), np.asarray(hi)], axis=2)
        else:
            dq = np.asarray(vals.astype(jnp.float32))
        deq.append(dq * np.asarray(sc)[:, :, None, None])
        stored.append(_poison_quantized(vals, nan, mode, rng))
        scales.append(np.array(sc))
    kw = QCASES[option]
    qr = np.asarray(jnp.asarray(q, jnp.bfloat16), np.float32)
    ref = _reference(qr, deq[0], deq[1], lens, tables, kw)
    return q, stored, scales, lens, tables, kw, ref


def _to_jax(pages, mode):
    x = jnp.asarray(pages)
    return jax.lax.bitcast_convert_type(x, jnp.float8_e4m3fn) if mode == "fp8" else x


def _to_torch(pages, mode):
    x = torch.from_numpy(pages.copy())
    return x.view(torch.float8_e4m3fn) if mode == "fp8" else x


@pytest.mark.parametrize("variant", ["K4", "K5"])
@pytest.mark.parametrize("option", sorted(QCASES))
@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
def test_quantized_pages_match_jax(mode, option, variant, monkeypatch):
    q, (kp, vp), (ks, vs), lens, tables, kw, ref = _quantized_inputs(mode, option)
    if variant == "K5":
        monkeypatch.setattr(jax_pa, "_FULL_VARIANT_VMEM_CAP", 0)
    jax_pa._build_decode_call.cache_clear()
    try:
        jax_out = np.asarray(jax_pa.paged_decode_attention(
            jnp.asarray(q, jnp.bfloat16), _to_jax(kp, mode), _to_jax(vp, mode),
            jnp.asarray(lens), jnp.asarray(tables), mode=mode,
            k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), **kw), np.float32)
    finally:
        jax_pa._build_decode_call.cache_clear()
    out = paged_decode_attention(
        torch.from_numpy(q).bfloat16(), _to_torch(kp, mode), _to_torch(vp, mode),
        torch.from_numpy(lens), torch.from_numpy(tables), mode=mode,
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs), **kw)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert np.isfinite(jax_out).all()
    ok, ratio, where = sliced_tolerance_check(
        out, torch.from_numpy(jax_out).bfloat16(), ref, lead=1)
    assert ok, (mode, option, variant, ratio, where)
    assert float(out[QLENGTHS.index(0)].float().abs().max()) == 0.0


def test_gqa_row_order():
    """Q head h = hk * group + g attends KV head hk: a pool whose KV heads
    differ must route each query head to its own KV head."""
    heads, kv_heads = 8, 2
    k, v, lens, tables = _pool(kv_heads, [40], seed=23)
    v[1] = np.where(np.isnan(v[1]), np.nan, 5.0)  # KV head 1: constant V
    q = torch.from_numpy(np.random.default_rng(24).standard_normal(
        (1, heads, D)).astype(np.float32))
    out = paged_decode_attention(q, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(lens), torch.from_numpy(tables))
    group = heads // kv_heads
    assert torch.allclose(out[0, group:], torch.full((group, D), 5.0))
    assert not torch.allclose(out[0, :group], torch.full((group, D), 5.0))


def test_unported_options_raise():
    """Still unported: int8-compute attention and multi-token q; and a
    quantized mode needs its scales."""
    q = torch.zeros((1, 4, D), dtype=torch.bfloat16)
    pages = torch.zeros((2, 4, PAGE, D), dtype=torch.bfloat16)
    lens, tables = torch.ones(1, dtype=torch.int32), torch.zeros((1, 4), dtype=torch.int32)
    qpages, scales = torch.zeros((2, 4, PAGE, D), dtype=torch.int8), torch.ones((2, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_decode_attention(q, qpages, qpages, lens, tables, mode="int8",
                               k_scales=scales, v_scales=scales, int8_compute=True)
    for mode in ("int8", "int4", "fp8"):
        with pytest.raises(ValueError, match="k_scales"):
            paged_decode_attention(q, qpages, qpages, lens, tables, mode=mode)
    with pytest.raises(ValueError):
        paged_decode_attention(q, pages, pages, lens, tables, mode="int2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        paged_decode_attention(q[:, :, None], pages, pages, lens, tables)
    with pytest.raises(ValueError):
        paged_decode_attention(q, pages, pages, lens, tables, window=-1)
    with pytest.raises(ValueError):
        paged_decode_attention(q[:, :3], pages, pages, lens, tables)
