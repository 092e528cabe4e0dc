"""K4/K5 at every page size: the port (plain path on the CPU) vs the JAX package.

The JAX paged wrapper checks no page size. The port's kernel walks pages in
chunks where their sizes allow (``chunk_tokens``: a multiple of 8 tokens)
and gathers tiles of 64 consecutive positions across pages otherwise
(``PagedPlan.gather``): 1 token a page (SGLang's default), 4, 12, 100, ...

- ``paged_decode_attention`` against the JAX package's own at page sizes 1
  (int4: 2), 4, 12, 96 and 100 in each store, t = 1 (with a softcap) and
  t = 4 (with a window; lengths at least 4): the JAX side is its per-page kernel (K5,
  ``_loop_kernel``, forced by ``_FULL_VARIANT_VMEM_CAP`` 0) in interpret
  mode, whose cost does not grow with the page table's width; the
  tolerance is the adaptive rule in each sequence (each (sequence, token)
  at t = 4) with both references from the JAX side (its kernel's bf16
  output, its ``reference_attention`` in fp32 on the dequantized rows).
  Slots no sequence owns hold NaN (dense) or poison (quantized).

The plan at every page size, the gather walk's indexing and a served
model at pages of 1 and 12 are in ``tests/test_torch_any_page_walk.py``.
"""

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
from flash_attention_from_scratch_tpu_torch.ops import paged_attention as pa
from flash_attention_from_scratch_tpu_torch.utils.testing import sliced_tolerance_check

D = 128
HEADS, KV_HEADS = 4, 2
LENGTHS = [1, 9, 0, 37, 70]  # 70: more than one 64-position tile at page 1
PAGE_SIZES = {"dense": (1, 4, 12, 96, 100), "int4": (2, 4, 12, 96, 100)}
CASES = [(mode, ps, t) for mode in ("dense", "int8", "fp8", "int4")
         for ps in PAGE_SIZES.get(mode, PAGE_SIZES["dense"]) for t in (1, 4)]


def _lengths(t):
    """The sequences' lengths; at t > 1 the shortest is t (a verify call's
    shortest: its rows then all see a token, as the JAX kernels assume)."""
    return [max(LENGTHS[0], t)] + LENGTHS[1:]


def _pool(ps, seed, lengths):
    """A NaN-poisoned pool of ``ps``-token pages, shuffled page ids, -1
    padded tables."""
    rng = np.random.default_rng(seed)
    need = [-(-n // ps) for n in lengths]
    num_pages = sum(need) + 2
    perm = rng.permutation(num_pages)
    k = np.full((KV_HEADS, num_pages, ps, D), np.nan, np.float32)
    v = np.full_like(k, np.nan)
    tables = -np.ones((len(lengths), max(need)), np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        for i in range(need[b]):
            page = perm[nxt]
            nxt += 1
            tables[b, i] = page
            rows = min(ps, n - i * ps)
            k[:, page, :rows] = rng.standard_normal((KV_HEADS, rows, D))
            v[:, page, :rows] = rng.standard_normal((KV_HEADS, rows, D))
    return k, v, tables


def _store(x, mode, rng):
    """(stored pages as numpy, scales, fp32 dequantized values) of one pool,
    every slot no sequence owns poisoned after quantization."""
    nan = np.isnan(x)
    if mode == "dense":
        return x, None, np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    vals, sc = jax_quantize_kv_pages(jnp.asarray(np.nan_to_num(x), jnp.bfloat16), mode)
    if mode == "int4":
        lo, hi = jax_unpack_int4_halves(vals, jnp.float32)
        deq = np.concatenate([np.asarray(lo), np.asarray(hi)], axis=2)
    else:
        deq = np.asarray(vals.astype(jnp.float32))
    deq = deq * np.asarray(sc)[:, :, None, None]
    raw = np.asarray(vals).view(np.uint8).copy()
    if mode == "fp8":
        raw[nan] = 0x7F
    elif mode == "int8":
        raw[nan] = rng.integers(0, 256, int(nan.sum()))
    return raw, np.array(sc), deq


def _reference(q, k, v, tables, ps, lengths, kw):
    """The JAX reference in fp32 on each sequence's gathered rows, token j
    of t at position n - t + j."""
    t = q.shape[2]
    out = np.zeros_like(q)
    for b, n in enumerate(lengths):
        if n == 0:
            continue
        pages = tables[b, :-(-n // ps)]
        kb = k[:, pages].reshape(KV_HEADS, -1, D)[None, :, :n]
        vb = v[:, pages].reshape(KV_HEADS, -1, D)[None, :, :n]
        out[b] = np.asarray(jax_reference(
            jnp.asarray(q[b][None]), jnp.asarray(kb), jnp.asarray(vb), causal=True,
            q_offset=n - t, window=kw.get("window", 0), softcap=kw.get("softcap", 0.0)))[0]
    return out


@pytest.mark.parametrize("mode,ps,t", CASES, ids=[f"{m}-ps{ps}-t{t}" for m, ps, t in CASES])
def test_paged_decode_matches_jax_at_any_page_size(mode, ps, t, monkeypatch):
    rng = np.random.default_rng(ps + t)
    lengths = _lengths(t)
    k, v, tables = _pool(ps, ps, lengths)
    (kp, ks, kd), (vp, vs, vd) = (_store(x, mode, rng) for x in (k, v))
    q = rng.standard_normal((len(lengths), HEADS, t, D)).astype(np.float32)
    q = np.asarray(jnp.asarray(q, jnp.bfloat16), np.float32)
    kw = dict(window=30) if t > 1 else dict(softcap=3.0)
    if mode != "dense":
        kw.update(mode=mode)
    lens = np.asarray(lengths, np.int32)

    def jax_pages(raw):
        if mode == "dense":
            return jnp.asarray(raw, jnp.bfloat16)
        x = jnp.asarray(raw)
        return jax.lax.bitcast_convert_type(x, jnp.float8_e4m3fn if mode == "fp8" else jnp.int8)

    def torch_pages(raw):
        if mode == "dense":
            return torch.from_numpy(raw).bfloat16()
        x = torch.from_numpy(raw)
        return x.view(torch.float8_e4m3fn if mode == "fp8" else torch.int8)

    scales = {} if mode == "dense" else dict(k_scales=ks, v_scales=vs)
    q_in = q if t > 1 else q[:, :, 0]  # one token: the (batch, heads, d) decode query
    monkeypatch.setattr(jax_pa, "_FULL_VARIANT_VMEM_CAP", 0)
    jax_pa._build_decode_call.cache_clear()
    try:
        want = np.asarray(jax_pa.paged_decode_attention(
            jnp.asarray(q_in, jnp.bfloat16), jax_pages(kp), jax_pages(vp), jnp.asarray(lens),
            jnp.asarray(tables), **{n: jnp.asarray(s) for n, s in scales.items()}, **kw),
            np.float32).reshape(q.shape)
    finally:
        jax_pa._build_decode_call.cache_clear()
    got = pa.paged_decode_attention(
        torch.from_numpy(q_in).bfloat16(), torch_pages(kp), torch_pages(vp),
        torch.from_numpy(lens), torch.from_numpy(tables),
        **{n: torch.from_numpy(s) for n, s in scales.items()}, **kw).reshape(q.shape)
    ref = _reference(q, kd, vd, tables, ps, lengths, kw)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert np.isfinite(want).all()
    by_token = lambda x: x.transpose(1, 2)  # noqa: E731
    ok, ratio, where = sliced_tolerance_check(
        by_token(got), by_token(torch.from_numpy(want).bfloat16()),
        by_token(torch.from_numpy(ref)), lead=2)
    assert ok, (mode, ps, t, ratio, where)
    assert float(got[lengths.index(0)].float().abs().max()) == 0.0
