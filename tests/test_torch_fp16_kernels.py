"""fp16 through the serving kernels: the port (plain paths on the CPU) vs the
JAX package in fp16.

On the card K1, K11, K4/K5 and K6-K9 take fp16 from libraries of their own
(the same sources built for fp16, ``csrc/*_f16.cu``), computing what the
JAX kernels compute in fp16; their plain versions, which these tests hold
to the JAX kernels, are the ones the card's kernels are held to.

- K1 and K11 (``flash_forward`` / ``flash_forward_with_lse``, fp16 q, k, v)
  against the JAX kernels in fp16 in interpret mode (K1's grid kernel, K11's
  FORI kernel at depths 2 and 3), at d 128 and 256: causal with a q_offset,
  a window, a softcap, sinks, GQA. The rule: the adaptive tolerance rule in
  each (batch, head, 64-row band), both references from the JAX side (its
  kernel's fp16 output, its ``reference_attention`` in fp32 on the
  fp16-rounded inputs), with fp16's eps; the LSE within 1e-3. The JAX
  kernels run with ``scale_q=False`` (their default rounds ``Q * scale *
  log2(e)`` to the input type before QK^T; the port scales the fp32
  scores).
- A planted fault: the same plain K1 with P rounded through bf16 before
  P V fails the rule at the K1 cases' shape, so the rule tells fp16's
  rounding from bf16's (fp16's eps is 8x bf16's).
- K4/K5 (``paged_decode_attention``, fp16 q) against the JAX kernel (its
  per-page K5, in interpret mode) on dense fp16, int8, fp8 and int4 pages
  and int8 compute, t 1 and 4, pages of 12 tokens (the gather walk on the
  card) and, at t = 1, 64 (the chunk walk): the rule in each (sequence,
  token) against the JAX kernel's fp16 output and its fp32 reference on the
  dequantized rows (int8 compute: against its own fp32 reference too).
- K6-K9 (``quant_matmul``, fp16 x) against the JAX ``quant_matmul`` in
  fp16 at an aligned and a ragged (N % 16 = 2, K % 8 = 4) shape: K6/K7 by
  the rule in 16-row bands against the exact product; K8/K9 and the
  activation quantization bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attention_from_scratch_tpu.ops.paged_attention as jax_pa
from flash_attention_from_scratch_tpu.ops import quant_matmul as jax_qm
from flash_attention_from_scratch_tpu.ops.configs import (
    DType as JaxDType, KernelConfig as JaxKernelConfig, KVLoop as JaxKVLoop,
)
from flash_attention_from_scratch_tpu.ops.flash_forward import (
    flash_forward_with_lse as jax_flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu.ops.quant import (
    quantize_kv_pages as jax_quantize_kv_pages,
    unpack_int4_halves as jax_unpack_int4_halves,
)
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu_torch.ops import paged_attention as pa
from flash_attention_from_scratch_tpu_torch.ops import quant_matmul as qm
from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
    flash_forward, flash_forward_plain, flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu_torch.ops.reference import _scores, _sink_column
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    make_qkv, row_bands, sliced_tolerance_check,
)

# name: (d, heads, kv_heads, seq_q, seq_kv, options, sinks)
FLASH_CASES = {
    "d128-causal-q_offset": (128, 4, 2, 128, 256, dict(causal=True, q_offset=128), False),
    "d128-window": (128, 4, 2, 256, 256, dict(causal=True, window=64), False),
    "d128-softcap-sinks": (128, 2, 2, 128, 128, dict(causal=True, attn_softcap=5.0), True),
    "d128-full-gqa": (128, 4, 1, 128, 128, {}, False),
    "d256-causal-q_offset": (256, 2, 1, 128, 256, dict(causal=True, q_offset=128), False),
    "d256-window-softcap": (256, 2, 2, 256, 256,
                            dict(causal=True, window=64, attn_softcap=5.0), False),
    "d256-sinks": (256, 2, 1, 128, 128, dict(causal=True), True),
}
# K11's cases: (name, ring depth).
FORI_CASES = [("d128-causal-q_offset", 2), ("d128-window", 3), ("d256-sinks", 2)]


def _flash_inputs(name):
    d, h, kvh, sq, skv, kw, with_sinks = FLASH_CASES[name]
    q, k, v = make_qkv(1, h, sq, d, kv_heads=kvh, seq_kv=skv, seed=31)
    sinks = (np.random.default_rng(32).standard_normal(h).astype(np.float32)
             if with_sinks else None)
    return (q, k, v), d, kw, sinks


def _jax_flash(name, depth=0):
    """The JAX kernel in fp16 (K1's grid kernel, or K11 at ``depth``):
    (output, LSE) as numpy fp32."""
    (q, k, v), d, kw, sinks = _flash_inputs(name)
    loop = dict(kv_loop=JaxKVLoop.FORI, num_kv_buffers=depth) if depth else {}
    cfg = JaxKernelConfig(block_q=128, block_kv=128, d_head=d, dtype=JaxDType.FP16,
                          scale_q=False, optimized_softmax=not kw.get("window"), **loop, **kw)
    args = [jnp.asarray(x, jnp.float16) for x in (q, k, v)]
    out, lse = jax_flash_forward_with_lse(
        *args, cfg, sinks=None if sinks is None else jnp.asarray(sinks))
    return np.asarray(out, np.float32), np.asarray(lse)


def _jax_fp32(name):
    """The JAX reference in fp32 on the fp16-rounded inputs (an explicit
    q_offset: its default aligns causal masks bottom-right)."""
    (q, k, v), _, kw, sinks = _flash_inputs(name)
    args = [jnp.asarray(x, jnp.float16).astype(jnp.float32) for x in (q, k, v)]
    causal = kw.get("causal", False)
    out = jax_reference(
        *args, causal=causal, q_offset=kw.get("q_offset", 0) if causal else None,
        window=kw.get("window", 0), softcap=kw.get("attn_softcap", 0.0),
        sinks=None if sinks is None else jnp.asarray(sinks))
    return torch.from_numpy(np.array(out))


def _port_args(name):
    (q, k, v), d, kw, sinks = _flash_inputs(name)
    cfg = KernelConfig(d_head=d, dtype=DType.FP16, **kw)
    args = [torch.from_numpy(x).half() for x in (q, k, v)]
    return args, cfg, None if sinks is None else torch.from_numpy(sinks)


def _flash_rule(name, out, jax_out):
    return sliced_tolerance_check(row_bands(out), row_bands(torch.from_numpy(jax_out).half()),
                                  row_bands(_jax_fp32(name)), lead=3)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_forward_fp16_matches_jax(name):
    jax_out, jax_lse = _jax_flash(name)
    args, cfg, sinks = _port_args(name)
    out, lse = flash_forward_with_lse(*args, cfg, sinks=sinks)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    assert torch.equal(out, flash_forward(*args, cfg, sinks=sinks))
    ok, ratio, where = _flash_rule(name, out, jax_out)
    assert ok, (name, ratio, where)
    np.testing.assert_allclose(lse.numpy(), jax_lse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name,depth", FORI_CASES, ids=[f"{n}-nb{d}" for n, d in FORI_CASES])
def test_fori_fp16_matches_jax(name, depth):
    """K11 (``kv_loop=FORI``): on the CPU the same plain version, held to the
    JAX FORI kernel in fp16."""
    import dataclasses

    from flash_attention_from_scratch_tpu_torch.ops.configs import KVLoop

    jax_out, jax_lse = _jax_flash(name, depth)
    args, cfg, sinks = _port_args(name)
    cfg = dataclasses.replace(cfg, kv_loop=KVLoop.FORI, num_kv_buffers=depth)
    out, lse = flash_forward_with_lse(*args, cfg, sinks=sinks)
    assert out.dtype == torch.float16
    ok, ratio, where = _flash_rule(name, out, jax_out)
    assert ok, (name, depth, ratio, where)
    np.testing.assert_allclose(lse.numpy(), jax_lse, atol=1e-3, rtol=0)


def _plain_p_through_bf16(q, k, v, cfg, sinks):
    """K1's plain version with the planted fault: P rounded to bf16 (then
    to the inputs' fp16) before P V, as a kernel that reused a bf16 pack
    in its fp16 form would."""
    s = _scores(q, k, causal=cfg.causal, scale=cfg.softmax_scale,
                q_offset=cfg.q_offset if cfg.causal else None, window=cfg.window,
                softcap=cfg.attn_softcap)
    full = s if sinks is None else torch.cat([s, _sink_column(s, sinks)], -1)
    p = torch.softmax(full, dim=-1)[..., :s.shape[-1]].bfloat16().to(q.dtype)
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


@pytest.mark.parametrize("name", ["d128-window", "d256-causal-q_offset"])
def test_rule_fails_p_rounded_through_bf16(name):
    """The planted fault fails the rule where the plain version passes: the
    rule at fp16's eps tells fp16 rounding of P from bf16's."""
    jax_out, _ = _jax_flash(name)
    args, cfg, sinks = _port_args(name)
    ok, _, _ = _flash_rule(name, flash_forward_plain(*args, cfg, sinks)[0], jax_out)
    assert ok
    ok, ratio, _ = _flash_rule(name, _plain_p_through_bf16(*args, cfg, sinks), jax_out)
    assert not ok, f"the bf16-rounded P passed the fp16 rule (worst err/bound {ratio})"


# K4/K5. (store, page size, t): every store at page 12 (the card's gather
# walk), t 1 and 4; at page 64 (its chunk walk) t 1.
PAGED_D, PAGED_HEADS, PAGED_KV_HEADS = 128, 4, 2
PAGED_LENGTHS = [5, 9, 0, 37, 70]
PAGED_CASES = ([(store, 12, t) for store in ("dense", "int8", "fp8", "int4", "int8c")
                for t in (1, 4)] + [(store, 64, 1) for store in ("dense", "int8c")])


def _paged_pool(ps, seed):
    """A NaN-poisoned pool of ``ps``-token pages under shuffled page ids."""
    rng = np.random.default_rng(seed)
    need = [-(-n // ps) for n in PAGED_LENGTHS]
    num_pages = sum(need) + 2
    perm = rng.permutation(num_pages)
    k = np.full((PAGED_KV_HEADS, num_pages, ps, PAGED_D), np.nan, np.float32)
    v = np.full_like(k, np.nan)
    tables = -np.ones((len(PAGED_LENGTHS), max(need)), np.int32)
    nxt = 0
    for b, n in enumerate(PAGED_LENGTHS):
        for i in range(need[b]):
            page = perm[nxt]
            nxt += 1
            tables[b, i] = page
            rows = min(ps, n - i * ps)
            k[:, page, :rows] = rng.standard_normal((PAGED_KV_HEADS, rows, PAGED_D))
            v[:, page, :rows] = rng.standard_normal((PAGED_KV_HEADS, rows, PAGED_D))
    return k, v, tables


def _paged_store(x, mode):
    """(stored pages as numpy, scales, fp32 dequantized values): dense pages
    fp16; quantized pages from the fp16-rounded values, the slots no
    sequence owns poisoned (fp8's NaN byte)."""
    nan = np.isnan(x)
    x16 = jnp.asarray(np.nan_to_num(x), jnp.float16)
    if mode == "dense":
        return np.asarray(jnp.asarray(x, jnp.float16)), None, np.asarray(x16, np.float32)
    vals, sc = jax_quantize_kv_pages(x16, mode)
    if mode == "int4":
        lo, hi = jax_unpack_int4_halves(vals, jnp.float32)
        deq = np.concatenate([np.asarray(lo), np.asarray(hi)], axis=2)
    else:
        deq = np.asarray(vals.astype(jnp.float32))
    raw = np.asarray(vals).view(np.uint8).copy()
    if mode == "fp8":
        raw[nan] = 0x7F
    return raw, np.array(sc), deq * np.asarray(sc)[:, :, None, None]


def _paged_reference(q, k, v, tables, ps, kw):
    """The JAX reference in fp32 on each sequence's gathered rows."""
    t = q.shape[2]
    out = np.zeros_like(q)
    for b, n in enumerate(PAGED_LENGTHS):
        if n == 0:
            continue
        pages = tables[b, :-(-n // ps)]
        kb = k[:, pages].reshape(PAGED_KV_HEADS, -1, PAGED_D)[None, :, :n]
        vb = v[:, pages].reshape(PAGED_KV_HEADS, -1, PAGED_D)[None, :, :n]
        out[b] = np.asarray(jax_reference(
            jnp.asarray(q[b][None]), jnp.asarray(kb), jnp.asarray(vb), causal=True,
            q_offset=n - t, window=kw.get("window", 0), softcap=kw.get("softcap", 0.0)))[0]
    return out


@pytest.mark.parametrize("store,ps,t", PAGED_CASES,
                         ids=[f"{s}-ps{ps}-t{t}" for s, ps, t in PAGED_CASES])
def test_paged_decode_fp16_matches_jax(store, ps, t, monkeypatch):
    i8c = store == "int8c"
    mode = "int8" if i8c else store
    rng = np.random.default_rng(ps + t)
    k, v, tables = _paged_pool(ps, ps + 1)
    (kp, ks, kd), (vp, vs, vd) = (_paged_store(x, mode) for x in (k, v))
    q = rng.standard_normal((len(PAGED_LENGTHS), PAGED_HEADS, t, PAGED_D)).astype(np.float32)
    q = np.asarray(jnp.asarray(q, jnp.float16), np.float32)
    kw = dict(window=30) if t > 1 else dict(softcap=3.0)
    if mode != "dense":
        kw.update(mode=mode)
    if i8c:
        kw.update(int8_compute=True)
    lens = np.asarray(PAGED_LENGTHS, np.int32)
    page_type = {"dense": (jnp.float16, torch.float16),
                 "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}.get(mode, (jnp.int8,
                                                                             torch.int8))
    jax_pages = ((lambda raw: jnp.asarray(raw)) if mode == "dense" else
                 (lambda raw: jax.lax.bitcast_convert_type(jnp.asarray(raw), page_type[0])))
    torch_pages = ((lambda raw: torch.from_numpy(raw)) if mode == "dense" else
                   (lambda raw: torch.from_numpy(raw).view(page_type[1])))
    scales = {} if mode == "dense" else dict(k_scales=ks, v_scales=vs)
    q_in = q if t > 1 else q[:, :, 0]
    monkeypatch.setattr(jax_pa, "_FULL_VARIANT_VMEM_CAP", 0)  # JAX's per-page K5
    jax_pa._build_decode_call.cache_clear()
    try:
        want = np.asarray(jax_pa.paged_decode_attention(
            jnp.asarray(q_in, jnp.float16), jax_pages(kp), jax_pages(vp), jnp.asarray(lens),
            jnp.asarray(tables), **{n: jnp.asarray(s) for n, s in scales.items()}, **kw),
            np.float32).reshape(q.shape)
    finally:
        jax_pa._build_decode_call.cache_clear()
    got = pa.paged_decode_attention(
        torch.from_numpy(q_in).half(), torch_pages(kp), torch_pages(vp),
        torch.from_numpy(lens), torch.from_numpy(tables),
        **{n: torch.from_numpy(s) for n, s in scales.items()}, **kw).reshape(q.shape)
    assert got.dtype == torch.float16 and torch.isfinite(got).all()
    assert np.isfinite(want).all()
    ref = _paged_reference(q, kd, vd, tables, ps, kw)
    by_token = lambda x: x.transpose(1, 2)  # noqa: E731
    ok, ratio, where = sliced_tolerance_check(
        by_token(got), by_token(torch.from_numpy(want).half()), by_token(torch.from_numpy(ref)),
        lead=2)
    assert ok, (store, ps, t, ratio, where)
    assert float(got[PAGED_LENGTHS.index(0)].float().abs().max()) == 0.0


# K6-K9: (m, K, N) aligned, and ragged (N % 16 = 2, K % 8 = 4).
QMM_SHAPES = [(16, 512, 1024), (3, 1028, 1026)]
QMM_RECIPES = [("int8", False), ("int4", False), ("int8", True), ("int4", True)]


@pytest.mark.parametrize("shape", QMM_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode,act_quant", QMM_RECIPES, ids=["K6", "K7", "K8", "K9"])
def test_quant_matmul_fp16_matches_jax(mode, act_quant, shape):
    """fp16 x: the weight converted to x's type before the product (JAX's
    ``w.astype(x.dtype)``), fp32 sums, the scale in fp32, fp16 out; a8: x
    quantized per row from fp16 rows, the exact int32 product, and JAX's
    bits."""
    m, k, n = shape
    rng = np.random.default_rng(5)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    w[:, 3] *= 40.0  # one column with a much larger scale
    jwq = jax_qm.quantize_weight(jnp.asarray(w, jnp.float16), mode,
                                 "int8" if act_quant else "bf16")
    jx = jnp.asarray(x, jnp.float16)
    want = np.asarray(jax.jit(lambda a, b: jax_qm.quant_matmul(a, b, act_quant=act_quant))(
        jx, jwq), np.float32)
    wq = qm.QuantizedWeight(torch.from_numpy(np.array(jwq.values)),
                            torch.from_numpy(np.array(jwq.scales)), jwq.mode, torch.float16,
                            jwq.act)
    x16 = torch.from_numpy(np.asarray(jx, np.float32)).half()
    got = qm.quant_matmul(x16, wq, act_quant=act_quant)
    assert got.dtype == torch.float16 and got.shape == (m, n)
    if act_quant:
        jq, js = jax.jit(jax_qm.quantize_activations)(jx)  # as quant_matmul runs it
        pq, ps = qm.quantize_rows(x16)
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(got.float().numpy(), want)
        return
    stored = np.asarray(jax_qm._stored_int8_columns(jwq), np.float64)
    exact = np.asarray(jx, np.float64) @ (stored * np.asarray(jwq.scales, np.float64))
    pad = -m % 16

    def bands(t):
        return row_bands(torch.nn.functional.pad(t, (0, 0, 0, pad))[None], 16)

    ok, ratio, where = sliced_tolerance_check(
        bands(got.float()), bands(torch.from_numpy(want)).half(),
        bands(torch.from_numpy(exact).float()), lead=2)
    assert ok, (ratio, where)
