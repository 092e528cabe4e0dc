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
- K2/K3 (``flash_backward``, fp16 q, k, v, dO) against the JAX backward
  kernels in fp16 in interpret mode, fused (K2) and split (K3), at d 128
  and 256 (causal with GQA, a window, a softcap, a q_offset): O and the LSE
  from the JAX forward in fp16, the rule in each 64-row band with fp16's eps
  against the JAX kernel's fp16 gradients and ``jax.grad`` of its
  ``reference_attention`` in fp32 on the fp16-rounded inputs. A planted
  fault, dS * scale rounded through bf16 before its products, fails it.
- K10 (``flash_forward_quantized``, compute type fp16) against the JAX
  kernel in fp16 (``scale_q=False``) on every variant: dense fp16 Q over
  int8, fp8 and int4 K/V, int8 and fp8 Q (upcast), and int8 compute; the
  QTensors are the JAX side's own (fp16 ``orig_dtype``) carried across bit
  for bit; the rule per band against the JAX kernel's fp16 output and the
  fp32 reference on the dequantized inputs. On the card the wrapper picks
  the fp16 library from the compute type, a quantized Q's ``orig_dtype``
  included, and refuses fp32 naming ROADMAP item 4c.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attention_from_scratch_tpu.ops.paged_attention as jax_pa
from flash_attention_from_scratch_tpu.ops import quant as jax_quant
from flash_attention_from_scratch_tpu.ops import quant_matmul as jax_qm
from flash_attention_from_scratch_tpu.ops.configs import (
    DType as JaxDType, KernelConfig as JaxKernelConfig, KVLoop as JaxKVLoop,
)
from flash_attention_from_scratch_tpu.ops.flash_backward import (
    flash_backward as jax_flash_backward,
)
from flash_attention_from_scratch_tpu.ops.flash_forward import (
    flash_forward_with_lse as jax_flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu.ops.flash_quant import (
    flash_forward_quantized as jax_flash_quant,
)
from flash_attention_from_scratch_tpu.ops.quant import (
    quantize_kv_pages as jax_quantize_kv_pages,
    unpack_int4_halves as jax_unpack_int4_halves,
)
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference,
)
from flash_attention_from_scratch_tpu_torch.ops import _build
from flash_attention_from_scratch_tpu_torch.ops import flash_backward as fb
from flash_attention_from_scratch_tpu_torch.ops import flash_quant as fq
from flash_attention_from_scratch_tpu_torch.ops import paged_attention as pa
from flash_attention_from_scratch_tpu_torch.ops import quant_matmul as qm
from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
    flash_forward, flash_forward_plain, flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu_torch.ops.quant import QTensor, quantize_kv
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


# K2/K3. name: (d, heads, kv_heads, seq_q, seq_kv, options), b 1.
BACKWARD_CASES = {
    "d128-causal-gqa": (128, 4, 2, 256, 256, dict(causal=True)),
    "d128-window": (128, 4, 2, 256, 256, dict(causal=True, window=64)),
    "d128-softcap": (128, 2, 2, 128, 128, dict(causal=True, attn_softcap=5.0)),
    "d256-causal-q_offset": (256, 2, 1, 128, 256, dict(causal=True, q_offset=128)),
    "d256-window-softcap": (256, 2, 1, 256, 256,
                            dict(causal=True, window=64, attn_softcap=50.0)),
}


def _backward_inputs(name):
    d, h, kvh, sq, skv, kw = BACKWARD_CASES[name]
    q, k, v = make_qkv(1, h, sq, d, kv_heads=kvh, seq_kv=skv, seed=51)
    do = np.random.default_rng(52).standard_normal(q.shape).astype(np.float32)
    cfg = JaxKernelConfig(block_q=128, block_kv=128, d_head=d, dtype=JaxDType.FP16,
                          scale_q=False, optimized_softmax=not kw.get("window"), **kw)
    return [jnp.asarray(x, jnp.float16) for x in (q, k, v, do)], cfg, d, kw


@functools.lru_cache(maxsize=None)
def _jax_backward_forward(name):
    (q, k, v, _), cfg, _, _ = _backward_inputs(name)
    return jax_flash_forward_with_lse(q, k, v, cfg)


@functools.lru_cache(maxsize=None)
def _jax_backward_fp32(name):
    """jax.grad of the JAX reference in fp32 on the fp16-rounded inputs."""
    args, _, _, kw = _backward_inputs(name)
    q, k, v, do = (x.astype(jnp.float32) for x in args)
    causal = kw.get("causal", False)
    ref_kw = dict(causal=causal, q_offset=kw.get("q_offset", 0) if causal else None,
                  window=kw.get("window", 0), softcap=kw.get("attn_softcap", 0.0))
    grads = jax.grad(lambda q, k, v: jnp.sum(jax_reference(q, k, v, **ref_kw) * do),
                     argnums=(0, 1, 2))(q, k, v)
    return [torch.from_numpy(np.array(g)) for g in grads]


def _port_backward_args(name):
    """The port's (q, k, v, o, lse, do) in fp16 from the JAX forward, and its
    config."""
    (q, k, v, do), _, d, kw = _backward_inputs(name)
    out, lse = _jax_backward_forward(name)
    half = [torch.from_numpy(np.asarray(x, np.float32)).half() for x in (q, k, v, out)]
    return (*half, torch.from_numpy(np.array(lse)),
            torch.from_numpy(np.asarray(do, np.float32)).half()), KernelConfig(
        d_head=d, dtype=DType.FP16, **kw)


def _backward_rule(name, got, want16):
    """(ok, worst err/bound) over dq, dk and dv by the rule per 64-row band."""
    worst, good = 0.0, True
    for g, w16, w32 in zip(got, want16, _jax_backward_fp32(name)):
        assert g.shape == w32.shape and g.dtype == torch.float16
        ok, ratio, _ = sliced_tolerance_check(
            row_bands(g), row_bands(torch.from_numpy(np.asarray(w16, np.float32)).half()),
            row_bands(w32), lead=3)
        good, worst = good and ok, max(worst, ratio)
    return good, worst


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("name", sorted(BACKWARD_CASES))
def test_flash_backward_fp16_matches_jax(name, fused):
    """The port's backward in fp16 (its plain version here, K2/K3's fp16
    libraries on the card) against the JAX kernel of the same mode."""
    (q, k, v, do), cfg, _, _ = _backward_inputs(name)
    out, lse = _jax_backward_forward(name)
    want16 = jax_flash_backward(q, k, v, out, lse, do, cfg, fused=fused)
    args, port_cfg = _port_backward_args(name)
    ok, ratio = _backward_rule(name, fb.flash_backward(*args, port_cfg, fused=fused), want16)
    assert ok, (name, ratio)


def _plain_ds_through_bf16(q, k, v, o, lse, do, cfg):
    """K2/K3's plain version (no softcap) with the planted fault: dS * scale
    rounded to bf16, then to the inputs' fp16, before its products, as a
    kernel that kept a bf16 pack for dS in its fp16 form would."""
    group, scale = q.shape[1] // k.shape[1], cfg.softmax_scale
    q32, do32 = q.float(), do.float()
    k32, v32 = (x.float().repeat_interleave(group, dim=1) for x in (k, v))
    p = torch.exp2((q32 @ k32.transpose(-1, -2)) * (scale * fb.LOG2E) - lse[..., None] * fb.LOG2E)
    p = torch.where(fb._visible(q.shape[2], k.shape[2], cfg, q.device), p, 0.0)
    dsum = (do32 * o.float()).sum(-1, keepdim=True)
    ds = (p * (do32 @ v32.transpose(-1, -2) - dsum) * scale).bfloat16().half().float()
    dv = p.half().float().transpose(-1, -2) @ do32
    dk, dq = ds.transpose(-1, -2) @ q32, ds @ k32

    def group_sum(x):
        return x.unflatten(1, (k.shape[1], group)).sum(2).half()

    return dq.half(), group_sum(dk), group_sum(dv)


def test_rule_fails_ds_rounded_through_bf16():
    """The planted fault fails the rule where the plain version passes: the
    rule at fp16's eps tells fp16 rounding of dS from bf16's."""
    name = "d128-causal-gqa"
    (q, k, v, do), cfg, _, _ = _backward_inputs(name)
    out, lse = _jax_backward_forward(name)
    want16 = jax_flash_backward(q, k, v, out, lse, do, cfg, fused=False)
    args, port_cfg = _port_backward_args(name)
    ok, _ = _backward_rule(name, fb.flash_backward_plain(*args, port_cfg), want16)
    assert ok
    ok, ratio = _backward_rule(name, _plain_ds_through_bf16(*args, port_cfg), want16)
    assert not ok, f"the bf16-rounded dS passed the fp16 rule (worst err/bound {ratio})"


# K10. name: (d, K/V mode, Q kind, options), b 1, 4/2 heads, s 256: every
# variant at d 128, and d 256 with a window and softcap 50 and int8c.
QUANT_CASES = {
    "int8kv": (128, "int8", "dense", dict(causal=True)),
    "fp8kv": (128, "fp8", "dense", dict(causal=True, window=100)),
    "int4kv": (128, "int4", "dense", {}),
    "int8q-upcast": (128, "int8", "int8", dict(causal=True)),
    "fp8q": (128, "fp8", "fp8", dict(causal=True, attn_softcap=5.0)),
    "int8c": (128, "int8", "int8", dict(causal=True)),
    "d256-int4kv-window-softcap": (256, "int4", "dense",
                                   dict(causal=True, window=100, attn_softcap=50.0)),
    "d256-int8c": (256, "int8", "int8", {}),
}


def _to_port(x):
    """A JAX QTensor as the port's, bit for bit (fp8 values through their
    byte patterns), or a dense JAX array as fp16."""
    if not isinstance(x, jax_quant.QTensor):
        return torch.from_numpy(np.asarray(x, np.float32)).half()
    vals = np.asarray(x.values)
    vals = (torch.from_numpy(vals.view(np.uint8).copy()).view(torch.float8_e4m3fn)
            if x.mode == "fp8" else torch.from_numpy(vals.copy()))
    return QTensor(vals, torch.from_numpy(np.array(x.scales)), x.mode, torch.float16)


@pytest.mark.parametrize("name", sorted(QUANT_CASES))
def test_flash_forward_quantized_fp16_matches_jax(name):
    d, mode, q_kind, kw = QUANT_CASES[name]
    i8c = name.endswith("int8c")
    q, k, v = (jnp.asarray(x, jnp.float16)
               for x in make_qkv(1, 4, 256, d, kv_heads=2, seed=53))
    jq = q if q_kind == "dense" else jax_quant.quantize_kv(q, q_kind)
    jk, jv = jax_quant.quantize_kv(k, mode), jax_quant.quantize_kv(v, mode)
    assert jk.orig_dtype == jnp.float16
    jcfg = JaxKernelConfig(block_q=128, block_kv=128, d_head=d, dtype=JaxDType.FP16,
                           scale_q=False, optimized_softmax=not kw.get("window"), **kw)
    want = jax_flash_quant(jq, jk, jv, jcfg, int8_compute=i8c)

    def fp32(x):
        if isinstance(x, jax_quant.QTensor):
            return jax_quant.dequantize(dataclasses.replace(x, orig_dtype=jnp.float32))
        return x.astype(jnp.float32)

    causal = kw.get("causal", False)
    ref32 = jax_reference(*(fp32(x) for x in (jq, jk, jv)), causal=causal,
                          q_offset=0 if causal else None, window=kw.get("window", 0),
                          softcap=kw.get("attn_softcap", 0.0))
    pq = _to_port(jq)
    assert (pq.orig_dtype if isinstance(pq, QTensor) else pq.dtype) == torch.float16
    got = fq.flash_forward_quantized(pq, _to_port(jk), _to_port(jv),
                                     KernelConfig(d_head=d, dtype=DType.FP16, **kw),
                                     int8_compute=i8c)
    assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
    ok, ratio, where = sliced_tolerance_check(
        row_bands(got), row_bands(torch.from_numpy(np.asarray(want, np.float32)).half()),
        row_bands(torch.from_numpy(np.array(ref32, np.float32))), lead=3)
    assert ok, (name, ratio, where)


class _Picked(Exception):
    pass


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("orig", [torch.float16, torch.bfloat16, torch.float32])
def test_k10_library_follows_the_compute_type(orig, d, monkeypatch):
    """The card's path (``_launch``) loads the library of the compute type, a
    quantized Q's ``orig_dtype`` when no config is given: fp16 the fp16
    library, bf16 the bf16 one, fp32 ``ValueError`` naming item 4c (the
    fault this replaces ran every quantized Q as bf16). K2/K3 pick theirs by
    q's type alike. The load is intercepted before any build."""
    loaded = []

    def load(name):
        loaded.append(name)
        raise _Picked

    monkeypatch.setattr(_build, "load", load)
    q = torch.zeros(1, 2, 128, d, dtype=orig)
    qq, kq = quantize_kv(q, "int8"), quantize_kv(q.bfloat16(), "int8")
    cfg = KernelConfig(d_head=d, dtype=DType.from_torch(orig))
    for launch in (lambda: fq._launch(qq, kq, kq, cfg, cfg.softmax_scale, True),
                   lambda: fb._launch(q, q, q, torch.zeros(1, 2, 128), torch.zeros(1, 2, 128),
                                      q, cfg, cfg.softmax_scale, fused=True)):
        fq._lib.cache_clear()
        fb._lib.cache_clear()
        if orig == torch.float32:
            with pytest.raises(ValueError, match="ROADMAP Queue 1, item 4c"):
                launch()
        else:
            with pytest.raises(_Picked):
                launch()
    fq._lib.cache_clear()
    fb._lib.cache_clear()
    if orig != torch.float32:
        stem = {128: "", 256: "_d256"}[d] + ("_f16" if orig == torch.float16 else "")
        assert loaded == [f"flash_quant{stem}.cu", f"flash_backward{stem}.cu"]
    assert qq.orig_dtype == orig
