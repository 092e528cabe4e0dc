"""fp32 through K1 and K11: the product scheme, the plain versions against
the JAX kernels in fp32, the launch plans and the libraries.

On the card K1 and K11 take fp32 from libraries of their own
(``csrc/flash_forward_f32.cu``, ``flash_forward_fori_f32.cu``,
``flash_forward_fori_d256_f32.cu``) on the fp32 main loop of
``csrc/flash_f32.cuh``: products split into TF32 halves (3xTF32 on
``mma.sync``), P kept in fp32, as the JAX kernels compute at
``Precision.HIGHEST`` with ``cast_p_to_dtype`` fp32.

- The product scheme, emulated before any kernel: TF32 rounding is
  round-to-nearest (ties away) to 10 mantissa bits, by integer ops on the
  fp32 bits. Attention at b 2, s 512 with fp32 sums, its two products on
  one TF32 product each, fails the adaptive rule against the fp32 plain
  version (err/bound about 100); on 3xTF32 (lo*hi + hi*lo, then hi*hi)
  it passes. So a plain TF32 kernel is refused, and the kernels split.
- The plain K1 and K11 (the CPU path of ``flash_forward_with_lse`` in
  fp32) against the JAX kernels in fp32 in interpret mode (K1's grid
  kernel, K11's FORI kernel at depths 2 and 3), at d 128 and 256: causal
  with a q_offset, a window, a softcap, sinks, GQA; the LSE within 1e-4.
  The rule is ``utils/testing.py::fp32_tolerance_check`` in each (batch,
  head, 64-row band): the port's error from the exact answer (numpy,
  fp64) at most twice the JAX kernel's, floored at fp32's floors. A
  planted fault, P rounded through TF32 once before P V, fails it.
- The fp32 launch plans fit a block at every width and depth and mirror
  the sources' constants; ``typed_source`` maps each kernel and type to its
  library, and names the ROADMAP sub-item for the kernels still without
  fp32.
"""

import dataclasses
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.ops.configs import (
    DType as JaxDType, KernelConfig as JaxKernelConfig, KVLoop as JaxKVLoop,
)
from flash_attention_from_scratch_tpu.ops.flash_forward import (
    flash_forward_with_lse as jax_flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu_torch.ops import _build
from flash_attention_from_scratch_tpu_torch.ops import flash_forward as ff
from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig, KVLoop
from flash_attention_from_scratch_tpu_torch.ops.reference import _scores, _sink_column
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    adaptive_tolerance_check, fp32_tolerance_check, make_qkv, row_bands,
)

CSRC = pathlib.Path(ff.__file__).resolve().parent.parent / "csrc"


# ---------------------------------------------------------------------------
# The product scheme, emulated.

def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32(a, b):
    """One TF32 product, fp32 sums."""
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    """3xTF32: each operand split into hi = tf32(x) and lo = tf32(x - hi);
    lo*hi + hi*lo first, then hi*hi, fp32 sums."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated(q, k, v, mm):
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return mm(torch.softmax(s, -1), v)


def test_tf32_rounding_is_round_to_nearest():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -11 + 2 ** -20, -(1.0 + 3 * 2 ** -11),
                      1.0 + 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 * 2 ** -10), 1.0])
    assert torch.equal(tf32(x), want)
    # hi + lo keeps 22 significant bits.
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    hi = tf32(y)
    rest = (y.double() - hi.double() - tf32(y - hi).double()).abs()
    assert float((rest / y.double().abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("d_head", [128, 256])
def test_one_tf32_product_fails_and_3xtf32_passes(d_head):
    """Attention at b 2, s 512 with fp32 sums, against the fp32 plain
    version by the adaptive rule: one TF32 product a matmul misses the
    bound many times over; 3xTF32 meets it."""
    q, k, v = (torch.from_numpy(x) for x in make_qkv(2, 2, 512, d_head, seed=3))
    ref, _ = ff.flash_forward_plain(q, k, v, KernelConfig(d_head=d_head, dtype=DType.FP32))
    ok, err, base = adaptive_tolerance_check(_emulated(q, k, v, mm_tf32), ref, ref)
    assert not ok and base == 0.0
    bound = 2 * torch.finfo(torch.float32).eps * float(ref.abs().max()) * math.sqrt(512)
    assert err > 20 * bound, (err, bound)
    ok, err, _ = adaptive_tolerance_check(_emulated(q, k, v, mm_3xtf32), ref, ref)
    assert ok and err < 0.5 * bound, (err, bound)


# ---------------------------------------------------------------------------
# The plain K1 and K11 in fp32 against the JAX kernels in fp32.

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


def _inputs(name):
    d, h, kvh, sq, skv, kw, with_sinks = FLASH_CASES[name]
    q, k, v = make_qkv(1, h, sq, d, kv_heads=kvh, seq_kv=skv, seed=41)
    sinks = (np.random.default_rng(42).standard_normal(h).astype(np.float32)
             if with_sinks else None)
    return (q, k, v), d, kw, sinks


def _exact(name):
    """The exact answer in numpy fp64: softcap, mask (row i at position
    q_offset + i; a window keeps keys less than ``window`` behind), sinks in
    the denominator, GQA."""
    (q, k, v), d, kw, sinks = _inputs(name)
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    group = q.shape[1] // k.shape[1]
    k, v = np.repeat(k, group, 1), np.repeat(v, group, 1)
    s = q @ k.transpose(0, 1, 3, 2) / math.sqrt(d)
    cap = kw.get("attn_softcap", 0.0)
    if cap:
        s = np.tanh(s / cap) * cap
    if kw.get("causal"):
        qpos = np.arange(q.shape[2])[:, None] + kw.get("q_offset", 0)
        kpos = np.arange(k.shape[2])[None, :]
        keep = kpos <= qpos
        if kw.get("window"):
            keep &= qpos - kpos < kw["window"]
        s = np.where(keep, s, -1e30)
    m = s.max(-1, keepdims=True)
    if sinks is not None:
        m = np.maximum(m, sinks.astype(np.float64)[None, :, None, None])
    e = np.exp(s - m)
    den = e.sum(-1, keepdims=True)
    if sinks is not None:
        den = den + np.exp(sinks.astype(np.float64)[None, :, None, None] - m)
    return torch.from_numpy((e / den) @ v)


def _jax_flash(name, depth=0):
    """The JAX kernel in fp32 (K1's grid kernel, or K11 at ``depth``):
    (output, LSE) as numpy fp32."""
    (q, k, v), d, kw, sinks = _inputs(name)
    loop = dict(kv_loop=JaxKVLoop.FORI, num_kv_buffers=depth) if depth else {}
    cfg = JaxKernelConfig(block_q=128, block_kv=128, d_head=d, dtype=JaxDType.FP32,
                          scale_q=False, optimized_softmax=not kw.get("window"), **loop, **kw)
    out, lse = jax_flash_forward_with_lse(
        *(jnp.asarray(x) for x in (q, k, v)), cfg,
        sinks=None if sinks is None else jnp.asarray(sinks))
    return torch.from_numpy(np.array(out)), np.asarray(lse)


def _port_args(name):
    (q, k, v), d, kw, sinks = _inputs(name)
    cfg = KernelConfig(d_head=d, dtype=DType.FP32, **kw)
    return [torch.from_numpy(x) for x in (q, k, v)], cfg, (
        None if sinks is None else torch.from_numpy(sinks))


def _rule(name, out, jax_out):
    """The port's error from the exact answer at most twice the JAX
    kernel's, per (batch, head, 64-row band), fp32's floors."""
    return fp32_tolerance_check(row_bands(out), row_bands(jax_out), row_bands(_exact(name)),
                                lead=3)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_forward_fp32_matches_jax(name):
    jax_out, jax_lse = _jax_flash(name)
    args, cfg, sinks = _port_args(name)
    out, lse = ff.flash_forward_with_lse(*args, cfg, sinks=sinks)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert torch.equal(out, ff.flash_forward(*args, cfg, sinks=sinks))
    ok, ratio, where = _rule(name, out, jax_out)
    assert ok, (name, ratio, where)
    np.testing.assert_allclose(lse.numpy(), jax_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name,depth", FORI_CASES, ids=[f"{n}-nb{d}" for n, d in FORI_CASES])
def test_fori_fp32_matches_jax(name, depth):
    """K11 (``kv_loop=FORI``): on the CPU the same plain version, held to the
    JAX FORI kernel in fp32."""
    jax_out, jax_lse = _jax_flash(name, depth)
    args, cfg, sinks = _port_args(name)
    cfg = dataclasses.replace(cfg, kv_loop=KVLoop.FORI, num_kv_buffers=depth)
    out, lse = ff.flash_forward_with_lse(*args, cfg, sinks=sinks)
    assert out.dtype == torch.float32
    ok, ratio, where = _rule(name, out, jax_out)
    assert ok, (name, depth, ratio, where)
    np.testing.assert_allclose(lse.numpy(), jax_lse, atol=1e-4, rtol=0)


def _plain_p_through_tf32(q, k, v, cfg, sinks):
    """K1's plain version with the planted fault: P rounded through TF32
    once before P V, as a kernel that fed P to one TF32 product would."""
    s = _scores(q, k, causal=cfg.causal, scale=cfg.softmax_scale,
                q_offset=cfg.q_offset if cfg.causal else None, window=cfg.window,
                softcap=cfg.attn_softcap)
    full = s if sinks is None else torch.cat([s, _sink_column(s, sinks)], -1)
    p = tf32(torch.softmax(full, dim=-1)[..., :s.shape[-1]])
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    return torch.matmul(p, v)


@pytest.mark.parametrize("name", ["d128-window", "d256-causal-q_offset"])
def test_rule_fails_p_rounded_through_tf32(name):
    """The planted fault fails the rule where the plain version passes."""
    jax_out, _ = _jax_flash(name)
    args, cfg, sinks = _port_args(name)
    ok, _, _ = _rule(name, ff.flash_forward_plain(*args, cfg, sinks)[0], jax_out)
    assert ok
    ok, ratio, _ = _rule(name, _plain_p_through_tf32(*args, cfg, sinks), jax_out)
    assert not ok, f"P rounded through TF32 passed the fp32 rule (worst err/bound {ratio})"


# ---------------------------------------------------------------------------
# The fp32 launch plans, held to the sources.

MAIN_LOOP = (CSRC / "flash_f32.cuh").read_text()
GRID_F32 = (CSRC / ff.SOURCE_F32).read_text()
FORI_F32 = (CSRC / ff.SOURCES_FORI_F32[128]).read_text()
STATIC_BARRIERS = 128  # the kernels' static mbarriers, at most


@pytest.mark.parametrize("d_head", ff.D_HEADS)
@pytest.mark.parametrize("nbuf", [1, 2, 3, 4])
def test_fori_fp32_plan_mirrors_the_kernel(nbuf, d_head):
    """K11 in fp32: 4 consumer warps of 16 rows and a producer warp; 32 keys
    a slot at d 128, 16 at d 256, every depth within a block's shared
    memory."""
    warps = int(re.search(r"FORI_WARPS = (\d+);", FORI_F32).group(1))
    a, b = map(int, re.search(r"FORI_BK = FORI_HD == 128 \? (\d+) : (\d+);", FORI_F32).groups())
    assert f"case {nbuf}: return launch_f32<{nbuf}, FORI_HD, FORI_WARPS, FORI_BK>" in FORI_F32
    assert (warps, a if d_head == 128 else b) == ff.FORI_TILES_F32[d_head]
    p = ff.fori_plan(nbuf, 2, 8, 1024, 1024, d_head, 4)
    keys = a if d_head == 128 else b
    assert (p.rows, p.keys, p.slots, p.threads) == (warps * 16, keys, nbuf, (warps + 1) * 32)
    assert p.smem == warps * 16 * d_head * 4 + nbuf * 2 * keys * d_head * 4 + ff.ALIGN_SLACK
    assert p.smem + STATIC_BARRIERS <= ff.SMEM_LIMIT, p
    assert p.grid == (-(-1024 // p.rows), 8, 2)
    # the 16-bit plan is unchanged by the element size's default
    assert ff.fori_plan(nbuf, 2, 8, 1024, 1024, d_head) == ff.fori_plan(
        nbuf, 2, 8, 1024, 1024, d_head, 2)
    assert (CSRC / ff.SOURCES_FORI_F32[d_head]).exists()


@pytest.mark.parametrize("d_head", ff.D_HEADS)
def test_grid_fp32_plan_mirrors_the_kernel(d_head):
    """K1 in fp32: ``GridTileF32<HD>``, one CTA an item (no persistent CTAs),
    at most 8 warps (ptxas gives more only 168 registers a thread)."""
    tile = re.search(r"struct GridTileF32 \{(.*?)\n\};", GRID_F32, re.S).group(1)

    def field(name):
        got = re.search(rf"\b{name} = (?:HD == 128 \? (\d+) : (\d+)|(\d+));", tile).groups()
        return int(got[2]) if got[2] else int(got[0] if d_head == 128 else got[1])

    warps, keys, slots, q_bufs = ff.GRID_TILES_F32[d_head]
    assert (field("WARPS"), field("BK"), field("NB"), q_bufs) == (warps, keys, slots, 1)
    assert warps + 1 <= 8
    assert f"if (d_head == {d_head}) return launch<{d_head}>(" in GRID_F32
    assert "(void)ctas;" in GRID_F32
    for shape in [(1, 32, 4000, 4000, True, 0, 0), (2, 16, 1024, 2048, True, 512, 1024),
                  (1, 8, 64, 64, False, 0, 0)]:
        p = ff.grid_plan(*shape, 132, d_head, 4)
        assert (p.rows, p.keys, p.slots, p.threads) == (warps * 16, keys, slots,
                                                        (warps + 1) * 32)
        assert p.ctas == p.n_items == -(-shape[2] // p.rows) * shape[1] * shape[0]
        assert p.smem == warps * 16 * d_head * 4 + slots * 2 * keys * d_head * 4 + ff.ALIGN_SLACK
        assert p.smem + STATIC_BARRIERS <= ff.SMEM_LIMIT
        assert ff.grid_plan(*shape, 132, d_head) == ff.grid_plan(*shape, 132, d_head, 2)


def test_main_loop_sizes_its_tiles_in_fp32():
    """``F32Tile``: the Q tile and the K, V slots in 4-byte elements, in
    boxes of 32 columns (128 bytes), within a block."""
    tile = re.search(r"struct F32Tile \{(.*?)\n\};", MAIN_LOOP, re.S).group(1)
    assert "Q_BYTES = f32_tile_bytes(BQ, HD);" in tile
    assert "SLOT = 2 * f32_tile_bytes(BK, HD);" in tile
    assert "SMEM = Q_BYTES + NB * SLOT + ALIGN_SLACK;" in tile
    assert "THREADS = (WARPS + 1) * 32;" in tile
    assert "return rows * d * 4;" in MAIN_LOOP and "F32_BOX_COLS = 32;" in MAIN_LOOP
    assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in MAIN_LOOP
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in MAIN_LOOP
    assert "cvt.rna.tf32.f32" in MAIN_LOOP
    for header in ("flash_wgmma.cuh", "hopper.cuh"):  # the 16-bit loop is not the fp32 one's
        assert "tf32" not in (CSRC / header).read_text()


# ---------------------------------------------------------------------------
# The libraries by kernel and type.

FP32_REFUSED = {"paged_attention.cu": ("K4/K5", "4c-2"), "quant_matmul.cu": ("K6-K9", "4c-2"),
                "flash_backward.cu": ("K2/K3", "4c-3"),
                "flash_backward_d256.cu": ("K2/K3", "4c-3"),
                "flash_quant.cu": ("K10", "4c-3"), "flash_quant_d256.cu": ("K10", "4c-3")}


@pytest.mark.parametrize("source", sorted(_build.FP32_SOURCES) + sorted(FP32_REFUSED))
def test_typed_source_by_kernel_and_type(source):
    stem = source[:-3]
    assert _build.typed_source(source, torch.bfloat16, "k") == source
    assert _build.typed_source(source, torch.float16, "k") == f"{stem}_f16.cu"
    if source in FP32_REFUSED:
        kernel, item = FP32_REFUSED[source]
        with pytest.raises(ValueError, match=f"ROADMAP Queue 1, item {item}") as e:
            _build.typed_source(source, torch.float32, kernel)
        assert "ROADMAP Queue 1, item 4c" in str(e.value)
    else:
        assert _build.typed_source(source, torch.float32, "k") == f"{stem}_f32.cu"
        assert (CSRC / f"{stem}_f32.cu").exists()
    with pytest.raises(ValueError, match="not a type the JAX package's kernels take"):
        _build.typed_source(source, torch.float64, "k")
