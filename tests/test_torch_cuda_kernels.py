"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: they skip without a card, decided inside the ``cuda``
fixture. On a machine with one (which need not have JAX, so skip the
repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: the adaptive tolerance rule against the plain version in bf16
(native) and in fp32 on the same bf16-rounded inputs, held in each
(batch, head, 64-row band) of a flash output or gradient and each sequence
of a paged one on its own (each (sequence, token) with multi-token
queries); the LSE within 1e-3. fp32 kernels (K1, K11) by
``utils/testing.py::fp32_tolerance_check``: the error from the exact answer
(the plain version in fp64) at most twice the plain fp32 version's, fp32's
floors, the LSE within 1e-4. With ``int8_compute`` the native reference
is the plain int8-compute version and the fp32 one the plain version
without it on the same pages, q in fp32. The quantized matmuls: the
weight-only kernels (K6, K7) by the same rule in each 16-row band against
the plain version cast to bf16 and in fp32; the a8 kernels (K8, K9) within
one bf16 ulp of each value of the plain version, whose integer sums are
exact as the kernel's are (on one-hot rows bit for bit), and their
activation quantization kernel bit for bit. The compiled step (CUDA-graph
replays of ``models/step_graphs.py``) equals the eager step bit for bit,
logits and pages, and counts the eager step's launches on every replay;
``prefill_chunked`` (K1 with ``q_offset`` over [prefix | chunk]) is held to
``prefill`` by the adaptive rule against the same model in fp32. A MoE
model's routed steps and loops replay bit for bit too; the routing on the
card gives the CPU's dispatch and combine bit for bit, and the MoE layer in
fp32 within 1e-5 of the CPU's largest output; a checkpoint and bf16
safetensors shards restore onto the card bit for bit. The
training step compares
the parameter gradients of the split (the default) and the fused backward
kernels with those of the plain backward: all three run the same bf16
arithmetic and differ in summation order only, so they agree within 1e-2
of each leaf's largest gradient (about one bf16 ulp).
"""

import collections
import dataclasses
import re

import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu_torch.models import decode, llama, moe, train
from flash_attention_from_scratch_tpu_torch.models.step_graphs import StepGraphs
from flash_attention_from_scratch_tpu_torch.ops import _build
from flash_attention_from_scratch_tpu_torch.ops.configs import (
    MAX_KV_BUFFERS, DType, KernelConfig, KVLoop,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
    KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED, SOURCES as BACKWARD_SOURCES, flash_backward,
    flash_backward_plain,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
    KERNEL as FLASH, KERNEL_FORI as FORI, SOURCE as FLASH_SOURCE, SOURCE_FORI, SOURCES_FORI,
    flash_forward_plain, flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
    KERNEL as FLASH_QUANT, SOURCE as SOURCE_QUANT, SOURCES as SOURCES_QUANT,
    flash_forward_quantized, flash_forward_quantized_plain,
)
from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
    KERNEL as PAGED, KERNEL_MERGE, MODE_INT8C, MODES, SOURCE as PAGED_SOURCE, kernel_name,
    paged_decode_attention, paged_decode_attention_plain, plan,
)
from flash_attention_from_scratch_tpu_torch.ops.quant import (
    QTensor, dequantize, quantize_kv, quantize_kv_pages,
)
from flash_attention_from_scratch_tpu_torch.ops.reference import reference_attention
from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
    KERNELS as QMM, SOURCE as QMM_SOURCE, QuantizedWeight, quant_matmul, quant_matmul_plain,
    quantize_activations, quantize_rows, quantize_weight,
)
from flash_attention_from_scratch_tpu_torch.tools import bench_quant
from flash_attention_from_scratch_tpu_torch.tools.mosaic_dump import (
    KERNEL_SASS_DIR, check_regression, resource_usage, sass_by_function,
)
from flash_attention_from_scratch_tpu_torch.utils.device import sm_count
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    fp32_tolerance_check, make_qkv, row_bands, sliced_tolerance_check,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


FLASH_CASES = [
    (256, dict()), (128, dict()), (256, dict(causal=True)),
    (256, dict(causal=True, window=100)), (128, dict(causal=True, q_offset=128)),
    (128, dict(causal=True, q_offset=128, window=70)),
    (256, dict(causal=True, attn_softcap=30.0))]


# The shapes the main loop's 128-row work items and 128-key slots make
# ragged: the second consumer warpgroup of the last Q tile past seq_q, the
# last KV tile half zero-filled (``seq_kv`` is popped from the options).
RAGGED_CASES = [
    (192, dict(seq_kv=320)), (192, dict(causal=True, seq_kv=320)),
    (192, dict(causal=True, q_offset=128, window=70, seq_kv=320))]

# K1's own: rows 79-191 see no key (positions past the 64 keys plus the
# window), so with the sinks their output is 0 and their LSE the sink's;
# strided (b, s, h, d) views as training passes them; many work items a
# persistent CTA (b 2 x 8 heads x 16 Q tiles over 132 SMs).
K1_CASES = FLASH_CASES + RAGGED_CASES + [
    (128, dict(causal=True, q_offset=64, window=16, seq_kv=64)),
    (256, dict(causal=True, strided=True)), (192, dict(strided=True, seq_kv=320)),
    (2048, dict(causal=True)), (2048, dict(causal=True, window=300, strided=True))]


@pytest.mark.parametrize("sq,kw", K1_CASES)
def test_flash_kernel_matches_plain(cuda, sq, kw):
    """K1 (persistent, on the wgmma main loop) with sinks and the LSE."""
    kw = dict(kw)
    skv, strided = kw.pop("seq_kv", 256), kw.pop("strided", False)
    check_flash_kernel(cuda, sq, KernelConfig(**kw), FLASH, seq_kv=skv, strided=strided)


@pytest.mark.parametrize("sq,kw", K1_CASES)
def test_flash_kernel_d256_matches_plain(cuda, sq, kw):
    """K1 at head width 256 (its one-consumer-warpgroup CTA, 64-row items
    and 64-key slots) on K1's cases, with sinks and the LSE."""
    kw = dict(kw)
    skv, strided = kw.pop("seq_kv", 256), kw.pop("strided", False)
    check_flash_kernel(cuda, sq, KernelConfig(d_head=256, **kw), FLASH, seq_kv=skv,
                       strided=strided)


def test_flash_kernel_d256_plain_grid_matches_persistent(cuda):
    """At d 256 too, one CTA per work item gives the persistent output bit
    for bit, causal and not."""
    from flash_attention_from_scratch_tpu_torch.ops import flash_forward as ff

    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, 1024, 256, kv_heads=2, seed=4))
    for cfg in (KernelConfig(d_head=256, causal=True), KernelConfig(d_head=256)):
        out, lse = ff._launch(q, k, v, cfg, None, True)
        grid_out, grid_lse = ff._launch(q, k, v, cfg, None, True, ctas=0)
        assert torch.equal(out, grid_out) and torch.equal(lse, grid_lse)


def test_flash_kernel_plain_grid_matches_persistent(cuda):
    """One CTA per work item (``ctas=0``) gives K1's persistent output bit
    for bit: the schedule moves work, not arithmetic."""
    from flash_attention_from_scratch_tpu_torch.ops import flash_forward as ff

    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, 1024, kv_heads=2, seed=4))
    cfg = KernelConfig(causal=True)
    out, lse = ff._launch(q, k, v, cfg, None, True)
    grid_out, grid_lse = ff._launch(q, k, v, cfg, None, True, ctas=0)
    assert torch.equal(out, grid_out) and torch.equal(lse, grid_lse)


FORI_CASES = FLASH_CASES + RAGGED_CASES


@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
@pytest.mark.parametrize("sq,kw", FORI_CASES)
def test_fori_kernel_matches_plain(cuda, sq, kw, nbuf):
    """K11 at every ring depth it is built for, on K1's cases and the
    ragged ones."""
    kw = dict(kw)
    skv = kw.pop("seq_kv", 256)
    cfg = KernelConfig(kv_loop=KVLoop.FORI, num_kv_buffers=nbuf, **kw)
    check_flash_kernel(cuda, sq, cfg, FORI, seq_kv=skv)


@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
@pytest.mark.parametrize("sq,kw", FORI_CASES + [(256, dict(causal=True, strided=True))])
def test_fori_kernel_d256_matches_plain(cuda, sq, kw, nbuf):
    """K11 at head width 256 (its one-consumer-warpgroup CTA, 64-key slots,
    32-key slots at depth 4) at every ring depth, on K11's cases and a
    strided one, with sinks and the LSE."""
    kw = dict(kw)
    skv, strided = kw.pop("seq_kv", 256), kw.pop("strided", False)
    cfg = KernelConfig(d_head=256, kv_loop=KVLoop.FORI, num_kv_buffers=nbuf, **kw)
    check_flash_kernel(cuda, sq, cfg, FORI, seq_kv=skv, strided=strided)


def check_flash_kernel(cuda, sq, cfg, kernel, seq_kv=256, strided=False):
    q, k, v = (torch.from_numpy(x).to(cuda, cfg.dtype.torch_dtype) for x in
               make_qkv(2, 8, sq, cfg.d_head, kv_heads=2, seq_kv=seq_kv, seed=1))
    if strided:  # (b, h, s, d) views of contiguous (b, s, h, d) rows
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    sinks = torch.linspace(-2, 2, 8, device=cuda)
    before = _build.launch_counts[kernel]
    out, lse = flash_forward_with_lse(q, k, v, cfg, sinks=sinks)
    torch.cuda.synchronize()
    assert _build.launch_counts[kernel] == before + 1
    ref16, _ = flash_forward_plain(q, k, v, cfg, sinks)
    ref32, lse32 = flash_forward_plain(
        q.float(), k.float(), v.float(),
        dataclasses.replace(cfg, dtype=DType.FP32), sinks)
    ok, ratio, where = sliced_tolerance_check(
        row_bands(out), row_bands(ref16), row_bands(ref32), lead=3)
    assert ok, (ratio, where)
    assert float((lse - lse32).abs().max()) <= 1e-3


@pytest.mark.parametrize("heads,kv_heads", [(8, 2), (4, 4), (8, 4), (16, 2)])
def test_paged_kernel_matches_plain(cuda, heads, kv_heads):
    rng = np.random.default_rng(2)
    ps, num_pages = 16, 64
    lengths = torch.tensor([0, 1, 31, 200, 500], dtype=torch.int32, device=cuda)
    k = torch.full((kv_heads, num_pages, ps, 128), float("nan"), device=cuda)
    v = torch.full_like(k, float("nan"))
    perm = rng.permutation(num_pages)
    tables = torch.full((5, 32), -1, dtype=torch.int32, device=cuda)
    nxt = 0
    for b, n in enumerate(lengths.tolist()):
        for i in range(-(-n // ps)):
            page, rows = int(perm[nxt]), min(ps, n - i * ps)
            nxt += 1
            tables[b, i] = page
            k[:, page, :rows] = torch.randn(kv_heads, rows, 128, device=cuda)
            v[:, page, :rows] = torch.randn(kv_heads, rows, 128, device=cuda)
    q = torch.randn(5, heads, 128, device=cuda)
    # fp32 copies of the bf16 values: the baseline is rounding inside the
    # function, not of its inputs.
    q, k, v = (x.bfloat16().float() for x in (q, k, v))
    for kw in (dict(), dict(window=64), dict(softcap=20.0)):
        before = _build.launch_counts[PAGED]
        out = paged_decode_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                     lengths, tables, **kw)
        torch.cuda.synchronize()
        assert _build.launch_counts[PAGED] == before + 1
        ref16 = paged_decode_attention_plain(q.bfloat16(), k.bfloat16(),
                                             v.bfloat16(), lengths, tables,
                                             scale=128 ** -0.5, **kw)
        ref32 = paged_decode_attention_plain(q, k, v, lengths, tables,
                                             scale=128 ** -0.5, **kw)
        assert torch.isfinite(out).all() and float(out[0].abs().max()) == 0.0
        ok, ratio, where = sliced_tolerance_check(out, ref16, ref32, lead=1)
        assert ok, (kw, ratio, where)


# variant: (K/V mode, Q kind, int8_compute): the bench tool's and fp8 Q
# over int4 K/V.
QUANT_VARIANTS = {**bench_quant.CHECK_VARIANTS, "fp8q_int4kv": ("int4", "fp8", False)}


QUANT_CASES = [
    *[(variant, dict(causal=causal), False) for variant in QUANT_VARIANTS
      for causal in (False, True)],
    ("int8c", dict(causal=True, window=200), False),
    ("int8kv", dict(causal=True, window=100), False),
    ("fp8", dict(causal=True, attn_softcap=20.0), False),
    ("int8kv", dict(causal=True), True), ("int8c", {}, True),
    # s 640 (five 128-key groups, an odd count of 128-row Q tiles), causal,
    # 32 Q / 8 KV heads (``seq`` and ``heads`` are popped from the options).
    *[(variant, dict(causal=True, seq=640, heads=(32, 8)), False)
      for variant in QUANT_VARIANTS]]


@pytest.mark.parametrize("variant,kw,strided", QUANT_CASES)
def test_flash_quant_kernel_matches_plain(cuda, variant, kw, strided):
    """K10 vs its plain version (b 2, 8 Q / 2 KV heads, s 384: three
    int8-compute groups, unless the case says otherwise): the adaptive rule
    per (batch, head, 64-row band) against the plain version and reference
    attention in fp32 on the inputs dequantized in fp32; ``strided`` hands
    Q over as a transposed view, whose strides the output keeps."""
    check_quant_variant(cuda, variant, kw, strided, 128)


@pytest.mark.parametrize("variant,kw,strided", QUANT_CASES + [
    # Gemma-2's softcap on every upcast variant, with a window.
    (variant, dict(causal=True, window=200, attn_softcap=50.0), False)
    for variant in QUANT_VARIANTS if not QUANT_VARIANTS[variant][2]])
def test_flash_quant_kernel_d256_matches_plain(cuda, variant, kw, strided):
    """K10 at head width 256 (one consumer warpgroup of 64 Q rows, 64-key
    upcast tiles, int8 compute's P V over V's two column halves) on the
    cases of the test above and Gemma-2's softcap, by its rule."""
    check_quant_variant(cuda, variant, kw, strided, 256)


def check_quant_variant(cuda, variant, kw, strided, d_head, dtype=torch.bfloat16):
    """``variant`` on inputs of ``dtype`` (a quantized Q's ``orig_dtype``),
    the config in that type."""
    kv_mode, q_kind, i8c = QUANT_VARIANTS[variant]
    kw = dict(kw)
    seq, (heads, kv_heads) = kw.pop("seq", 384), kw.pop("heads", (8, 2))
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in
               make_qkv(2, heads, seq, d_head, kv_heads=kv_heads, seed=8))
    qq = q if q_kind == "bf16" else quantize_kv(q, q_kind)
    if strided:
        rows = lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731
        qq = rows(qq) if q_kind == "bf16" else QTensor(rows(qq.values), qq.scales, q_kind)
    kq, vq = quantize_kv(k, kv_mode), quantize_kv(v, kv_mode)
    cfg = KernelConfig(d_head=d_head, dtype=DType.from_torch(dtype), **kw)
    check_flash_quant(qq, kq, vq, cfg, i8c, (variant, kw))


def check_flash_quant(qq, kq, vq, cfg, i8c, what):
    """K10 once on (qq, kq, vq) by the rule of the test above; the output
    in the config's type with Q's strides."""
    before = _build.launch_counts[FLASH_QUANT]
    out = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c)
    torch.cuda.synchronize()
    assert _build.launch_counts[FLASH_QUANT] == before + 1
    q_vals = qq.values if isinstance(qq, QTensor) else qq
    assert out.dtype == cfg.dtype.torch_dtype and out.stride() == q_vals.stride()
    native = flash_forward_quantized_plain(qq, kq, vq, cfg, scale=cfg.softmax_scale,
                                           int8_compute=i8c)

    def fp32(x):
        if isinstance(x, QTensor):
            return dequantize(dataclasses.replace(x, orig_dtype=torch.float32))
        return x.float()

    ref32 = reference_attention(*(fp32(x) for x in (qq, kq, vq)), causal=cfg.causal,
                                q_offset=0 if cfg.causal else None, window=cfg.window,
                                softcap=cfg.attn_softcap)
    assert bool(torch.isfinite(out).all())
    ok, ratio, where = sliced_tolerance_check(
        row_bands(out), row_bands(native), row_bands(ref32), lead=3)
    assert ok, (what, ratio, where)
    return out


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_int8c_kernel_pairs_p_with_its_v_rows(cuda, causal):
    """int8_compute with a one-hot V (key i holds 127 at column i mod 128):
    output column c is the weight of the keys i = c mod 128 alone, so a P
    register paired with the wrong V row of its 16-key chunk (the kernel
    permutes V's key order to match P's accumulator columns) moves weight
    between columns and fails the rule against the plain int8 path."""
    q, k, _ = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, 384, kv_heads=2, seed=12))
    onehot = torch.zeros((2, 2, 384, 128), dtype=torch.int8, device=cuda)
    keys = torch.arange(384, device=cuda)
    onehot[:, :, keys, keys % 128] = 127
    vq = QTensor(onehot, torch.full((2, 2), 1 / 127, device=cuda), "int8")
    qq, kq = quantize_kv(q, "int8"), quantize_kv(k, "int8")
    out = check_flash_quant(qq, kq, vq, KernelConfig(causal=causal), True, "one-hot V")
    # Every key's weight lands in its own column: the row sums are 1.
    assert float((out.float().sum(-1) - 1).abs().max()) < 2e-2


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_int8c_kernel_d256_pairs_p_with_its_v_rows(cuda, causal):
    """The one-hot test above at d 256: key i holds 127 at column i mod 256
    (keys 0-127 in V's first column half, 128-255 in its second), so a P
    register paired with the wrong V row, or a column half folded into the
    wrong half of O, moves weight between columns."""
    q, k, _ = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, 384, 256, kv_heads=2, seed=12))
    onehot = torch.zeros((2, 2, 384, 256), dtype=torch.int8, device=cuda)
    keys = torch.arange(384, device=cuda)
    onehot[:, :, keys, keys % 256] = 127
    vq = QTensor(onehot, torch.full((2, 2), 1 / 127, device=cuda), "int8")
    qq, kq = quantize_kv(q, "int8"), quantize_kv(k, "int8")
    out = check_flash_quant(qq, kq, vq, KernelConfig(d_head=256, causal=causal), True,
                            "one-hot V d256")
    assert float((out.float().sum(-1) - 1).abs().max()) < 2e-2


@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
def test_fori_kernel_is_deterministic(cuda, nbuf):
    """K11 has no atomics and a fixed order: two calls agree bit for bit
    (a slot refilled before both warpgroups finished with it would not)."""
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, 1024, kv_heads=2, seq_kv=1088, seed=13))
    for kw in (dict(), dict(causal=True, q_offset=64)):
        cfg = KernelConfig(kv_loop=KVLoop.FORI, num_kv_buffers=nbuf, **kw)
        first, lse = flash_forward_with_lse(q, k, v, cfg)
        second, lse2 = flash_forward_with_lse(q, k, v, cfg)
        assert torch.equal(first, second) and torch.equal(lse, lse2), kw


@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
def test_fori_kernel_d256_is_deterministic(cuda, nbuf):
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, 1024, 256, kv_heads=2, seq_kv=1088, seed=13))
    for kw in (dict(), dict(causal=True, q_offset=64)):
        cfg = KernelConfig(d_head=256, kv_loop=KVLoop.FORI, num_kv_buffers=nbuf, **kw)
        first, lse = flash_forward_with_lse(q, k, v, cfg)
        second, lse2 = flash_forward_with_lse(q, k, v, cfg)
        assert torch.equal(first, second) and torch.equal(lse, lse2), kw


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("variant", list(QUANT_VARIANTS))
def test_flash_quant_kernel_is_deterministic(cuda, variant, d_head):
    kv_mode, q_kind, i8c = QUANT_VARIANTS[variant]
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, 1024, d_head, kv_heads=2, seed=14))
    qq = q if q_kind == "bf16" else quantize_kv(q, q_kind)
    kq, vq = quantize_kv(k, kv_mode), quantize_kv(v, kv_mode)
    for cfg in (KernelConfig(d_head=d_head), KernelConfig(d_head=d_head, causal=True)):
        first = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c)
        assert torch.equal(first, flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c))


def test_attention_kernels_run_on_wgmma(cuda):
    """K1, K11 and K10's upcast kernels issue bf16 wgmma (HGMMA), K10's int8
    compute kernel int8 wgmma (IGMMA); none keeps an mma.sync (HMMA/IMMA).
    K1 spills nothing (no local memory, no stack)."""
    k1 = sass_by_function(FLASH_SOURCE)
    assert [n for n in k1 if "flash_forward_kernel" in n], list(k1)
    fori = sass_by_function(SOURCE_FORI)
    assert len([n for n in fori if "flash_forward_fori_kernel" in n]) == MAX_KV_BUFFERS
    quant = sass_by_function(SOURCE_QUANT)
    assert len([n for n in quant if "flash_quant_kernel" in n]) == 9
    for name, sass in {**k1, **fori, **quant}.items():
        want = "IGMMA" if "flash_quant_i8_kernel" in name else "HGMMA"
        assert want in sass, name
        assert "HMMA" not in sass and "IMMA" not in sass, name
    assert any("flash_quant_i8_kernel" in n for n in quant)
    for name, use in resource_usage(FLASH_SOURCE).items():
        assert use["local"] == 0 and use["stack"] == 0, (name, use)


def test_d256_attention_kernels_run_on_wgmma(cuda):
    """K11's and K10's d-256 libraries hold their kernels at d 256 alone
    (four ring depths; nine upcast kernels and the int8-compute one), each
    on wgmma (HGMMA; IGMMA for int8 compute) with no mma.sync."""
    fori = sass_by_function(SOURCES_FORI[256])
    names = [n for n in fori if "flash_forward_fori_kernel" in n]
    assert len(names) == MAX_KV_BUFFERS and all("Li256EE" in n for n in names), list(fori)
    quant = sass_by_function(SOURCES_QUANT[256])
    upcast = [n for n in quant if "flash_quant_kernel" in n]
    i8 = [n for n in quant if "flash_quant_i8_kernel" in n]
    assert len(upcast) == 9 and len(i8) == 1, list(quant)
    assert all("Li256EE" in n for n in upcast + i8), list(quant)
    for name in names + upcast + i8:
        sass = {**fori, **quant}[name]
        assert ("IGMMA" if name in i8 else "HGMMA") in sass, name
        assert "HMMA" not in sass and "IMMA" not in sass, name


def test_kernel_sass_within_committed_budget(cuda):
    """Every kernel symbol of every library, rebuilt from the sources, within
    the committed baselines under the package's ``kernel_sass/``
    (``tools/mosaic_dump.py::check_regression``: total opcodes +5%, one
    opcode max(8, +25%), no register more, no new stack or local bytes)."""
    failures = check_regression(KERNEL_SASS_DIR, log=lambda *a: None)
    assert not failures, "\n".join(failures)


def test_backward_kernels_run_on_wgmma_without_spills(cuda):
    """K2's and K3's kernels (the dK/dV kernel with and without dQ, the dQ
    kernel; each head width's library its own) issue bf16 wgmma (HGMMA)
    and no mma.sync (HMMA), and spill nothing: no local memory, no stack."""
    for d, source in BACKWARD_SOURCES.items():
        sass = sass_by_function(source)
        usage = resource_usage(source)
        names = [n for n in sass if "flash_backward_" in n]
        assert len(names) == 3 and all(f"Li{d}EE" in n for n in names), list(sass)
        assert len([n for n in names if "flash_backward_dkv_kernel" in n]) == 2
        for name in names:
            assert "HGMMA" in sass[name], name
            assert "HMMA" not in sass[name], name
            assert usage[name]["local"] == 0 and usage[name]["stack"] == 0, (name, usage[name])


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def check_quant_matmul(got, x, wq, act_quant):
    """The rule of the module docstring; returns the worst err/bound (a8:
    the worst error in ulps)."""
    plain = quant_matmul_plain(x, wq, act_quant)
    if act_quant:
        ratio = float(((got.float() - plain.float()).abs() / _bf16_ulp(plain.float())).max())
        return ratio <= 1.0, ratio
    ref32 = quant_matmul_plain(x, wq, act_quant, out_dtype=torch.float32)
    pad = -x.shape[0] % 16

    def bands(t):
        return row_bands(torch.nn.functional.pad(t.float(), (0, 0, 0, pad))[None], 16)

    ok, ratio, _ = sliced_tolerance_check(bands(got), bands(plain).bfloat16(),
                                          bands(ref32), lead=2)
    return ok, ratio


QMM_RAGGED = [(512, 320), (544, 336)]  # (K, N): K 544 and N 336 no tile multiple
QMM_LLAMA = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
QMM_CASES = (
    [(mode, False, k, n, m) for mode in ("int8", "int4") for k, n in QMM_RAGGED
     for m in (1, 16, 17, 32, 64, 100, 1024)]
    + [(mode, False, k, n, m) for mode in ("int8", "int4") for k, n in QMM_LLAMA
       for m in (16, 1024)]
    + [(mode, True, k, n, m) for mode in ("int8", "int4") for k, n in QMM_RAGGED
       for m in (1, 16, 100)]
    + [(mode, True, k, n, m) for mode in ("int8", "int4") for k, n in QMM_LLAMA
       for m in (16, 32, 64, 1024)])


@pytest.mark.parametrize(
    "mode,act_quant,k,n,m", QMM_CASES,
    ids=[f"{QMM[(mo, a)]}-{k}x{n}-m{m}" for mo, a, k, n, m in QMM_CASES])
def test_quant_matmul_kernels_match_plain(cuda, mode, act_quant, k, n, m):
    """Ragged m, N and K (no tile multiple) and every Llama-3-8B weight
    shape, K6/K7 at decode and prefill rows, K8/K9 also at the verify steps'
    32 and at 64; stored bytes over the whole int8 range, so -128 and int4
    nibbles of -8 occur; small m splits the K walk. One launch count per
    call, and a second call gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    rows = k // 2 if mode == "int4" else k
    wq = QuantizedWeight(
        torch.randint(-128, 128, (rows, n), generator=gen, device=cuda, dtype=torch.int8),
        torch.rand(n, generator=gen, device=cuda) / k, mode, torch.bfloat16,
        "int8" if act_quant else "bf16")
    x = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    name = QMM[(mode, act_quant)]
    before = _build.launch_counts[name]
    got = quant_matmul(x, wq, act_quant=act_quant)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    ok, ratio = check_quant_matmul(got, x, wq, act_quant)
    assert ok, ratio
    assert torch.equal(got, quant_matmul(x, wq, act_quant=act_quant))  # reproducible


@pytest.mark.parametrize("m", [1, 16, 32, 64, 100, 256])
@pytest.mark.parametrize("mode", ["int8", "int4"], ids=["K6", "K7"])
def test_weight_only_kernels_dequantize_every_byte_exactly(cuda, mode, m):
    """One-hot rows of x pick single weight rows, so out[i] = W[pick[i]] * s
    is exact in bf16 (|W| <= 128, power-of-two scales): every stored byte,
    -128 and each int4 nibble of -8 included, its nibble half, its column
    and that column's scale must come out bit for bit, at every token tile
    and through the split K walk of small m. N 336 is no tile multiple."""
    k, n = 256, 336
    gen = torch.Generator(device=cuda).manual_seed(11)
    rows = k // 2 if mode == "int4" else k
    values = torch.randint(-128, 128, (rows, n), generator=gen, device=cuda,
                           dtype=torch.int8)
    scales = torch.exp2(torch.randint(-6, 3, (n,), generator=gen, device=cuda).float())
    wq = QuantizedWeight(values, scales, mode, torch.bfloat16, "bf16")
    pick = torch.randperm(k, generator=gen, device=cuda)[:m]
    x = torch.zeros(m, k, device=cuda, dtype=torch.bfloat16)
    x[torch.arange(m, device=cuda), pick] = 1
    got = quant_matmul(x, wq)
    want = (wq.stored_columns() * scales)[pick].bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1, 16, 32, 64, 100, 256])
@pytest.mark.parametrize("mode", ["int8", "int4"], ids=["K8", "K9"])
def test_a8_kernels_multiply_every_byte_exactly(cuda, mode, m):
    """One-hot rows of x (+-1) quantize to +-127 at one K row each, so
    out[i] = (127 W[pick[i]] * xs) * s: every stored byte, -128 and each
    int4 nibble of -8 included, its nibble half, its column and that
    column's scale must give the plain version's bits, at every token tile
    and through the split K walk of small m (K 1024: 8 int8 K tiles, 4
    int4). N 336 is no tile multiple."""
    k, n = 1024, 336
    gen = torch.Generator(device=cuda).manual_seed(17)
    rows = k // 2 if mode == "int4" else k
    values = torch.randint(-128, 128, (rows, n), generator=gen, device=cuda,
                           dtype=torch.int8)
    scales = torch.rand(n, generator=gen, device=cuda) / k
    wq = QuantizedWeight(values, scales, mode, torch.bfloat16, "int8")
    pick = torch.randperm(k, generator=gen, device=cuda)[:m]
    sign = torch.randint(0, 2, (m,), generator=gen, device=cuda).float() * 2 - 1
    x = torch.zeros(m, k, device=cuda, dtype=torch.bfloat16)
    x[torch.arange(m, device=cuda), pick] = sign.bfloat16()
    got = quant_matmul(x, wq, act_quant=True)
    want = quant_matmul_plain(x, wq, act_quant=True)
    assert torch.equal(got, want)
    x_q, xs = quantize_activations(x)
    exact = (x_q.float() @ wq.stored_columns()) * xs * scales
    assert torch.equal(want, exact.bfloat16())


def _activation_rows(m, k, gen, device):
    """Normal rows, with (for m > 2) an all-zero row (the 1e-12 floor), a
    row whose values divide to exact halves (absmax 127 * 2^-3: the scale is
    2^-3) and a row with one value 1e4x the rest."""
    x = torch.randn(m, k, generator=gen, device=device)
    if m > 2:
        x[0] = 0.0
        ties = torch.randint(-127, 127, (k,), generator=gen, device=device) + 0.5
        ties[0] = 127.0
        x[1] = ties / 8
        x[2, k // 3] *= 1e4
    return x.bfloat16()


@pytest.mark.parametrize("k", [4096, 14336, 20480])
@pytest.mark.parametrize("m", [1, 16, 1024])
def test_quantize_rows_kernel_equals_the_plain_quantization(cuda, m, k):
    """K8/K9's activation quantization kernel gives the bytes and scales of
    the plain version (itself the JAX package's, tests/
    test_torch_quant_matmul.py) bit for bit, at decode and prefill rows and
    Llama-3-8B's two K values, on a strided (sliced) x too; K 20480 is
    longer than the kernel keeps in registers, so part of it is read
    twice."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    x = _activation_rows(m, k, gen, cuda)
    for xin in (x, torch.cat([x, x], dim=1)[:, k:]):
        got_q, got_s = quantize_rows(xin)
        want_q, want_s = quantize_activations(xin)
        assert got_q.dtype == torch.int8 and got_s.shape == (m, 1)
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)


def test_quant_matmul_kernels_run_on_wgmma_without_spills(cuda):
    """K6-K9 are one template, quant_matmul_kernel<W4, A8, BT>: the
    weight-only instances issue bf16 wgmma (HGMMA), the a8 ones int8 wgmma
    (IGMMA), none an mma.sync (HMMA/IMMA); the a8 ones spill nothing."""
    sass = sass_by_function(QMM_SOURCE)
    usage = resource_usage(QMM_SOURCE)
    for kernel in ("quant_matmul_kernel", "quant_matmul_edge_kernel"):  # N % 8: the edge
        names = [n for n in sass if kernel in n]
        assert len(names) == 16, list(sass)  # W4 x A8 x 4 token tiles
        a8 = [n for n in names if re.search(kernel + r"ILb[01]ELb1E", n)]
        assert len(a8) == 8, names
        for name in names:
            assert ("IGMMA" if name in a8 else "HGMMA") in sass[name], name
            assert "HMMA" not in sass[name] and "IMMA" not in sass[name], name
        for name in a8:
            assert usage[name]["local"] == 0 and usage[name]["stack"] == 0, (name, usage[name])


@pytest.mark.parametrize("mode", ["int8", "int4"], ids=["K6", "K7"])
def test_weight_only_kernels_key_weight_maps_by_shape(cuda, mode):
    """The wrapper keeps each weight's tensor map; weights that share their
    first byte but not their shape, or their shape but not their bytes,
    must each be read as what they are."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    k = 512
    rows = k // 2 if mode == "int4" else k
    buf = torch.randint(-128, 128, (rows * 336,), generator=gen, device=cuda,
                        dtype=torch.int8)
    x = torch.randn(16, k, generator=gen, device=cuda).bfloat16()
    for n in (336, 320, 336):
        wq = QuantizedWeight(buf[:rows * n].view(rows, n),
                             torch.rand(n, generator=gen, device=cuda) / k,
                             mode, torch.bfloat16, "bf16")
        ok, ratio = check_quant_matmul(quant_matmul(x, wq), x, wq, False)
        assert ok, (n, ratio)
        buf.neg_()  # the same address and shape now hold other bytes


# The shapes the JAX package's quantize_weight makes and the old kernels
# refused: OpenHermes-2.5-Mistral-7B's 32,002-wide lm_head, N 4,100 and
# 40 (N % 8 != 0 and N % 16 != 0: the edge kernels), K 4,000 (K % 32 != 0)
# and 4,004 (K % 8 = 4, K % 16 = 4: x copied into padded rows).
QMM_ANY = [(4096, 32002), (4000, 4100), (4004, 4100), (4096, 40)]


@pytest.mark.parametrize("m", [1, 16, 32, 1000, 1024])
@pytest.mark.parametrize("k,n", QMM_ANY, ids=[f"{k}x{n}" for k, n in QMM_ANY])
@pytest.mark.parametrize("mode,act_quant", [("int8", False), ("int4", False), ("int8", True),
                                            ("int4", True)], ids=["K6", "K7", "K8", "K9"])
def test_quant_matmul_kernels_take_any_shape(cuda, mode, act_quant, k, n, m):
    """K6-K9 at ragged K and N, by the rule of the module docstring: one
    launch count a call, reproducible bits, the weight's stored rows padded
    to 16 bytes once (its logical (K, N) kept) and no copy of it on a call
    (the call's peak allocation stays below the weight's bytes)."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    rows = k // 2 if mode == "int4" else k
    wq = QuantizedWeight(
        torch.randint(-128, 128, (rows, n), generator=gen, device=cuda, dtype=torch.int8),
        torch.rand(n, generator=gen, device=cuda) / k, mode, torch.bfloat16,
        "int8" if act_quant else "bf16")
    assert wq.shape == (k, n) and wq.values.stride(0) % 16 == 0
    x = torch.randn(m, k, generator=gen, device=cuda).bfloat16()
    name = QMM[(mode, act_quant)]
    before, ptr = _build.launch_counts[name], wq.values.data_ptr()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = quant_matmul(x, wq, act_quant=act_quant)
    torch.cuda.synchronize()
    call_bytes = torch.cuda.max_memory_allocated() - base
    assert _build.launch_counts[name] == before + 1 and wq.values.data_ptr() == ptr
    if m <= 32 and n >= 4096:  # the output and split partials are small beside the weight
        assert call_bytes < wq.values.numel(), call_bytes
    assert got.shape == (m, n) and bool(torch.isfinite(got).all())
    ok, ratio = check_quant_matmul(got, x, wq, act_quant)
    assert ok, ratio
    assert torch.equal(got, quant_matmul(x, wq, act_quant=act_quant))


@pytest.mark.parametrize("m", [1, 100])
@pytest.mark.parametrize("k,n", [(260, 330), (1028, 4100)])
@pytest.mark.parametrize("mode,act_quant", [("int8", False), ("int4", False), ("int8", True),
                                            ("int4", True)], ids=["K6", "K7", "K8", "K9"])
def test_ragged_kernels_are_exact_on_one_hot_rows(cuda, mode, act_quant, k, n, m):
    """One-hot rows at ragged K and N (K 260 and 1,028: K % 8 = 4; N 330:
    the edge kernel): every stored byte, its nibble half, its column and
    that column's scale come out bit for bit (weight-only: exact in bf16
    with power-of-two scales; a8: the plain version's bits)."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    rows = k // 2 if mode == "int4" else k
    values = torch.randint(-128, 128, (rows, n), generator=gen, device=cuda,
                           dtype=torch.int8)
    scales = torch.exp2(torch.randint(-6, 3, (n,), generator=gen, device=cuda).float())
    wq = QuantizedWeight(values, scales, mode, torch.bfloat16, "int8" if act_quant else "bf16")
    pick = torch.randperm(k, generator=gen, device=cuda)[:m]
    x = torch.zeros(m, k, device=cuda, dtype=torch.bfloat16)
    x[torch.arange(m, device=cuda), pick] = 1
    got = quant_matmul(x, wq, act_quant=act_quant)
    if act_quant:
        assert torch.equal(got, quant_matmul_plain(x, wq, act_quant=True))
    else:
        assert torch.equal(got, (wq.stored_columns() * scales)[pick].bfloat16())


@pytest.mark.parametrize("k", [4000, 4004, 4100, 13])
@pytest.mark.parametrize("m", [1, 16, 1024])
def test_quantize_rows_kernel_takes_any_k(cuda, m, k):
    """The activation quantization at K % 8 != 0 (x copied into rows padded
    with zeros, which change no abs-max) gives the plain bytes and scales
    bit for bit, in the logical (m, K)."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    x = _activation_rows(m, k, gen, cuda)
    got_q, got_s = quantize_rows(x)
    want_q, want_s = quantize_activations(x)
    assert got_q.shape == (m, k) and got_s.shape == (m, 1)
    assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)


def test_quant_matmul_refuses_a_weight_laid_out_past_tma(cuda):
    """A weight whose rows were re-pointed after it was made at a stride TMA
    cannot read raises: the wrapper never copies a weight to fix it."""
    wq = QuantizedWeight(torch.zeros((64, 40), device=cuda, dtype=torch.int8),
                         torch.ones(40, device=cuda), "int8")
    wq.values = torch.zeros((64, 41), device=cuda, dtype=torch.int8)[:, :40]
    with pytest.raises(ValueError, match="16 bytes"):
        quant_matmul(torch.zeros((1, 64), device=cuda, dtype=torch.bfloat16), wq)


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
def test_quantized_paged_kernel_matches_plain(cuda, mode):
    rng = np.random.default_rng(9)
    heads, kv_heads, ps, num_pages = 8, 2, 16, 64
    lengths = torch.tensor([0, 1, 31, 200, 500], dtype=torch.int32, device=cuda)
    pool = torch.randn(kv_heads, num_pages, ps, 128, device=cuda)
    tables = torch.full((5, 32), -1, dtype=torch.int32, device=cuda)
    perm, nxt = rng.permutation(num_pages), 0
    owned = torch.zeros(kv_heads, num_pages, ps, 128, dtype=torch.bool, device=cuda)
    for b, n in enumerate(lengths.tolist()):
        for i in range(-(-n // ps)):
            page = int(perm[nxt])
            nxt += 1
            tables[b, i] = page
            owned[:, page, :min(ps, n - i * ps)] = True
    kp, ks = quantize_kv_pages(pool, mode)
    vp, vs = quantize_kv_pages(pool.flip(-1) * 3, mode)
    if mode == "fp8":  # slots no sequence owns hold the e4m3 NaN byte
        for p in (kp, vp):
            p.view(torch.uint8)[~owned] = 0x7F
    q = torch.randn(5, heads, 128, device=cuda).bfloat16()
    kw0 = dict(mode=mode, k_scales=ks, v_scales=vs, scale=128 ** -0.5)
    for kw in (dict(), dict(window=64), dict(softcap=20.0)):
        before = _build.launch_counts[PAGED]
        out = paged_decode_attention(q, kp, vp, lengths, tables, **kw0, **kw)
        torch.cuda.synchronize()
        assert _build.launch_counts[PAGED] == before + 1
        ref16 = paged_decode_attention_plain(q, kp, vp, lengths, tables, **kw0, **kw)
        ref32 = paged_decode_attention_plain(q.float(), kp, vp, lengths, tables,
                                             **kw0, **kw)
        assert torch.isfinite(out).all() and float(out[0].abs().max()) == 0.0
        ok, ratio, where = sliced_tolerance_check(out, ref16, ref32, lead=1)
        assert ok, (mode, kw, ratio, where)


def _paged_pool(cuda, kv_heads, lengths, mode, seed, ps=16, num_pages=96, d=128):
    """A pool with shuffled pages and tables, heads ``d`` wide; slots no
    sequence owns hold NaN (dense) or the e4m3 NaN byte (fp8). Returns (k,
    v, keyword arguments for the page format)."""
    rng = np.random.default_rng(seed)
    tables = torch.full((len(lengths), 40), -1, dtype=torch.int32, device=cuda)
    owned = torch.zeros(kv_heads, num_pages, ps, d, dtype=torch.bool, device=cuda)
    perm, nxt = rng.permutation(num_pages), 0
    for b, n in enumerate(lengths):
        for i in range(-(-n // ps)):
            page = int(perm[nxt])
            nxt += 1
            tables[b, i] = page
            owned[:, page, :min(ps, n - i * ps)] = True
    gen = torch.Generator(device=cuda).manual_seed(seed)
    k, v = (torch.randn(kv_heads, num_pages, ps, d, device=cuda, generator=gen)
            for _ in range(2))
    if mode == "dense":
        k, v = (torch.where(owned, x, float("nan")).bfloat16() for x in (k, v))
        return k, v, tables, {}
    kp, ks = quantize_kv_pages(k, mode)
    vp, vs = quantize_kv_pages(v * 2, mode)
    if mode == "fp8":
        for p in (kp, vp):
            p.view(torch.uint8)[~owned] = 0x7F
    return kp, vp, tables, dict(mode=mode, k_scales=ks, v_scales=vs)


@pytest.mark.parametrize("splits", [1, 2, 8, 0], ids=["splits1", "splits2", "splits8", "plan"])
@pytest.mark.parametrize("heads,kv_heads", [(8, 2), (4, 4), (32, 8)])
@pytest.mark.parametrize("t", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["dense", "int8", "fp8", "int4", "int8c"])
def test_paged_kernel_multi_token_and_int8c(cuda, mode, t, heads, kv_heads, splits):
    """t query tokens (the rows of a KV head in 16-row tiles, one CTA each:
    32 heads over 8 KV heads at t = 4 is one tile of 16 rows, at t = 8 two)
    and int8 compute, plain, with a window and with a softcap, at split
    counts 1 (no merge), 2, 8 and the plan's (1 for these 640-token
    tables), on
    a pool whose unowned slots hold NaN; lengths 0, below t (rows that see
    no token give zeros), t and long ones."""
    i8c = mode == "int8c"
    lengths = [0, 1, t, 37, 300, 611]
    kp, vp, tables, kw0 = _paged_pool(cuda, kv_heads, lengths, "int8" if i8c else mode,
                                      seed=10 + t)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    shape = (len(lengths), heads) + ((t,) if t > 1 else ()) + (128,)
    q = torch.randn(shape, device=cuda).bfloat16()
    kw0 = dict(kw0, scale=128 ** -0.5)
    name = kernel_name(t, i8c)
    mode_num = MODE_INT8C if i8c else MODES[mode][0]
    merged = plan(len(lengths), kv_heads, heads // kv_heads * t, tables.shape[1], 16,
                  mode_num, sm_count(q.device), splits).splits > 1
    for kw in (dict(), dict(window=100), dict(softcap=20.0)):
        before, merges = _build.launch_counts[name], _build.launch_counts[KERNEL_MERGE]
        out = paged_decode_attention(q, kp, vp, lens, tables, int8_compute=i8c,
                                     splits=splits, **kw0, **kw)
        torch.cuda.synchronize()
        assert _build.launch_counts[name] == before + 1
        assert _build.launch_counts[KERNEL_MERGE] == merges + merged
        native = paged_decode_attention_plain(q, kp, vp, lens, tables, int8_compute=i8c,
                                              **kw0, **kw)
        pages32 = (kp.float(), vp.float()) if mode == "dense" else (kp, vp)
        ref32 = paged_decode_attention_plain(q.float(), *pages32, lens, tables, **kw0, **kw)
        assert out.shape == q.shape and torch.isfinite(out).all()
        assert float(out[0].abs().max()) == 0.0
        by_token = (lambda x: x.transpose(1, 2)) if t > 1 else (lambda x: x[:, None])
        ok, ratio, where = sliced_tolerance_check(by_token(out), by_token(native),
                                                  by_token(ref32), lead=2)
        assert ok, (mode, t, kw, ratio, where)


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("mode", ["dense", "int8", "fp8", "int4", "int8c"])
def test_paged_kernel_is_deterministic(cuda, mode, t):
    """The merge adds the splits in a fixed order: repeated calls agree bit
    for bit, at the plan's split count and at 2."""
    i8c = mode == "int8c"
    lengths = [0, 5, 300, 611]
    kp, vp, tables, kw0 = _paged_pool(cuda, 8, lengths, "int8" if i8c else mode, seed=40)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn((len(lengths), 32) + ((t,) if t > 1 else ()) + (128,),
                    device=cuda).bfloat16()
    for splits in (0, 2):
        first = paged_decode_attention(q, kp, vp, lens, tables, int8_compute=i8c,
                                       splits=splits, **kw0)
        for _ in range(3):
            assert torch.equal(first, paged_decode_attention(
                q, kp, vp, lens, tables, int8_compute=i8c, splits=splits, **kw0))


@pytest.mark.parametrize("splits", [1, 2, 0], ids=["splits1", "splits2", "plan"])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("mode", ["dense", "int8", "fp8", "int4", "int8c"])
def test_paged_kernel_d256_matches_plain(cuda, mode, t, splits):
    """K4/K5 at head width 256 (Gemma-2-9B's 16 Q over 8 KV heads: its
    one-CTA-an-SM instantiation) on every page format and int8 compute,
    t = 1 and 4, plain, with a window and with a softcap, by the rule of
    the test above; the merge is launched whenever the plan splits."""
    i8c = mode == "int8c"
    lengths = [0, 1, t, 37, 300, 611]
    kp, vp, tables, kw0 = _paged_pool(cuda, 8, lengths, "int8" if i8c else mode,
                                      seed=50 + t, d=256)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn((len(lengths), 16) + ((t,) if t > 1 else ()) + (256,),
                    device=cuda).bfloat16()
    kw0 = dict(kw0, scale=256 ** -0.5)
    name = kernel_name(t, i8c)
    merged = plan(len(lengths), 8, 2 * t, tables.shape[1], 16,
                  MODE_INT8C if i8c else MODES[mode][0], sm_count(q.device), splits,
                  256).splits > 1
    for kw in (dict(), dict(window=100), dict(softcap=50.0)):
        before, merges = _build.launch_counts[name], _build.launch_counts[KERNEL_MERGE]
        out = paged_decode_attention(q, kp, vp, lens, tables, int8_compute=i8c,
                                     splits=splits, **kw0, **kw)
        torch.cuda.synchronize()
        assert _build.launch_counts[name] == before + 1
        assert _build.launch_counts[KERNEL_MERGE] == merges + merged
        native = paged_decode_attention_plain(q, kp, vp, lens, tables, int8_compute=i8c,
                                              **kw0, **kw)
        pages32 = (kp.float(), vp.float()) if mode == "dense" else (kp, vp)
        ref32 = paged_decode_attention_plain(q.float(), *pages32, lens, tables, **kw0, **kw)
        assert out.shape == q.shape and torch.isfinite(out).all()
        assert float(out[0].abs().max()) == 0.0
        by_token = (lambda x: x.transpose(1, 2)) if t > 1 else (lambda x: x[:, None])
        ok, ratio, where = sliced_tolerance_check(by_token(out), by_token(native),
                                                  by_token(ref32), lead=2)
        assert ok, (mode, t, kw, ratio, where)


@pytest.mark.parametrize("mode", ["dense", "int8c"])
def test_paged_kernel_d256_is_deterministic(cuda, mode):
    i8c = mode == "int8c"
    lengths = [0, 5, 300, 611]
    kp, vp, tables, kw0 = _paged_pool(cuda, 8, lengths, "int8" if i8c else mode, seed=41,
                                      d=256)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn((len(lengths), 16, 256), device=cuda).bfloat16()
    for splits in (0, 2):
        first = paged_decode_attention(q, kp, vp, lens, tables, int8_compute=i8c,
                                       splits=splits, **kw0)
        for _ in range(3):
            assert torch.equal(first, paged_decode_attention(
                q, kp, vp, lens, tables, int8_compute=i8c, splits=splits, **kw0))


# Page sizes the chunk walk takes (40) and the gather walk takes (1: SGLang's
# default, 4, 12, 72, 96, 100, 200); int4 pages are even.
ANY_PAGE_SIZES = {"dense": (1, 4, 12, 40, 72, 96, 100, 200),
                  "int4": (2, 12, 40, 96, 100, 200)}
ANY_PAGE_CASES = [(mode, ps, d, t) for mode in ("dense", "int8", "fp8", "int4", "int8c")
                  for ps in ANY_PAGE_SIZES.get(mode, ANY_PAGE_SIZES["dense"])
                  for d in (128, 256) for t in (1, 4)]


def _any_page_pool(cuda, kv_heads, lengths, mode, seed, ps, d):
    """A pool of ``ps``-token pages, shuffled, as many as the lengths need
    and three more; slots no sequence owns hold NaN (dense) or the e4m3 NaN
    byte (fp8). Returns (k, v, tables, keyword arguments of the format)."""
    rng = np.random.default_rng(seed)
    need = [-(-n // ps) for n in lengths]
    num_pages = sum(need) + 3
    tables = torch.full((len(lengths), max(need)), -1, dtype=torch.int32, device=cuda)
    owned = torch.zeros(kv_heads, num_pages, ps, d, dtype=torch.bool, device=cuda)
    perm, nxt = rng.permutation(num_pages), 0
    for b, n in enumerate(lengths):
        for i in range(need[b]):
            page = int(perm[nxt])
            nxt += 1
            tables[b, i] = page
            owned[:, page, :min(ps, n - i * ps)] = True
    gen = torch.Generator(device=cuda).manual_seed(seed)
    k, v = (torch.randn(kv_heads, num_pages, ps, d, device=cuda, generator=gen)
            for _ in range(2))
    if mode == "dense":
        k, v = (torch.where(owned, x, float("nan")).bfloat16() for x in (k, v))
        return k, v, tables, {}
    kp, ks = quantize_kv_pages(k, mode)
    vp, vs = quantize_kv_pages(v * 2, mode)
    if mode == "fp8":
        for p in (kp, vp):
            p.view(torch.uint8)[~owned] = 0x7F
    # Every page its own scale, so a tile across pages must take each token's.
    ks = ks * torch.linspace(0.5, 2.0, ks.numel(), device=cuda).view_as(ks)
    return kp, vp, tables, dict(mode=mode, k_scales=ks, v_scales=vs)


@pytest.mark.parametrize("mode,ps,d,t", ANY_PAGE_CASES,
                         ids=[f"{m}-ps{ps}-d{d}-t{t}" for m, ps, d, t in ANY_PAGE_CASES])
def test_paged_kernel_takes_every_page_size(cuda, mode, ps, d, t):
    """K4/K5 at page sizes the chunk walk does not take (and 40, which it
    does), every page format and int8 compute, d 128 and 256, t 1 and 4,
    split counts 1 (no merge) and the plan's, plain, with a window and
    with a softcap, by the rule of the multi-token test; each page its own
    K scale; unowned slots NaN."""
    i8c = mode == "int8c"
    lengths = [0, 1, t, 37, 300, 611]
    heads, kv_heads = (32, 8) if d == 128 else (16, 8)
    kp, vp, tables, kw0 = _any_page_pool(cuda, kv_heads, lengths, "int8" if i8c else mode,
                                         seed=60 + ps + t, ps=ps, d=d)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn((len(lengths), heads) + ((t,) if t > 1 else ()) + (d,),
                    device=cuda).bfloat16()
    kw0 = dict(kw0, scale=d ** -0.5)
    name = kernel_name(t, i8c)
    mode_num = MODE_INT8C if i8c else MODES[mode][0]
    for splits in (1, 0):
        merged = plan(len(lengths), kv_heads, heads // kv_heads * t, tables.shape[1], ps,
                      mode_num, sm_count(q.device), splits, d).splits > 1
        for kw in (dict(), dict(window=100), dict(softcap=20.0)):
            before, merges = _build.launch_counts[name], _build.launch_counts[KERNEL_MERGE]
            out = paged_decode_attention(q, kp, vp, lens, tables, int8_compute=i8c,
                                         splits=splits, **kw0, **kw)
            torch.cuda.synchronize()
            assert _build.launch_counts[name] == before + 1
            assert _build.launch_counts[KERNEL_MERGE] == merges + merged
            native = paged_decode_attention_plain(q, kp, vp, lens, tables, int8_compute=i8c,
                                                  **kw0, **kw)
            pages32 = (kp.float(), vp.float()) if mode == "dense" else (kp, vp)
            ref32 = paged_decode_attention_plain(q.float(), *pages32, lens, tables, **kw0,
                                                 **kw)
            assert out.shape == q.shape and torch.isfinite(out).all()
            assert float(out[0].abs().max()) == 0.0
            by_token = (lambda x: x.transpose(1, 2)) if t > 1 else (lambda x: x[:, None])
            ok, ratio, where = sliced_tolerance_check(by_token(out), by_token(native),
                                                      by_token(ref32), lead=2)
            assert ok, (mode, ps, d, t, splits, kw, ratio, where)


@pytest.mark.parametrize("mode", ["dense", "int4", "int8c"])
def test_paged_gather_walk_is_deterministic(cuda, mode):
    """The gather walk (pages of 12 tokens, int4 of 100) and its merge give
    the same bits on every call, at the plan's split count and at 2."""
    i8c = mode == "int8c"
    lengths = [0, 5, 300, 611]
    ps = 100 if mode == "int4" else 12
    kp, vp, tables, kw0 = _any_page_pool(cuda, 8, lengths, "int8" if i8c else mode, seed=42,
                                         ps=ps, d=128)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn((len(lengths), 32, 128), device=cuda).bfloat16()
    for splits in (0, 2):
        first = paged_decode_attention(q, kp, vp, lens, tables, int8_compute=i8c,
                                       splits=splits, **kw0)
        for _ in range(3):
            assert torch.equal(first, paged_decode_attention(
                q, kp, vp, lens, tables, int8_compute=i8c, splits=splits, **kw0))


def test_kernels_refuse_other_dtypes(cuda):
    """A type with no kernel (K1: fp64, which the JAX package's kernels do
    not take; K4/K5: fp32): ValueError, no plain fallback on the card. fp16
    runs, and fp32 on K1 and K11 (the tests above and below)."""
    q = torch.zeros((1, 2, 64, 128), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        flash_forward_with_lse(q, q, q, KernelConfig())
    pages = torch.zeros((1, 2, 16, 128), device=cuda)
    with pytest.raises(ValueError):
        paged_decode_attention(torch.zeros((1, 2, 128), device=cuda), pages,
                               pages, torch.ones(1, dtype=torch.int32, device=cuda),
                               torch.zeros((1, 2), dtype=torch.int32, device=cuda))


def test_kernels_refuse_other_head_widths(cuda):
    """Every attention kernel (K1, K2/K3, K4/K5, K10, K11) takes d 128 and
    256 on the card, and every wrapper raises at d 384 (the plain versions
    run it on the CPU): nothing falls back to a plain version on a CUDA
    tensor."""
    q384 = torch.zeros((1, 2, 128, 384), device=cuda, dtype=torch.bfloat16)
    for cfg in (KernelConfig(d_head=384), KernelConfig(d_head=384, kv_loop=KVLoop.FORI)):
        with pytest.raises(ValueError, match="wide"):
            flash_forward_with_lse(q384, q384, q384, cfg)
    with pytest.raises(ValueError, match="wide"):
        flash_backward(q384, q384, q384, q384, torch.zeros((1, 2, 128), device=cuda), q384,
                       KernelConfig(d_head=384))
    kq384 = quantize_kv(q384, "int8")
    with pytest.raises(ValueError, match="wide"):
        flash_forward_quantized(q384, kq384, kq384, KernelConfig(d_head=384))
    pages = torch.zeros((2, 2, 16, 384), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wide"):
        paged_decode_attention(q384[:, :, 0], pages, pages,
                               torch.ones(1, dtype=torch.int32, device=cuda),
                               torch.zeros((1, 2), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("sq,kw", [
    (256, dict()), (256, dict(causal=True)),
    (128, dict(causal=True, q_offset=128)), (256, dict(causal=True, window=100)),
    (128, dict(causal=True, q_offset=128, window=70)),
    (256, dict(causal=True, attn_softcap=30.0))])
def test_flash_backward_kernels_match_plain(cuda, fused, sq, kw):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, sq, kv_heads=2, seq_kv=256, seed=3))
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(
        cuda, torch.bfloat16)
    cfg = KernelConfig(**kw)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    names = [KERNEL_FUSED] if fused else [KERNEL_DKV, KERNEL_DQ]
    before = {n: _build.launch_counts[n] for n in names}
    got = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
    torch.cuda.synchronize()
    assert all(_build.launch_counts[n] == before[n] + 1 for n in names)
    ref16 = flash_backward_plain(q, k, v, o, lse, do, cfg)
    ref32 = flash_backward_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                 do.float(), dataclasses.replace(cfg, dtype=DType.FP32))
    for name, g, r16, r32 in zip(("dq", "dk", "dv"), got, ref16, ref32):
        ok, ratio, where = sliced_tolerance_check(
            row_bands(g), row_bands(r16), row_bands(r32), lead=3)
        assert ok, (name, ratio, where)


def _backward_inputs(cuda, sq, skv, heads, kv_heads, cfg, seed):
    rng = np.random.default_rng(seed + 1)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, heads, sq, kv_heads=kv_heads, seq_kv=skv, seed=seed))
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(
        cuda, torch.bfloat16)
    return q, k, v, do


def _check_backward(got, q, k, v, o, lse, do, cfg, what):
    ref16 = flash_backward_plain(q, k, v, o, lse, do, cfg)
    ref32 = flash_backward_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                 do.float(), dataclasses.replace(cfg, dtype=DType.FP32))
    for name, g, r16, r32 in zip(("dq", "dk", "dv"), got, ref16, ref32):
        assert g.shape == r16.shape and bool(torch.isfinite(g).all()), (what, name)
        ok, ratio, where = sliced_tolerance_check(
            row_bands(g), row_bands(r16), row_bands(r32), lead=3)
        assert ok, (what, name, ratio, where)
    return ref16


# Ragged against the dK/dV kernel's 128-key CTAs and the dQ kernel's 128-row
# CTAs (seq 192 and 320 are odd multiples of 64), and a GQA group of 1.
BACKWARD_EDGE_CASES = [
    (192, 320, 8, 2, dict(causal=True, q_offset=128, window=70)),
    (320, 320, 8, 2, dict()),
    (320, 320, 8, 2, dict(causal=True, window=100)),
    (256, 256, 4, 4, dict(causal=True)),
    (192, 192, 4, 4, dict(causal=True, attn_softcap=30.0)),
]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("sq,skv,heads,kv_heads,kw", BACKWARD_EDGE_CASES)
def test_flash_backward_ragged_and_mha(cuda, fused, sq, skv, heads, kv_heads, kw):
    """The sliced rule on ragged tiles (no row past seq_kv or seq_q stored,
    keys past seq_kv masked) and with one Q head per KV head; a second call
    gives the same dK and dV bit for bit in both modes, and the same dQ in
    the split pair (K2's dQ is summed by atomics)."""
    cfg = KernelConfig(**kw)
    q, k, v, do = _backward_inputs(cuda, sq, skv, heads, kv_heads, cfg, seed=8)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    got = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
    again = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
    torch.cuda.synchronize()
    _check_backward(got, q, k, v, o, lse, do, cfg, (fused, sq, skv, kw))
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    if not fused:
        assert torch.equal(got[0], again[0])


@pytest.mark.parametrize("sq,skv", [(256, 256), (256, 512), (256, 768)])
def test_fused_backward_on_past_keys(cuda, sq, skv):
    """K2 with fewer Q rows than keys and no mask: the banded backward's
    past-key calls (band i's rows against the i bands before them)."""
    cfg = KernelConfig()
    q, k, v, do = _backward_inputs(cuda, sq, skv, 8, 2, cfg, seed=12)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    got = flash_backward(q, k, v, o, lse, do, cfg, fused=True)
    torch.cuda.synchronize()
    _check_backward(got, q, k, v, o, lse, do, cfg, ("past keys", sq, skv))


@pytest.mark.parametrize("bands", [2, 4])
def test_banded_backward_matches_plain(cuda, bands):
    """``flash_backward(..., bands=n)``: 2 n - 1 K2 launches (each band's
    diagonal square, and its past keys after band 0) and no other kernel,
    held to the plain backward by the sliced rule."""
    cfg = KernelConfig(causal=True)
    q, k, v, do = _backward_inputs(cuda, 512, 512, 8, 2, cfg, seed=13)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    names = (KERNEL_FUSED, KERNEL_DKV, KERNEL_DQ)
    before = {n: _build.launch_counts[n] for n in names}
    got = flash_backward(q, k, v, o, lse, do, cfg, bands=bands)
    torch.cuda.synchronize()
    launched = {n: _build.launch_counts[n] - before[n] for n in names}
    assert launched == {KERNEL_FUSED: 2 * bands - 1, KERNEL_DKV: 0, KERNEL_DQ: 0}
    _check_backward(got, q, k, v, o, lse, do, cfg, ("banded", bands))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_flash_backward_reads_each_box_in_place(cuda, fused):
    """One-hot rows make each MN-major operand's columns land in known
    gradient columns: dV = P^T dO in dO's columns (0-31), dK = dS^T Q in
    Q's (80-111), dQ = dS K in K's (32-63). A swapped or misplaced
    64-column box, or a wrong leading offset, moves them."""
    cfg = KernelConfig(causal=True)
    sq = skv = 256
    rows = torch.arange(sq, device=cuda)

    def one_hot(heads, col):
        x = torch.zeros((2, heads, sq, 128), device=cuda, dtype=torch.bfloat16)
        x[:, :, rows, col] = 1.0
        return x

    q, k, do = one_hot(8, 80 + rows % 32), one_hot(2, 32 + rows % 32), one_hot(8, rows % 32)
    v = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 2, skv, 128)).astype(np.float32)).to(cuda, torch.bfloat16)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    got = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
    ref = _check_backward(got, q, k, v, o, lse, do, cfg, fused)
    for name, g, r, cols in zip(("dq", "dk", "dv"), got, ref, (range(32, 64), range(80, 112),
                                                               range(0, 32))):
        support = g.float().abs().amax(dim=(0, 1, 2)) > 0
        assert torch.equal(support, r.float().abs().amax(dim=(0, 1, 2)) > 0), name
        assert set(torch.nonzero(support).flatten().tolist()) <= set(cols), name


def test_flash_backward_takes_strided_inputs(cuda):
    """The model's q/k/v/dO are transposed views of (b, s, h, d) rows."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    rows = [torch.randn(2, 256, h, 128, device=cuda, generator=gen).bfloat16()
            for h in (8, 2, 2, 8)]
    q, k, v, do = (x.transpose(1, 2) for x in rows)
    cfg = KernelConfig(causal=True)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    ref16 = flash_backward_plain(q, k, v, o, lse, do, cfg)
    ref32 = flash_backward_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                 do.float(), dataclasses.replace(cfg, dtype=DType.FP32))
    for fused in (True, False):
        got = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
        for name, g, r16, r32 in zip(("dq", "dk", "dv"), got, ref16, ref32):
            ok, ratio, where = sliced_tolerance_check(
                row_bands(g), row_bands(r16), row_bands(r32), lead=3)
            assert ok, (fused, name, ratio, where)


# Head width 256 (K2/K3's d-256 instantiations: the dK/dV kernel's two
# warpgroups that split dK's and dV's columns, the dQ kernel's 64-key
# slots): Gemma-2-9B's group of 2 Q heads a KV head at 4/2 heads, every
# option, ragged tiles and a window that starts mid-tile.
D256_BACKWARD_CASES = [
    (256, 256, dict()), (256, 256, dict(causal=True)),
    (128, 256, dict(causal=True, q_offset=128)), (256, 256, dict(causal=True, window=100)),
    (192, 320, dict(causal=True, q_offset=128, window=70)),
    (256, 256, dict(causal=True, attn_softcap=50.0)),
    (320, 320, dict(causal=True, window=64, attn_softcap=50.0)),
]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("sq,skv,kw", D256_BACKWARD_CASES)
def test_flash_backward_d256_kernels_match_plain(cuda, fused, sq, skv, kw):
    """K2 and K3 at d 256 against the plain version by the sliced rule, one
    launch of each kernel a call; a second call gives the same dK and dV
    bit for bit (and dQ on K3)."""
    cfg = KernelConfig(d_head=256, **kw)
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 4, sq, d_head=256, kv_heads=2, seq_kv=skv, seed=11))
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(
        cuda, torch.bfloat16)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    names = [KERNEL_FUSED] if fused else [KERNEL_DKV, KERNEL_DQ]
    before = {n: _build.launch_counts[n] for n in names}
    got = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
    again = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
    torch.cuda.synchronize()
    assert all(_build.launch_counts[n] == before[n] + 2 for n in names)
    _check_backward(got, q, k, v, o, lse, do, cfg, (fused, sq, skv, kw))
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    if not fused:
        assert torch.equal(got[0], again[0])


def test_flash_backward_d256_takes_strided_inputs(cuda):
    """The model's q/k/v/dO at d 256: transposed views of (b, s, h, d) rows."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    rows = [torch.randn(2, 192, h, 256, device=cuda, generator=gen).bfloat16()
            for h in (4, 2, 2, 4)]
    q, k, v, do = (x.transpose(1, 2) for x in rows)
    cfg = KernelConfig(d_head=256, causal=True, window=100, attn_softcap=50.0)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    for fused in (True, False):
        _check_backward(flash_backward(q, k, v, o, lse, do, cfg, fused=fused),
                        q, k, v, o, lse, do, cfg, fused)


def _train_grads_on_each_backward(cuda, monkeypatch, cfg, tokens):
    """Every parameter gradient of ``loss_fn`` on the split backward (the
    default), the fused one and the plain one, with the kernels' launches;
    the split and fused gradients within 1e-2 of each leaf's largest plain
    one."""
    from flash_attention_from_scratch_tpu_torch.ops import autodiff

    def grads():
        params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(1))
        train.make_optimizer(params)  # marks the leaves as requiring grad
        llama.loss_fn(params, tokens, cfg).backward()
        return [p.grad for p in train.param_leaves(params)]

    before = {n: _build.launch_counts[n] for n in (KERNEL_FUSED, KERNEL_DKV, KERNEL_DQ)}
    split = grads()  # the default, the split kernels
    # Deterministic mode keeps them; cuBLAS only warns.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        grads()
    finally:
        torch.use_deterministic_algorithms(False)
    monkeypatch.setattr(autodiff, "flash_backward",
                        lambda *args, **kw: flash_backward(*args, fused=True))
    fused = grads()
    assert [_build.launch_counts[n] - before[n] for n in before] == [
        cfg.n_layers, 2 * cfg.n_layers, 2 * cfg.n_layers]
    monkeypatch.setattr(autodiff, "flash_backward",
                        lambda *args, **kw: flash_backward_plain(*args))
    plain = grads()
    for g, s, w in zip(fused, split, plain):
        for got in (g, s):
            assert bool(torch.isfinite(got).all())
            assert float((got.float() - w.float()).abs().max()) <= 1e-2 * float(
                w.float().abs().max())
    monkeypatch.undo()


def test_train_step_d256_on_the_kernels(cuda, monkeypatch):
    """A Gemma-2-shaped model at d 256 (``D256_CFG``: a 64-token window on
    layer 0, softcaps, sandwich norms) trains on K2/K3: its gradients on
    either backward within 1e-2 of the plain backward's, three AdamW steps
    with a falling loss and K1 and K3 once a layer a step."""
    cfg = D256_CFG
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 193))).to(cuda)
    _train_grads_on_each_backward(cuda, monkeypatch, cfg, tokens)
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(1))
    step = train.make_train_step(cfg, train.make_optimizer(params, lr=1e-3))
    before = {n: _build.launch_counts[n] for n in (FLASH, KERNEL_DKV, KERNEL_DQ)}
    losses = [float(step(params, tokens)) for _ in range(3)]
    assert losses[-1] < losses[0], losses
    for n in (FLASH, KERNEL_DKV, KERNEL_DQ):
        assert _build.launch_counts[n] == before[n] + 3 * cfg.n_layers


def test_train_step_on_the_kernels(cuda, monkeypatch):
    cfg = llama.LlamaConfig(vocab_size=256, dim=512, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_head=128, hidden_dim=512)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 257))).to(cuda)
    _train_grads_on_each_backward(cuda, monkeypatch, cfg, tokens)

    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(1))
    step = train.make_train_step(cfg, train.make_optimizer(params, lr=1e-3))
    before = {n: _build.launch_counts[n] for n in (FLASH, KERNEL_DKV, KERNEL_DQ)}
    losses = [float(step(params, tokens)) for _ in range(3)]
    assert losses[-1] < losses[0], losses
    for n in (FLASH, KERNEL_DKV, KERNEL_DQ):
        assert _build.launch_counts[n] == before[n] + 3 * cfg.n_layers


# The compiled step: a small model of full head width on the card, its
# weights dense or quantized, each with a cache format.
GRAPH_CFG = llama.LlamaConfig(vocab_size=2048, dim=1024, n_layers=2, n_heads=8,
                              n_kv_heads=2, d_head=128, hidden_dim=2048)
GRAPH_RECIPES = {"dense": (None, "dense"), "int8": (("int8", "bf16"), "int8"),
                 "int4": (("int4", "bf16"), "int4"), "a8": (("int8", "int8"), "fp8")}
GRAPH_LENGTHS = (100, 300, 37)
GRAPH_PAGES_PER_SEQ = 8
# Head width 256: a Gemma-2-shaped model (4 Q heads over 2 KV heads of 256,
# a 64-token window on layer 0, softcaps 50 / 30, the sandwich norms, the
# GeLU MLP) with GRAPH_CFG's vocabulary.
D256_CFG = llama.LlamaConfig(vocab_size=2048, dim=1024, n_layers=2, n_heads=4, n_kv_heads=2,
                             d_head=256, hidden_dim=2048, window_pattern=(64, 0),
                             mlp_act="gelu", post_norms=True, embed_scale=True,
                             attn_softcap=50.0, final_softcap=30.0, attn_scale=256 ** -0.5)


def _graph_model(cuda, recipe, cfg=GRAPH_CFG):
    gen = torch.Generator(device=cuda).manual_seed(0)
    weights, mode = GRAPH_RECIPES[recipe]
    if weights is None:
        params = llama.init_params(cfg, gen, cuda)
    elif cfg.post_norms:  # init_quantized_params makes no sandwich norms (as in JAX)
        params = llama.quantize_params(llama.init_params(cfg, gen, cuda), weights[0],
                                       act=weights[1])
    else:
        params = llama.init_quantized_params(cfg, gen, weights[0], act=weights[1],
                                             device=cuda)
    batch = len(GRAPH_LENGTHS)
    cache = decode.init_cache(cfg, batch * GRAPH_PAGES_PER_SEQ + 1, 64, mode, cuda)
    tables = torch.arange(batch * GRAPH_PAGES_PER_SEQ, dtype=torch.int32,
                          device=cuda).view(batch, -1)
    rng = np.random.default_rng(1)
    for b, n in enumerate(GRAPH_LENGTHS):
        toks = torch.zeros((1, 512), dtype=torch.long, device=cuda)
        toks[0, :n] = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
        decode.prefill(params, toks, cfg, cache, tables[b], prompt_len=n)
    return params, cache, tables


def _clone(cache):
    return dataclasses.replace(
        cache, **{name: [p.clone() for p in getattr(cache, name)]
                  for name in ("k_pages", "v_pages", "k_scales", "v_scales")})


def _bits(x):
    return x.contiguous().view(torch.uint8)


def _same_pools(a, b):
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert torch.equal(_bits(x), _bits(y)), name


def _step_inputs(t, seed, grown):
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, GRAPH_CFG.vocab_size, (len(GRAPH_LENGTHS), t)))
    return tokens, torch.tensor([n + grown for n in GRAPH_LENGTHS], dtype=torch.int32)


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("recipe", list(GRAPH_RECIPES))
def test_replayed_step_equals_eager_step(cuda, recipe, t):
    """Two steps of t tokens (the first call captures, the second only
    replays) against the eager ``_step`` on a copy of the cache: logits and
    every page and scale bit for bit, int8 compute too on an int8 cache."""
    _check_replayed_steps(cuda, recipe, t, GRAPH_CFG)


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("recipe", ["dense", "int8"])
def test_d256_replayed_step_equals_eager_step(cuda, recipe, t):
    """The same at head width 256 (K4/K5's d-256 kernels in the graphs)."""
    _check_replayed_steps(cuda, recipe, t, D256_CFG)


def _check_replayed_steps(cuda, recipe, t, cfg):
    params, cache, tables = _graph_model(cuda, recipe, cfg)
    for attn_int8 in {False, cache.mode == "int8"}:
        replayed, eager = _clone(cache), _clone(cache)
        graphs = StepGraphs(params, cfg, replayed, attn_int8=attn_int8)
        for call in range(2):
            tokens, lengths = _step_inputs(t, seed=call, grown=(call + 1) * t)
            got = graphs.verify_step(tokens, lengths, tables.cpu())
            want, _ = decode._step(params, tokens.to(cuda), cfg, eager,
                                   lengths.to(cuda), tables, None, None, attn_int8)
            assert torch.equal(_bits(got), _bits(want)), (recipe, t, attn_int8, call)
        _same_pools(replayed, eager)
        assert graphs.graphs == 1 and graphs.replays == 2
        assert graphs.nonfinite_logits() == 0


@pytest.mark.parametrize("recipe", list(GRAPH_RECIPES))
def test_replay_counts_the_eager_launches(cuda, recipe):
    """A replay adds to the launch counts what the eager step launches:
    the capture and its warm-up add nothing of their own."""
    params, cache, tables = _graph_model(cuda, recipe)
    tokens, lengths = _step_inputs(1, seed=3, grown=1)
    before = collections.Counter(_build.launch_counts)
    decode.decode_step(params, tokens[:, 0].to(cuda), GRAPH_CFG, _clone(cache),
                       lengths.to(cuda), tables)
    eager = _build.launch_counts - before
    assert eager  # the step launched the paged kernel (and the quantized matmuls)
    graphs = StepGraphs(params, GRAPH_CFG, _clone(cache))
    for n in (1, 2):
        graphs.decode_step(tokens[:, 0], lengths, tables.cpu())
        assert _build.launch_counts - before == collections.Counter(
            {k: (n + 1) * c for k, c in eager.items()})


@pytest.mark.parametrize("recipe", list(GRAPH_RECIPES))
def test_graph_decode_loop_equals_replayed_steps(cuda, recipe):
    """``StepGraphs.decode_loop(steps=4)`` (one graph of four steps) gives the
    tokens and pages of four replayed decode steps fed their own argmax,
    and of the eager ``decode_loop``."""
    _check_decode_loop(cuda, recipe, GRAPH_CFG)


@pytest.mark.parametrize("recipe", ["dense", "int8"])
def test_d256_graph_decode_loop_equals_replayed_steps(cuda, recipe):
    """The same at head width 256."""
    _check_decode_loop(cuda, recipe, D256_CFG)


def _check_decode_loop(cuda, recipe, cfg):
    params, cache, tables = _graph_model(cuda, recipe, cfg)
    first, lengths = _step_inputs(1, seed=4, grown=0)
    first = first[:, 0]
    loop_cache, step_cache, eager_cache = _clone(cache), _clone(cache), _clone(cache)
    out, lens = StepGraphs(params, cfg, loop_cache).decode_loop(
        first, lengths, tables.cpu(), 4)
    stepper = StepGraphs(params, cfg, step_cache)
    toks, lens_s = first, lengths
    for i in range(4):
        lens_s = lens_s + 1
        toks = stepper.decode_step(toks, lens_s, tables.cpu()).argmax(-1).cpu()
        assert torch.equal(toks, out[:, i].cpu()), (recipe, i)
    assert torch.equal(lens.cpu(), lens_s)
    _same_pools(loop_cache, step_cache)
    eager_out, _, _ = decode.decode_loop(params, first.to(cuda), cfg, eager_cache,
                                         lengths.to(cuda), tables, 4)
    assert torch.equal(eager_out, out)
    _same_pools(loop_cache, eager_cache)


def test_server_replays_every_decode(cuda):
    """On the card the server replays a graph for every decode step and
    loop; with ``chunk=4`` and ``prefill_chunk_tokens=128`` it serves the
    tokens of the plain server (greedy, bit-equal steps)."""
    params, _, _ = _graph_model(cuda, "dense")
    from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

    prompts = {i: list(range(3 * i, 3 * i + n)) for i, n in enumerate((20, 300, 131))}
    runs = []
    for kw in ({}, dict(chunk=4, prefill_chunk_tokens=128)):
        server = GenerationServer(params, GRAPH_CFG, num_pages=32, page_size=64,
                                  max_batch=4, pages_per_seq=8, **kw)
        for sid, prompt in prompts.items():
            server.submit(sid, prompt, 11)
        runs.append(server.run())
        stats = server.stats()
        if kw:  # a replay a loop, and one a step outside loops
            assert 0 < stats["decode_loops"] <= server.graphs.replays < stats["decode_steps"]
        else:
            assert server.graphs.replays == stats["decode_steps"] > 0
    assert runs[0] == runs[1]


def test_prefill_chunked_on_k1_matches_prefill(cuda, monkeypatch):
    """Two layers of Llama-3-8B at full width, a 2000-token prompt in
    512-token chunks (K1 with q_offset over [prefix | chunk]) against one
    ``prefill``: the logits by the adaptive rule against the same model in
    fp32 (every projection an fp32 product, the plain attention), every
    layer's K and V pages by the rule in each 64-row page."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import flash_forward_plain
    from flash_attention_from_scratch_tpu_torch.utils.testing import adaptive_tolerance_check

    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=2)
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(2), cuda)
    n = 2000
    toks = torch.zeros((1, 2048), dtype=torch.long, device=cuda)
    toks[0, :n] = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, n))
    table = torch.arange(32, dtype=torch.int32, device=cuda)

    def run(fn, c, **kw):
        cache = decode.init_cache(c, 32, 64, device=cuda)
        logits, cache = fn(params, toks, c, cache, table, prompt_len=n, **kw)
        return logits, torch.stack([torch.stack(p) for p in (cache.k_pages, cache.v_pages)])

    chunked = run(decode.prefill_chunked, cfg, chunk_tokens=512)
    one_shot = run(decode.prefill, cfg)
    monkeypatch.setattr(llama, "_mm", lambda x, w: x.float() @ w.float())
    monkeypatch.setattr(llama, "flash_forward", lambda q, k, v, c, sinks=None:
                        flash_forward_plain(q, k, v, c, sinks)[0])
    monkeypatch.setattr(decode, "_embed",
                        lambda p, tokens, c: p["embed"][tokens].float())
    fp32 = run(decode.prefill, dataclasses.replace(cfg, dtype=DType.FP32))
    ok, err, base = adaptive_tolerance_check(chunked[0], one_shot[0], fp32[0])
    assert ok, (err, base)
    ok, ratio, where = sliced_tolerance_check(
        *(x[1].flatten(0, 1) for x in (chunked, one_shot, fp32)), lead=3)
    assert ok, (ratio, where)


SAMPLE_VOCAB = 128256  # Llama-3's vocabulary


def test_noise_bits_on_the_card_equal_the_cpu(cuda):
    """The noise source's integers, (batch 16) x 128,256 in every stream,
    bit for bit on the card and on the CPU."""
    keys = decode.row_keys(0, torch.arange(16) - 4)
    pos = torch.arange(16) * 3
    for stream in (0, 1, 2):
        want = decode.noise_bits(keys, pos, stream, SAMPLE_VOCAB)
        got = decode.noise_bits(keys.to(cuda), pos.to(cuda), stream, SAMPLE_VOCAB)
        assert torch.equal(got.cpu(), want), stream


@pytest.mark.parametrize("top_k", [0, 50])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_sample_token_on_the_card_equals_the_cpu(cuda, temperature, top_k):
    """The same logits (ties included) and the same noise give the same
    tokens on the card as on the CPU."""
    logits = torch.from_numpy(np.round(np.random.default_rng(2).standard_normal(
        (16, SAMPLE_VOCAB)).astype(np.float32) * 8) / 8)
    _, gumbel = decode.sample_noise(decode.row_keys(1, torch.arange(16)),
                                    torch.arange(16), 0, SAMPLE_VOCAB)
    want = decode.sample_token(logits, gumbel, temperature, top_k)
    got = decode.sample_token(logits.to(cuda), gumbel.to(cuda), temperature, top_k)
    assert torch.equal(got.cpu(), want)


def _keys_at(seed):
    return (decode.row_keys(seed, torch.arange(len(GRAPH_LENGTHS))),
            torch.tensor([0, 7, 3]))


def test_sampled_graphs_equal_eager_picks(cuda):
    """A sampled decode step (``pick_step`` at t = 1) picks inside its graph
    what the eager step and ``sample_token`` pick (two calls, the second
    only replays); a sampled loop of four steps equals four sampled step
    replays (tokens and pages); a sampled verify step accepts in its graph
    what the eager step and ``pick_keyed`` accept."""
    params, cache, tables = _graph_model(cuda, "dense")
    kw = dict(temperature=0.8, top_k=20)
    keys, pos = _keys_at(3)
    no_drafts = torch.zeros(len(GRAPH_LENGTHS), dtype=torch.int64)
    replayed, eager = _clone(cache), _clone(cache)
    graphs = StepGraphs(params, GRAPH_CFG, replayed, **kw)
    for call in range(2):
        tokens, lengths = _step_inputs(1, seed=call, grown=call + 1)
        got, n_emit = graphs.pick_step(tokens, lengths, tables.cpu(), no_drafts, keys,
                                       pos + call)
        logits, _ = decode.decode_step(params, tokens[:, 0].to(cuda), GRAPH_CFG, eager,
                                       lengths.to(cuda), tables)
        _, g = decode.sample_noise(keys.to(cuda), (pos + call).to(cuda), 0,
                                   GRAPH_CFG.vocab_size)
        assert torch.equal(got[:, 0], decode.sample_token(logits, g, **kw)), call
        assert n_emit.tolist() == [1] * len(GRAPH_LENGTHS)
    assert graphs.graphs == 1 and graphs.replays == 2
    _same_pools(replayed, eager)

    first, lengths = _step_inputs(1, seed=4, grown=0)
    loop_cache, step_cache = _clone(cache), _clone(cache)
    out, _ = StepGraphs(params, GRAPH_CFG, loop_cache, **kw).decode_loop(
        first[:, 0], lengths, tables.cpu(), 4, row_keys=keys, pos0=pos)
    stepper = StepGraphs(params, GRAPH_CFG, step_cache, **kw)
    toks, lens = first, lengths
    for i in range(4):
        lens = lens + 1
        toks = stepper.pick_step(toks, lens, tables.cpu(), no_drafts, keys,
                                 pos + i)[0].cpu()
        assert torch.equal(toks[:, 0], out[:, i].cpu()), i
    _same_pools(loop_cache, step_cache)

    tokens, lengths = _step_inputs(4, seed=5, grown=4)
    draft_lens = torch.tensor([3, 1, 0])
    replayed, eager = _clone(cache), _clone(cache)
    got = StepGraphs(params, GRAPH_CFG, replayed, **kw).pick_step(
        tokens, lengths, tables.cpu(), draft_lens, keys, pos)
    logits, _ = decode.verify_step(params, tokens.to(cuda), GRAPH_CFG, eager,
                                   lengths.to(cuda), tables)
    want = decode.pick_keyed(logits, tokens[:, 1:].to(cuda), draft_lens.to(cuda),
                             keys.to(cuda), pos.to(cuda), kw["temperature"], kw["top_k"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _same_pools(replayed, eager)


def test_sampled_server_replays_every_pick(cuda):
    """Sampled serving on the card: every decode step, loop and verify step
    a graph replay, and the same tokens at chunk 1 and chunk 4."""
    params, _, _ = _graph_model(cuda, "dense")
    from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

    prompts = {i: list(range(3 * i, 3 * i + n)) for i, n in enumerate((20, 300, 131))}
    runs = []
    for kw in ({}, dict(chunk=4), dict(spec_k=3)):
        server = GenerationServer(params, GRAPH_CFG, num_pages=32, page_size=64,
                                  max_batch=4, pages_per_seq=8, temperature=0.8,
                                  top_k=50, seed=1, **kw)
        for sid, prompt in prompts.items():
            server.submit(sid, prompt, 11)
        runs.append(server.run())
        stats = server.stats()
        if kw.get("chunk"):  # a replay a loop, and one a step outside loops
            assert 0 < stats["decode_loops"] <= server.graphs.replays < stats["decode_steps"]
        else:
            assert server.graphs.replays == stats["decode_steps"] + stats["verify_steps"] > 0
        assert server.graphs.nonfinite_logits() == 0
    assert runs[0] == runs[1]
    assert {sid: len(t) for sid, t in runs[2].items()} == {sid: 11 for sid in prompts}


def test_prefix_server_on_the_card(cuda):
    """A prefix-cached server on the card: a publisher, then three prompts
    sharing its first 192 tokens claim 3 pages each and serve every token."""
    params, _, _ = _graph_model(cuda, "dense")
    from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

    shared = list(range(5, 197))
    server = GenerationServer(params, GRAPH_CFG, num_pages=40, page_size=64,
                              max_batch=3, pages_per_seq=8, prefix_cache=True)
    server.submit(0, shared + [1, 2], 3)
    server.run()
    for sid, n in ((1, 20), (2, 70), (3, 1)):
        server.submit(sid, shared + list(range(300, 300 + n)), 6)
    got = server.run()
    assert server.stats()["prefix_hit_pages"] == 9
    assert all(len(got[sid]) == 6 for sid in (1, 2, 3))


def test_d256_servers_on_the_card(cuda):
    """Head width 256 on the card: the server replays a graph for every
    decode step (and, with ``chunk=4`` and ``prefill_chunk_tokens=128``,
    every loop, serving the plain server's tokens); a prefix-cached server
    runs K1 on the suffix chunks at q_offset > 0 and serves every token;
    nothing raises for want of a d-256 kernel."""
    params, _, _ = _graph_model(cuda, "dense", D256_CFG)
    from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

    prompts = {i: list(range(3 * i, 3 * i + n)) for i, n in enumerate((20, 300, 131))}
    runs = []
    for kw in ({}, dict(chunk=4, prefill_chunk_tokens=128)):
        server = GenerationServer(params, D256_CFG, num_pages=32, page_size=64,
                                  max_batch=4, pages_per_seq=8, **kw)
        for sid, prompt in prompts.items():
            server.submit(sid, prompt, 11)
        before = _build.launch_counts[FLASH]
        runs.append(server.run())
        assert _build.launch_counts[FLASH] > before
        assert server.graphs.replays > 0
    assert runs[0] == runs[1]
    shared = list(range(5, 197))
    server = GenerationServer(params, D256_CFG, num_pages=40, page_size=64, max_batch=3,
                              pages_per_seq=8, prefix_cache=True)
    server.submit(0, shared + [1, 2], 3)
    server.run()
    for sid, n in ((1, 20), (2, 70)):
        server.submit(sid, shared + list(range(300, 300 + n)), 6)
    got = server.run()
    assert server.stats()["prefix_hit_pages"] == 6
    assert all(len(got[sid]) == 6 for sid in (1, 2))


def test_d256_prefill_chunked_on_k1_matches_prefill(cuda, monkeypatch):
    """``prefill_chunked`` at head width 256 (K1 with q_offset over [prefix |
    chunk], past the 64-token window) against one ``prefill``, by the
    adaptive rule against the same model in fp32, as the d-128 test holds
    Llama-3-8B."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import flash_forward_plain
    from flash_attention_from_scratch_tpu_torch.utils.testing import adaptive_tolerance_check

    cfg = D256_CFG
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(2), cuda)
    n = 300
    toks = torch.zeros((1, 384), dtype=torch.long, device=cuda)
    toks[0, :n] = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, n))
    table = torch.arange(8, dtype=torch.int32, device=cuda)

    def run(fn, c, **kw):
        cache = decode.init_cache(c, 8, 64, device=cuda)
        logits, cache = fn(params, toks, c, cache, table, prompt_len=n, **kw)
        return logits, torch.stack([torch.stack(p) for p in (cache.k_pages, cache.v_pages)])

    before = _build.launch_counts[FLASH]
    chunked = run(decode.prefill_chunked, cfg, chunk_tokens=128)
    assert _build.launch_counts[FLASH] == before + 3 * cfg.n_layers
    one_shot = run(decode.prefill, cfg)
    monkeypatch.setattr(llama, "_mm", lambda x, w: x.float() @ w.float())
    monkeypatch.setattr(llama, "flash_forward", lambda q, k, v, c, sinks=None:
                        flash_forward_plain(q, k, v, c, sinks)[0])
    monkeypatch.setattr(decode, "_embed",  # with Gemma's sqrt(dim) scale
                        lambda p, tokens, c: p["embed"][tokens].float() * c.dim ** 0.5)
    fp32 = run(decode.prefill, dataclasses.replace(cfg, dtype=DType.FP32))
    ok, err, base = adaptive_tolerance_check(chunked[0], one_shot[0], fp32[0])
    assert ok, (err, base)


def test_frontend_serves_on_the_card(cuda):
    """``ServingFrontend`` on the card: its step-loop thread captures and
    replays the server's graphs (no other thread touches CUDA) and a
    request gets the tokens a plain ``run()`` serves for it."""
    params, _, _ = _graph_model(cuda, "dense")
    from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer
    from flash_attention_from_scratch_tpu_torch.serving.http_server import ServingFrontend

    kw = dict(num_pages=32, page_size=64, max_batch=2, pages_per_seq=8, chunk=4,
              temperature=0.8, top_k=50, seed=2)
    fe = ServingFrontend(GenerationServer(params, GRAPH_CFG, **kw))
    try:
        sid, toks = fe.generate(list(range(7, 90)), 9, timeout=300)
    finally:
        fe.shutdown()
    assert not fe._loop.is_alive() and fe._fatal is None
    assert fe.server.graphs.replays > 0
    server = GenerationServer(params, GRAPH_CFG, **kw)
    server.submit(sid, list(range(7, 90)), 9)
    assert server.run()[sid] == toks


# The row-band forward at chip_smoke's banded_case shapes: b 1, 32/8 heads;
# (seq_q, options); the bands split seq_q into 512-row bands (band_count).
BANDED_CASES = [(4096, dict()), (8192, dict()), (4096, dict(window=1024)),
                (2048, dict(q_offset=2048)), (4096, dict(sinks=True))]


def _plain_by_heads(q, k, v, cfg, sinks, group_heads=8):
    """The plain forward (out, lse), 8 query heads (and their KV heads) at a
    time: its scores of 32 heads at s 8192 would take 8.6 GB each."""
    ratio = q.shape[1] // k.shape[1]
    parts = []
    for h in range(0, q.shape[1], group_heads):
        kv = slice(h // ratio, (h + group_heads) // ratio)
        parts.append(flash_forward_plain(
            q[:, h:h + group_heads], k[:, kv], v[:, kv], cfg,
            None if sinks is None else sinks[h:h + group_heads]))
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


@pytest.mark.parametrize("sq,kw", BANDED_CASES)
def test_banded_forward_matches_plain(cuda, sq, kw):
    """``KernelConfig(decompose=True)`` on the card: one K1 launch a band,
    the output within the adaptive rule in each 64-row band against the
    plain (monolithic) version in bf16 and fp32, the LSE within 1e-3 (the
    sinks folded in after the bands)."""
    from flash_attention_from_scratch_tpu_torch.ops.causal_decomp import band_count

    kw = dict(kw)
    with_sinks = kw.pop("sinks", False)
    cfg = KernelConfig(causal=True, decompose=True, **kw)
    skv = sq + cfg.q_offset
    q, _, _ = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(1, 32, sq, kv_heads=8, seq_kv=skv, seed=5))
    _, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(1, 32, skv, kv_heads=8, seed=6))
    sinks = torch.linspace(-2, 2, 32, device=cuda) if with_sinks else None
    before = _build.launch_counts[FLASH]
    out, lse = flash_forward_with_lse(q, k, v, cfg, sinks=sinks)
    torch.cuda.synchronize()
    assert _build.launch_counts[FLASH] == before + band_count(sq)
    plain = dataclasses.replace(cfg, decompose=False)
    ref16, _ = _plain_by_heads(q, k, v, plain, sinks)
    ref32, lse32 = _plain_by_heads(q.float(), k.float(), v.float(),
                                   dataclasses.replace(plain, dtype=DType.FP32), sinks)
    ok, ratio, where = sliced_tolerance_check(
        row_bands(out), row_bands(ref16), row_bands(ref32), lead=3)
    assert ok, (ratio, where)
    assert float((lse - lse32).abs().max()) <= 1e-3


def _graph_lora(cuda):
    from flash_attention_from_scratch_tpu_torch.models.lora import init_lora_adapters

    lora = init_lora_adapters(GRAPH_CFG, 3, 16, torch.Generator(device=cuda).manual_seed(9),
                              zero_b=False, device=cuda)
    lora["layers"] = [{k: (a * 0.3, b * 0.3) for k, (a, b) in layer.items()}
                      for layer in lora["layers"]]
    return lora


# Adapter ids of the three graph rows, changed between replays.
LORA_IDS = ([0, -1, 2], [2, 1, -1], [1, 1, 0])


def test_lora_pick_step_graph_equals_eager(cuda):
    """A LoRA decode step (``pick_step``, t = 1) by replay equals the eager
    step bit for bit (logits' greedy pick, pages), with the adapter ids
    changed between replays (one capture, three replays), and the ids
    change the tokens."""
    params, cache, tables = _graph_model(cuda, "dense")
    lora = _graph_lora(cuda)
    replayed, eager = _clone(cache), _clone(cache)
    graphs = StepGraphs(params, GRAPH_CFG, replayed, lora=lora)
    no_drafts = torch.zeros(len(GRAPH_LENGTHS), dtype=torch.int64)
    keys, pos = _keys_at(0)
    for call, ids in enumerate(LORA_IDS):
        tokens, lengths = _step_inputs(1, seed=call, grown=call + 1)
        got, _ = graphs.pick_step(tokens, lengths, tables.cpu(), no_drafts, keys, pos,
                                  torch.tensor(ids))
        logits, _ = decode.decode_step(params, tokens[:, 0].to(cuda), GRAPH_CFG, eager,
                                       lengths.to(cuda), tables, lora=lora,
                                       adapter_ids=torch.tensor(ids, device=cuda))
        assert torch.equal(got[:, 0], logits.argmax(-1)), call
    assert graphs.graphs == 1 and graphs.replays == len(LORA_IDS)
    _same_pools(replayed, eager)
    # The ids reach the step: an adapted row's logits differ from the base
    # model's, and a row of id -1 equals it bit for bit.
    tokens, lengths = _step_inputs(1, seed=0, grown=1)
    adapted, base = (decode.decode_step(
        params, tokens[:, 0].to(cuda), GRAPH_CFG, _clone(cache), lengths.to(cuda), tables,
        **kw)[0] for kw in (dict(lora=lora, adapter_ids=torch.tensor(LORA_IDS[0], device=cuda)),
                            {}))
    assert not torch.equal(adapted[0], base[0]) and torch.equal(adapted[1], base[1])


def test_lora_loop_graph_equals_eager(cuda):
    """A LoRA decode loop of four steps by replay equals the eager
    ``decode_loop`` (tokens and pages), twice, with other adapter ids on
    the second call."""
    params, cache, tables = _graph_model(cuda, "dense")
    lora = _graph_lora(cuda)
    loop_cache, eager_cache = _clone(cache), _clone(cache)
    graphs = StepGraphs(params, GRAPH_CFG, loop_cache, lora=lora)
    first, lengths = _step_inputs(1, seed=4, grown=0)
    for call, ids in enumerate(LORA_IDS[:2]):
        lens = lengths + 4 * call
        out, _ = graphs.decode_loop(first[:, 0], lens, tables.cpu(), 4,
                                    adapter_ids=torch.tensor(ids))
        want, _, _ = decode.decode_loop(params, first[:, 0].to(cuda), GRAPH_CFG, eager_cache,
                                        lens.to(cuda), tables, 4, lora=lora,
                                        adapter_ids=torch.tensor(ids, device=cuda))
        assert torch.equal(out, want), call
    assert graphs.graphs == 1 and graphs.replays == 2
    _same_pools(loop_cache, eager_cache)


def test_bound_kernels_equal_the_wrappers(cuda):
    """``make_flash_forward``'s call is one K1 launch giving
    ``flash_forward_with_lse``'s output bit for bit; ``make_flash_backward``'s
    two calls are one K3 launch each, together ``flash_backward(fused=False)``
    bit for bit; ``make_flash_backward_fused``'s call is one K2 launch, dK
    and dV bit for bit (its dQ adds in no fixed order: within 1e-2 of the
    largest value, about one bf16 ulp)."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        make_flash_backward, make_flash_backward_fused)
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import make_flash_forward

    b, h, kvh, s = 2, 8, 2, 512
    cfg = KernelConfig(causal=True)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(b, h, s, kv_heads=kvh, seed=12))
    do = torch.randn_like(q)
    before = collections.Counter(_build.launch_counts)
    out, lse = make_flash_forward(cfg, b, h, s, s, kv_heads=kvh, return_lse=True)(q, k, v)
    assert _build.launch_counts - before == collections.Counter({FLASH: 1})
    want = flash_forward_with_lse(q, k, v, cfg)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    dsum = (do.float() * out.float()).sum(-1)
    dq_call, dkv_call = make_flash_backward(cfg, b, h, s, s, kvh)
    before = collections.Counter(_build.launch_counts)
    dq = dq_call(q, k, v, do, lse, dsum)
    assert _build.launch_counts - before == collections.Counter({KERNEL_DQ: 1})
    dk, dv = dkv_call(q, k, v, do, lse, dsum)
    assert _build.launch_counts - before == collections.Counter({KERNEL_DQ: 1, KERNEL_DKV: 1})
    split = flash_backward(q, k, v, out, lse, do, cfg, fused=False)
    assert all(torch.equal(a, w) for a, w in zip((dq, dk, dv), split))
    before = collections.Counter(_build.launch_counts)
    fused = make_flash_backward_fused(cfg, b, h, s, s, kvh)(q, k, v, do, lse, dsum)
    assert _build.launch_counts - before == collections.Counter({KERNEL_FUSED: 1})
    want = flash_backward(q, k, v, out, lse, do, cfg, fused=True)
    assert torch.equal(fused[1], want[1]) and torch.equal(fused[2], want[2])
    assert float((fused[0].float() - want[0].float()).abs().max()) <= 1e-2 * float(
        want[0].float().abs().max())


def test_timers_and_block_oracle_on_the_card(cuda):
    """``sync_overhead``, ``chain_runtime`` and ``forward_timed`` give
    positive times on the card; ``block_flash_attention`` on CUDA tensors
    agrees with the plain reference in fp32 within 1e-4 of its largest
    value."""
    from flash_attention_from_scratch_tpu_torch import dispatch
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import flash_forward
    from flash_attention_from_scratch_tpu_torch.ops.reference import block_flash_attention

    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(1, 8, 1024, kv_heads=2, seed=13))
    cfg = KernelConfig(causal=True)
    assert dispatch.sync_overhead() > 0
    assert dispatch.chain_runtime(lambda x, k, v: flash_forward(x, k, v, cfg), q, k, v,
                                  steps=8, iters=3) > 0
    assert dispatch.forward_timed(q, k, v, cfg, iters=3)[1] > 0
    x = torch.randn(1, 2, 256, 128, device=cuda)
    got = block_flash_attention(x, x.flip(2), x, block_q=64, block_kv=128)
    want = reference_attention(x, x.flip(2), x)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


MOE_GRAPH_CFG = moe.MoEConfig(vocab_size=2048, dim=1024, n_layers=2, n_heads=8, n_kv_heads=2,
                              d_head=128, hidden_dim=1024, n_experts=4, expert_top_k=2)


def _moe_graph_model(cuda):
    """A MoE model with ``GRAPH_LENGTHS`` prompts prefilled (the padded
    prompts route through the experts)."""
    params = moe.init_moe_params(MOE_GRAPH_CFG, torch.Generator(device=cuda).manual_seed(0),
                                 device=cuda)
    batch = len(GRAPH_LENGTHS)
    cache = decode.init_cache(MOE_GRAPH_CFG, batch * GRAPH_PAGES_PER_SEQ + 1, 64, "dense", cuda)
    tables = torch.arange(batch * GRAPH_PAGES_PER_SEQ, dtype=torch.int32,
                          device=cuda).view(batch, -1)
    rng = np.random.default_rng(1)
    for b, n in enumerate(GRAPH_LENGTHS):
        toks = torch.zeros((1, 512), dtype=torch.long, device=cuda)
        toks[0, :n] = torch.from_numpy(rng.integers(0, MOE_GRAPH_CFG.vocab_size, n))
        decode.prefill(params, toks, MOE_GRAPH_CFG, cache, tables[b], prompt_len=n)
    return params, cache, tables


@pytest.mark.parametrize("t", [1, 4])
def test_moe_replayed_step_equals_eager_step(cuda, t):
    """The routed decode (t = 1) and verify (t = 4) steps: two calls (the
    first captures, the second only replays) against the eager ``_step``,
    logits and pages bit for bit, and the replay counts the eager launches."""
    params, cache, tables = _moe_graph_model(cuda)
    replayed, eager = _clone(cache), _clone(cache)
    graphs = StepGraphs(params, MOE_GRAPH_CFG, replayed)
    for call in range(2):
        tokens, lengths = _step_inputs(t, seed=call, grown=(call + 1) * t)
        before = collections.Counter(_build.launch_counts)
        got = graphs.verify_step(tokens, lengths, tables.cpu())
        replay = _build.launch_counts - before
        before = collections.Counter(_build.launch_counts)
        want, _ = decode._step(params, tokens.to(cuda), MOE_GRAPH_CFG, eager,
                               lengths.to(cuda), tables, None, None, False)
        assert replay == _build.launch_counts - before
        assert torch.equal(_bits(got), _bits(want)), (t, call)
    _same_pools(replayed, eager)
    assert graphs.graphs == 1 and graphs.replays == 2 and graphs.nonfinite_logits() == 0


def test_moe_graph_decode_loop_equals_eager(cuda):
    """A loop graph of four routed steps gives the eager ``decode_loop``'s
    tokens and pages."""
    params, cache, tables = _moe_graph_model(cuda)
    first, lengths = _step_inputs(1, seed=4, grown=0)
    loop_cache, eager_cache = _clone(cache), _clone(cache)
    out, _ = StepGraphs(params, MOE_GRAPH_CFG, loop_cache).decode_loop(
        first[:, 0], lengths, tables.cpu(), 4)
    want, _, _ = decode.decode_loop(params, first[:, 0].to(cuda), MOE_GRAPH_CFG, eager_cache,
                                    lengths.to(cuda), tables, 4)
    assert torch.equal(out, want)
    _same_pools(loop_cache, eager_cache)


def test_moe_layer_on_the_card_matches_the_cpu(cuda):
    """The routing on the card (sort, cumsum, one-hots by comparison) gives
    the CPU's dispatch and combine bit for bit on the same gates; ``_moe_mlp``
    in fp32 (TF32 off) within 1e-5 of the CPU's largest output; and
    ``moe_forward`` in bf16 launches K1 once a layer and gives finite
    logits."""
    cfg = dataclasses.replace(MOE_GRAPH_CFG, dtype=DType.FP32)
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 128, cfg.dim, generator=torch.Generator().manual_seed(1))
    gates = torch.softmax(x.view(-1, cfg.dim) @ params["layers"][0]["router"], dim=-1)
    for cap in (moe._capacity(cfg, 256), 8):
        want = moe._route(cfg, gates, cap)
        got = moe._route(cfg, gates.to(cuda), cap)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got[:2], want[:2]))
    want, want_aux = moe._moe_mlp(cfg, params["layers"][0], x)
    got, aux = moe._moe_mlp(cfg, _to_device(params["layers"][0], cuda), x.to(cuda))
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))
    params, _, _ = _moe_graph_model(cuda)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, MOE_GRAPH_CFG.vocab_size, (2, 256))).to(cuda)
    before = collections.Counter(_build.launch_counts)
    with torch.no_grad():
        logits, aux = moe.moe_forward(params, tokens, MOE_GRAPH_CFG)
    assert _build.launch_counts - before == collections.Counter(
        {FLASH: MOE_GRAPH_CFG.n_layers})
    assert bool(torch.isfinite(logits).all()) and float(aux) > 0


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """A state saved from the card restores onto a template on the card:
    every tensor on the card, bit for bit, a QuantizedWeight with its mode."""
    from flash_attention_from_scratch_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)

    params = llama.quantize_params(llama.init_params(
        GRAPH_CFG, torch.Generator(device=cuda).manual_seed(0), cuda), "int8")
    save_checkpoint(str(tmp_path), params, 2)
    got = restore_checkpoint(str(tmp_path), params)
    assert got["embed"].device.type == "cuda" and torch.equal(got["embed"], params["embed"])
    w = got["layers"][1]["w_down"]
    assert w.values.device.type == "cuda" and w.mode == "int8"
    assert torch.equal(w.values, params["layers"][1]["w_down"].values)


def test_load_hf_checkpoint_onto_the_card(cuda, tmp_path):
    """bf16 shards read by the port's reader and converted on the card equal
    the CPU conversion bit for bit."""
    import json

    from flash_attention_from_scratch_tpu_torch.models import convert

    cfg = dataclasses.replace(GRAPH_CFG, n_layers=1)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    names = {"attn_norm": "input_layernorm", "wq": "self_attn.q_proj",
             "wk": "self_attn.k_proj", "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "mlp_norm": "post_attention_layernorm", "w_gate": "mlp.gate_proj",
             "w_up": "mlp.up_proj", "w_down": "mlp.down_proj"}
    sd = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"].T.contiguous()}
    sd.update({f"model.layers.0.{n}.weight": (w if w.dim() == 1 else w.T.contiguous())
               for k, n in names.items() for w in [params["layers"][0][k]]})
    header, blobs, offset = {}, [], 0
    for name, t in sd.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    blob = json.dumps(header).encode()
    (tmp_path / "model.safetensors").write_bytes(len(blob).to_bytes(8, "little") + blob
                                                 + b"".join(blobs))
    got, _ = convert.load_hf_checkpoint(str(tmp_path), cfg, device=cuda)
    for a, b in zip(train.param_leaves(got), train.param_leaves(params)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


# The ring's windowed hops (``parallel/ring_attention.py::_hop_cfg``): seq_q
# == seq_kv == the shard length L at q_offset = t * L with the window, so the
# kernels align rows top-left plus the offset with no prefix of keys before
# the diagonal (before the ring only chunked prefill's seq_kv = seq_q +
# q_offset). (L, q_offset, window); a window of L leaves the last row
# without a key.
RING_HOP_CASES = [(256, 256, 256), (256, 256, 300), (256, 512, 600), (512, 512, 700),
                  (128, 128, 100)]


@pytest.mark.parametrize("shard,offset,window", RING_HOP_CASES)
def test_ring_hop_kernels_match_plain(cuda, shard, offset, window):
    """K1 (with sinks and the LSE) and K3 and K2 at a ring hop's config
    against their plain versions; the backward on the sink-inclusive LSE,
    finite on every row, as the ring's global LSE is."""
    cfg = KernelConfig(causal=True, q_offset=offset, window=window)
    check_flash_kernel(cuda, shard, cfg, FLASH, seq_kv=shard)
    q, k, v, do = _backward_inputs(cuda, shard, shard, 8, 2, cfg, seed=12)
    o, lse = flash_forward_with_lse(q, k, v, cfg, sinks=torch.linspace(-2, 2, 8, device=cuda))
    for fused in (False, True):
        got = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
        torch.cuda.synchronize()
        _check_backward(got, q, k, v, o, lse, do, cfg, (shard, offset, window, fused))


def test_ring_on_the_card_over_gloo(cuda):
    """Two gloo ranks on card 0: ppermute moves a CUDA tensor through pinned
    host memory (4 KiB each way counted) and returns it on the card; the
    causal ring (1024 tokens, 8/2 heads) gives single-device
    ``flash_attention``'s output and gradients within 2^-6 of their largest
    value, two bf16 ulps there (the ring rounds its partials before the
    merge and runs K2 on the plain hop), on the kernels its rank's
    ``launch_plan`` states."""
    import torch_parallel_ranks as ranks
    from flash_attention_from_scratch_tpu_torch.parallel.launch import spawn
    from flash_attention_from_scratch_tpu_torch.parallel.ring_attention import launch_plan

    _build.load(FLASH_SOURCE)  # built once here, not by each rank
    _build.load(BACKWARD_SOURCES[128])
    got = spawn(ranks.cuda_ring, 2, backend="gloo", device="cuda:0", timeout=300)
    for rank, r in enumerate(got):
        assert torch.equal(r["moved"], torch.full((1024,), float(1 - rank)))
        assert r["device"] == "cuda" and r["staged"] == 2 * 4096
        assert r["launches"] == dict(launch_plan(KernelConfig(causal=True), 2, 512, rank))
        assert all(d <= 2.0 ** -6 * scale for d, scale in r["diffs"]), r["diffs"]


def test_pipeline_and_expert_axes_on_the_card_over_gloo(cuda):
    """Four gloo ranks on card 0, on a "pp" and an "ep" mesh: ppermute
    along the partial chain (i, i + 1) moves each CUDA tensor one rank on
    (rank 0 gets zeros) and its gradient one rank back (the last rank gets
    zeros); copy_to then reduce_from sums over the axis forward and
    backward; each rank staged its sends and receives through host memory
    and got its results on the card."""
    import torch_parallel_ranks as ranks
    from flash_attention_from_scratch_tpu_torch.parallel.launch import spawn

    world = 4
    got = spawn(ranks.cuda_axes, world, backend="gloo", device="cuda:0", timeout=300)
    for rank, r in enumerate(got):
        for axis in ("pp", "ep"):
            a = r[axis]
            assert a["device"] == "cuda" and a["staged"] > 0
            assert torch.equal(a["moved"], torch.full((256,), float(rank)))
            back = float(rank + 2) if rank < world - 1 else 0.0
            assert torch.equal(a["moved_grad"], torch.full((256,), back))
            assert torch.equal(a["summed"], torch.full((2,), float(sum(range(1, world + 1)))))
            assert torch.equal(a["copy_grad"], torch.full((2,), 2.0 * world))


def test_tp_lora_decode_on_the_card_over_gloo(cuda):
    """Two gloo ranks on card 0: LoRA prefill and one decode step with
    adapters 1 and -1 in one batch on tp shards (K1 per prompt, K4/K5 on
    each rank's 2 heads) give the same logits on both ranks, within 6e-2 (the
    JAX tp decode test's bound) of the whole model's on the CPU's plain
    path."""
    import torch_parallel_ranks as ranks
    from flash_attention_from_scratch_tpu_torch.parallel.launch import spawn

    _build.load(FLASH_SOURCE)  # built once here, not by each rank
    _build.load(PAGED_SOURCE)
    got = spawn(ranks.cuda_tp_lora, 2, backend="gloo", device="cuda:0", timeout=300)
    assert torch.equal(got[0]["logits"], got[1]["logits"])
    for r in got:
        assert r["launches"][FLASH] == 2 and r["launches"][PAGED] == 1, r["launches"]
    err = float((got[0]["logits"] - got[0]["plain"]).abs().max())
    assert err < 6e-2, err


# ---------------------------------------------------------------------------
# fp16: every kernel from its fp16 library (the bf16 sources built with
# FA_F16), by the rules above with fp16's eps; the type still refused.

FP16_LIBRARIES = {FLASH_SOURCE: "flash_forward_f16.cu", SOURCE_FORI: "flash_forward_fori_f16.cu",
                  SOURCES_FORI[256]: "flash_forward_fori_d256_f16.cu",
                  PAGED_SOURCE: "paged_attention_f16.cu", QMM_SOURCE: "quant_matmul_f16.cu",
                  BACKWARD_SOURCES[128]: "flash_backward_f16.cu",
                  BACKWARD_SOURCES[256]: "flash_backward_d256_f16.cu",
                  SOURCES_QUANT[128]: "flash_quant_f16.cu",
                  SOURCES_QUANT[256]: "flash_quant_d256_f16.cu"}


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("sq,kw", FLASH_CASES + RAGGED_CASES)
def test_flash_kernel_fp16_matches_plain(cuda, sq, kw, d_head):
    """K1 in fp16 at d 128 and 256 (with sinks, the LSE; GQA)."""
    kw = dict(kw)
    skv = kw.pop("seq_kv", 256)
    check_flash_kernel(cuda, sq, KernelConfig(d_head=d_head, dtype=DType.FP16, **kw), FLASH,
                       seq_kv=skv)


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
@pytest.mark.parametrize("sq,kw", [(256, dict(causal=True)), (192, dict(
    causal=True, q_offset=128, window=70, seq_kv=320)), (256, dict(attn_softcap=30.0))])
def test_fori_kernel_fp16_matches_plain(cuda, sq, kw, nbuf, d_head):
    """K11 in fp16 at every ring depth, d 128 and 256."""
    kw = dict(kw)
    skv = kw.pop("seq_kv", 256)
    cfg = KernelConfig(d_head=d_head, dtype=DType.FP16, kv_loop=KVLoop.FORI,
                       num_kv_buffers=nbuf, **kw)
    check_flash_kernel(cuda, sq, cfg, FORI, seq_kv=skv)


def _fp16_pool(cuda, ps, d, kv_heads, lengths, seed):
    """A NaN-poisoned fp16 pool of ``ps``-token pages under shuffled ids."""
    rng = np.random.default_rng(seed)
    need = [-(-n // ps) for n in lengths]
    num_pages = sum(need) + 2
    k = torch.full((kv_heads, num_pages, ps, d), float("nan"), device=cuda)
    v = torch.full_like(k, float("nan"))
    perm = rng.permutation(num_pages)
    tables = torch.full((len(lengths), max(need)), -1, dtype=torch.int32, device=cuda)
    nxt = 0
    for b, n in enumerate(lengths):
        for i in range(need[b]):
            page, rows = int(perm[nxt]), min(ps, n - i * ps)
            nxt += 1
            tables[b, i] = page
            k[:, page, :rows] = torch.randn(kv_heads, rows, d, device=cuda)
            v[:, page, :rows] = torch.randn(kv_heads, rows, d, device=cuda)
    return k.half(), v.half(), tables


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("ps", [64, 1, 12])
@pytest.mark.parametrize("store", ["dense", "int8", "fp8", "int4", "int8c"])
def test_paged_kernel_fp16_matches_plain(cuda, store, ps, t, d_head):
    """K4/K5 with fp16 q on every store, on the chunk walk (page 64) and the
    gather walk (pages 1 and 12; int4 2 and 12), with a window and a
    softcap: the rule in each (sequence, token) against the plain version
    with fp16 q (int8 compute: the plain int8-compute version), and the
    fp32 plain version without int8 compute; fp16 out, one launch."""
    if store == "int4" and ps == 1:
        ps = 2
    i8c, mode = store == "int8c", "int8" if store == "int8c" else store
    lengths = [0, 1, 4, 37, 300]
    k, v, tables = _fp16_pool(cuda, ps, d_head, 2, lengths, seed=ps + t)
    kw = {}
    if mode != "dense":
        qk, ks = quantize_kv_pages(torch.nan_to_num(k), mode)
        qv, vs = quantize_kv_pages(torch.nan_to_num(v), mode)
        k, v, kw = qk, qv, dict(mode=mode, k_scales=ks, v_scales=vs)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn((len(lengths), 8) + ((t,) if t > 1 else ()) + (d_head,),
                    device=cuda).half()
    for extra in ({}, dict(window=100, softcap=20.0)):
        args = dict(kw, scale=d_head ** -0.5, **extra)
        name = kernel_name(t, i8c)
        before = _build.launch_counts[name]
        out = paged_decode_attention(q, k, v, lens, tables, int8_compute=i8c, **args)
        torch.cuda.synchronize()
        assert _build.launch_counts[name] == before + 1 and out.dtype == torch.float16
        ref16 = paged_decode_attention_plain(q, k, v, lens, tables, int8_compute=i8c, **args)
        pages32 = (k.float(), v.float()) if mode == "dense" else (k, v)
        ref32 = paged_decode_attention_plain(q.float(), *pages32, lens, tables, **args)
        by_token = (lambda x: x.transpose(1, 2)) if t > 1 else (lambda x: x[:, None])
        assert torch.isfinite(out).all() and float(out[0].abs().max()) == 0.0
        ok, ratio, where = sliced_tolerance_check(by_token(out), by_token(ref16),
                                                  by_token(ref32), lead=2)
        assert ok, (extra, ratio, where)


@pytest.mark.parametrize("m,k,n", [(16, 4096, 4096), (1024, 4096, 1024), (3, 4004, 4100),
                                   (5, 512, 32002)])
@pytest.mark.parametrize("mode,act_quant", [("int8", False), ("int4", False),
                                            ("int8", True), ("int4", True)])
def test_quant_matmul_fp16_matches_plain(cuda, mode, act_quant, m, k, n):
    """K6-K9 with fp16 x (aligned and ragged shapes): K6/K7 by the rule in
    each 16-row band against the plain version in fp16 and in fp32; K8/K9
    and their activation quantization equal to the plain versions bit for
    bit; fp16 out, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    w = torch.randn(k, n, generator=gen, device=cuda) / k ** 0.5
    wq = quantize_weight(w.half(), mode, "int8" if act_quant else "bf16")
    x = torch.randn(m, k, generator=gen, device=cuda).half()
    name = QMM[(mode, act_quant)]
    before = _build.launch_counts[name]
    got = quant_matmul(x, wq, act_quant=act_quant)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    assert got.dtype == torch.float16 and got.shape == (m, n)
    plain = quant_matmul_plain(x, wq, act_quant)
    if act_quant:
        got_q, got_s = quantize_rows(x)
        want_q, want_s = quantize_activations(x)
        assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)
        assert torch.equal(got, plain)
        return
    ref32 = quant_matmul_plain(x, wq, act_quant, out_dtype=torch.float32)
    pad = -m % 16

    def bands(t):
        return row_bands(torch.nn.functional.pad(t.float(), (0, 0, 0, pad))[None], 16)

    ok, ratio, where = sliced_tolerance_check(bands(got), bands(plain).half(), bands(ref32),
                                              lead=2)
    assert ok, (ratio, where)


@pytest.mark.parametrize("bf16_source", sorted(FP16_LIBRARIES))
def test_fp16_libraries_multiply_fp16(cuda, bf16_source):
    """Each fp16 library's 16-bit tensor-core products are fp16 (no HGMMA or
    HMMA of its kernels names BF16), and its bf16 library's are bf16."""
    def products(source):
        return [line for text in sass_by_function(source).values()
                for line in text.splitlines() if "HGMMA" in line or "HMMA" in line]

    f16, bf16 = products(FP16_LIBRARIES[bf16_source]), products(bf16_source)
    assert f16 and not any(".BF16" in line for line in f16), f16[:4]
    assert any(".BF16" in line for line in bf16), bf16[:4]


# K2/K3 in fp16: (seq_q, seq_kv, Q heads, KV heads, options) at d 128 and
# 256: every mask (causal with a q_offset, a window starting mid-tile,
# softcap 50, none), ragged tiles, one Q head a KV head, and non-square
# shapes (the banded backward's past keys: K2 with fewer rows than keys).
FP16_BACKWARD_CASES = [
    (256, 256, 8, 2, dict()), (256, 256, 8, 2, dict(causal=True)),
    (128, 256, 8, 2, dict(causal=True, q_offset=128)),
    (192, 320, 8, 2, dict(causal=True, q_offset=128, window=70)),
    (256, 256, 4, 4, dict(causal=True, attn_softcap=50.0)),
    (256, 768, 8, 2, dict()),
]


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("sq,skv,heads,kv_heads,kw", FP16_BACKWARD_CASES)
def test_flash_backward_fp16_matches_plain(cuda, sq, skv, heads, kv_heads, kw, fused, d_head):
    """K2 and K3 in fp16 from their fp16 libraries against the plain
    backward in fp16 and in fp32 by the sliced rule (fp16's eps): one
    launch of each kernel a call, dQ, dK and dV in fp16, a second call's
    dK and dV (and K3's dQ) equal bit for bit."""
    cfg = KernelConfig(d_head=d_head, dtype=DType.FP16, **kw)
    rng = np.random.default_rng(sq + skv)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.float16) for x in
               make_qkv(2, heads, sq, d_head, kv_heads=kv_heads, seq_kv=skv, seed=13))
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(
        cuda, torch.float16)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    names = [KERNEL_FUSED] if fused else [KERNEL_DKV, KERNEL_DQ]
    before = {n: _build.launch_counts[n] for n in names}
    got = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
    again = flash_backward(q, k, v, o, lse, do, cfg, fused=fused)
    torch.cuda.synchronize()
    assert all(_build.launch_counts[n] == before[n] + 2 for n in names)
    assert all(g.dtype == torch.float16 for g in got)
    _check_backward(got, q, k, v, o, lse, do, cfg, (fused, d_head, sq, skv, kw))
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    if not fused:
        assert torch.equal(got[0], again[0])


@pytest.mark.parametrize("d_head", [128, 256])
def test_banded_backward_fp16_matches_plain(cuda, d_head):
    """``flash_backward(bands=2)`` in fp16: K2 on each band's diagonal
    square and past keys, by the sliced rule against the plain backward."""
    cfg = KernelConfig(d_head=d_head, dtype=DType.FP16, causal=True)
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(x).to(cuda, torch.float16) for x in
               make_qkv(1, 4, 512, d_head, kv_heads=2, seed=14))
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(
        cuda, torch.float16)
    o, lse = flash_forward_with_lse(q, k, v, cfg)
    before = _build.launch_counts[KERNEL_FUSED]
    got = flash_backward(q, k, v, o, lse, do, cfg, bands=2)
    torch.cuda.synchronize()
    assert _build.launch_counts[KERNEL_FUSED] == before + 3
    assert all(g.dtype == torch.float16 for g in got)
    _check_backward(got, q, k, v, o, lse, do, cfg, ("bands 2", d_head))


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("variant,kw,strided", QUANT_CASES)
def test_flash_quant_kernel_fp16_matches_plain(cuda, variant, kw, strided, d_head):
    """K10 in fp16 (dense fp16 Q, or Q, K and V quantized from fp16: every
    QTensor's ``orig_dtype`` fp16) on the cases above by their rule with
    fp16's eps; int8c's integer sums stored in fp16."""
    check_quant_variant(cuda, variant, kw, strided, d_head, torch.float16)


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("q_kind", ["int8", "fp8"])
def test_quantized_fp16_q_keeps_its_type(cuda, q_kind, d_head):
    """A quantized Q of fp16 ``orig_dtype`` and no config: the compute type
    is fp16 (the JAX kernel's ``DType.from_jnp(q.orig_dtype)``), so K10's
    fp16 library runs and the output is fp16, equal in bits to the same
    call with an explicit fp16 config, and within the rule of the plain
    version; the same Q from bf16 runs in bf16."""
    q, k, v = (torch.from_numpy(x).to(cuda, torch.float16) for x in
               make_qkv(1, 4, 256, d_head, kv_heads=2, seed=15))
    kq, vq = quantize_kv(k, "int8"), quantize_kv(v, "int8")
    qq = quantize_kv(q, q_kind)
    assert qq.orig_dtype == torch.float16
    before = _build.launch_counts[FLASH_QUANT]
    out = flash_forward_quantized(qq, kq, vq)
    torch.cuda.synchronize()
    assert _build.launch_counts[FLASH_QUANT] == before + 1 and out.dtype == torch.float16
    cfg = KernelConfig(d_head=d_head, dtype=DType.FP16)
    i8c = q_kind == "int8"
    assert torch.equal(out, check_flash_quant(qq, kq, vq, cfg, i8c, (q_kind, d_head)))
    q16 = quantize_kv(q.bfloat16(), q_kind)
    assert flash_forward_quantized(q16, kq, vq).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# fp32: K1 and K11 from their fp32 libraries (csrc/flash_f32.cuh: 3xTF32
# products, P in fp32), held by utils/testing.py::fp32_tolerance_check (the
# kernel's error from the exact answer, the plain version in fp64, at most
# twice the plain fp32 version's, fp32's floors) on NaN-poisoned memory, the
# LSE within 1e-4 of the plain fp32 one; the model's prefill in fp32; the
# kernels still without fp32 (below: ``test_types_without_a_kernel_raise``).

FP32_LIBRARIES = {FLASH_SOURCE: "flash_forward_f32.cu", SOURCE_FORI: "flash_forward_fori_f32.cu",
                  SOURCES_FORI[256]: "flash_forward_fori_d256_f32.cu"}


def _poison_cuda_memory(mb: int = 256) -> None:
    """The next allocations of the caching allocator read as NaN (0xFF
    bytes), so that an output a kernel leaves unwritten shows."""
    block = torch.full((mb << 20,), 0xFF, dtype=torch.uint8, device="cuda")
    del block


def check_flash_kernel_fp32(cuda, sq, cfg, kernel, seq_kv=256, strided=False):
    q, k, v = (torch.from_numpy(x).to(cuda) for x in
               make_qkv(2, 8, sq, cfg.d_head, kv_heads=2, seq_kv=seq_kv, seed=1))
    if strided:  # (b, h, s, d) views of contiguous (b, s, h, d) rows
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    sinks = torch.linspace(-2, 2, 8, device=cuda)
    _poison_cuda_memory()
    before = _build.launch_counts[kernel]
    out, lse = flash_forward_with_lse(q, k, v, cfg, sinks=sinks)
    torch.cuda.synchronize()
    assert _build.launch_counts[kernel] == before + 1 and out.dtype == torch.float32
    plain, lse32 = flash_forward_plain(q, k, v, cfg, sinks)
    exact = reference_attention(q.double(), k.double(), v.double(), causal=cfg.causal,
                                scale_override=cfg.softmax_scale,
                                q_offset=cfg.q_offset if cfg.causal else None,
                                window=cfg.window, softcap=cfg.attn_softcap, sinks=sinks)
    ok, ratio, where = fp32_tolerance_check(row_bands(out), row_bands(plain), row_bands(exact),
                                            lead=3)
    assert ok, (ratio, where)
    assert float((lse - lse32).abs().max()) <= 1e-4


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("sq,kw", K1_CASES)
def test_flash_kernel_fp32_matches_plain(cuda, sq, kw, d_head):
    """K1 in fp32 at d 128 and 256 on K1's cases (sinks, the LSE, GQA,
    strided views, rows that see no key)."""
    kw = dict(kw)
    skv, strided = kw.pop("seq_kv", 256), kw.pop("strided", False)
    check_flash_kernel_fp32(cuda, sq, KernelConfig(d_head=d_head, dtype=DType.FP32, **kw),
                            FLASH, seq_kv=skv, strided=strided)


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
@pytest.mark.parametrize("sq,kw", [(256, dict(causal=True)), (192, dict(
    causal=True, q_offset=128, window=70, seq_kv=320)), (256, dict(attn_softcap=30.0)),
    (64, dict(causal=True))])
def test_fori_kernel_fp32_matches_plain(cuda, sq, kw, nbuf, d_head):
    """K11 in fp32 at every ring depth, d 128 and 256."""
    kw = dict(kw)
    skv = kw.pop("seq_kv", 256)
    cfg = KernelConfig(d_head=d_head, dtype=DType.FP32, kv_loop=KVLoop.FORI,
                       num_kv_buffers=nbuf, **kw)
    check_flash_kernel_fp32(cuda, sq, cfg, FORI, seq_kv=skv)


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("loop", [{}, dict(kv_loop=KVLoop.FORI, num_kv_buffers=3)])
def test_make_flash_forward_fp32_is_one_launch(cuda, loop, d_head):
    """``make_flash_forward`` bound to fp32: one launch a call (K1, or K11),
    fp32 out, the bits of ``flash_forward_with_lse``."""
    from flash_attention_from_scratch_tpu_torch.ops.flash_forward import make_flash_forward

    cfg = KernelConfig(d_head=d_head, dtype=DType.FP32, causal=True, **loop)
    q, k, v = (torch.from_numpy(x).to(cuda) for x in
               make_qkv(1, 4, 320, d_head, kv_heads=2, seed=3))
    kernel = FORI if loop else FLASH
    call = make_flash_forward(cfg, 1, 4, 320, 320, kv_heads=2, return_lse=True)
    before = _build.launch_counts[kernel]
    out, lse = call(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts[kernel] == before + 1
    assert out.dtype == lse.dtype == torch.float32
    want, want_lse = flash_forward_with_lse(q, k, v, cfg)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)


@pytest.mark.parametrize("bf16_source", sorted(FP32_LIBRARIES))
def test_fp32_libraries_multiply_in_tf32(cuda, bf16_source):
    """Each fp32 library's products are TF32 mma.sync (HMMA ... TF32; no
    HGMMA), and its bf16 library's are bf16."""
    def products(source):
        return [line for text in sass_by_function(source).values()
                for line in text.splitlines() if "HGMMA" in line or "HMMA" in line]

    f32 = products(FP32_LIBRARIES[bf16_source])
    assert f32 and all(".TF32" in line and "HGMMA" not in line for line in f32), f32[:4]
    assert not any(".TF32" in line for line in products(bf16_source))


def test_fp32_flash_attention_backward_raises(cuda):
    """``flash_attention`` in fp32: the forward runs K1's fp32 library, the
    backward raises naming item 4c-3 before any kernel of it launches."""
    from flash_attention_from_scratch_tpu_torch.ops.autodiff import flash_attention

    q, k, v = (torch.from_numpy(x).to(cuda).requires_grad_() for x in
               make_qkv(1, 4, 256, 128, kv_heads=2, seed=4))
    cfg = KernelConfig(dtype=DType.FP32, causal=True)
    out = flash_attention(q, k, v, cfg)
    assert out.dtype == torch.float32
    before = {n: _build.launch_counts[n] for n in (KERNEL_FUSED, KERNEL_DKV, KERNEL_DQ)}
    with pytest.raises(ValueError, match="ROADMAP Queue 1, item 4c-3"):
        out.sum().backward()
    assert {n: _build.launch_counts[n] for n in before} == before


@pytest.mark.parametrize("cfg", [dataclasses.replace(GRAPH_CFG, dtype=DType.FP32),
                                 dataclasses.replace(D256_CFG, dtype=DType.FP32)],
                         ids=["d128", "d256"])
def test_fp32_prefill_on_the_card_matches_the_cpu(cuda, cfg):
    """A small fp32 model's ``prefill`` on the card (K1's fp32 library, one
    launch a layer) and ``forward`` give the CPU's plain path's logits within
    1e-4 of the row's largest; its pages are fp32."""
    def to(tree, dev):
        if isinstance(tree, dict):
            return {n: to(x, dev) for n, x in tree.items()}
        if isinstance(tree, list):
            return [to(x, dev) for x in tree]
        return tree.to(dev) if torch.is_tensor(tree) else tree

    params = llama.init_params(cfg, torch.Generator(device="cpu").manual_seed(2), "cpu")
    on_card = to(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 256)))
    table = torch.arange(4, dtype=torch.int32)
    got = {}
    for dev, p in (("cpu", params), ("cuda", on_card)):
        cache = decode.init_cache(cfg, 4, 64, device=dev)
        before = _build.launch_counts[FLASH]
        logits, cache = decode.prefill(p, toks.to(dev), cfg, cache, table.to(dev),
                                       prompt_len=200)
        forward = llama.forward(p, toks.to(dev), cfg)[0]
        got[dev] = (logits.cpu(), forward.cpu(), _build.launch_counts[FLASH] - before)
        assert cache.k_pages[0].dtype == torch.float32
    assert got["cuda"][2] == 2 * cfg.n_layers and got["cpu"][2] == 0
    for a, b in zip(got["cuda"][:2], got["cpu"][:2]):
        assert a.dtype == torch.float32
        gap = (a - b).abs().amax(-1) / b.abs().amax(-1)
        assert float(gap.max()) <= 1e-4, float(gap.max())


def _fp32_server(cuda, dtype):
    from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

    cfg = dataclasses.replace(GRAPH_CFG, n_layers=1, dtype=DType.from_torch(dtype))
    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    GenerationServer(params, cfg, num_pages=8, page_size=64, max_batch=2)


def _typed_forward(cuda, dtype):
    q = torch.zeros(1, 2, 128, 128, device=cuda, dtype=dtype)
    return flash_forward_with_lse(q, q, q, KernelConfig(dtype=DType.from_torch(dtype)))


def _refused_backward(cuda, dtype):
    q = torch.zeros(1, 2, 128, 128, device=cuda, dtype=dtype)
    lse = torch.zeros(1, 2, 128, device=cuda)
    flash_backward(q, q, q, q, lse, q, KernelConfig(dtype=DType.from_torch(dtype)))


def _refused_quant(cuda, dtype):
    q = torch.zeros(1, 2, 128, 128, device=cuda, dtype=dtype)
    kq = quantize_kv(q.float(), "int8")
    flash_forward_quantized(q, kq, kq, KernelConfig(dtype=DType.from_torch(dtype)))


def _refused_paged(cuda, dtype):
    q = torch.zeros(1, 2, 128, device=cuda, dtype=dtype)
    pages = torch.zeros(2, 2, 64, 128, device=cuda, dtype=dtype)
    paged_decode_attention(q, pages, pages, torch.ones(1, dtype=torch.int32, device=cuda),
                           torch.zeros(1, 1, dtype=torch.int32, device=cuda))


def _refused_quantized_q(cuda, dtype):
    q = torch.zeros(1, 2, 128, 128, device=cuda, dtype=dtype)
    qq, kq = quantize_kv(q, "int8"), quantize_kv(q.bfloat16(), "int8")
    flash_forward_quantized(qq, kq, kq)


def _refused_qmm(cuda, dtype):
    wq = quantize_weight(torch.randn(256, 256, device=cuda), "int8")
    quant_matmul(torch.zeros(16, 256, device=cuda, dtype=dtype), wq)


@pytest.mark.parametrize("call,dtype,item", [
    (_typed_forward, torch.float32, None), (_refused_paged, torch.float32, "4c-2"),
    (_refused_qmm, torch.float32, "4c-2"), (_refused_backward, torch.float32, "4c-3"),
    (_refused_quant, torch.float32, "4c-3"), (_refused_quantized_q, torch.float32, "4c-3"),
    (_fp32_server, torch.float32, "4c-2")],
    ids=["K1-fp32", "K4K5-fp32", "K6-fp32", "K2K3-fp32", "K10-fp32", "K10-fp32-quantized-q",
         "server-fp32"])
def test_types_without_a_kernel_raise(cuda, call, dtype, item):
    """fp32 on every kernel but K1 and K11 raises ValueError on a CUDA
    tensor, naming the ROADMAP sub-item that will bring it (4c-2: K4/K5,
    K6-K9; 4c-3: K2/K3, K10, for K10 also a quantized Q of fp32
    ``orig_dtype``, the compute type, which no kernel runs as bf16); so does
    an fp32 ``GenerationServer`` at construction (its decode is K4/K5).
    K1 runs fp32 from its own library (item None), fp32 out."""
    if item is None:
        out, lse = call(cuda, dtype)
        torch.cuda.synchronize()
        assert out.dtype == lse.dtype == torch.float32 and bool(torch.isfinite(out).all())
        return
    with pytest.raises(ValueError, match=f"ROADMAP Queue 1, item {item}"):
        call(cuda, dtype)
