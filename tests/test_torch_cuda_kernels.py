"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: they skip without a card, decided inside the ``cuda``
fixture. On a machine with one (which need not have JAX, so skip the
repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: the adaptive tolerance rule against the plain version in bf16
(native) and in fp32 on the same bf16-rounded inputs, held in each
(batch, head, 64-row band) of a flash output or gradient and each sequence
of a paged one on its own (each (sequence, token) with multi-token
queries); the LSE within 1e-3. With ``int8_compute`` the native reference
is the plain int8-compute version and the fp32 one the plain version
without it on the same pages, q in fp32. The quantized matmuls: the
weight-only kernels (K6, K7) by the same rule in each 16-row band against
the plain version cast to bf16 and in fp32; the a8 kernels (K8, K9) within
one bf16 ulp of each value of the plain version, whose integer sums are
exact as the kernel's are. The training step compares
the parameter gradients of the fused and the split backward kernels with
those of the plain backward: all three run the same bf16 arithmetic and
differ in summation order only, so they agree within 1e-2 of each leaf's
largest gradient (about one bf16 ulp).
"""

import dataclasses
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu_torch.models import llama, train
from flash_attention_from_scratch_tpu_torch.ops import _build
from flash_attention_from_scratch_tpu_torch.ops.configs import (
    MAX_KV_BUFFERS, DType, KernelConfig, KVLoop,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
    KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED, flash_backward, flash_backward_plain,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
    KERNEL as FLASH, KERNEL_FORI as FORI, SOURCE_FORI, flash_forward_plain,
    flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_quant import (
    KERNEL as FLASH_QUANT, SOURCE as SOURCE_QUANT, flash_forward_quantized,
    flash_forward_quantized_plain,
)
from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
    KERNEL as PAGED, kernel_name, paged_decode_attention, paged_decode_attention_plain,
)
from flash_attention_from_scratch_tpu_torch.ops.quant import (
    QTensor, dequantize, quantize_kv, quantize_kv_pages,
)
from flash_attention_from_scratch_tpu_torch.ops.reference import reference_attention
from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
    KERNELS as QMM, QuantizedWeight, quant_matmul, quant_matmul_plain,
)
from flash_attention_from_scratch_tpu_torch.tools import bench_quant
from flash_attention_from_scratch_tpu_torch.utils.testing import (
    make_qkv, row_bands, sliced_tolerance_check,
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


@pytest.mark.parametrize("sq,kw", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, sq, kw):
    check_flash_kernel(cuda, sq, KernelConfig(**kw), FLASH)


# K1's cases, then the shapes K11's 128-row CTAs and 128-key slots make
# ragged: the second consumer warpgroup of the last Q tile past seq_q, the
# last KV tile half zero-filled (``seq_kv`` is popped from the options).
FORI_CASES = FLASH_CASES + [
    (192, dict(seq_kv=320)), (192, dict(causal=True, seq_kv=320)),
    (192, dict(causal=True, q_offset=128, window=70, seq_kv=320))]


@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
@pytest.mark.parametrize("sq,kw", FORI_CASES)
def test_fori_kernel_matches_plain(cuda, sq, kw, nbuf):
    """K11 at every ring depth it is built for, on K1's cases and the
    ragged ones."""
    kw = dict(kw)
    skv = kw.pop("seq_kv", 256)
    cfg = KernelConfig(kv_loop=KVLoop.FORI, num_kv_buffers=nbuf, **kw)
    check_flash_kernel(cuda, sq, cfg, FORI, seq_kv=skv)


def check_flash_kernel(cuda, sq, cfg, kernel, seq_kv=256):
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, sq, kv_heads=2, seq_kv=seq_kv, seed=1))
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


@pytest.mark.parametrize("variant,kw,strided", [
    *[(variant, dict(causal=causal), False) for variant in QUANT_VARIANTS
      for causal in (False, True)],
    ("int8c", dict(causal=True, window=200), False),
    ("int8kv", dict(causal=True, window=100), False),
    ("fp8", dict(causal=True, attn_softcap=20.0), False),
    ("int8kv", dict(causal=True), True), ("int8c", {}, True),
    # s 640 (five 128-key groups, an odd count of 128-row Q tiles), causal,
    # 32 Q / 8 KV heads (``seq`` and ``heads`` are popped from the options).
    *[(variant, dict(causal=True, seq=640, heads=(32, 8)), False)
      for variant in QUANT_VARIANTS]])
def test_flash_quant_kernel_matches_plain(cuda, variant, kw, strided):
    """K10 vs its plain version (b 2, 8 Q / 2 KV heads, s 384: three
    int8-compute groups, unless the case says otherwise): the adaptive rule
    per (batch, head, 64-row band) against the plain version and reference
    attention in fp32 on the inputs dequantized in fp32; ``strided`` hands
    Q over as a transposed view, whose strides the output keeps."""
    kv_mode, q_kind, i8c = QUANT_VARIANTS[variant]
    kw = dict(kw)
    seq, (heads, kv_heads) = kw.pop("seq", 384), kw.pop("heads", (8, 2))
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, heads, seq, kv_heads=kv_heads, seed=8))
    qq = q if q_kind == "bf16" else quantize_kv(q, q_kind)
    if strided:
        rows = lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731
        qq = rows(qq) if q_kind == "bf16" else QTensor(rows(qq.values), qq.scales, q_kind)
    kq, vq = quantize_kv(k, kv_mode), quantize_kv(v, kv_mode)
    check_flash_quant(qq, kq, vq, KernelConfig(**kw), i8c, (variant, kw))


def check_flash_quant(qq, kq, vq, cfg, i8c, what):
    """K10 once on (qq, kq, vq) by the rule of the test above."""
    before = _build.launch_counts[FLASH_QUANT]
    out = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c)
    torch.cuda.synchronize()
    assert _build.launch_counts[FLASH_QUANT] == before + 1
    q_vals = qq.values if isinstance(qq, QTensor) else qq
    assert out.dtype == torch.bfloat16 and out.stride() == q_vals.stride()
    native = flash_forward_quantized_plain(qq, kq, vq, cfg, scale=128 ** -0.5,
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


@pytest.mark.parametrize("variant", list(QUANT_VARIANTS))
def test_flash_quant_kernel_is_deterministic(cuda, variant):
    kv_mode, q_kind, i8c = QUANT_VARIANTS[variant]
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, 1024, kv_heads=2, seed=14))
    qq = q if q_kind == "bf16" else quantize_kv(q, q_kind)
    kq, vq = quantize_kv(k, kv_mode), quantize_kv(v, kv_mode)
    for cfg in (KernelConfig(), KernelConfig(causal=True)):
        first = flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c)
        assert torch.equal(first, flash_forward_quantized(qq, kq, vq, cfg, int8_compute=i8c))


def _sass_by_function(source):
    """{kernel symbol: its SASS} of the built library of ``source``."""
    path = _build.load(source)._name
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


def test_attention_kernels_run_on_wgmma(cuda):
    """K11 and K10's upcast kernels issue bf16 wgmma (HGMMA), K10's int8
    compute kernel int8 wgmma (IGMMA); none keeps an mma.sync (HMMA/IMMA)."""
    fori = _sass_by_function(SOURCE_FORI)
    assert len([n for n in fori if "flash_forward_fori_kernel" in n]) == MAX_KV_BUFFERS
    quant = _sass_by_function(SOURCE_QUANT)
    assert len([n for n in quant if "flash_quant_kernel" in n]) == 9
    for name, sass in {**fori, **quant}.items():
        want = "IGMMA" if "flash_quant_i8_kernel" in name else "HGMMA"
        assert want in sass, name
        assert "HMMA" not in sass and "IMMA" not in sass, name
    assert any("flash_quant_i8_kernel" in n for n in quant)


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
       for m in (1, 16, 100)])


@pytest.mark.parametrize(
    "mode,act_quant,k,n,m", QMM_CASES,
    ids=[f"{QMM[(mo, a)]}-{k}x{n}-m{m}" for mo, a, k, n, m in QMM_CASES])
def test_quant_matmul_kernels_match_plain(cuda, mode, act_quant, k, n, m):
    """Ragged m, N and K (no tile multiple) and every Llama-3-8B weight
    shape of K6/K7 at decode and prefill rows; stored bytes over the whole
    int8 range, so -128 and int4 nibbles of -8 occur; small m splits the K
    walk. One launch count per call, and a second call gives the same bits."""
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


def _paged_pool(cuda, kv_heads, lengths, mode, seed, ps=16, num_pages=96):
    """A pool with shuffled pages and tables; slots no sequence owns hold
    NaN (dense) or the e4m3 NaN byte (fp8). Returns (k, v, keyword
    arguments for the page format)."""
    rng = np.random.default_rng(seed)
    tables = torch.full((len(lengths), 40), -1, dtype=torch.int32, device=cuda)
    owned = torch.zeros(kv_heads, num_pages, ps, 128, dtype=torch.bool, device=cuda)
    perm, nxt = rng.permutation(num_pages), 0
    for b, n in enumerate(lengths):
        for i in range(-(-n // ps)):
            page = int(perm[nxt])
            nxt += 1
            tables[b, i] = page
            owned[:, page, :min(ps, n - i * ps)] = True
    gen = torch.Generator(device=cuda).manual_seed(seed)
    k, v = (torch.randn(kv_heads, num_pages, ps, 128, device=cuda, generator=gen)
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


@pytest.mark.parametrize("heads,kv_heads", [(8, 2), (4, 4), (32, 8)])
@pytest.mark.parametrize("t", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["dense", "int8", "fp8", "int4", "int8c"])
def test_paged_kernel_multi_token_and_int8c(cuda, mode, t, heads, kv_heads):
    """t query tokens (rows in blocks of up to 8 per CTA: 32 heads over 8
    KV heads at t = 8 is 4 blocks) and int8 compute, plain, with a window
    and with a softcap; lengths 0, below t (rows that see no token give
    zeros), t and long ones."""
    i8c = mode == "int8c"
    lengths = [0, 1, t, 37, 300, 611]
    kp, vp, tables, kw0 = _paged_pool(cuda, kv_heads, lengths, "int8" if i8c else mode,
                                      seed=10 + t)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    shape = (len(lengths), heads) + ((t,) if t > 1 else ()) + (128,)
    q = torch.randn(shape, device=cuda).bfloat16()
    kw0 = dict(kw0, scale=128 ** -0.5)
    name = kernel_name(t, i8c)
    for kw in (dict(), dict(window=100), dict(softcap=20.0)):
        before = _build.launch_counts[name]
        out = paged_decode_attention(q, kp, vp, lens, tables, int8_compute=i8c, **kw0, **kw)
        torch.cuda.synchronize()
        assert _build.launch_counts[name] == before + 1
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


def test_kernels_refuse_other_dtypes(cuda):
    q = torch.zeros((1, 2, 64, 128), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        flash_forward_with_lse(q, q, q, KernelConfig(dtype=DType.FP16))
    pages = torch.zeros((1, 2, 16, 128), device=cuda)
    with pytest.raises(ValueError):
        paged_decode_attention(torch.zeros((1, 2, 128), device=cuda), pages,
                               pages, torch.ones(1, dtype=torch.int32, device=cuda),
                               torch.zeros((1, 2), dtype=torch.int32, device=cuda))


def test_kernels_refuse_other_head_widths(cuda):
    """d 256 runs on the CPU (the plain versions); the kernels' tiles are
    128 wide, so their wrappers raise on the card."""
    q = torch.zeros((1, 2, 128, 256), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="128 wide"):
        flash_forward_with_lse(q, q, q, KernelConfig(d_head=256))
    with pytest.raises(ValueError, match="128 wide"):
        flash_backward(q, q, q, q, torch.zeros((1, 2, 128), device=cuda), q,
                       KernelConfig(d_head=256))
    kq = quantize_kv(q, "int8")
    with pytest.raises(ValueError, match="128 wide"):
        flash_forward_quantized(q, kq, kq, KernelConfig(d_head=256))
    pages = torch.zeros((2, 2, 16, 256), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="128 wide"):
        paged_decode_attention(q[:, :, 0], pages, pages,
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


def test_train_step_on_the_kernels(cuda, monkeypatch):
    from flash_attention_from_scratch_tpu_torch.ops import autodiff

    cfg = llama.LlamaConfig(vocab_size=256, dim=512, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_head=128, hidden_dim=512)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 257))).to(cuda)

    def grads():
        params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(1))
        train.make_optimizer(params)  # marks the leaves as requiring grad
        llama.loss_fn(params, tokens, cfg).backward()
        return [p.grad for p in train.param_leaves(params)]

    before = {n: _build.launch_counts[n] for n in (KERNEL_FUSED, KERNEL_DKV, KERNEL_DQ)}
    fused = grads()
    # Deterministic mode selects the split kernels; cuBLAS only warns.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        split = grads()
    finally:
        torch.use_deterministic_algorithms(False)
    assert [_build.launch_counts[n] - before[n] for n in before] == [cfg.n_layers] * 3
    monkeypatch.setattr(autodiff, "flash_backward",
                        lambda *args, **kw: flash_backward_plain(*args))
    plain = grads()
    for g, s, w in zip(fused, split, plain):
        for got in (g, s):
            assert bool(torch.isfinite(got).all())
            assert float((got.float() - w.float()).abs().max()) <= 1e-2 * float(
                w.float().abs().max())
    monkeypatch.undo()

    params = llama.init_params(cfg, torch.Generator(device=cuda).manual_seed(1))
    step = train.make_train_step(cfg, train.make_optimizer(params, lr=1e-3))
    before = {n: _build.launch_counts[n] for n in (FLASH, KERNEL_FUSED)}
    losses = [float(step(params, tokens)) for _ in range(3)]
    assert losses[-1] < losses[0], losses
    for n in (FLASH, KERNEL_FUSED):
        assert _build.launch_counts[n] == before[n] + 3 * cfg.n_layers
