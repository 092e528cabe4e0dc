"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: they skip without a card, decided inside the ``cuda``
fixture. On a machine with one (which need not have JAX, so skip the
repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: the adaptive tolerance rule against the plain version in bf16
(native) and in fp32 on the same bf16-rounded inputs, held in each
(batch, head, 64-row band) of a flash output or gradient and each sequence
of a paged one on its own; the LSE within 1e-3. The quantized matmuls: the
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

import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu_torch.models import llama, train
from flash_attention_from_scratch_tpu_torch.ops import _build
from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
    KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED, flash_backward, flash_backward_plain,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
    KERNEL as FLASH, flash_forward_plain, flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
    KERNEL as PAGED, paged_decode_attention, paged_decode_attention_plain,
)
from flash_attention_from_scratch_tpu_torch.ops.quant import quantize_kv_pages
from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import (
    KERNELS as QMM, QuantizedWeight, quant_matmul, quant_matmul_plain,
)
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


@pytest.mark.parametrize("sq,kw", [
    (256, dict()), (128, dict()), (256, dict(causal=True)),
    (256, dict(causal=True, window=100)), (128, dict(causal=True, q_offset=128)),
    (128, dict(causal=True, q_offset=128, window=70)),
    (256, dict(causal=True, attn_softcap=30.0))])
def test_flash_kernel_matches_plain(cuda, sq, kw):
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in
               make_qkv(2, 8, sq, kv_heads=2, seq_kv=256, seed=1))
    sinks = torch.linspace(-2, 2, 8, device=cuda)
    cfg = KernelConfig(**kw)
    before = _build.launch_counts[FLASH]
    out, lse = flash_forward_with_lse(q, k, v, cfg, sinks=sinks)
    torch.cuda.synchronize()
    assert _build.launch_counts[FLASH] == before + 1
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


@pytest.mark.parametrize("m", [1, 16, 100])
@pytest.mark.parametrize("k,n", [(512, 320), (544, 336)])
@pytest.mark.parametrize("mode,act_quant", [("int8", False), ("int4", False),
                                            ("int8", True), ("int4", True)],
                         ids=["K6", "K7", "K8", "K9"])
def test_quant_matmul_kernels_match_plain(cuda, mode, act_quant, k, n, m):
    """Ragged m, N and K (no tile multiple); stored bytes over the whole
    int8 range, so int4 nibbles of -8 occur; m 1 and 16 split the K walk."""
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


def test_kernels_refuse_other_dtypes(cuda):
    q = torch.zeros((1, 2, 64, 128), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        flash_forward_with_lse(q, q, q, KernelConfig(dtype=DType.FP16))
    pages = torch.zeros((1, 2, 16, 128), device=cuda)
    with pytest.raises(ValueError):
        paged_decode_attention(torch.zeros((1, 2, 128), device=cuda), pages,
                               pages, torch.ones(1, dtype=torch.int32, device=cuda),
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
