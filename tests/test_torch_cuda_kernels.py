"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: they skip without a card, decided inside the ``cuda``
fixture. On a machine with one (which need not have JAX, so skip the
repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: the adaptive tolerance rule against the plain version in bf16
(native) and in fp32 on the same bf16-rounded inputs, held in each
(batch, head, 64-row band) of a flash output and each sequence of a paged
one on its own; the LSE within 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu_torch.ops import _build
from flash_attention_from_scratch_tpu_torch.ops.configs import DType, KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import (
    KERNEL as FLASH, flash_forward_plain, flash_forward_with_lse,
)
from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
    KERNEL as PAGED, paged_decode_attention, paged_decode_attention_plain,
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


def test_kernels_refuse_other_dtypes(cuda):
    q = torch.zeros((1, 2, 64, 128), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        flash_forward_with_lse(q, q, q, KernelConfig(dtype=DType.FP16))
    pages = torch.zeros((1, 2, 16, 128), device=cuda)
    with pytest.raises(ValueError):
        paged_decode_attention(torch.zeros((1, 2, 128), device=cuda), pages,
                               pages, torch.ones(1, dtype=torch.int32, device=cuda),
                               torch.zeros((1, 2), dtype=torch.int32, device=cuda))
