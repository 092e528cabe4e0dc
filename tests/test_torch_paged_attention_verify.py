"""Multi-token q (speculative verify) and int8_compute in the port's
paged_decode_attention (plain path on the CPU) vs the JAX kernels.

The cases of ``tests/test_torch_paged_attention.py``'s second half, in a
file of their own so that the test runner can spread the JAX interpret-mode
calls over its workers; the pools, references and calls are that module's.
Multi-token: t query tokens per sequence on dense, int8, fp8 and int4
pages, against JAX K4 (``_full_kernel``) and K5 (``_loop_kernel``), by the
adaptive rule in each (sequence, token). int8_compute: against JAX K5,
which rounds P as the port does, by the same rule, and against JAX K4,
which rounds P differently, within the JAX test's own bounds and a bound on
the difference stated below.
"""

import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu_torch.utils.testing import (
    sliced_tolerance_check,
)
from tests.test_torch_paged_attention import (
    MT_KW, _bf16, _by_token, _jax_call, _mt_case, _mt_lengths, _port_call, _reference,
)


@pytest.mark.parametrize("variant", ["K4", "K5"])
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("mode", ["dense", "int8", "fp8", "int4"])
def test_multi_token_matches_jax(mode, t, variant, monkeypatch):
    """t query tokens per sequence with a window and a softcap: the sliced
    rule in each (sequence, token), the JAX kernel as the native reference
    and the JAX reference in fp32 (``q_offset = length - t``) on the values
    the kernel reads. The last token agrees with the single-token call
    within one bf16 ulp (the two sum in another order)."""
    q, pages, scales, lens, tables, vals, _ = _mt_case(mode, _mt_lengths(t), 8, 2, t, 41)
    out = _port_call(q, pages, scales, lens, tables, mode, **MT_KW)
    jax_out = _jax_call(variant, monkeypatch, q, pages, scales, lens, tables, mode,
                        **MT_KW)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all() and np.isfinite(jax_out).all()
    ref = _reference(_bf16(q), vals[0], vals[1], lens, tables, MT_KW)
    ok, ratio, where = sliced_tolerance_check(
        _by_token(out), _by_token(torch.from_numpy(jax_out).bfloat16()),
        _by_token(ref), lead=2)
    assert ok, (mode, t, variant, ratio, where)
    single = _port_call(np.ascontiguousarray(q[:, :, -1]), pages, scales, lens, tables,
                        mode, **MT_KW)
    torch.testing.assert_close(out[:, :, -1].float(), single.float(), rtol=2 ** -7,
                               atol=1e-6)
    zero = list(lens).index(0)
    assert float(out[zero].float().abs().max()) == 0.0


I8C_KW = {"plain": {}, "window_softcap": MT_KW}
I8C_HEADS = {"gqa4": (8, 2), "mha": (2, 2)}


def _i8c_case(t, heads):
    lengths = _mt_lengths(t) if t > 1 else (1, 17, 0, 60, 33)
    return _mt_case("int8", lengths, *I8C_HEADS[heads], t, 51)


@pytest.mark.parametrize("option", sorted(I8C_KW))
@pytest.mark.parametrize("heads", sorted(I8C_HEADS))
@pytest.mark.parametrize("t", [1, 4])
def test_int8_compute_matches_jax_loop_kernel(t, heads, option, monkeypatch):
    """int8_compute against JAX K5 (``_loop_kernel``), which rounds P once
    per page against the running max as the port's plain version does: the
    sliced rule in each (sequence, token) with the JAX int8-compute kernel
    as the native reference and the JAX reference in fp32 on the
    dequantized values."""
    kw = dict(I8C_KW[option], int8_compute=True)
    q, pages, scales, lens, tables, vals, _ = _i8c_case(t, heads)
    out = _port_call(q, pages, scales, lens, tables, "int8", **kw)
    jax_out = _jax_call("K5", monkeypatch, q, pages, scales, lens, tables, "int8", **kw)
    assert out.shape == q.shape and torch.isfinite(out).all()
    ref = _reference(_bf16(q), vals[0], vals[1], lens, tables, I8C_KW[option])
    ok, ratio, where = sliced_tolerance_check(
        _by_token(out), _by_token(torch.from_numpy(jax_out).bfloat16()),
        _by_token(ref), lead=2)
    assert ok, (t, heads, option, ratio, where)
    assert float(out[list(lens).index(0)].float().abs().max()) == 0.0


# |port - JAX K4| with int8_compute: K4 rounds each weight p * v_scale /
# v_max to a step of 1/127 once against the row's final max, the port
# rounds p to 1/127 per page against the running max. Each side moves a
# weight by at most half a step, so the outputs differ by at most one step's
# share of the V rows: (1/127) x max |V| = 0.0079 x ~4.5 for these
# standard-normal pools, 0.035; bounded here with that 0.035 and no more.
I8C_K4_BOUND = 0.035


@pytest.mark.parametrize("heads", sorted(I8C_HEADS))
@pytest.mark.parametrize("t", [1, 4])
def test_int8_compute_within_jax_full_kernel_bounds(t, heads, monkeypatch):
    """int8_compute against JAX K4 (``_full_kernel``), which rounds P
    differently (module docstring): within the JAX test's own bounds
    (tests/test_paged_attention.py: 0.09 of the fp32 reference on the
    unquantized values, 0.05 of the same call without int8_compute), and
    within ``I8C_K4_BOUND`` of JAX K4's output."""
    q, pages, scales, lens, tables, _, dense = _i8c_case(t, heads)
    out = _port_call(q, pages, scales, lens, tables, "int8", int8_compute=True).float()
    exact = _port_call(q, pages, scales, lens, tables, "int8").float()
    jax_out = _jax_call("K4", monkeypatch, q, pages, scales, lens, tables, "int8",
                        int8_compute=True)
    oracle = _reference(_bf16(q), dense[0], dense[1], lens, tables, {})
    assert float((out - oracle).abs().max()) < 0.09
    assert float((out - exact).abs().max()) < 0.05
    assert float((out - torch.from_numpy(jax_out)).abs().max()) <= I8C_K4_BOUND
