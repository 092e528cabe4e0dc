"""The plain split-and-merge version of K4/K5
(``paged_decode_attention_split_plain``, what the CUDA split kernel and its
merge compute) vs the unsplit plain version and the JAX kernels.

The same seeded, NaN-poisoned pools and queries as
``tests/test_torch_paged_attention.py`` (whose helpers this module uses) go
through the port with ``splits`` forced to 1, 2 and 8 (one page a split)
and the split count ``ops/paged_attention.py::plan`` gives on an H100 (132
SMs) for the shape (1 for these tables of at most 256 tokens),
and through the JAX package's kernels in interpret mode. Tolerance: the
adaptive tolerance rule in each sequence (each (sequence, token) with t
query tokens) with the fp32 reference from the JAX side (``reference_attention``
on the values the kernel reads), and as the native reference either the JAX
kernel in bf16 or the port's unsplit plain version in bf16. Cases: dense,
int8, fp8 and int4 pages; a window and a softcap; t = 1 and 4; a length-0
row; sequences shorter than one split (whose other splits see no page).
``int8_compute`` is held to the JAX ``_loop_kernel`` (K5), which rounds P
per page against the running max as the port does (within a split, against
the split's running max).
"""

import functools

import numpy as np
import pytest
import torch

import flash_attention_from_scratch_tpu.ops.paged_attention as jax_pa
from flash_attention_from_scratch_tpu_torch.ops.paged_attention import (
    MODES, MODE_INT8C, plan,
)
from flash_attention_from_scratch_tpu_torch.utils.testing import sliced_tolerance_check
from tests.test_torch_paged_attention import (
    D, MT_KW, PAGE, QCASES, QLENGTHS, _bf16, _by_token, _jax_call, _mt_case, _mt_lengths,
    _pool, _port_call, _quantized_inputs, _reference,
)

H100_SMS = 132
SPLITS = [1, 2, 8, "plan"]  # 8: one page a split on the 8-column tables


def _splits(choice, q, lens, tables, mode, i8c=False):
    """A forced split count, or ``plan``'s for the call's shape."""
    if choice != "plan":
        return choice
    heads, kv_heads = q.shape[1], 2
    t = q.shape[2] if q.ndim == 4 else 1
    mode_num = MODE_INT8C if i8c else MODES[mode][0]
    return plan(len(lens), kv_heads, heads // kv_heads * t, tables.shape[1], PAGE, mode_num,
                H100_SMS).splits


class _Patch:
    """``monkeypatch`` for a cached JAX call outside a test's fixture."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)


def _jax_cached(variant, *args, **kw):
    patch = _Patch()
    try:
        return _jax_call(variant, patch, *args, **kw)
    finally:
        patch.undo()
        jax_pa._build_decode_call.cache_clear()


@functools.lru_cache(maxsize=None)
def _single_token(mode, option):
    """t = 1 on the QLENGTHS pool (8 pages of 32 a sequence): (q, pages,
    scales, lens, tables, options, fp32 reference, JAX K4 output)."""
    if mode == "dense":
        k, v, lens, tables = _pool(2, QLENGTHS, seed=31)
        q = np.random.default_rng(32).standard_normal((len(QLENGTHS), 8, D)).astype(
            np.float32)
        kw = QCASES[option]
        ref = _reference(_bf16(q), _bf16(k), _bf16(v), lens, tables, kw)
        pages, scales = (k, v), (None, None)
    else:
        q, pages, scales, lens, tables, kw, ref = _quantized_inputs(mode, option)
    jax_out = _jax_cached("K4", q, pages, scales, lens, tables, mode, **kw)
    return q, pages, scales, lens, tables, kw, ref, jax_out


def _hold(out, native, ref, what, lead=1):
    ok, ratio, where = sliced_tolerance_check(out, native, ref, lead=lead)
    assert ok, (what, ratio, where)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("option", sorted(QCASES))
@pytest.mark.parametrize("mode", ["dense", "int8", "fp8", "int4"])
def test_split_plain_single_token(mode, option, splits):
    """t = 1, with a window or a softcap: the split version against the JAX
    kernel and against the unsplit plain version, zeros for the length-0
    row, finite everywhere (the NaN slots never reach a sum)."""
    q, pages, scales, lens, tables, kw, ref, jax_out = _single_token(mode, option)
    n = _splits(splits, q, lens, tables, mode)
    out = _port_call(q, pages, scales, lens, tables, mode, splits=n, **kw)
    unsplit = _port_call(q, pages, scales, lens, tables, mode, **kw)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    _hold(out, torch.from_numpy(jax_out).bfloat16(), ref, (mode, option, n, "jax"))
    _hold(out, unsplit, ref, (mode, option, n, "unsplit"))
    assert float(out[QLENGTHS.index(0)].float().abs().max()) == 0.0


@functools.lru_cache(maxsize=None)
def _multi_token(mode, t):
    """t query tokens on the short-table pool (2 pages of 32 a sequence)
    with a window and a softcap, and the JAX K4 output."""
    q, pages, scales, lens, tables, vals, _ = _mt_case(mode, _mt_lengths(t), 8, 2, t, 41)
    jax_out = _jax_cached("K4", q, pages, scales, lens, tables, mode, **MT_KW)
    ref = _reference(_bf16(q), vals[0], vals[1], lens, tables, MT_KW)
    return q, pages, scales, lens, tables, ref, jax_out


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("mode", ["dense", "int8", "fp8", "int4"])
def test_split_plain_multi_token(mode, t, splits):
    """t = 1 and 4 tokens with a window and a softcap, split page by page
    (a length-17 sequence has one page, so its second split sees none): by
    the rule in each (sequence, token) against the JAX kernel and the
    unsplit plain version."""
    q, pages, scales, lens, tables, ref, jax_out = _multi_token(mode, t)
    out = _port_call(q, pages, scales, lens, tables, mode, splits=splits, **MT_KW)
    unsplit = _port_call(q, pages, scales, lens, tables, mode, **MT_KW)
    assert out.shape == q.shape and torch.isfinite(out).all()
    _hold(_by_token(out), _by_token(torch.from_numpy(jax_out).bfloat16()), _by_token(ref),
          (mode, t, splits, "jax"), lead=2)
    _hold(_by_token(out), _by_token(unsplit), _by_token(ref), (mode, t, splits, "unsplit"),
          lead=2)
    assert float(out[list(lens).index(0)].float().abs().max()) == 0.0


@functools.lru_cache(maxsize=None)
def _int8_compute(t, option):
    """int8 pages and the JAX ``_loop_kernel``'s int8-compute output: t = 1
    on the QLENGTHS pool with a QCASES option, t = 4 on the short-table pool
    with a window and a softcap. Returns (q, pages, scales, lens, tables,
    options, fp32 reference on the dequantized values, JAX output)."""
    if t == 1:
        q, pages, scales, lens, tables, kw, ref = _quantized_inputs("int8", option)
    else:
        kw = MT_KW
        q, pages, scales, lens, tables, vals, _ = _mt_case("int8", _mt_lengths(t), 8, 2, t,
                                                           51)
        ref = _reference(_bf16(q), vals[0], vals[1], lens, tables, kw)
    jax_out = _jax_cached("K5", q, pages, scales, lens, tables, "int8", int8_compute=True,
                          **kw)
    return q, pages, scales, lens, tables, kw, ref, jax_out


def _check_int8_compute(t, option, splits):
    q, pages, scales, lens, tables, kw, ref, jax_out = _int8_compute(t, option)
    n = _splits(splits, q, lens, tables, "int8", i8c=True)
    out = _port_call(q, pages, scales, lens, tables, "int8", int8_compute=True, splits=n,
                     **kw)
    assert out.shape == q.shape and torch.isfinite(out).all()
    _hold(_by_token(out), _by_token(torch.from_numpy(jax_out).bfloat16()), _by_token(ref),
          (t, option, n), lead=2)
    assert float(out[list(lens).index(0)].float().abs().max()) == 0.0


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("option", sorted(QCASES))
def test_split_plain_int8_compute_matches_jax_loop_kernel(option, splits):
    """int8_compute, t = 1: each split rounds P per page against its own
    running max (never above the row's), then the merge rescales the
    splits' fp32 partials; held to the JAX ``_loop_kernel`` by the rule in
    each sequence, the fp32 reference the JAX reference on the dequantized
    values."""
    _check_int8_compute(1, option, splits)


@pytest.mark.parametrize("splits", [1, 2])
def test_split_plain_int8_compute_multi_token(splits):
    """int8_compute at t = 4 with a window and a softcap, one page a split
    at 2 (the plan's count for these two-column tables), by the rule in
    each (sequence, token) against the JAX ``_loop_kernel``."""
    _check_int8_compute(4, "window_softcap", splits)


def test_split_counts_past_the_columns_are_capped():
    """A forced count above the page-table columns gives one page a split,
    the same result as the plan's; 0 is the plan's; a negative count
    raises."""
    q, pages, scales, lens, tables, kw, ref, _ = _single_token("dense", "plain")
    many = _port_call(q, pages, scales, lens, tables, "dense", splits=100)
    per_page = _port_call(q, pages, scales, lens, tables, "dense", splits=tables.shape[1])
    assert torch.equal(many, per_page)
    with pytest.raises(ValueError, match="splits"):
        _port_call(q, pages, scales, lens, tables, "dense", splits=-1)
