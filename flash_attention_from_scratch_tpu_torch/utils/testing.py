"""Test fixtures and error metrics.

Counterpart of ``flash_attention_from_scratch_tpu/utils/testing.py``:
mismatch statistics and the adaptive tolerance rule. Inputs come from numpy
with a seed (:func:`make_qkv`), so the same arrays can be handed to both
packages; the JAX package's ``generate_qkv`` draws from ``jax.random``,
which torch cannot reproduce: the port's :func:`generate_qkv` draws the
same distribution from a ``torch.Generator``, on the card by default.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .device import resolve_device

__all__ = ["BATCH_SIZE_FOR_SEQ_LEN", "BENCHMARK_N_HEADS", "ErrorStats",
           "error_stats", "adaptive_tolerance_check", "sliced_tolerance_check",
           "fp32_tolerance_check",
           "row_bands", "make_qkv", "generate_qkv"]

# The benchmark shapes of the JAX package's bench tools: batch shrinks as seq
# grows so the total work stays bounded.
BATCH_SIZE_FOR_SEQ_LEN = {512: 16, 1024: 16, 2048: 16, 4096: 16, 8192: 8, 16384: 4}
BENCHMARK_N_HEADS = 16


@dataclasses.dataclass
class ErrorStats:
    n_mismatch: int
    pct_mismatch: float
    max_abs_diff: float
    mean_abs_diff: float

    def __str__(self) -> str:
        return (
            f"mismatches={self.n_mismatch} ({self.pct_mismatch:.4f}%) "
            f"max|diff|={self.max_abs_diff:.3e} mean|diff|={self.mean_abs_diff:.3e}"
        )


def error_stats(out, ref, atol: float = 1e-5, rtol: float = 1e-3) -> ErrorStats:
    """Mismatch count/%, max and mean abs diff."""
    out = torch.as_tensor(out).float()
    ref = torch.as_tensor(ref).float().to(out.device)
    close = torch.isclose(out, ref, atol=atol, rtol=rtol)
    n_bad = int((~close).sum())
    diff = (out - ref).abs()
    return ErrorStats(
        n_mismatch=n_bad,
        pct_mismatch=100.0 * n_bad / out.numel(),
        max_abs_diff=float(diff.max()),
        mean_abs_diff=float(diff.mean()),
    )


def adaptive_tolerance_check(out, ref_native, ref_fp32, factor: float = 2.0):
    """The flash-attention acceptance rule.

    The kernel's max abs error vs the native-dtype reference must be at most
    ``factor`` x the native-vs-fp32 reference error, floored at ``factor``
    ulps of the output's magnitude and, for exact-dtype runs, at the fp32
    summation-order error ``factor * eps32 * max|ref| * sqrt(L)``.

    Returns (ok, kernel_err, baseline_err).
    """
    out32 = out.float()
    native32 = ref_native.float().to(out32.device)
    fp32 = ref_fp32.float().to(out32.device)
    kernel_err = float((out32 - native32).abs().max())
    baseline_err = float((native32 - fp32).abs().max())
    eps = torch.finfo(ref_native.dtype).eps
    eps32 = torch.finfo(torch.float32).eps
    ref_mag = float(fp32.abs().max())
    n_acc = out.shape[-2] if out.ndim >= 2 else 1
    ulp_floor = factor * eps * ref_mag
    order_floor = factor * eps32 * ref_mag * math.sqrt(n_acc)
    bound = max(factor * baseline_err, ulp_floor, order_floor, 1e-6)
    return kernel_err <= bound, kernel_err, baseline_err


def sliced_tolerance_check(out, ref_native, ref_fp32, lead: int,
                           factor: float = 2.0):
    """:func:`adaptive_tolerance_check` on each slice of the ``lead`` leading
    axes on its own.

    One bound over a whole tensor is set by its largest values: the ulp
    floor of a row that is a single V row (a length-1 sequence, causal row
    0) is far above the error a long row's small average may show. Slicing
    by sequence, or by (batch, head, row band), gives each part its own
    baseline and floor.

    Returns (ok, worst ratio of error to bound, index of the worst slice).
    """
    out32 = out.float()
    native32 = ref_native.float().to(out32.device)
    fp32 = ref_fp32.float().to(out32.device)

    def slice_max(x):
        return x.abs().reshape(*x.shape[:lead], -1).amax(-1)

    kernel_err = slice_max(out32 - native32)
    baseline_err = slice_max(native32 - fp32)
    ref_mag = slice_max(fp32)
    eps = torch.finfo(ref_native.dtype).eps
    eps32 = torch.finfo(torch.float32).eps
    n_acc = out.shape[-2] if out.ndim - lead >= 2 else 1
    bound = torch.stack([
        factor * baseline_err, factor * eps * ref_mag,
        factor * eps32 * math.sqrt(n_acc) * ref_mag,
        torch.full_like(ref_mag, 1e-6)]).amax(0)
    ratio = kernel_err / bound
    worst = tuple(int(i) for i in np.unravel_index(int(ratio.argmax()),
                                                     tuple(ratio.shape)))
    return bool((ratio <= 1).all()), float(ratio.max()), worst


def fp32_tolerance_check(out, plain, exact, lead: int, factor: float = 2.0):
    """:func:`sliced_tolerance_check` for an fp32 kernel: its error from the
    exact answer (``exact``, fp64, rounded to fp32) at most ``factor`` x
    the fp32 plain version's own error from it, floored at fp32's ulp and
    summation-order floors, in each slice of the ``lead`` leading axes.

    In fp32 the native and fp32 references are one computation, so the
    rule's baseline error is 0 and only its floors are left; in 64-row
    bands their ``sqrt(64)`` counts the band's rows, not the keys each row
    sums, and the exact answer itself comes near them, or past them at d
    256, against the plain version (``chip_smoke.py`` prints it). The
    higher-precision reference of an fp32 computation is fp64, as fp32 is
    of a 16-bit one.

    Returns (ok, worst ratio of error to bound, index of the worst slice).
    """
    return sliced_tolerance_check(out, exact.float(), plain, lead, factor)


def row_bands(x, band: int = 64):
    """(..., seq, d) -> (..., seq // band, band, d): attention rows in
    bands, for :func:`sliced_tolerance_check`."""
    return x.unflatten(-2, (-1, band))


def make_qkv(batch: int, heads: int, seq_q: int, d_head: int = 128, *,
             kv_heads: int | None = None, seq_kv: int | None = None,
             seed: int = 0):
    """Standard-normal Q (b, h, sq, d) and K, V (b, kv_heads, skv, d).

    float32 numpy arrays from ``np.random.default_rng(seed)``; cast them to
    the working dtype on each side.
    """
    rng = np.random.default_rng(seed)
    kv_heads = kv_heads or heads
    seq_kv = seq_kv or seq_q
    q = rng.standard_normal((batch, heads, seq_q, d_head), np.float32)
    k = rng.standard_normal((batch, kv_heads, seq_kv, d_head), np.float32)
    v = rng.standard_normal((batch, kv_heads, seq_kv, d_head), np.float32)
    return q, k, v


def generate_qkv(seq_len: int, d_head: int = 128, n_heads: int = BENCHMARK_N_HEADS,
                 batch: int | None = None, dtype=torch.bfloat16, seed: int = 0,
                 device="cuda"):
    """Standard-normal Q, K, V (batch, heads, seq, d_head) in ``dtype`` on
    ``device`` (the card by default; raises without one), drawn in fp32
    from a ``torch.Generator`` seeded with ``seed``. ``batch`` defaults to
    the benchmark table's (:data:`BATCH_SIZE_FOR_SEQ_LEN`, else 4), as in
    the JAX package; the draws are torch's, not ``jax.random``'s."""
    if batch is None:
        batch = BATCH_SIZE_FOR_SEQ_LEN.get(seq_len, 4)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, n_heads, seq_len, d_head)
    return tuple(torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).to(dtype)
                 for _ in range(3))
