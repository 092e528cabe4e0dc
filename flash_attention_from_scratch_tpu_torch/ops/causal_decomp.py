"""Row-band causal attention: one K1 call a band of Q rows, concatenated.

Counterpart of ``flash_attention_from_scratch_tpu/ops/causal_decomp.py``.
Band i (rows [i * L, (i + 1) * L) of n bands) sees exactly the KV prefix up
to its last row, so it is one offset-causal call over that prefix, clipped
from below by a sliding window; with a caller's ``q_offset`` (a chunk of a
longer prompt) every band's diagonal shifts by it. Each band's rows are
complete, so the outputs and the LSEs concatenate with no merge, and each
band's LSE is the full problem's for its rows: the backward runs the
standard kernels on the whole problem (``ops/autodiff.py``).

The TPU's reason for banding, a whole-KV single-shot program a band, does
not carry over: K1 is persistent and skips the tiles above the diagonal
itself. The dispatch is ported for its function (a JAX config with
``decompose=True`` runs here) and timed on the card against one K1 call
(``chip_smoke.py::banded_case``); nothing selects it by default.
"""

from __future__ import annotations

import dataclasses

import torch

from .configs import KernelConfig

__all__ = ["causal_forward_banded", "band_count", "band_slices"]


def band_count(seq: int, band_rows: int = 512) -> int:
    """Bands of about ``band_rows`` rows: seq // band_rows, at least 1,
    lowered until it divides ``seq``.

    The JAX package caps the count at 32, which widens the bands past seq
    16,384 (1,024 rows at 32,768). The port has no cap: it equals JAX's
    count up to seq 16,384 and exceeds 32 above it.
    """
    n = max(1, seq // band_rows)
    while seq % n:
        n -= 1
    return n


def band_slices(seq: int, q_offset: int, window: int, n: int) -> list[tuple[int, int]]:
    """(first row, KV slice start) of each of ``n`` bands of ``seq // n``
    rows: band i sees the keys [start, q_offset + (i + 1) * rows), the start
    moved down from the window's lower edge for its first row so that the
    slice's width is a multiple of 128, as in JAX (0 without a window)."""
    rows = seq // n
    out = []
    for i in range(n):
        width_end = q_offset + (i + 1) * rows
        kv_start = 0
        if window:
            lo = max(0, q_offset + i * rows - window + 1)
            kv_start = max(0, width_end - -(-(width_end - lo) // 128) * 128)
        out.append((i * rows, kv_start))
    return out


def _band_hints(cfg: KernelConfig, rows: int, width: int, band_rules):
    """The JAX package's per-band TPU knobs (block_q, block_kv, kv_splits,
    head_pack, q_splits) for a band of ``rows`` rows over ``width`` keys:
    hints K1 ignores, computed as JAX computes them. Where JAX's block_kv
    walk reaches 0 (a width past the S-tile budget that is not a multiple
    of 128), raises ``ValueError``."""
    bq = min(cfg.block_q, rows)
    while rows % bq:
        bq //= 2
    bkv = min(width, max(KernelConfig.S_TILE_BUDGET_BYTES // (4 * bq), 128))
    while width % bkv:
        bkv -= 128
        if bkv <= 0:
            raise ValueError(
                f"a band's KV slice of {width} keys has no 128-key block under the "
                "S-tile budget: q_offset must be a multiple of 128 at this length")
    if band_rules is not None:
        sp_t, hp_t = band_rules(bkv)
    elif bkv > 8192:
        sp_t, hp_t = 4, 2
    elif bkv >= 4096:
        sp_t, hp_t = 2, cfg.head_pack
    else:
        sp_t, hp_t = cfg.kv_splits, cfg.head_pack
    sp = max(cfg.kv_splits, sp_t)
    while sp > 1 and bkv % (sp * 128):
        sp //= 2
    qs = cfg.q_splits if bq % (cfg.q_splits * cfg.dtype.min_tile[0]) == 0 else 1
    return dict(block_q=bq, block_kv=bkv, kv_splits=sp,
                head_pack=max(1, min(cfg.head_pack, hp_t)), q_splits=qs)


def causal_forward_banded(q, k, v, cfg: KernelConfig, *, scale: float | None = None,
                          bands: int | None = None, band_rules=None):
    """(out, lse) of causal attention by row bands, each one K1 call
    (``flash_forward_with_lse``) over its clipped KV slice.

    Covers plain causal, sliding windows (band i's slice starts at the
    window's lower edge for its first row, moved down so that the slice's
    width is a multiple of 128, as in JAX), softcaps and a caller's
    ``q_offset``: each band runs with ``q_offset`` re-aligned to its slice
    start. ``bands`` defaults to :func:`band_count` of seq_q. The band's
    TPU knobs (block sizes, ``kv_splits``, ``head_pack``; ``band_rules``
    maps a band's KV width to (kv_splits, head_pack) targets) are computed
    as in JAX and passed on as hints.

    Raises ``ValueError`` without causal masking, unless seq_kv equals
    q_offset + seq_q, unless the bands divide seq_q into rows K1 takes (a
    multiple of 64: never padded), and where JAX's block walk divides by
    zero. ``scale`` overrides ``cfg.scale``.
    """
    from .flash_forward import SEQ_QUANTUM, flash_forward_with_lse

    if not cfg.causal:
        raise ValueError("causal_forward_banded requires causal masking")
    base = cfg.q_offset
    seq = q.shape[2]
    if k.shape[2] != seq + base:
        raise ValueError(
            "banding assumes (chunked) self-attention: seq_kv must equal "
            f"q_offset + seq_q, got {k.shape[2]} != {base} + {seq}")
    n = bands if bands is not None else band_count(seq)
    if n < 1 or seq % n or (seq // n) % SEQ_QUANTUM:
        raise ValueError(
            f"{n} bands do not split seq_q {seq} into rows that are a multiple of "
            f"{SEQ_QUANTUM} (the K1 tile)")
    rows = seq // n
    outs, lses = [], []
    for row0, kv_start in band_slices(seq, base, cfg.window, n):
        width_end = base + row0 + rows
        band_cfg = dataclasses.replace(
            cfg, q_offset=base + row0 - kv_start, decompose=False,
            **_band_hints(cfg, rows, width_end - kv_start, band_rules))
        o, lse = flash_forward_with_lse(
            q[:, :, row0:row0 + rows], k[:, :, kv_start:width_end],
            v[:, :, kv_start:width_end], band_cfg, scale=scale)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)
