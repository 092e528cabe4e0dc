"""Flash-attention backward: the wrappers of the Hopper kernels K2 and K3.

Counterpart of ``flash_attention_from_scratch_tpu/ops/flash_backward.py``
``flash_backward``. For CUDA tensors the wrapper launches
``csrc/flash_backward.cu``: K2, the fused kernel (one shared recompute for
dQ, dK and dV; dQ summed by fp32 atomics), or K3, the split pair (a dK/dV
kernel and a dQ kernel, each summing in a fixed order), all on wgmma with
TMA copies, at head width 128 or 256; their launches are :func:`plan`. For
CPU tensors it runs the plain version, :func:`flash_backward_plain`. :func:`make_flash_backward`
and :func:`make_flash_backward_fused` bind K3 and K2 to one shape, as the
JAX package's ``make_*`` functions bind its ``pallas_call``s.
``flash_backward(..., bands=n)`` runs the row-band causal backward
(:func:`banded_backward`): K2 on each band's diagonal square and on its
past keys.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _build
from .configs import KernelConfig
from .flash_forward import (
    ALIGN_SLACK, D_HEAD, D_HEADS, MAX_GRID_YZ, SMEM_LIMIT, WG_ROWS, TilePlan, _default_cfg,
    _kernel_layout, _strides, _validate, tile_bytes, check_grid,
)

__all__ = ["flash_backward", "flash_backward_plain", "fused_choice", "plan",
           "make_flash_backward", "make_flash_backward_fused", "fused_backward_fits",
           "dkv_q_tiles", "banded_backward", "banded_calls", "KERNEL_FUSED",
           "KERNEL_DKV", "KERNEL_DQ"]

KERNEL_FUSED = "flash_backward_fused"
KERNEL_DKV = "flash_backward_dkv"
KERNEL_DQ = "flash_backward_dq"
# One library a head width: csrc/flash_backward_d256.cu builds
# flash_backward.cu's kernels at d 256 (BACKWARD_HD there).
SOURCES = {128: "flash_backward.cu", 256: "flash_backward_d256.cu"}
SOURCE = SOURCES[128]
# The fp16 libraries: each width's kernels built for fp16 (FA_F16).
SOURCES_F16 = {d: _build.typed_source(s, torch.float16, "K2/K3") for d, s in SOURCES.items()}
LOG2E = math.log2(math.e)

_I64, _I32, _F32, _PTR = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p

# The launches of csrc/flash_backward.cu per head width (its FUSED_TILE_*,
# DKV_TILE_* and DQ_TILE_*): a CTA is consumer warpgroups only (its thread 0
# issues the copies). (consumer warpgroups, ring slots) of the dK/dV
# kernel, for K2 and for K3's first half, over slots of 64 Q rows: at d 128
# a warpgroup owns 64 KV rows; at d 256 two warpgroups share 64 KV rows,
# each 128 of dK's and dV's columns. The dQ kernel (one warpgroup of 64 Q
# rows): its ring slots and keys a slot.
FUSED_TILE = {128: (2, 3), 256: (2, 1)}
DKV_TILE = {128: (1, 2), 256: (2, 2)}
DQ_SLOTS = {128: 1, 256: 2}
DQ_KEYS = {128: 128, 256: 64}
DKV_Q_ROWS = 64
SM_SMEM = 233472  # an SM's shared memory, 1 KB of it reserved per CTA


def per_sm(warpgroups: int, smem: int) -> int:
    """CTAs an SM holds (``per_sm`` in the source, its launch bound): two of
    one warpgroup where their shared memory fits, else one."""
    return 2 if warpgroups == 1 and 2 * (smem + 1024) <= SM_SMEM else 1


def _check_width(d_head: int) -> None:
    if d_head not in D_HEADS:
        raise ValueError(f"K2/K3's tiles are {' or '.join(map(str, D_HEADS))} wide, got "
                         f"d_head {d_head} (other widths: ROADMAP Queue 2, coverage item 1)")


def _dkv_plan(fused: bool, batch: int, kv_heads: int, seq_kv: int,
              d_head: int = D_HEAD) -> TilePlan:
    _check_width(d_head)
    nc, slots = (FUSED_TILE if fused else DKV_TILE)[d_head]
    split = d_head // D_HEAD  # warpgroups that share 64 KV rows
    bkv, bq = nc // split * WG_ROWS, DKV_Q_ROWS
    stats = 2 * bq * 4  # a slot's LSE and D rows, fp32
    # K2: dS^T buffers, one a warpgroup; a stage of 16 x 64 fp32 dQ a warp.
    ds = nc * (bkv * bq * 2 + 4 * 16 * 64 * 4) if fused else 0
    tiles = -(-seq_kv // bkv)
    return TilePlan(rows=bq, keys=bkv, slots=slots,
                    smem=(2 * tile_bytes(bkv, d_head)
                          + slots * (2 * tile_bytes(bq, d_head) + stats)
                          + ds + ALIGN_SLACK),
                    grid=(kv_heads, batch, tiles), kv_tiles=tiles, threads=nc * 128)


def _dq_plan(batch: int, heads: int, seq_q: int, seq_kv: int,
             d_head: int = D_HEAD) -> TilePlan:
    _check_width(d_head)
    slots, keys = DQ_SLOTS[d_head], DQ_KEYS[d_head]
    return TilePlan(rows=WG_ROWS, keys=keys, slots=slots,
                    smem=(2 * tile_bytes(WG_ROWS, d_head)
                          + slots * 2 * tile_bytes(keys, d_head) + ALIGN_SLACK),
                    grid=(seq_q // WG_ROWS, heads, batch), kv_tiles=-(-seq_kv // keys),
                    threads=128)


def plan(fused: bool, batch: int, heads: int, kv_heads: int, seq_q: int,
         seq_kv: int, d_head: int = D_HEAD) -> tuple:
    """The launches of one backward call at head width ``d_head`` (128 or
    256): K2's, or K3's dK/dV then dQ.

    A dK/dV launch (``DkvTile`` in the source) has a CTA per (``keys`` KV
    rows, KV head, batch), grid (kv_heads, batch, KV tiles), walking Q tiles
    of ``rows`` rows through a ring of ``slots`` slots (Q and dO bf16, their
    LSE and D fp32; K2 adds a dS^T buffer a warpgroup and a dQ stage a
    warp). The dQ launch
    (``DqTile``) has a CTA per (``rows`` Q rows, head, batch), grid (Q
    tiles, heads, batch), walking ``keys``-key K/V slots, as the forward's
    main loop. Other widths raise ValueError."""
    if fused:
        return (_dkv_plan(True, batch, kv_heads, seq_kv, d_head),)
    return (_dkv_plan(False, batch, kv_heads, seq_kv, d_head),
            _dq_plan(batch, heads, seq_q, seq_kv, d_head))


def dkv_q_tiles(cfg: KernelConfig, kv0: int, kv_end: int, bq: int,
                seq_q: int) -> range:
    """The Q tiles (``bq`` rows each) that the dK/dV walk of the CTA owning
    keys ``kv0 .. kv_end - 1`` visits (``dkv_q_tiles`` in the source): with
    the causal mask, from the first tile whose last row reaches ``kv0`` to
    the last whose first row lies within the window of ``kv_end - 1``."""
    first, last = 0, seq_q // bq - 1
    if cfg.causal:
        lo = kv0 - cfg.q_offset - (bq - 1)
        if lo > 0:
            first = -(-lo // bq)
        if cfg.window:
            hi = cfg.window + kv_end - 2 - cfg.q_offset
            last = -1 if hi < 0 else min(last, hi // bq)
    return range(first, last + 1)


def _validate_backward(cfg: KernelConfig, q, k, v, o, lse, do):
    _validate(cfg, q, k, v, None)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o/do must have q's shape {tuple(q.shape)}: "
                         f"{tuple(o.shape)}, {tuple(do.shape)}")
    if tuple(lse.shape) != tuple(q.shape[:3]) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {tuple(q.shape[:3])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    devices = {t.device for t in (q, k, v, o, lse, do)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def _row_sums(o, do):
    """D = rowsum(dO * O) in fp32, (batch, heads, seq_q) (O is cast inside
    the product, not copied first)."""
    return (do.float() * o).sum(-1)


def _visible(sq: int, skv: int, cfg: KernelConfig, device):
    """The causal (and window) mask, (sq, skv) bool: row i at position
    q_offset + i sees column j."""
    qpos = cfg.q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    keep = kpos <= qpos
    if cfg.window:
        keep &= qpos - kpos < cfg.window
    return keep


def flash_backward_plain(q, k, v, o, lse, do, cfg: KernelConfig | None = None,
                         *, scale: float | None = None):
    """The plain PyTorch version of the kernels: (dq, dk, dv).

    Repeats their arithmetic: P from the saved LSE in the exp2 domain, the
    causal/window mask, the softcap slope 1 - tanh^2, P and dS * scale
    rounded to the input dtype before their products, fp32 sums, the GQA
    group summed into dK/dV.
    """
    cfg = cfg or _default_cfg(q)
    do = do.to(q.dtype)
    return _plain_from_rows(q, k, v, lse, _row_sums(o, do), do, cfg,
                            cfg.softmax_scale if scale is None else scale)


def _plain_from_rows(q, k, v, lse, dsum, do, cfg: KernelConfig, scale: float):
    """:func:`flash_backward_plain` from D = rowsum(dO * O) in place of O."""
    dt = q.dtype
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    group = h // kvh
    dsum = dsum[..., None]
    k32 = k.float().repeat_interleave(group, dim=1)
    v32 = v.float().repeat_interleave(group, dim=1)
    q32, do32 = q.float(), do.float()
    s = q32 @ k32.transpose(-1, -2)
    lse2 = lse[..., None] * LOG2E
    slope = None
    if cfg.attn_softcap:
        th = torch.tanh(s * (scale / cfg.attn_softcap))
        p = torch.exp2(th * (cfg.attn_softcap * LOG2E) - lse2)
        slope = 1.0 - th * th
    else:
        p = torch.exp2(s * (scale * LOG2E) - lse2)
    if cfg.causal:
        p = torch.where(_visible(sq, skv, cfg, q.device), p, 0.0)
    ds = p * (do32 @ v32.transpose(-1, -2) - dsum)
    if slope is not None:
        ds = ds * slope
    ds = (ds * scale).to(dt).float()
    dv = p.to(dt).float().transpose(-1, -2) @ do32
    dk = ds.transpose(-1, -2) @ q32
    dq = ds @ k32

    def group_sum(x):
        return x.unflatten(1, (kvh, group)).sum(2)

    return dq.to(dt), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


@functools.lru_cache(maxsize=None)
def _lib(d_head: int, dtype: torch.dtype = torch.bfloat16) -> ctypes.CDLL:
    lib = _build.load(_build.typed_source(SOURCES[d_head], dtype, "K2/K3"))
    argtypes = [_PTR] * 9 + [_I64] * 12 + [_I32] * 8 + [_F32, _F32, _I32, _PTR]
    for fn in (lib.fa_flash_backward_fused, lib.fa_flash_backward_dkv,
               lib.fa_flash_backward_dq):
        fn.restype = _I32
        fn.argtypes = argtypes
    return lib


def _aligned(x):
    """x contiguous, starting on a 16-byte boundary (the kernels copy row
    statistics in 16-byte units)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q, k, v, lse, dsum, do, cfg: KernelConfig, scale: float,
            fused: bool, part: str | None = None):
    """Launch K2, or K3's two kernels; ``part`` (K3 only) launches one of
    them: ``KERNEL_DQ`` returns dq, ``KERNEL_DKV`` (dk, dv). The library
    is q's type's (bf16, fp16; ValueError for any other)."""
    _check_width(q.shape[3])
    lib = _lib(q.shape[3], q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout(t):
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned "
                             f"d_head axis; strides {t.stride()}")
    if not _kernel_layout(do):  # autograd may hand over an expanded cotangent
        do = do.contiguous()
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    for launch in plan(fused, b, h, kvh, sq, skv, d):
        check_grid(launch)
    lse, dsum = _aligned(lse), _aligned(dsum)
    dk = torch.empty((b, kvh, skv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def call(fn, name, dq_buf, dk_buf, dv_buf):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dsum.data_ptr(), dq_buf, dk_buf, dv_buf,
                *_strides(q), *_strides(k), *_strides(v), *_strides(do),
                b, h, kvh, sq, skv, int(cfg.causal), cfg.q_offset, cfg.window,
                float(scale), float(cfg.attn_softcap), d, stream)
        _build.check(lib, rc, name)
        _build.launch_counts[name] += 1

    if fused:
        dq_acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
        call(lib.fa_flash_backward_fused, KERNEL_FUSED, dq_acc.data_ptr(),
             dk.data_ptr(), dv.data_ptr())
        return dq_acc.to(q.dtype), dk, dv
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if part != KERNEL_DQ:
        call(lib.fa_flash_backward_dkv, KERNEL_DKV, None, dk.data_ptr(), dv.data_ptr())
    if part != KERNEL_DKV:
        call(lib.fa_flash_backward_dq, KERNEL_DQ, dq.data_ptr(), None, None)
    return {None: (dq, dk, dv), KERNEL_DQ: dq, KERNEL_DKV: (dk, dv)}[part]


def fused_choice(fused: bool | None = None, causal: bool = True) -> bool:
    """Whether :func:`flash_backward` runs K2: ``fused`` when given; else
    K3 while PyTorch's deterministic mode is on
    (``torch.use_deterministic_algorithms``: K3's sums have a fixed order,
    K2 adds dQ in no fixed order), and otherwise the faster of the two: on
    an H100 (``chip_smoke.py::time_backward``: b 2, 32/8 heads, d 128,
    bf16) K3 with the causal mask (s 1024, 2048, the training run's, and
    4096), K2 without it (s 2048). At d 256 (``time_backward_d256``: b 1,
    16/8 heads, s 8192, causal) the two are within 5-12% of each other, K2
    ahead with softcap 50 and K3 without one, so the rule is the same at
    both widths.
    """
    if fused is not None:
        return fused
    return not causal and not torch.are_deterministic_algorithms_enabled()


def flash_backward(q, k, v, o, lse, do, cfg: KernelConfig | None = None, *,
                   scale: float | None = None, fused: bool | None = None,
                   bands: int | None = None):
    """Gradients (dq, dk, dv) of ``flash_forward`` from the saved (O, LSE).

    q, o, do (batch, heads, seq_q, d); k, v (batch, kv_heads, seq_kv, d);
    ``lse`` (batch, heads, seq_q) fp32 from :func:`flash_forward_with_lse`.
    ``do`` is cast to q's dtype. ``scale`` defaults to the config's softmax
    scale.

    ``fused=True`` runs K2, which shares one recompute between dQ, dK and
    dV and adds dQ by fp32 atomics, so dQ's summation order changes from
    run to run. ``fused=False`` runs K3, the split dK/dV and dQ kernels,
    whose sums have a fixed order; it is the default with the causal mask,
    where it is the faster on the card, and in PyTorch's deterministic mode
    (:func:`fused_choice`). The TPU's rule for choosing
    (``fused_backward_fits``: whole-sequence dK/dV scratch in VMEM) does
    not apply on Hopper, where each CTA keeps dK/dV for its own 64 or 128
    KV rows only.

    ``bands=n`` (explicit only) runs the row-band causal backward,
    :func:`banded_backward`, where the JAX package's guard holds: n > 1, a
    causal config without a window or ``q_offset``, seq_q == seq_kv,
    ``fused`` not False and K2's launch fitting past keys of seq - seq / n
    rows (:func:`fused_backward_fits`). Every other call runs K2 or K3 as
    without ``bands``. ``ValueError`` unless n >= 1 divides seq_q (the JAX
    package does not check, and drops the last rows' gradients).
    ``flash_attention`` and the ``decompose`` configs never band the
    backward, as in the JAX package.
    """
    if bands is not None and (bands < 1 or q.shape[2] % bands):
        raise ValueError(f"bands {bands} must be at least 1 and divide seq_q "
                         f"{q.shape[2]}")
    cfg = cfg or _default_cfg(q)
    _validate_backward(cfg, q, k, v, o, lse, do)
    scale = cfg.softmax_scale if scale is None else scale
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    seq = q.shape[2]
    if (bands is not None and bands > 1 and cfg.causal and not cfg.window
            and not cfg.q_offset and seq == k.shape[2] and fused is not False
            and fused_backward_fits(seq - seq // bands, q.shape[3])):
        return banded_backward(q, k, v, o, lse, do, cfg, scale, bands)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, do, cfg, scale=scale)
    do = do.to(q.dtype)
    return _launch(q, k, v, lse, _row_sums(o, do), do, cfg, scale,
                   fused=fused_choice(fused, cfg.causal))


def _bwd_band_count(seq: int, band_rows: int = 1024) -> int:
    """Row bands for the banded backward, as the JAX package's
    ``_bwd_band_count``: seq // band_rows, within 1 and 16, lowered until
    it divides ``seq``."""
    n = max(1, min(16, seq // band_rows))
    while seq % n:
        n -= 1
    return n


def banded_calls(seq: int, bands: int) -> list[tuple[int, int, int, bool]]:
    """The K2 calls of :func:`banded_backward` over ``seq`` rows in
    ``bands`` bands of r = seq / bands rows, in order: (first Q row, first
    key, key end, causal) each. Band i runs its diagonal square (keys i r
    to (i + 1) r, causal) and, for i > 0, its past keys (0 to i r, not
    causal): 2 bands - 1 calls."""
    rows = seq // bands
    calls = []
    for i in range(bands):
        calls.append((i * rows, i * rows, (i + 1) * rows, True))
        if i:
            calls.append((i * rows, 0, i * rows, False))
    return calls


def _fused_call(q, k, v, lse, dsum, do, cfg: KernelConfig, scale: float):
    """One K2 launch (its plain version for CPU tensors) from D = rowsum(dO
    * O): (dq, dk, dv) in the inputs' dtype."""
    if q.device.type == "cpu":
        return _plain_from_rows(q, k, v, lse, dsum, do, cfg, scale)
    return _launch(q, k, v, lse, dsum, do, cfg, scale, fused=True)


def banded_backward(q, k, v, o, lse, do, cfg: KernelConfig, scale: float, bands: int):
    """The row-band causal backward (counterpart of the JAX package's
    ``_cached_banded_backward``): :func:`banded_calls`' K2 calls.

    Each call takes its rows' global LSE and D = rowsum(dO * O), computed
    once for the whole call, so its recomputed P is the true softmax weight
    of its (rows, keys) rectangle, and the parts add up to the monolithic
    backward. dK and dV add up in fp32 over the bands; a band's two dQ
    parts are summed in fp32, then cast. The TPU measured it slower than
    the monolithic kernel and kept it for measuring on other chips
    (``chip_smoke.py::time_banded_backward`` times it on the card). On
    validated inputs (:func:`flash_backward`)."""
    b, h, seq, d = q.shape
    rows = seq // bands
    diag = dataclasses.replace(cfg, q_offset=0, decompose=False)
    rect = dataclasses.replace(cfg, causal=False, q_offset=0, window=0, decompose=False)
    do = do.to(q.dtype)
    dsum = _row_sums(o, do)
    dq = torch.empty((b, h, seq, d), dtype=q.dtype, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq_band = None
    for row0, kv0, kv_end, causal in banded_calls(seq, bands):
        sl, keys = slice(row0, row0 + rows), slice(kv0, kv_end)
        dq_p, dk_p, dv_p = _fused_call(q[:, :, sl], k[:, :, keys], v[:, :, keys],
                                       lse[:, :, sl], dsum[:, :, sl], do[:, :, sl],
                                       diag if causal else rect, scale)
        dk[:, :, keys] += dk_p
        dv[:, :, keys] += dv_p
        if causal:  # a band's first call
            dq_band = dq_p.float()
        else:
            dq_band += dq_p
        if kv0 == 0:  # a band's last call: its prefix, or band 0's square
            dq[:, :, sl] = dq_band.to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def fused_backward_fits(seq_kv: int, d_head: int, vmem_limit_mb: int = 64) -> bool:
    """Whether K2 runs a backward over ``seq_kv`` keys of width ``d_head``.

    The JAX package answers for its fused kernel's whole-sequence dK/dV
    scratch in VMEM. The port's K2 keeps dK/dV for its own 128 (d 128) or
    64 (d 256) KV rows a CTA, so the answer is its launch's (:func:`plan`
    at ``d_head``): a width it has tiles for (128 or 256), the CTA's shared
    memory within the SM's limit (for any ``seq_kv``) and the KV tiles
    within the grid's limit. ``vmem_limit_mb`` (a TPU figure) is accepted
    and ignored.
    """
    del vmem_limit_mb
    if d_head not in FUSED_TILE:
        return False
    launch = _dkv_plan(True, 1, 1, seq_kv, d_head)
    return launch.smem <= SMEM_LIMIT and launch.kv_tiles <= MAX_GRID_YZ


def _rows(lse, batch: int, heads: int, seq_q: int):
    """An LSE or D row statistic as (batch, heads, seq_q): the JAX
    ``make_*`` functions take it as (batch, heads, 1, seq_q)."""
    return lse.reshape(batch, heads, seq_q)


def _bound_checker(cfg, batch, heads, seq_q, seq_kv, kv_heads, device):
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    kv_heads = kv_heads or heads
    q_shape = (batch, heads, seq_q, cfg.d_head)
    kv_shape = (batch, kv_heads, seq_kv, cfg.d_head)

    def check(q, k, v, do, lse, dsum):
        got = tuple(tuple(t.shape) for t in (q, k, v, do))
        if got != (q_shape, kv_shape, kv_shape, q_shape):
            raise ValueError(f"bound to q/do {q_shape} and k/v {kv_shape}, got {got}")
        if q.device.type != dev.type:
            raise ValueError(f"bound to {dev}, got tensors on {q.device}")
        lse, dsum = (_rows(x, batch, heads, seq_q).float() for x in (lse, dsum))
        _validate_backward(cfg, q, k, v, q, lse, do)
        return lse, dsum, do.to(q.dtype)

    return check


def make_flash_backward(cfg: KernelConfig, batch: int, heads: int, seq_q: int,
                        seq_kv: int, kv_heads: int | None = None,
                        scale: float | None = None, interpret: bool | None = None,
                        block_q: int | None = None, block_kv: int | None = None,
                        splits: int | None = None, *, device="cuda"):
    """(dq_call, dkv_call) bound to K3's two kernels for one shape, shaped
    like the JAX package's: ``dq_call(q, k, v, do, lse, dsum) -> dq``
    and ``dkv_call(q, k, v, do, lse, dsum) -> (dk, dv)``, with ``lse`` and
    ``dsum`` = rowsum(dO * O) fp32 (batch, heads, seq_q) or the JAX
    functions' (batch, heads, 1, seq_q). Each call is one kernel launch on
    ``device`` (the card by default; the plain version on the CPU).
    ``interpret``, ``block_q``, ``block_kv`` and ``splits`` (TPU tiling)
    are accepted and ignored: the launch is :func:`plan`'s."""
    del interpret, block_q, block_kv, splits
    scale = cfg.softmax_scale if scale is None else scale
    check = _bound_checker(cfg, batch, heads, seq_q, seq_kv, kv_heads, device)

    def dq_call(q, k, v, do, lse, dsum):
        lse, dsum, do = check(q, k, v, do, lse, dsum)
        if q.device.type == "cpu":
            return _plain_from_rows(q, k, v, lse, dsum, do, cfg, scale)[0]
        return _launch(q, k, v, lse, dsum, do, cfg, scale, fused=False, part=KERNEL_DQ)

    def dkv_call(q, k, v, do, lse, dsum):
        lse, dsum, do = check(q, k, v, do, lse, dsum)
        if q.device.type == "cpu":
            return _plain_from_rows(q, k, v, lse, dsum, do, cfg, scale)[1:]
        return _launch(q, k, v, lse, dsum, do, cfg, scale, fused=False, part=KERNEL_DKV)

    return dq_call, dkv_call


def make_flash_backward_fused(cfg: KernelConfig, batch: int, heads: int,
                              seq_q: int, seq_kv: int, kv_heads: int | None = None,
                              scale: float | None = None, interpret: bool | None = None,
                              block_q: int | None = None, block_kv: int | None = None,
                              splits: int | None = None, *, device="cuda"):
    """``call(q, k, v, do, lse, dsum) -> (dq, dk, dv)`` bound to K2 for one
    shape (one launch), as :func:`make_flash_backward` binds K3."""
    del interpret, block_q, block_kv, splits
    scale = cfg.softmax_scale if scale is None else scale
    check = _bound_checker(cfg, batch, heads, seq_q, seq_kv, kv_heads, device)

    def call(q, k, v, do, lse, dsum):
        lse, dsum, do = check(q, k, v, do, lse, dsum)
        if q.device.type == "cpu":
            return _plain_from_rows(q, k, v, lse, dsum, do, cfg, scale)
        return _launch(q, k, v, lse, dsum, do, cfg, scale, fused=True)

    return call
