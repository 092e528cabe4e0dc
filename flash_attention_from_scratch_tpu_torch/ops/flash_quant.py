"""Flash attention over quantized K/V: the wrapper of the Hopper kernel K10.

Counterpart of ``flash_attention_from_scratch_tpu/ops/flash_quant.py``
``flash_forward_quantized``: K and V are :class:`QTensor` s (int8, fp8-e4m3
or int4 packed along d, one fp32 scale per (batch, KV head)); Q is a dense
tensor in ``cfg.dtype`` or an int8 / fp8 :class:`QTensor`. The K scale (and
Q's) folds into the softmax scale and the V scale into the output
normalization, so no dequantized K/V is written. ``int8_compute`` runs both
products in int8 with P quantized at the constant 127 per group of
``I8_P_GROUP`` KV columns. For a CUDA tensor at head width 128 or 256 the
wrapper launches ``csrc/flash_quant.cu`` (on the wgmma + TMA main loop of
``csrc/flash_wgmma.cuh``; at d 256 the library
``csrc/flash_quant_d256.cu`` builds; its launch is :func:`plan`); for a CPU
tensor it runs the plain version, :func:`flash_forward_quantized_plain`,
which takes any head width that is a multiple of 128.

Two behaviours of the JAX kernel are refused instead of copied: it ignores
``cfg.q_offset`` (its causal mask is top-left aligned whatever the offset)
and its int8-compute path ignores ``attn_softcap``. Both raise here.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .configs import DType, KernelConfig
from .flash_forward import (
    ALIGN_SLACK, D_HEAD, D_HEADS, WG_ROWS, TilePlan, tile_bytes, check_grid,
)
from .quant import QTensor, unpack_int4
from .reference import MASK_VALUE, reference_attention

__all__ = ["flash_forward_quantized", "flash_forward_quantized_plain", "plan", "KERNEL",
           "SEQ_QUANTUM", "I8_P_GROUP", "D_HEADS", "QUANT_TILES"]

KERNEL = "flash_quant"
# One library a head width: csrc/flash_quant_d256.cu builds flash_quant.cu's
# kernels at d 256 (QUANT_HD there).
SOURCES = {128: "flash_quant.cu", 256: "flash_quant_d256.cu"}
SOURCE = SOURCES[128]
# The fp16 libraries: each width's kernels built for fp16 (FA_F16).
SOURCES_F16 = {d: _build.typed_source(s, torch.float16, "K10") for d, s in SOURCES.items()}
SEQ_QUANTUM = 128  # seq_q and seq_kv must be multiples (d 128's KV tile; the P group)
I8_P_GROUP = 128   # KV columns that share one P quantization max (int8_compute)
# The kernels' CTA and tiles per head width (``UpcastTile<QT, KV, HD>`` and
# ``I8Tile<HD>`` in csrc/flash_quant.cu): (consumer warpgroups of 64 Q rows,
# keys a tile of the upcast modes, int8_compute's K + V^T slots). d 128: two
# consumer warpgroups, 128-key tiles, 4 slots; d 256: one consumer
# warpgroup (its 64 x 256 fp32 O is 128 registers a thread), 64-key tiles,
# 2 slots. int8_compute's tiles are I8_P_GROUP keys at both widths.
QUANT_TILES = {128: (2, 128, 4), 256: (1, 64, 2)}
LOG2E = math.log2(math.e)

# The kernel's codes for Q's type and the K/V mode; the stored dtype of each.
_Q_TYPES = {"bf16": 0, "int8": 1, "fp8": 2}
_KV_MODES = {"int8": 1, "fp8": 2, "int4": 3}
_STORED = {"int8": torch.int8, "int4": torch.int8, "fp8": torch.float8_e4m3fn}

_I64, _I32, _F32, _PTR = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def _raw(x):
    """The stored values of a QTensor as fp32 (int4 unpacked along d), or a
    dense tensor as it is."""
    if not isinstance(x, QTensor):
        return x
    return unpack_int4(x.values) if x.mode == "int4" else x.values.float()


def _per_q_head(scales, heads: int):
    """(b, kv_heads) scales -> (b, heads): Q head h reads KV head h // group."""
    return scales.float().repeat_interleave(heads // scales.shape[1], dim=1)


def _attend_i8(q, k, v, c, v_scale, cfg: KernelConfig):
    """One batch element of the int8-compute path, as ``_attend_i8`` of the
    JAX kernel at block_kv = I8_P_GROUP computes it: q (h, sq, d), k/v
    (h, skv, d) integer-valued fp32; c and v_scale (h,) fp32.

    Integer products of int8 values sum exactly in fp32 here (|sum| <=
    127 * 127 * 256 < 2^24 at d 256; P V's 127 * 127 * 128 a group), as in
    the kernel's int32 accumulators.
    """
    s = torch.matmul(q, k.transpose(-1, -2))
    if cfg.causal:
        sq, skv = s.shape[-2:]
        ones = torch.ones((sq, skv), dtype=torch.bool, device=s.device)
        keep = torch.tril(ones)
        if cfg.window:
            keep &= ~torch.tril(ones, diagonal=-cfg.window)
        s = torch.where(keep, s, torch.full_like(s, MASK_VALUE))
    s = s.unflatten(-1, (-1, I8_P_GROUP))                   # (h, sq, G, 128)
    c4 = c[:, None, None, None]
    m = s.amax(-1, keepdim=True) * c4                        # the group max
    p = torch.round(torch.exp2(s * c4 - m) * 127.0)          # P_i8
    l = p.sum(-1)                                            # (h, sq, G)
    vg = v.unflatten(-2, (-1, I8_P_GROUP))                   # (h, G, 128, d)
    acc = torch.matmul(p.transpose(1, 2), vg).transpose(1, 2)  # (h, sq, G, d)
    w = torch.exp2(m - m.amax(-2, keepdim=True))             # (h, sq, G, 1)
    out = (acc * w).sum(-2) / (l[..., None] * w).sum(-2)
    return out * v_scale[:, None, None]


def flash_forward_quantized_plain(q, k: QTensor, v: QTensor, cfg: KernelConfig, *,
                                  scale: float, int8_compute: bool):
    """The plain PyTorch version of K10, one batch element at a time.

    Upcast modes: the stored values go to ``cfg.dtype`` (exact for int8,
    fp8 and int4 in bf16 and fp16), the K scale (and Q's) fold into the
    softmax scale, the V scale into V in fp32, and :func:`reference_attention`
    computes the rest (P cast to ``cfg.dtype`` before PV). ``int8_compute``:
    the JAX kernel's ``_attend_i8``. Returns (b, h, sq, d) in ``cfg.dtype``
    with q's strides.
    """
    q_vals = q.values if isinstance(q, QTensor) else q
    b, h = q_vals.shape[:2]
    q_scale = (q.scales.float() if isinstance(q, QTensor)
               else torch.ones((b, h), device=q_vals.device))
    eff = scale * _per_q_head(k.scales, h) * q_scale       # (b, h)
    v_scale = _per_q_head(v.scales, h)
    qr, kr, vr = _raw(q), _raw(k), _raw(v)
    dt = cfg.dtype.torch_dtype
    out = torch.empty_like(q_vals, dtype=dt)  # keeps q's strides
    for i in range(b):
        if int8_compute:
            group = h // kr.shape[1]
            out[i] = _attend_i8(
                qr[i], kr[i].repeat_interleave(group, 0),
                vr[i].repeat_interleave(group, 0), eff[i] * LOG2E, v_scale[i], cfg)
            continue
        vi = vr[i:i + 1] * v.scales[i:i + 1, :, None, None].float()
        out[i] = reference_attention(
            qr[i:i + 1].to(dt), kr[i:i + 1].to(dt), vi, causal=cfg.causal,
            scale_override=eff[i:i + 1, :, None, None],
            q_offset=0 if cfg.causal else None, window=cfg.window,
            softcap=cfg.attn_softcap)[0]
    return out


@functools.lru_cache(maxsize=None)
def _lib(d_head: int, dtype: torch.dtype = torch.bfloat16) -> ctypes.CDLL:
    lib = _build.load(_build.typed_source(SOURCES[d_head], dtype, "K10"))
    lib.fa_flash_quant.restype = _I32
    lib.fa_flash_quant.argtypes = ([_PTR] * 7 + [_I64] * 12 + [_I32] * 10
                                   + [_F32, _F32, _I32, _PTR])
    return lib


def _byte_strides(x):
    return [_I64(s * x.element_size()) for s in x.stride()[:3]]


def plan(kv_mode: str, int8_compute: bool, batch: int, heads: int, seq_q: int,
         seq_kv: int, d_head: int = D_HEAD) -> TilePlan:
    """K10's launch on the wgmma main loop (``UpcastTile`` and ``I8Tile`` in
    ``csrc/flash_quant.cu``) at head width ``d_head`` (128 or 256), from
    :data:`QUANT_TILES`. Upcast modes: the bf16 Q tile, two bf16 K/V slots
    and two raw K/V slots (a quantized Q's raw bytes pass through the second
    before its first tile). ``int8_compute``: the int8 Q tile, slots of the
    int8 K tile and the transposed V tile (I8_P_GROUP keys), and two raw V
    slots."""
    if d_head not in QUANT_TILES:
        raise ValueError(f"K10 takes head widths {D_HEADS}, got {d_head}")
    consumers, keys, i8_slots = QUANT_TILES[d_head]
    rows = consumers * WG_ROWS
    if int8_compute:
        keys, slots = I8_P_GROUP, i8_slots
        smem = (rows * d_head + slots * 2 * keys * d_head + 2 * keys * d_head
                + ALIGN_SLACK)
    else:
        slots = 2
        row = d_head // 2 if kv_mode == "int4" else d_head
        smem = (tile_bytes(rows, d_head) + slots * 2 * tile_bytes(keys, d_head)
                + 2 * (2 * keys * row) + ALIGN_SLACK)
    return TilePlan(rows=rows, keys=keys, slots=slots, smem=smem,
                    grid=(-(-seq_q // rows), heads, batch),
                    kv_tiles=-(-seq_kv // keys), threads=(consumers + 1) * 128)


def _launch(q, k: QTensor, v: QTensor, cfg: KernelConfig, scale: float,
            int8_compute: bool):
    """Launch K10 from the library of the compute type ``cfg.dtype`` (a
    dense Q's type, or a quantized Q's ``orig_dtype``, as the JAX kernel
    computes in; bf16 or fp16, ValueError for any other); the output is in
    that type."""
    q_quant = isinstance(q, QTensor)
    q_vals = q.values if q_quant else q
    d_head = q_vals.shape[3]
    if d_head not in D_HEADS:
        raise ValueError(f"the CUDA kernel's tiles are {' or '.join(map(str, D_HEADS))} "
                         f"wide, got d_head {d_head} (other widths: ROADMAP Queue 2, "
                         "coverage item 1)")
    dt = cfg.dtype.torch_dtype
    lib = _lib(d_head, dt)
    for name, t in (("q", q_vals), ("k", k.values), ("v", v.values)):
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(s * t.element_size() % 16 for s in t.stride()[:3])):
            raise ValueError(f"{name} needs a contiguous d axis and 16-byte aligned "
                             f"rows; strides {t.stride()}")
    b, h, sq, _ = q_vals.shape
    kvh, skv = k.values.shape[1], k.seq_len
    check_grid(plan(k.mode, int8_compute, b, h, sq, skv, d_head))
    out = torch.empty_like(q_vals, dtype=dt)  # keeps q's strides
    f32 = dict(device=q_vals.device, dtype=torch.float32)
    ks, vs = k.scales.to(**f32).contiguous(), v.scales.to(**f32).contiguous()
    qs = q.scales.to(**f32).contiguous() if q_quant else None
    rc = lib.fa_flash_quant(
        q_vals.data_ptr(), k.values.data_ptr(), v.values.data_ptr(), out.data_ptr(),
        qs.data_ptr() if qs is not None else None, ks.data_ptr(), vs.data_ptr(),
        *_byte_strides(q_vals), *_byte_strides(k.values), *_byte_strides(v.values),
        *[_I64(s) for s in out.stride()[:3]],
        b, h, kvh, sq, skv, _Q_TYPES[q.mode if q_quant else "bf16"], _KV_MODES[k.mode],
        int(int8_compute), int(cfg.causal), cfg.window, float(scale),
        float(cfg.attn_softcap), d_head,
        torch.cuda.current_stream(q_vals.device).cuda_stream)
    _build.check(lib, rc, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return out


def _validate(q, k: QTensor, v: QTensor, cfg: KernelConfig, int8_compute: bool):
    """Input checks, raised as ValueError with the field that failed."""
    q_vals = q.values if isinstance(q, QTensor) else q
    if q_vals.ndim != 4 or k.values.ndim != 4:
        raise ValueError(f"expected (batch, heads, seq, d_head), got "
                         f"{tuple(q_vals.shape)} and {tuple(k.values.shape)}")
    if cfg.q_offset:
        raise ValueError(
            "q_offset is not supported: the JAX kernel ignores it (its causal mask "
            "is top-left aligned whatever the offset; ROADMAP Queue 3)")
    if int8_compute and cfg.attn_softcap:
        raise ValueError(
            "int8_compute with attn_softcap is not supported: the JAX int8 path "
            "ignores the softcap (ROADMAP Queue 3)")
    for name, t in (("k", k), ("v", v)):
        if t.mode not in _KV_MODES or t.values.dtype != _STORED[t.mode]:
            raise ValueError(f"{name}: mode {t.mode!r} with values of "
                             f"{t.values.dtype}")
    if isinstance(q, QTensor) and (q.mode not in _Q_TYPES
                                   or q.values.dtype != _STORED[q.mode]):
        raise ValueError(f"q: mode {q.mode!r} with values of {q.values.dtype}")
    if k.values.shape != v.values.shape or tuple(k.scales.shape) != tuple(
            v.scales.shape):
        raise ValueError(f"K/V shape mismatch: {tuple(k.values.shape)} vs "
                         f"{tuple(v.values.shape)}")
    b, h, sq, d = q_vals.shape
    kb, kvh, skv, kd = k.values.shape
    if kb != b or kd * (2 if k.mode == "int4" else 1) != d:
        raise ValueError(f"Q/K shape mismatch: {tuple(q_vals.shape)} vs "
                         f"{tuple(k.values.shape)} ({k.mode})")
    if h % kvh:
        raise ValueError(f"GQA requires q_heads % kv_heads == 0: {h} vs {kvh}")
    if d != cfg.d_head or d % D_HEAD:
        raise ValueError(f"d_head must be a multiple of {D_HEAD} (config "
                         f"{cfg.d_head}), got {d}")
    if sq % SEQ_QUANTUM or skv % SEQ_QUANTUM:
        raise ValueError(f"seq ({sq}, {skv}) not a multiple of {SEQ_QUANTUM}")
    if tuple(k.scales.shape) != (b, kvh):
        raise ValueError(f"K/V scales must be (batch, kv_heads) = ({b}, {kvh}), "
                         f"got {tuple(k.scales.shape)}")
    if isinstance(q, QTensor):
        if tuple(q.scales.shape) != (b, h):
            raise ValueError(f"Q scales must be (batch, heads) = ({b}, {h}), got "
                             f"{tuple(q.scales.shape)}")
    elif q.dtype != cfg.dtype.torch_dtype:
        raise ValueError(f"dtype mismatch: config {cfg.dtype}, q {q.dtype}")
    devices = {t.device for t in (q_vals, k.values, v.values)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def flash_forward_quantized(q, k: QTensor, v: QTensor, cfg: KernelConfig | None = None,
                            *, scale: float | None = None,
                            int8_compute: bool | None = None):
    """softmax(Q K^T * scale) V with quantized K/V (and optionally Q).

    ``k``/``v``: :class:`QTensor` s of one mode (b, kv_heads, seq, d) (int4:
    d / 2 packed bytes). ``q``: a dense (b, heads, seq, d) tensor in
    ``cfg.dtype``, or an int8 / fp8 :class:`QTensor`. Q head h reads KV head
    h // (heads // kv_heads). ``cfg``: ``causal``, ``window`` and
    ``attn_softcap`` as in :func:`flash_forward` (top-left aligned);
    ``q_offset`` must be 0. ``scale``: None means ``cfg.softmax_scale``.
    ``int8_compute`` (default: on exactly when Q, K and V are int8
    QTensors): both products in int8, P quantized at the constant 127 per
    group of ``I8_P_GROUP`` KV columns. ``cfg`` defaults to one in the
    dense Q's type, or the quantized Q's ``orig_dtype``. Returns (b, heads,
    seq, d) in ``cfg.dtype`` with q's strides (on the card bf16 or fp16;
    fp32 raises ``ValueError``).
    """
    if k.mode != v.mode:
        raise ValueError(f"K/V quant modes differ: {k.mode} vs {v.mode}")
    q_quant = isinstance(q, QTensor)
    if q_quant and q.mode == "int4":
        raise ValueError("int4 Q unsupported: quantize Q as fp8 or int8")
    all_int8 = q_quant and q.mode == "int8" and k.mode == "int8"
    if int8_compute is None:
        int8_compute = all_int8
    if int8_compute and not all_int8:
        raise ValueError("int8_compute needs int8 Q, K, and V QTensors")
    q_vals = q.values if q_quant else q
    if cfg is None:
        cfg = KernelConfig(d_head=q_vals.shape[-1], dtype=DType.from_torch(
            q.orig_dtype if q_quant else q.dtype))
    _validate(q, k, v, cfg, bool(int8_compute))
    if scale is None:
        scale = cfg.softmax_scale
    if q_vals.device.type == "cpu":
        return flash_forward_quantized_plain(q, k, v, cfg, scale=scale,
                                             int8_compute=bool(int8_compute))
    if q_vals.device.type != "cuda":
        raise ValueError(f"unsupported device {q_vals.device}")
    return _launch(q, k, v, cfg, scale, bool(int8_compute))
