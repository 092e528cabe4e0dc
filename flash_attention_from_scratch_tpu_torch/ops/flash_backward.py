"""Flash-attention backward: the wrappers of the Hopper kernels K2 and K3.

Counterpart of ``flash_attention_from_scratch_tpu/ops/flash_backward.py``
``flash_backward``. For CUDA tensors the wrapper launches
``csrc/flash_backward.cu``: K2, the fused kernel (one shared recompute for
dQ, dK and dV; dQ summed by fp32 atomics), or K3, the split pair (a dK/dV
kernel and a dQ kernel, each summing in a fixed order). For CPU tensors it
runs the plain version, :func:`flash_backward_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .configs import KernelConfig
from .flash_forward import D_HEAD, _default_cfg, _kernel_layout, _strides, _validate

__all__ = ["flash_backward", "flash_backward_plain", "fused_choice",
           "KERNEL_FUSED", "KERNEL_DKV", "KERNEL_DQ"]

KERNEL_FUSED = "flash_backward_fused"
KERNEL_DKV = "flash_backward_dkv"
KERNEL_DQ = "flash_backward_dq"
SOURCE = "flash_backward.cu"
LOG2E = math.log2(math.e)

_I64, _I32, _F32, _PTR = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p


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
    """D = rowsum(dO * O) in fp32, (batch, heads, seq_q)."""
    return (do.float() * o.float()).sum(-1)


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
    scale = cfg.softmax_scale if scale is None else scale
    dt = q.dtype
    do = do.to(dt)
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    group = h // kvh
    dsum = _row_sums(o, do)[..., None]
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
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    argtypes = [_PTR] * 9 + [_I64] * 12 + [_I32] * 8 + [_F32, _F32, _PTR]
    for fn in (lib.fa_flash_backward_fused, lib.fa_flash_backward_dkv,
               lib.fa_flash_backward_dq):
        fn.restype = _I32
        fn.argtypes = argtypes
    return lib


def _aligned(x):
    """x contiguous, starting on a 16-byte boundary (the kernels read row
    statistics 16 bytes at a time)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q, k, v, lse, dsum, do, cfg: KernelConfig, scale: float,
            fused: bool):
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernels take bf16, got {q.dtype} "
                         "(fp16/fp32: ROADMAP Queue 2, K2/K3)")
    if q.shape[3] != D_HEAD:
        raise ValueError(f"the CUDA kernels' tiles are {D_HEAD} wide, got d_head "
                         f"{q.shape[3]} (256-wide tiles: ROADMAP Queue 2)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout(t):
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned "
                             f"d_head axis; strides {t.stride()}")
    if not _kernel_layout(do):  # autograd may hand over an expanded cotangent
        do = do.contiguous()
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    lse, dsum = _aligned(lse), _aligned(dsum)
    dk = torch.empty((b, kvh, skv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def call(fn, name, dq_buf, dk_buf, dv_buf):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dsum.data_ptr(), dq_buf, dk_buf, dv_buf,
                *_strides(q), *_strides(k), *_strides(v), *_strides(do),
                b, h, kvh, sq, skv, int(cfg.causal), cfg.q_offset, cfg.window,
                float(scale), float(cfg.attn_softcap), stream)
        _build.check(lib, rc, name)
        _build.launch_counts[name] += 1

    if fused:
        dq_acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
        call(lib.fa_flash_backward_fused, KERNEL_FUSED, dq_acc.data_ptr(),
             dk.data_ptr(), dv.data_ptr())
        return dq_acc.to(q.dtype), dk, dv
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    call(lib.fa_flash_backward_dkv, KERNEL_DKV, None, dk.data_ptr(), dv.data_ptr())
    call(lib.fa_flash_backward_dq, KERNEL_DQ, dq.data_ptr(), None, None)
    return dq, dk, dv


def fused_choice(fused: bool | None = None) -> bool:
    """Whether :func:`flash_backward` runs K2: ``fused`` when given, else
    K2 unless PyTorch's deterministic mode is on
    (``torch.use_deterministic_algorithms``), which selects K3."""
    if fused is not None:
        return fused
    return not torch.are_deterministic_algorithms_enabled()


def flash_backward(q, k, v, o, lse, do, cfg: KernelConfig | None = None, *,
                   scale: float | None = None, fused: bool | None = None,
                   bands: int | None = None):
    """Gradients (dq, dk, dv) of ``flash_forward`` from the saved (O, LSE).

    q, o, do (batch, heads, seq_q, d); k, v (batch, kv_heads, seq_kv, d);
    ``lse`` (batch, heads, seq_q) fp32 from :func:`flash_forward_with_lse`.
    ``do`` is cast to q's dtype. ``scale`` defaults to the config's softmax
    scale.

    ``fused=True`` (the default on every length) runs K2, which shares one
    recompute between dQ, dK and dV and adds dQ by fp32 atomics, so dQ's
    summation order changes from run to run. ``fused=False`` runs K3, the
    split dK/dV and dQ kernels, whose sums have a fixed order; it is also
    the default while PyTorch's deterministic mode is on (:func:`fused_choice`).
    The TPU's rule for choosing (``fused_backward_fits``: whole-sequence
    dK/dV scratch in VMEM) does not apply on Hopper, where each CTA keeps
    dK/dV for one 64-row KV tile only. ``bands`` (the TPU's banded
    backward, a measured loss there) is not ported.
    """
    if bands is not None:
        raise NotImplementedError(
            "the banded backward is not ported (ROADMAP Queue 2, K2)")
    cfg = cfg or _default_cfg(q)
    _validate_backward(cfg, q, k, v, o, lse, do)
    scale = cfg.softmax_scale if scale is None else scale
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, do, cfg, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    do = do.to(q.dtype)
    return _launch(q, k, v, lse, _row_sums(o, do), do, cfg, scale,
                   fused=fused_choice(fused))
