"""Flash-attention forward: the wrapper of the Hopper kernels K1 and K11.

Counterpart of ``flash_attention_from_scratch_tpu/ops/flash_forward.py``
``flash_forward`` / ``flash_forward_with_lse``. For a CUDA tensor the wrapper
launches ``csrc/flash_forward.cu`` (K1), or ``csrc/flash_forward_fori.cu``
(K11, the K/V copy ring) when ``cfg.kv_loop`` is ``KVLoop.FORI``; for a CPU
tensor it runs the plain version, :func:`flash_forward_plain`, the same
function for both. The JAX package's row-band causal dispatch
(``ops/causal_decomp.py``) has no counterpart: its output is that of a
causal kernel that skips the tiles above the diagonal, which both kernels
do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .configs import DType, KernelConfig, KVLoop
from .reference import reference_attention

__all__ = ["flash_forward", "flash_forward_with_lse", "flash_forward_plain",
           "KERNEL", "KERNEL_FORI", "SEQ_QUANTUM", "D_HEAD"]

KERNEL = "flash_forward"
SOURCE = "flash_forward.cu"
KERNEL_FORI = "flash_forward_fori"
SOURCE_FORI = "flash_forward_fori.cu"
SEQ_QUANTUM = 64  # both kernels' Q and KV tile height
D_HEAD = 128      # both kernels' head width

_I64, _I32, _F32, _PTR = ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def _validate(cfg: KernelConfig, q, k, v, sinks):
    """Input checks, raised as ValueError with the field that failed."""
    if q.ndim != 4:
        raise ValueError(f"expected (batch, heads, seq, d_head), got {tuple(q.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"K/V shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"Q/K shape mismatch: {tuple(q.shape)} vs {tuple(k.shape)}")
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            f"GQA requires q_heads % kv_heads == 0: {q.shape[1]} vs {k.shape[1]}")
    if q.shape[3] != cfg.d_head:
        raise ValueError(f"d_head mismatch: config {cfg.d_head}, tensors {q.shape[3]}")
    if q.shape[3] % D_HEAD:
        raise ValueError(f"d_head must be a multiple of {D_HEAD}, got {q.shape[3]}")
    if q.dtype != cfg.dtype.torch_dtype or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtype mismatch: config {cfg.dtype}, tensors "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[2] % SEQ_QUANTUM:
        raise ValueError(f"seq_q {q.shape[2]} not a multiple of {SEQ_QUANTUM}")
    if k.shape[2] % SEQ_QUANTUM:
        raise ValueError(f"seq_kv {k.shape[2]} not a multiple of {SEQ_QUANTUM}")
    if sinks is not None and tuple(sinks.shape) != (q.shape[1],):
        raise ValueError(
            f"sinks must be (heads,) = ({q.shape[1]},), got {tuple(sinks.shape)}")
    devices = {t.device for t in (q, k, v) + (() if sinks is None else (sinks,))}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")


def flash_forward_plain(q, k, v, cfg: KernelConfig, sinks=None):
    """The plain PyTorch version of the kernel: (out, lse)."""
    return reference_attention(
        q, k, v, causal=cfg.causal, scale_override=cfg.softmax_scale,
        q_offset=cfg.q_offset if cfg.causal else None, window=cfg.window,
        softcap=cfg.attn_softcap, sinks=sinks, return_lse=True)


_ARGTYPES = [_PTR] * 6 + [_I64] * 12 + [_I32] * 8 + [_F32, _F32]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.fa_flash_forward.restype = _I32
    lib.fa_flash_forward.argtypes = _ARGTYPES + [_PTR]
    return lib


@functools.lru_cache(maxsize=None)
def _fori_lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE_FORI)
    lib.fa_flash_forward_fori.restype = _I32
    lib.fa_flash_forward_fori.argtypes = _ARGTYPES + [_I32, _PTR]
    return lib


def _strides(x):
    return [_I64(s) for s in x.stride()[:3]]


def _kernel_layout(t) -> bool:
    """Does t have the layout the kernels read: d contiguous, rows 16-byte
    aligned?"""
    return (t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _launch(q, k, v, cfg: KernelConfig, sinks, want_lse: bool):
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16, got {q.dtype} "
                         "(fp16/fp32: ROADMAP Queue 2, K1)")
    if q.shape[3] != D_HEAD:
        raise ValueError(f"the CUDA kernels' tiles are {D_HEAD} wide, got d_head "
                         f"{q.shape[3]} (256-wide tiles: ROADMAP Queue 2)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout(t):
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned "
                             f"d_head axis; strides {t.stride()}")
    b, h, sq, _ = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)  # keeps q's strides (a transposed view stays one)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    sinks32 = sinks.float().contiguous() if sinks is not None else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            sinks32.data_ptr() if sinks32 is not None else None,
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            b, h, kvh, sq, skv, int(cfg.causal), cfg.q_offset, cfg.window,
            float(cfg.softmax_scale), float(cfg.attn_softcap))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if cfg.kv_loop == KVLoop.FORI:
        lib, name = _fori_lib(), KERNEL_FORI
        rc = lib.fa_flash_forward_fori(*args, cfg.num_kv_buffers, stream)
    else:
        lib, name = _lib(), KERNEL
        rc = lib.fa_flash_forward(*args, stream)
    _build.check(lib, rc, name)
    _build.launch_counts[name] += 1
    return out, lse


def _default_cfg(q) -> KernelConfig:
    return KernelConfig(d_head=q.shape[-1], dtype=DType.from_torch(q.dtype))


def flash_forward_with_lse(q, k, v, cfg: KernelConfig | None = None,
                           sinks=None):
    """Forward pass that also returns the per-row log-sum-exp.

    ``lse`` is (batch, heads, seq_q) fp32, the natural log of the sum of
    exp(scaled scores) over each row, sink term included.
    """
    cfg = cfg or _default_cfg(q)
    _validate(cfg, q, k, v, sinks)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, cfg, sinks)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, cfg, sinks, want_lse=True)


def flash_forward(q, k, v, cfg: KernelConfig | None = None, sinks=None):
    """softmax(Q K^T * scale) V. Inputs (batch, heads, seq, d_head).

    K/V may have fewer heads than Q (GQA: Q head h reads KV head
    h // (heads // kv_heads)). ``sinks`` ((heads,) fp32): per-head logits
    that join the softmax denominator only. The output has q's shape,
    dtype and strides.
    """
    cfg = cfg or _default_cfg(q)
    _validate(cfg, q, k, v, sinks)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, cfg, sinks)[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, cfg, sinks, want_lse=False)[0]
