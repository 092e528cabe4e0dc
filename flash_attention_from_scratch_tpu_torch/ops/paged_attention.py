"""Paged decode attention: the wrapper of the Hopper kernel for K4/K5.

Counterpart of ``flash_attention_from_scratch_tpu/ops/paged_attention.py``
``paged_decode_attention``, whose two TPU kernels (``_full_kernel``, the
whole window at once, and ``_loop_kernel``, an online softmax per page)
compute the same function; on Hopper it is one kernel,
``csrc/paged_attention.cu``. For a CPU tensor the wrapper runs the plain
version, :func:`paged_decode_attention_plain`.

Page formats: dense (the query's dtype), int8, fp8 (``torch.float8_e4m3fn``)
and int4 packed along the tokens of a page (``(kv_heads, num_pages,
page_size // 2, d)`` int8: byte (t, c) holds token t in the low nibble and
token t + page_size/2 in the high nibble), the quantized ones with fp32
scales per (kv_head, page). One query token per sequence. ``int8_compute``
and multi-token queries (speculative verify) raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .quant import unpack_int4_halves

__all__ = ["paged_decode_attention", "paged_decode_attention_plain", "KERNEL"]

KERNEL = "paged_decode_attention"
SOURCE = "paged_attention.cu"
D_HEAD = 128
GROUPS = (1, 2, 4, 8)  # heads // kv_heads the kernel is built for
# Page format -> (the kernel's mode number, the pages' dtype; None: q's).
MODES = {"dense": (0, None), "int8": (1, torch.int8),
         "fp8": (2, torch.float8_e4m3fn), "int4": (3, torch.int8)}

_I32, _F32, _PTR = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.fa_paged_decode.restype = _I32
    lib.fa_paged_decode.argtypes = ([_PTR] * 8 + [_I32] * 6 + [_F32, _F32, _I32, _I32]
                                    + [_PTR])
    return lib


def _page_values(pages, scales, idx, mode: str):
    """Pages ``idx`` of one pool as fp32 token rows (kv_heads, n * ps, d),
    dequantized: int4 rows unpacked along the tokens of each page."""
    if pages.dtype == torch.float8_e4m3fn:  # gather the bytes
        got = pages.view(torch.uint8)[:, idx].view(pages.dtype)
    else:
        got = pages[:, idx]  # (kv_heads, n, rows, d)
    if mode == "int4":
        lo, hi = unpack_int4_halves(got)
        got = torch.cat([lo, hi], dim=2)  # token order within each page
    else:
        got = got.float()
    if mode != "dense":
        got = got * scales[:, idx].float()[:, :, None, None]
    return got.reshape(got.shape[0], -1, got.shape[-1])


def paged_decode_attention_plain(q, k_pages, v_pages, lengths, page_tables, *,
                                 scale: float, window: int = 0,
                                 softcap: float = 0.0, mode: str = "dense",
                                 k_scales=None, v_scales=None):
    """Plain PyTorch version: gather each sequence's pages, masked softmax.

    Quantized pages are dequantized in fp32 (values times their page's
    scale). Scores, softmax and PV run in fp32; the output is cast to q's
    dtype. Only the rows [start, length) of each sequence are gathered:
    table entries past the length (-1 padding) and rows never written
    cannot reach the sum.
    """
    batch, heads, d = q.shape
    kv_heads = k_pages.shape[0]
    page_size = k_pages.shape[2] * (2 if mode == "int4" else 1)
    group = heads // kv_heads
    out = torch.zeros_like(q)
    lengths_l = [int(x) for x in lengths.tolist()]
    tables = page_tables.tolist()
    for b in range(batch):
        n = lengths_l[b]
        if n == 0:
            continue
        n_pages = -(-n // page_size)
        idx = torch.as_tensor(tables[b][:n_pages], device=k_pages.device)
        k = _page_values(k_pages, k_scales, idx, mode)[:, :n]
        v = _page_values(v_pages, v_scales, idx, mode)[:, :n]
        start = max(n - window, 0) if window else 0
        k, v = k[:, start:], v[:, start:]
        qb = q[b].float().reshape(kv_heads, group, d)  # head h = hk*group + g
        s = torch.matmul(qb, k.transpose(-1, -2)) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        p = torch.softmax(s, dim=-1)
        out[b] = torch.matmul(p, v).reshape(heads, d).to(q.dtype)
    return out


def _launch(q, k_pages, v_pages, lengths, page_tables, scale, window, softcap,
            mode, k_scales, v_scales):
    mode_id, page_dtype = MODES[mode]
    page_dtype = page_dtype or torch.bfloat16
    if q.dtype != torch.bfloat16 or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        raise ValueError(f"the CUDA kernel takes bf16 q and {page_dtype} pages for "
                         f"mode {mode!r}, got {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype} (other types: ROADMAP Queue 2, K4/K5)")
    batch, heads, d = q.shape
    kv_heads, num_pages, rows, _ = k_pages.shape
    page_size = rows * 2 if mode == "int4" else rows
    if heads // kv_heads not in GROUPS:
        raise ValueError(f"heads // kv_heads must be one of {GROUPS}, got "
                         f"{heads // kv_heads}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mode == "dense":
        k_scales = v_scales = q  # not read by the kernel
    else:
        k_scales = k_scales.to(device=q.device, dtype=torch.float32).contiguous()
        v_scales = v_scales.to(device=q.device, dtype=torch.float32).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    page_tables = page_tables.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.fa_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(),
            lengths.data_ptr(), page_tables.data_ptr(), out.data_ptr(),
            batch, heads, kv_heads, num_pages, page_size,
            page_tables.shape[1], float(scale), float(softcap), int(window),
            mode_id, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "paged_decode_attention")
    _build.launch_counts[KERNEL] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, lengths, page_tables, *,
                           mode: str = "dense", k_scales=None, v_scales=None,
                           scale: float | None = None, int8_compute: bool = False,
                           window: int = 0, softcap: float = 0.0):
    """softmax(q K^T * scale) V for one query token over a paged KV cache.

    Args:
      q: (batch, n_heads, d_head): the current step's query per sequence.
        Q head h attends KV head h // (n_heads // n_kv_heads).
      k_pages/v_pages: (n_kv_heads, num_pages, page_size, d_head); for
        int4, (n_kv_heads, num_pages, page_size // 2, d_head) int8, packed
        along the tokens of each page.
      lengths: (batch,) int: valid KV tokens per sequence (the current
        token's K/V must already be in its page). 0 gives a zero row.
      page_tables: (batch, pages_per_seq) int: page ids in order, -1 padded.
      mode: "dense" | "int8" | "fp8" | "int4".
      k_scales/v_scales: (n_kv_heads, num_pages) fp32, required for the
        quantized modes.
      int8_compute: not ported yet (raises).
      window: each query sees only the last ``window`` positions; 0 disables.
      softcap: Gemma-2 logit softcap on the scaled scores; 0 disables.

    Returns q's shape in q's dtype.
    """
    if mode not in MODES:
        raise ValueError(f"unknown page format {mode!r}; one of {sorted(MODES)}")
    if int8_compute:
        raise NotImplementedError(
            "int8_compute (int8-compute attention) is not ported yet "
            "(ROADMAP Queue 1 item 6, attn_int8 on K4/K5)")
    if mode != "dense" and (k_scales is None or v_scales is None):
        raise ValueError(f"mode {mode!r} requires k_scales and v_scales")
    if q.ndim == 4:
        raise NotImplementedError(
            "multi-token q (speculative verify) is not ported yet "
            "(ROADMAP Queue 1 item 6, multi-token verify on K4/K5)")
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected q (batch, heads, d) and pages (kv_heads, "
                         f"num_pages, page_size, d); got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    batch, heads, d = q.shape
    kv_heads = k_pages.shape[0]
    if heads % kv_heads:
        raise ValueError(f"heads {heads} not divisible by kv_heads {kv_heads}")
    if mode != "dense" and tuple(k_scales.shape) != tuple(k_pages.shape[:2]):
        raise ValueError(f"k_scales/v_scales must be (kv_heads, num_pages) = "
                         f"{tuple(k_pages.shape[:2])}, got {tuple(k_scales.shape)}")
    if d != k_pages.shape[3] or d != D_HEAD:
        raise ValueError(f"d_head must be {D_HEAD} in q and pages, got "
                         f"{d} and {k_pages.shape[3]}")
    if tuple(lengths.shape) != (batch,) or page_tables.ndim != 2 \
            or page_tables.shape[0] != batch:
        raise ValueError(f"lengths {tuple(lengths.shape)} / page_tables "
                         f"{tuple(page_tables.shape)} do not match batch {batch}")
    if window < 0:
        raise ValueError(f"window must be >= 0: {window}")
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, lengths, page_tables, scale=scale,
            window=window, softcap=softcap, mode=mode, k_scales=k_scales,
            v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, lengths, page_tables, scale, window,
                   softcap, mode, k_scales, v_scales)
