"""Paged decode attention: the wrapper of the Hopper kernel for K4/K5.

Counterpart of ``flash_attention_from_scratch_tpu/ops/paged_attention.py``
``paged_decode_attention``, whose two TPU kernels (``_full_kernel``, the
whole window at once, and ``_loop_kernel``, an online softmax per page)
compute the same function; on Hopper it is one kernel,
``csrc/paged_attention.cu``. For a CPU tensor the wrapper runs the plain
version, :func:`paged_decode_attention_plain`.

Dense pages and one query token per sequence are ported. Quantized page
formats (int8, fp8, int4) and multi-token queries (speculative verify) raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_plain", "KERNEL"]

KERNEL = "paged_decode_attention"
SOURCE = "paged_attention.cu"
D_HEAD = 128
GROUPS = (1, 2, 4, 8)  # heads // kv_heads the kernel is built for

_I32, _F32, _PTR = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.fa_paged_decode.restype = _I32
    lib.fa_paged_decode.argtypes = [_PTR] * 6 + [_I32] * 6 + [_F32, _F32, _I32, _PTR]
    return lib


def paged_decode_attention_plain(q, k_pages, v_pages, lengths, page_tables, *,
                                 scale: float, window: int = 0,
                                 softcap: float = 0.0):
    """Plain PyTorch version: gather each sequence's pages, masked softmax.

    Scores, softmax and PV run in fp32; the output is cast to q's dtype.
    Only the rows [start, length) of each sequence are gathered: table
    entries past the length (-1 padding) and rows never written cannot
    reach the sum.
    """
    batch, heads, d = q.shape
    kv_heads, _, page_size, _ = k_pages.shape
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
        k = k_pages[:, idx].reshape(kv_heads, -1, d)[:, :n].float()
        v = v_pages[:, idx].reshape(kv_heads, -1, d)[:, :n].float()
        start = max(n - window, 0) if window else 0
        k, v = k[:, start:], v[:, start:]
        qb = q[b].float().reshape(kv_heads, group, d)  # head h = hk*group + g
        s = torch.matmul(qb, k.transpose(-1, -2)) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        p = torch.softmax(s, dim=-1)
        out[b] = torch.matmul(p, v).reshape(heads, d).to(q.dtype)
    return out


def _launch(q, k_pages, v_pages, lengths, page_tables, scale, window, softcap):
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16 \
            or v_pages.dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel takes bf16 q and pages, got "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype} "
                         "(other types: ROADMAP Queue 2, K4/K5)")
    batch, heads, d = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    if heads // kv_heads not in GROUPS:
        raise ValueError(f"heads // kv_heads must be one of {GROUPS}, got "
                         f"{heads // kv_heads}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    page_tables = page_tables.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.fa_paged_decode(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_tables.data_ptr(), out.data_ptr(),
            batch, heads, kv_heads, num_pages, page_size,
            page_tables.shape[1], float(scale), float(softcap), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "paged_decode_attention")
    _build.launch_counts[KERNEL] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, lengths, page_tables, *,
                           mode: str = "dense", scale: float | None = None,
                           window: int = 0, softcap: float = 0.0):
    """softmax(q K^T * scale) V for one query token over a paged KV cache.

    Args:
      q: (batch, n_heads, d_head): the current step's query per sequence.
        Q head h attends KV head h // (n_heads // n_kv_heads).
      k_pages/v_pages: (n_kv_heads, num_pages, page_size, d_head).
      lengths: (batch,) int: valid KV tokens per sequence (the current
        token's K/V must already be in its page). 0 gives a zero row.
      page_tables: (batch, pages_per_seq) int: page ids in order, -1 padded.
      mode: "dense" only; quantized pages are not ported yet.
      window: each query sees only the last ``window`` positions; 0 disables.
      softcap: Gemma-2 logit softcap on the scaled scores; 0 disables.

    Returns q's shape in q's dtype.
    """
    if mode != "dense":
        raise NotImplementedError(
            f"mode={mode!r}: quantized page formats are not ported yet "
            "(ROADMAP Queue 1 item 6, quantized cache modes of K4/K5)")
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
            window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, lengths, page_tables, scale, window,
                   softcap)
