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
scales per (kv_head, page).

Queries: one token per sequence, ``(batch, heads, d)``, or t tokens,
``(batch, heads, t, d)`` (speculative verify): token j sits at position
``length - t + j`` and sees the tokens ``[max(limit - window, 0), limit)``
with ``limit = length - (t - 1) + j``. Within a KV head hk, the kernel and
the plain version order the rows as the JAX package does: row r is the
group-g copy of token j, r = g * t + j.

``int8_compute`` (int8 pages only) quantizes q per row and runs both
products on integers: S is an exact int32 dot, P is rounded at the
constant scale 127 against the running max, and the int32 P.V dot of each
page is dequantized by that page's V scale / 127. The plain version takes
the semantics of the JAX ``_loop_kernel`` (P rounded once per page, in page
order); ``_full_kernel`` rounds P once against the row's final max after
folding every page's V scale into it, so the two JAX variants differ.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .quant import div_const, unpack_int4_halves

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "quantize_q_rows", "kernel_name", "KERNEL", "KERNEL_MULTI",
           "KERNEL_INT8C", "KERNEL_MULTI_INT8C"]

# Launch counts, one name per path: single-token or multi-token q, with or
# without int8_compute.
KERNEL = "paged_decode_attention"
KERNEL_MULTI = "paged_decode_attention_multi"
KERNEL_INT8C = "paged_decode_attention_int8c"
KERNEL_MULTI_INT8C = "paged_decode_attention_multi_int8c"
SOURCE = "paged_attention.cu"
D_HEAD = 128
LOG2E = math.log2(math.e)
# Page format -> (the kernel's mode number, the pages' dtype; None: q's).
MODES = {"dense": (0, None), "int8": (1, torch.int8),
         "fp8": (2, torch.float8_e4m3fn), "int4": (3, torch.int8)}
MODE_INT8C = 4  # int8 pages, int8_compute

_I32, _F32, _PTR = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def kernel_name(q_tokens: int, int8_compute: bool) -> str:
    """The launch-count name of a call with ``q_tokens`` query tokens."""
    if q_tokens > 1:
        return KERNEL_MULTI_INT8C if int8_compute else KERNEL_MULTI
    return KERNEL_INT8C if int8_compute else KERNEL


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.fa_paged_decode.restype = _I32
    lib.fa_paged_decode.argtypes = ([_PTR] * 8 + [_I32] * 7 + [_F32, _F32, _I32, _I32]
                                    + [_PTR])
    return lib


def quantize_q_rows(q):
    """Per-row symmetric int8 quantization of (..., d) query rows: the JAX
    ``_quantize_q_rows`` as ``jit`` compiles it (the division of the abs-max
    by 127 becomes a product with the fp32 reciprocal, ``div_const``).
    Returns (int8 values, fp32 scales (..., 1))."""
    qf = q.float()
    q_scale = div_const(torch.clamp_min(qf.abs().amax(-1, keepdim=True), 1e-12), 127.0)
    return torch.round(qf / q_scale).to(torch.int8), q_scale


def _stored(pages, idx):
    """Pages ``idx`` of one pool as stored (kv_heads, n, rows, d); fp8
    gathered through its bytes."""
    if pages.dtype == torch.float8_e4m3fn:
        return pages.view(torch.uint8)[:, idx].view(pages.dtype)
    return pages[:, idx]


def _page_values(pages, scales, idx, mode: str):
    """Pages ``idx`` of one pool as fp32 token rows (kv_heads, n * ps, d),
    dequantized: int4 rows unpacked along the tokens of each page."""
    got = _stored(pages, idx)  # (kv_heads, n, rows, d)
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
                                 k_scales=None, v_scales=None,
                                 int8_compute: bool = False):
    """Plain PyTorch version: gather each sequence's pages, masked softmax.

    ``q`` is (batch, heads, d) or (batch, heads, t, d). Quantized pages are
    dequantized in fp32 (values times their page's scale). Scores, softmax
    and PV run in fp32; the output is cast to q's dtype. Only the rows
    [start, length) of each sequence are gathered, start the lowest window
    start of its rows: table entries past the length (-1 padding) and rows
    never written cannot reach the sum. A row that sees no token (a length-0
    sequence) gives zeros. ``int8_compute``: see :func:`_int8_compute_plain`.
    """
    single = q.ndim == 3
    q4 = q[:, :, None] if single else q
    batch, heads, t, d = q4.shape
    kv_heads = k_pages.shape[0]
    page_size = k_pages.shape[2] * (2 if mode == "int4" else 1)
    group = heads // kv_heads
    out = torch.zeros_like(q4)
    lengths_l = [int(x) for x in lengths.tolist()]
    tables = page_tables.tolist()
    for b in range(batch):
        n = lengths_l[b]
        if n == 0:
            continue
        start = max(n - (t - 1) - window, 0) if window else 0
        first, n_pages = start // page_size, -(-n // page_size)
        idx = torch.as_tensor(tables[b][first:n_pages], device=k_pages.device)
        # (kv_heads, group * t, d): row r = g * t + j of KV head hk.
        qb = q4[b].float().reshape(kv_heads, group * t, d)
        # Row r = g * t + j sees tokens below its limit n - (t - 1) + j.
        j = torch.arange(group * t, device=q.device)[:, None] % t
        limit = n - (t - 1) + j  # (R, 1)
        if int8_compute:
            o = _int8_compute_plain(qb, k_pages, v_pages, k_scales, v_scales, idx,
                                    first * page_size, limit, page_size, scale,
                                    window, softcap)
        else:
            lo = start - first * page_size
            k = _page_values(k_pages, k_scales, idx, mode)[:, lo:n - first * page_size]
            v = _page_values(v_pages, v_scales, idx, mode)[:, lo:n - first * page_size]
            pos = start + torch.arange(k.shape[1], device=q.device)[None, :]
            keep = pos < limit
            if window:
                keep &= pos >= limit - window
            s = torch.matmul(qb, k.transpose(-1, -2)) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
            p = torch.where(keep.any(-1, keepdim=True), p, 0.0)
            o = torch.matmul(p, v)
        out[b] = o.reshape(heads, t, d).to(q.dtype)
    return out[:, :, 0] if single else out


def _int8_compute_plain(qb, k_pages, v_pages, k_scales, v_scales, idx, pos0,
                        limit, page_size, scale, window, softcap):
    """One sequence's int8-compute attention, the JAX ``_loop_kernel``'s
    arithmetic page by page in page order (pages ``idx``, the first at
    token ``pos0``): q rows quantized by :func:`quantize_q_rows`; S = the
    exact int32 dot x q_scale x scale x log2(e) x the page's K scale, then
    the softcap and the mask; P = exp2(S - m) against the running max m
    after this page, rounded to int8 at the constant scale 127; each page's
    int32 P.V dot times its V scale / 127; l the fp32 sum of the unrounded
    P. The online rescale by alpha = exp2(m_old - m_new) is written in its
    closed form: page i's terms are scaled once by exp2(m_i - m_last).
    Integer products are exact in fp32 (|sums| < 2^24). Returns (kv_heads,
    rows, d) fp32."""
    q_i8, q_scale = quantize_q_rows(qb)  # (kvh, R, d), (kvh, R, 1)
    k = _stored(k_pages, idx).float()  # (kvh, n, ps, d) raw int8 values
    v = _stored(v_pages, idx).float()
    ks = k_scales[:, idx].float()[:, None, :, None]  # (kvh, 1, n, 1)
    vs = v_scales[:, idx].float()[:, None, :, None]
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    s = torch.einsum("hrd,hnpd->hrnp", q_i8.float(), k)  # exact int32 dot
    s = s * (q_scale * c)[..., None] * ks
    if softcap:
        capf = softcap * LOG2E
        s = torch.tanh(s / capf) * capf
    pos = pos0 + torch.arange(s.shape[2] * page_size, device=s.device).view(
        s.shape[2], page_size)
    keep = pos[None] < limit[..., None]  # (R, n, ps)
    if window:
        keep &= pos[None] >= (limit - window)[..., None]
    s = s.masked_fill(~keep, float("-inf"))
    m_run = torch.cummax(s.amax(-1), dim=-1).values  # (kvh, R, n): after page i
    m_safe = torch.where(m_run == float("-inf"), 0.0, m_run)
    p = torch.exp2(s - m_safe[..., None])  # masked -> 0
    p_i8 = torch.round(p * 127.0)
    pv = torch.einsum("hrnp,hnpd->hrnd", p_i8, v) * (vs / 127.0)
    m_last = m_safe[..., -1:]
    w = torch.where(m_run == float("-inf"), 0.0, torch.exp2(m_safe - m_last))
    acc = (pv * w[..., None]).sum(2)
    l_sum = (p.sum(-1) * w).sum(-1, keepdim=True)
    return torch.where(l_sum > 0, acc / l_sum.clamp_min(1e-30), 0.0)


def _launch(q, k_pages, v_pages, lengths, page_tables, scale, window, softcap,
            mode, k_scales, v_scales, int8_compute):
    mode_id, page_dtype = MODES[mode]
    page_dtype = page_dtype or torch.bfloat16
    if q.dtype != torch.bfloat16 or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        raise ValueError(f"the CUDA kernel takes bf16 q and {page_dtype} pages for "
                         f"mode {mode!r}, got {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype} (other types: ROADMAP Queue 2, K4/K5)")
    if q.shape[-1] != D_HEAD:
        raise ValueError(f"the CUDA kernel's tiles are {D_HEAD} wide, got d_head "
                         f"{q.shape[-1]} (256-wide tiles: ROADMAP Queue 2)")
    batch, heads = q.shape[:2]
    q_tokens = q.shape[2] if q.ndim == 4 else 1
    kv_heads, num_pages, rows, _ = k_pages.shape
    page_size = rows * 2 if mode == "int4" else rows
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
            page_tables.shape[1], q_tokens, float(scale), float(softcap),
            int(window), MODE_INT8C if int8_compute else mode_id,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "paged_decode_attention")
    _build.launch_counts[kernel_name(q_tokens, int8_compute)] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, lengths, page_tables, *,
                           mode: str = "dense", k_scales=None, v_scales=None,
                           scale: float | None = None, int8_compute: bool = False,
                           window: int = 0, softcap: float = 0.0):
    """softmax(q K^T * scale) V for 1..t query tokens over a paged KV cache.

    Args:
      q: (batch, n_heads, d_head): the current step's query per sequence;
        or (batch, n_heads, t, d_head) for multi-token decode (speculative
        verify): token j sits at position lengths - t + j and is masked
        causally within the new tokens (their K/V must already be in the
        cache). Q head h attends KV head h // (n_heads // n_kv_heads).
      k_pages/v_pages: (n_kv_heads, num_pages, page_size, d_head); for
        int4, (n_kv_heads, num_pages, page_size // 2, d_head) int8, packed
        along the tokens of each page.
      lengths: (batch,) int: valid KV tokens per sequence, the new tokens
        included. 0 gives a zero row, and so does a row that sees no token.
      page_tables: (batch, pages_per_seq) int: page ids in order, -1 padded.
      mode: "dense" | "int8" | "fp8" | "int4".
      k_scales/v_scales: (n_kv_heads, num_pages) fp32, required for the
        quantized modes.
      int8_compute: int8 pages only: q quantized per row (in the kernel),
        an exact int32 S dot, P rounded at the constant scale 127, an exact
        int32 P.V dot per page (see the module docstring).
      window: each query token sees only the last ``window`` positions up
        to its own; 0 disables.
      softcap: Gemma-2 logit softcap on the scaled scores; 0 disables.

    Returns q's shape in q's dtype.
    """
    if mode not in MODES:
        raise ValueError(f"unknown page format {mode!r}; one of {sorted(MODES)}")
    if int8_compute and mode != "int8":
        raise ValueError(f"int8_compute requires mode='int8', got {mode!r}")
    if mode != "dense" and (k_scales is None or v_scales is None):
        raise ValueError(f"mode {mode!r} requires k_scales and v_scales")
    if q.ndim not in (3, 4) or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"expected q (batch, heads, d) or (batch, heads, t, d) and "
                         f"pages (kv_heads, num_pages, page_size, d); got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    batch, heads, d = q.shape[0], q.shape[1], q.shape[-1]
    kv_heads = k_pages.shape[0]
    if heads % kv_heads:
        raise ValueError(f"heads {heads} not divisible by kv_heads {kv_heads}")
    if q.ndim == 4 and q.shape[2] < 1:
        raise ValueError("q has no tokens")
    if mode != "dense" and tuple(k_scales.shape) != tuple(k_pages.shape[:2]):
        raise ValueError(f"k_scales/v_scales must be (kv_heads, num_pages) = "
                         f"{tuple(k_pages.shape[:2])}, got {tuple(k_scales.shape)}")
    if d != k_pages.shape[3] or d % D_HEAD:
        raise ValueError(f"d_head must be a multiple of {D_HEAD}, the same in q "
                         f"and pages, got {d} and {k_pages.shape[3]}")
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
            v_scales=v_scales, int8_compute=int8_compute)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, lengths, page_tables, scale, window,
                   softcap, mode, k_scales, v_scales, int8_compute)
