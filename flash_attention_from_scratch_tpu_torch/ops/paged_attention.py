"""Paged decode attention: the wrapper of the Hopper kernels for K4/K5.

Counterpart of ``flash_attention_from_scratch_tpu/ops/paged_attention.py``
``paged_decode_attention``, whose two TPU kernels (``_full_kernel``, the
whole window at once, and ``_loop_kernel``, an online softmax per page)
compute the same function; on Hopper it is one split-KV kernel and a merge
kernel, ``csrc/paged_attention.cu``: split s of :func:`plan` walks its
range of page-table columns and writes its partial (O, m, l), and the merge
combines the splits in order (one split: no merge). The split count is a
function of shapes alone, so a call reads no device value on the host. For
a CPU tensor the wrapper runs the plain version,
:func:`paged_decode_attention_plain` (or, with ``splits`` given, the plain
split-and-merge version, :func:`paged_decode_attention_split_plain`).

Queries bf16 or fp16 on the card: fp16 runs the same kernels built for fp16
(``csrc/paged_attention_f16.cu``), the pages converted to fp16 and P rounded
to it, as the JAX kernels compute in q's dtype; fp32 raises ``ValueError``.

Page formats: dense (the query's dtype), int8, fp8 (``torch.float8_e4m3fn``)
and int4 packed along the tokens of a page (``(kv_heads, num_pages,
page_size // 2, d)`` int8: byte (t, c) holds token t in the low nibble and
token t + page_size/2 in the high nibble), the quantized ones with fp32
scales per (kv_head, page). Any page size (int4: even), as the JAX wrapper
takes: the kernel walks pages in chunks where their sizes allow
(:func:`chunk_tokens`), and gathers tiles of 64 positions across pages
otherwise (1 token a page, 12, 100, ...; :attr:`PagedPlan.gather`).

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
import dataclasses
import functools
import math

import torch

from . import _build
from .quant import div_const, unpack_int4_halves
from ..utils.device import sm_count

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "paged_decode_attention_split_plain", "plan", "PagedPlan",
           "quantize_q_rows", "kernel_name", "KERNEL", "KERNEL_MULTI",
           "KERNEL_INT8C", "KERNEL_MULTI_INT8C", "KERNEL_MERGE", "geometry", "Geometry",
           "D_HEADS"]

# Launch counts, one name per path of the split kernel: single-token or
# multi-token q, with or without int8_compute; and the merge kernel's.
KERNEL = "paged_decode_attention"
KERNEL_MULTI = "paged_decode_attention_multi"
KERNEL_INT8C = "paged_decode_attention_int8c"
KERNEL_MULTI_INT8C = "paged_decode_attention_multi_int8c"
KERNEL_MERGE = "paged_decode_merge"
SOURCE = "paged_attention.cu"
SOURCE_F16 = _build.typed_source(SOURCE, torch.float16, "K4/K5")  # the fp16 library
D_HEAD = 128               # the narrowest head width (the ring budgets' own)
D_HEADS = (128, 256)       # the head widths the kernels take
LOG2E = math.log2(math.e)
# Page format -> (the kernel's mode number, the pages' dtype; None: q's).
MODES = {"dense": (0, None), "int8": (1, torch.int8),
         "fp8": (2, torch.float8_e4m3fn), "int4": (3, torch.int8)}
MODE_INT8C = 4  # int8 pages, int8_compute

_I32, _F32, _PTR = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

# The split kernel's geometry (csrc/paged_attention.cu; plan() mirrors it):
# a CTA holds a tile of 16 rows (the M of mma.sync); on the chunk walk pages
# arrive in chunks of up to 64 tokens (an int4 page whole, up to 256)
# through a ring of 2-8 slots (the K chunk, then the V chunk): dense ones by
# TMA straight into the tiles the products read (RING_BYTES), quantized ones
# as raw bytes (RAW_RING_BYTES) converted into a bf16 tile (STAGE_BYTES); on
# the gather walk every format arrives as raw token rows, 64 positions a
# slot (RAW_RING_BYTES), converted into the bf16 tile with each token's
# factors (FAC_BYTES); the Q tile and the tiles 1024-aligned; the warps'
# merge scratch reuses the tiles. The ring budgets are d 128's;
# :func:`geometry` gives the rest at each width (``Geo<D>`` in the kernel).
MMA_ROWS = 16
TILE_TOKENS = 64
NWARPS = 8
RING_BYTES = 98304
RAW_RING_BYTES = 65536
MIN_SLOTS, MAX_SLOTS = 2, 8
INT4_WHOLE_PAGE = 256    # int4 pages up to this many tokens go whole on the chunk walk
FAC_BYTES = 512          # the gather walk's K and V factors of a tile's tokens
ALIGN_SLACK = 1024
SMEM_LIMIT = 232448      # shared memory an H100 block may use
STATIC_RESERVE = 1024    # of it kept for the kernel's static arrays
SM_SMEM = 233472         # shared memory of one H100 SM
CTA_RESERVED = 1024      # of it reserved for each resident CTA
WAVES = 2                # CTA slots the split count aims to fill, in waves
# Table tokens a split covers, at least: a CTA's fixed cost (its Q rows, its
# merge, its partial's writes) against its walk. The gather walk's tile
# costs a copy a page (64 at page 1), so it splits finer: at the decode
# step of chip_smoke.py's OpenHermes run R1 (1-token pages, 8 x 201-2,001
# tokens, one layer) one split took 0.194 ms, 16 forced ones 0.053 (PERF.md;
# NVIDIA H100 80GB HBM3, 700 W).
MIN_SPLIT_TOKENS = {"dense": 1024, "quantized": 512, "gather": 128}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The kernel's constants at one head width (``Geo<D>``): its launch
    bound's CTAs an SM, the dense and raw rings' budgets, the quantized
    pages' bf16 K and V tile, the Q tile, and the merge scratch (rows
    ``merge_stride`` floats apart)."""
    d_head: int
    ctas_per_sm: int
    ring_bytes: int
    raw_ring_bytes: int
    stage_bytes: int
    q_tile_bytes: int
    merge_stride: int
    merge_bytes: int


def geometry(d_head: int) -> Geometry:
    """``Geo<D>`` of ``csrc/paged_attention.cu`` at head width ``d_head``:
    at d 128 two CTAs an SM (128 registers a thread); at d 256, where a
    warp's 16 x 256 fp32 O alone is 128 registers, one CTA an SM with twice
    the ring budgets."""
    if d_head not in D_HEADS:
        raise ValueError(f"the CUDA kernels take head widths {D_HEADS}, got {d_head}")
    wide = d_head // D_HEAD
    stride = d_head + 8
    return Geometry(d_head=d_head, ctas_per_sm=2 if wide == 1 else 1,
                    ring_bytes=RING_BYTES * wide, raw_ring_bytes=RAW_RING_BYTES * wide,
                    stage_bytes=2 * TILE_TOKENS * d_head * 2,
                    q_tile_bytes=MMA_ROWS * d_head * 2, merge_stride=stride,
                    merge_bytes=NWARPS * MMA_ROWS * (stride + 2) * 4)


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """A launch of the split kernel: ``row_blocks`` CTAs of up to 16 rows
    over a (sequence, KV head)'s rows, chunks of ``chunk_tokens`` tokens
    through a ring of ``slots`` slots of ``slot_bytes`` (a chunk's K and V),
    ``smem`` bytes of dynamic shared memory, ``ctas_per_sm`` resident CTAs
    an SM, and ``splits`` splits of ``pages_per_split`` page-table columns;
    ``grid`` (batch, kv_heads, splits x row_blocks); ``d_head`` its head
    width."""
    row_blocks: int
    chunk_tokens: int
    slot_bytes: int
    slots: int
    smem: int
    ctas_per_sm: int
    splits: int
    pages_per_split: int
    grid: tuple
    d_head: int = D_HEAD

    @property
    def gather(self) -> bool:
        """The gather walk (``paged_decode_gather_kernel``): tiles of 64
        consecutive positions copied across pages; ``chunk_tokens`` 0."""
        return self.chunk_tokens == 0

    def columns(self, split: int, pages_per_seq: int) -> range:
        """The page-table columns split ``split`` owns (before the kernel
        clips them to the pages its sequence's rows can see)."""
        return range(split * self.pages_per_split,
                     min((split + 1) * self.pages_per_split, pages_per_seq))

    def workspace_floats(self, batch: int, kv_heads: int, rows: int) -> tuple[int, int]:
        """fp32 values of the splits' partials: O (batch * kv_heads, splits,
        rows, d_head), then m and l (..., 2); (0, 0) with one split (the
        split kernel writes the output itself)."""
        if self.splits == 1:
            return 0, 0
        pairs = batch * kv_heads * self.splits * rows
        return pairs * self.d_head, pairs * 2


def chunk_tokens(mode: int, page_size: int) -> int:
    """Tokens of a ring slot's chunk on the chunk walk (``walk_chunk_tokens``
    in the kernel), always a multiple of 8: a page of up to 64 tokens, else
    runs of 64 (the page size a multiple of 64); an int4 page whole, up to
    ``INT4_WHOLE_PAGE`` tokens; 0 where the page size takes the gather walk
    (a page size not a multiple of 8, above 64 and not a multiple of 64, or
    an int4 page above ``INT4_WHOLE_PAGE``)."""
    if page_size % 8:
        return 0
    if mode == MODES["int4"][0]:
        return page_size if page_size <= INT4_WHOLE_PAGE else 0
    if page_size <= TILE_TOKENS:
        return page_size
    return TILE_TOKENS if page_size % TILE_TOKENS == 0 else 0


def gather_row_bytes(store: int, d_head: int) -> int:
    """Bytes of a token's row in a gather slot of K (or V): a dense row, or
    one stored row (an int4 row holds the token in one of its nibbles)."""
    return 2 * d_head if store == MODES["dense"][0] else d_head


@functools.lru_cache(maxsize=4096)
def plan(batch: int, kv_heads: int, rows: int, pages_per_seq: int, page_size: int,
         mode: int, sm_count: int, splits: int = 0, d_head: int = D_HEAD) -> PagedPlan:
    """The split kernel's launch for ``rows`` rows a KV head (group x t),
    the kernel's ``mode`` number (0 dense, 1 int8, 2 fp8, 3 int4, 4 int8
    compute) and head width ``d_head`` (128 or 256): a function of shapes
    only, never of lengths or page ids.
    ``splits`` > 0 forces the split count (capped at the columns); 0 takes
    enough splits to fill ``WAVES`` waves of the card's CTA slots (the
    (sequence, KV head, row block) CTAs alone are far fewer at decode, and
    the splits of short sequences see no page and end at once), but no
    fewer than ``MIN_SPLIT_TOKENS`` table tokens a split (by walk)."""
    geo = geometry(d_head)
    store = MODES["int8"][0] if mode == MODE_INT8C else mode
    dense = store == MODES["dense"][0]
    row_blocks = -(-rows // MMA_ROWS)
    tokens = chunk_tokens(store, page_size)
    if tokens:  # the chunk walk
        stored = tokens // 2 if store == MODES["int4"][0] else tokens
        slot_bytes = 2 * stored * d_head * (2 if dense else 1)
        budget = geo.ring_bytes if dense else geo.raw_ring_bytes
        tiles = 0 if dense else geo.stage_bytes
    else:  # the gather walk: raw slots of 64 token rows, the bf16 tile, the factors
        slot_bytes = 2 * TILE_TOKENS * gather_row_bytes(store, d_head)
        budget = geo.raw_ring_bytes
        tiles = geo.stage_bytes + FAC_BYTES
    slots = max(MIN_SLOTS, min(MAX_SLOTS, budget // slot_bytes))
    smem = ALIGN_SLACK + geo.q_tile_bytes + max(tiles + slots * slot_bytes, geo.merge_bytes)
    ctas_per_sm = max(1, min(geo.ctas_per_sm,
                             SM_SMEM // (smem + STATIC_RESERVE + CTA_RESERVED)))
    cols = max(pages_per_seq, 1)
    if splits <= 0:
        walk = "gather" if not tokens else "dense" if dense else "quantized"
        splits = min(-(-WAVES * ctas_per_sm * sm_count // (batch * kv_heads * row_blocks)),
                     max(1, cols * page_size // MIN_SPLIT_TOKENS[walk]))
    per = -(-cols // max(1, min(splits, cols)))
    splits = -(-cols // per)
    return PagedPlan(row_blocks=row_blocks, chunk_tokens=tokens, slot_bytes=slot_bytes,
                     slots=slots, smem=smem, ctas_per_sm=ctas_per_sm, splits=splits,
                     pages_per_split=per, grid=(batch, kv_heads, splits * row_blocks),
                     d_head=d_head)


def kernel_name(q_tokens: int, int8_compute: bool) -> str:
    """The launch-count name of a call with ``q_tokens`` query tokens."""
    if q_tokens > 1:
        return KERNEL_MULTI_INT8C if int8_compute else KERNEL_MULTI
    return KERNEL_INT8C if int8_compute else KERNEL


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.bfloat16) -> ctypes.CDLL:
    lib = _build.load(_build.typed_source(SOURCE, dtype, "K4/K5"))
    lib.fa_paged_decode_split.restype = _I32
    lib.fa_paged_decode_split.argtypes = ([_PTR] * 8 + [_I32] * 8 + [_F32, _F32]
                                          + [_I32] * 4 + [_PTR] * 3)
    lib.fa_paged_decode_merge.restype = _I32
    lib.fa_paged_decode_merge.argtypes = [_PTR] * 3 + [_I32] * 6 + [_PTR]
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
    arithmetic page by page in page order (:func:`_int8_compute_partials`),
    normalised. Returns (kv_heads, rows, d) fp32."""
    acc, l_sum, _ = _int8_compute_partials(qb, k_pages, v_pages, k_scales, v_scales, idx,
                                           pos0, limit, page_size, scale, window, softcap)
    return torch.where(l_sum > 0, acc / l_sum.clamp_min(1e-30), 0.0)


def _int8_compute_partials(qb, k_pages, v_pages, k_scales, v_scales, idx, pos0,
                           limit, page_size, scale, window, softcap):
    """The JAX ``_loop_kernel``'s int8-compute arithmetic page by page in
    page order (pages ``idx``, the first at token ``pos0``): q rows
    quantized by :func:`quantize_q_rows`; S = the exact int32 dot x q_scale
    x scale x log2(e) x the page's K scale, then the softcap and the mask;
    P = exp2(S - m) against the running max m after this page, rounded to
    int8 at the constant scale 127; each page's int32 P.V dot times its V
    scale / 127; l the fp32 sum of the unrounded P. The online rescale by
    alpha = exp2(m_old - m_new) is written in its closed form: page i's
    terms are scaled once by exp2(m_i - m_last). Integer products are exact
    in fp32 (|sums| < 2^24). Returns (acc (kv_heads, rows, d), l (kv_heads,
    rows, 1), m_last (kv_heads, rows, 1), -inf for a row that saw no
    token), acc and l relative to exp2(m_last)."""
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
    return acc, l_sum, m_run[..., -1:]


def paged_decode_attention_split_plain(q, k_pages, v_pages, lengths, page_tables, *,
                                       pages_per_split: int, scale: float,
                                       window: int = 0, softcap: float = 0.0,
                                       mode: str = "dense", k_scales=None,
                                       v_scales=None, int8_compute: bool = False):
    """Plain PyTorch version of the split kernel and its merge: split s
    takes page-table columns [s * pages_per_split, (s + 1) *
    pages_per_split), clipped to the pages its sequence's rows can see, and
    gives each row its partial (O, m, l) in fp32 and the log2 domain (m =
    -inf, l = 0 where the row sees none of the split's tokens; with
    ``int8_compute``, :func:`_int8_compute_partials` on the split's pages);
    the merge takes out = sum_s exp2(m_s - M) O_s / sum_s exp2(m_s - M) l_s
    in split order (M the largest m_s; zeros where the sums are 0). The
    same arguments and result as :func:`paged_decode_attention_plain`."""
    single = q.ndim == 3
    q4 = q[:, :, None] if single else q
    batch, heads, t, d = q4.shape
    kv_heads = k_pages.shape[0]
    page_size = k_pages.shape[2] * (2 if mode == "int4" else 1)
    group = heads // kv_heads
    cols = page_tables.shape[1]
    splits = -(-max(cols, 1) // pages_per_split)
    out = torch.zeros_like(q4)
    lengths_l = [int(x) for x in lengths.tolist()]
    tables = page_tables.tolist()
    neg_inf = float("-inf")
    for b in range(batch):
        n = lengths_l[b]
        start = max(n - (t - 1) - window, 0) if window else 0
        qb = q4[b].float().reshape(kv_heads, group * t, d)
        j = torch.arange(group * t, device=q.device)[:, None] % t
        limit = n - (t - 1) + j  # (R, 1)
        parts = []  # (O, m, l) per split
        for s in range(splits):
            c0 = max(s * pages_per_split, start // page_size)
            c1 = min((s + 1) * pages_per_split, cols, -(-n // page_size))
            if c1 <= c0:
                parts.append((torch.zeros(kv_heads, group * t, d, device=q.device),
                              torch.full((kv_heads, group * t, 1), neg_inf, device=q.device),
                              torch.zeros(kv_heads, group * t, 1, device=q.device)))
                continue
            idx = torch.as_tensor(tables[b][c0:c1], device=k_pages.device)
            if int8_compute:
                acc, l_s, m_s = _int8_compute_partials(
                    qb, k_pages, v_pages, k_scales, v_scales, idx, c0 * page_size, limit,
                    page_size, scale, window, softcap)
                parts.append((acc, m_s, l_s))
                continue
            k = _page_values(k_pages, k_scales, idx, mode)
            v = _page_values(v_pages, v_scales, idx, mode)
            pos = c0 * page_size + torch.arange(k.shape[1], device=q.device)[None, :]
            keep = (pos < limit) & (pos < n)
            if window:
                keep &= pos >= limit - window
            sc = torch.matmul(qb, k.transpose(-1, -2)) * scale
            if softcap:
                sc = torch.tanh(sc / softcap) * softcap
            sc = (sc * LOG2E).masked_fill(~keep, neg_inf)
            m_s = sc.amax(-1, keepdim=True)
            p = torch.exp2(sc - torch.where(m_s == neg_inf, 0.0, m_s))
            # A select, not a product: slots the rows cannot see hold anything.
            o_s = torch.matmul(p, torch.where(keep.any(0)[:, None], v, 0.0))
            parts.append((o_s, m_s, p.sum(-1, keepdim=True)))
        m_all = torch.stack([m for _, m, _ in parts])  # (splits, kvh, R, 1)
        m_max = m_all.amax(0)
        w = torch.where(m_all == neg_inf, 0.0,
                        torch.exp2(m_all - torch.where(m_max == neg_inf, 0.0, m_max)))
        o = sum(w[i] * parts[i][0] for i in range(splits))
        l_sum = sum(w[i] * parts[i][2] for i in range(splits))
        o = torch.where(l_sum > 0, o / l_sum.clamp_min(1e-30), 0.0)
        out[b] = o.reshape(heads, t, d).to(q.dtype)
    return out[:, :, 0] if single else out


def _launch(q, k_pages, v_pages, lengths, page_tables, scale, window, softcap,
            mode, k_scales, v_scales, int8_compute, splits):
    mode_id, page_dtype = MODES[mode]
    page_dtype = page_dtype or q.dtype
    if k_pages.dtype != page_dtype or v_pages.dtype != page_dtype:
        raise ValueError(f"the CUDA kernel takes {page_dtype} pages for mode {mode!r} "
                         f"and {q.dtype} q, got {k_pages.dtype}/{v_pages.dtype}")
    d_head = q.shape[-1]
    if d_head not in D_HEADS:
        raise ValueError(f"the CUDA kernel's tiles are {' or '.join(map(str, D_HEADS))} "
                         f"wide, got d_head {d_head} (other widths: ROADMAP Queue 2)")
    batch, heads = q.shape[:2]
    q_tokens = q.shape[2] if q.ndim == 4 else 1
    kv_heads, num_pages, rows, _ = k_pages.shape
    page_size = rows * 2 if mode == "int4" else rows
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if mode == "dense":
        k_scales = v_scales = q  # not read by the kernel
    else:
        k_scales = k_scales.to(device=q.device, dtype=torch.float32).contiguous()
        v_scales = v_scales.to(device=q.device, dtype=torch.float32).contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    page_tables = page_tables.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    mode_num = MODE_INT8C if int8_compute else mode_id
    rows = heads // kv_heads * q_tokens
    pl = plan(batch, kv_heads, rows, page_tables.shape[1], page_size, mode_num,
              sm_count(q.device), splits, d_head)
    ws_o = ws_ml = None
    if pl.splits > 1:
        # Each split's partial: O, then m and l, fp32, in one allocation.
        n_o, n_ml = pl.workspace_floats(batch, kv_heads, rows)
        ws = torch.empty(n_o + n_ml, dtype=torch.float32, device=q.device)
        ws_o, ws_ml = ws.data_ptr(), ws.data_ptr() + 4 * n_o
    lib = _lib(q.dtype)  # q's type (bf16, fp16) or ValueError
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.fa_paged_decode_split(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(),
            lengths.data_ptr(), page_tables.data_ptr(), out.data_ptr(),
            batch, heads, kv_heads, num_pages, page_size,
            page_tables.shape[1], q_tokens, d_head, float(scale), float(softcap),
            int(window), mode_num, pl.splits, pl.pages_per_split, ws_o, ws_ml, stream)
    _build.check(lib, rc, "paged_decode_attention")
    _build.launch_counts[kernel_name(q_tokens, int8_compute)] += 1
    if pl.splits > 1:
        rc = lib.fa_paged_decode_merge(ws_o, ws_ml, out.data_ptr(), batch, heads, kv_heads,
                                       q_tokens, pl.splits, d_head, stream)
        _build.check(lib, rc, KERNEL_MERGE)
        _build.launch_counts[KERNEL_MERGE] += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, lengths, page_tables, *,
                           mode: str = "dense", k_scales=None, v_scales=None,
                           scale: float | None = None, int8_compute: bool = False,
                           window: int = 0, softcap: float = 0.0, splits: int = 0):
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
      splits: the KV walk's split count (capped at the page-table columns);
        0 takes :func:`plan`'s. On the CPU a non-zero count runs the plain
        split-and-merge version. The result is the same function.

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
    if splits < 0:
        raise ValueError(f"splits must be >= 0: {splits}")
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        kw = dict(scale=scale, window=window, softcap=softcap, mode=mode,
                  k_scales=k_scales, v_scales=v_scales, int8_compute=int8_compute)
        if splits:
            cols = page_tables.shape[1]
            per = -(-max(cols, 1) // min(splits, max(cols, 1)))
            return paged_decode_attention_split_plain(
                q, k_pages, v_pages, lengths, page_tables, pages_per_split=per, **kw)
        return paged_decode_attention_plain(q, k_pages, v_pages, lengths, page_tables, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, lengths, page_tables, scale, window,
                   softcap, mode, k_scales, v_scales, int8_compute, splits)
