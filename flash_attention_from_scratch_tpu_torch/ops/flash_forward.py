"""Flash-attention forward: the wrapper of the Hopper kernels K1 and K11.

Counterpart of ``flash_attention_from_scratch_tpu/ops/flash_forward.py``
``flash_forward`` / ``flash_forward_with_lse``. For a CUDA tensor the
wrapper launches K1 (``csrc/flash_forward.cu``: persistent CTAs over a work
list of (Q tile, head, batch) items, heaviest first; its launch is
:func:`grid_plan`), or K11 (``csrc/flash_forward_fori.cu``, the K/V copy
ring of ``num_kv_buffers`` slots; its launch is :func:`fori_plan`; at d 256
the library ``csrc/flash_forward_fori_d256.cu`` builds) when ``cfg.kv_loop``
is ``KVLoop.FORI``; both take d 128 and 256. bf16 and fp16 (the fp16
libraries ``csrc/flash_forward_f16.cu``, ``csrc/flash_forward_fori_f16.cu``
and ``csrc/flash_forward_fori_d256_f16.cu``: the same sources built for
fp16) run the wgmma + TMA main loop of ``csrc/flash_wgmma.cuh``, P rounded
to the inputs' type as the JAX kernel's ``cast_p_to_dtype``. fp32 runs the
libraries ``csrc/flash_forward_f32.cu``, ``csrc/flash_forward_fori_f32.cu``
and ``csrc/flash_forward_fori_d256_f32.cu`` on the fp32 main loop of
``csrc/flash_f32.cuh``: exact products (3xTF32 on ``mma.sync``, as the JAX
kernel's ``Precision.HIGHEST``), P kept in fp32, one CTA a (Q tile, head,
batch) item for K1 too. For a CPU tensor it runs the plain version,
:func:`flash_forward_plain`, the same function for every kernel. The JAX
package's row-band causal dispatch (``ops/causal_decomp.py``) has no
counterpart: its output is that of a causal kernel that skips the tiles
above the diagonal, which every kernel does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .configs import DType, KernelConfig, KVLoop
from .reference import reference_attention
from ..utils.device import resolve_device, sm_count

__all__ = ["flash_forward", "flash_forward_with_lse", "flash_forward_plain",
           "make_flash_forward", "fori_plan", "grid_plan", "GridPlan", "TilePlan", "KERNEL",
           "KERNEL_FORI", "SEQ_QUANTUM", "D_HEAD", "D_HEADS", "FORI_TILES", "FORI_TILES_F32",
           "GRID_TILES_F32", "tile_bytes"]

KERNEL = "flash_forward"
SOURCE = "flash_forward.cu"
KERNEL_FORI = "flash_forward_fori"
# K11: one library a head width; csrc/flash_forward_fori_d256.cu builds
# flash_forward_fori.cu's kernels at d 256 (FORI_HD there).
SOURCES_FORI = {128: "flash_forward_fori.cu", 256: "flash_forward_fori_d256.cu"}
SOURCE_FORI = SOURCES_FORI[128]
# The fp16 libraries: each bf16 source's kernels built for fp16 (FA_F16).
SOURCE_F16 = _build.typed_source(SOURCE, torch.float16, KERNEL)
SOURCES_FORI_F16 = {d: _build.typed_source(s, torch.float16, KERNEL_FORI)
                    for d, s in SOURCES_FORI.items()}
# The fp32 libraries: K1's and K11's kernels on the fp32 main loop
# (csrc/flash_f32.cuh).
SOURCE_F32 = _build.typed_source(SOURCE, torch.float32, KERNEL)
SOURCES_FORI_F32 = {d: _build.typed_source(s, torch.float32, KERNEL_FORI)
                    for d, s in SOURCES_FORI.items()}
SEQ_QUANTUM = 64  # both kernels take seq_q and seq_kv in multiples of this
D_HEAD = 128      # the narrowest head width; the plain versions take its multiples
D_HEADS = (128, 256)  # the head widths every attention kernel takes (its HD template argument)

# The CTA of the wgmma attention main loop (csrc/flash_wgmma.cuh) at d 128,
# which K1, K11 and K10 share: a producer warpgroup and two consumer
# warpgroups of 64 Q rows each (one at d 256: ``CtaShape<HD>``).
WG_ROWS = 64
CONSUMER_WGS = 2
TILE_ROWS = CONSUMER_WGS * WG_ROWS   # Q rows per CTA
TILE_THREADS = (CONSUMER_WGS + 1) * 128
SMEM_LIMIT = 232448   # shared memory an H100 block may use
ALIGN_SLACK = 1024    # swizzled tiles start at a 1024-byte boundary
MAX_GRID_YZ = 65535   # CUDA's limit on the grid's y (heads) and z (batch)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """A launch of the wgmma attention main loop: ``rows`` Q rows per CTA,
    ``keys`` keys per ring slot, ``slots`` K/V slots, ``smem`` bytes of
    dynamic shared memory, ``grid`` (Q tiles, heads, batch) and ``kv_tiles``
    the KV tiles of the whole walk (the zero-filled tail of the last one
    masked)."""
    rows: int
    keys: int
    slots: int
    smem: int
    grid: tuple
    kv_tiles: int
    threads: int = TILE_THREADS


def tile_bytes(rows: int, d_head: int = D_HEAD, elem_bytes: int = 2) -> int:
    """Bytes of a (rows, d_head) tile of ``elem_bytes``-byte elements (2:
    bf16 or fp16; 4: fp32) in shared memory."""
    return rows * d_head * elem_bytes


# The fp32 main loop (``F32Tile`` in csrc/flash_f32.cuh): consumer warps of
# 16 Q rows and one producer warp.
F32_WARP_ROWS = 16


# K11's CTA and slots (``ForiTile<NB, HD>`` in csrc/flash_forward_fori.cu)
# per head width: (consumer warpgroups of 64 Q rows, keys a slot at depths
# 1-3; depth 4 halves the slot). d 128: two consumer warpgroups, 128-key
# slots; d 256: one consumer warpgroup (its 64 x 256 fp32 O is 128
# registers a thread), 64-key slots (32 at depth 4, whose four 64-key slots
# do not fit).
FORI_TILES = {128: (2, 128), 256: (1, 64)}
# K11 in fp32 (csrc/flash_forward_fori_f32.cu, ``F32Tile<NB, HD, 4, BK>``):
# (consumer warps of 16 Q rows, keys a slot) per head width, every depth.
FORI_TILES_F32 = {128: (4, 32), 256: (4, 16)}


def fori_plan(num_kv_buffers: int, batch: int, heads: int, seq_q: int,
              seq_kv: int, d_head: int = D_HEAD, elem_bytes: int = 2) -> TilePlan:
    """K11's launch at head width ``d_head`` (128 or 256) for elements of
    ``elem_bytes`` bytes. 2 (bf16, fp16): ``ForiTile<NB, HD>`` in
    ``csrc/flash_forward_fori.cu``, a ring of ``num_kv_buffers`` slots of
    BK keys (the K tile, then the V tile) beside the Q tile, BK from
    :data:`FORI_TILES`, halved at depth 4. 4 (fp32): ``F32Tile`` in
    ``csrc/flash_f32.cuh``, 4 consumer warps of 16 rows and a producer warp,
    BK from :data:`FORI_TILES_F32` at every depth."""
    if d_head not in FORI_TILES:
        raise ValueError(f"K11 takes head widths {D_HEADS}, got {d_head}")
    if elem_bytes == 4:
        warps, keys = FORI_TILES_F32[d_head]
        rows, threads = warps * F32_WARP_ROWS, (warps + 1) * 32
    else:
        consumers, keys = FORI_TILES[d_head]
        keys //= 2 if num_kv_buffers == 4 else 1
        rows = consumers * WG_ROWS
        threads = (consumers + 1) * 128
    return TilePlan(
        rows=rows, keys=keys, slots=num_kv_buffers,
        smem=(tile_bytes(rows, d_head, elem_bytes)
              + num_kv_buffers * 2 * tile_bytes(keys, d_head, elem_bytes) + ALIGN_SLACK),
        grid=(-(-seq_q // rows), heads, batch), kv_tiles=-(-seq_kv // keys),
        threads=threads)


# K1's CTA and ring (``GridTile<HD>`` in csrc/flash_forward.cu) per head
# width: (consumer warpgroups of 64 Q rows, keys a slot, slots, Q tiles).
# d 128: two consumer warpgroups, 2 slots of 128 keys, two Q tiles (the
# current work item's and the next one's); d 256: one consumer warpgroup
# (its 64 x 256 fp32 O is 128 registers a thread), 3 slots of 64 keys, one
# Q tile.
GRID_TILES = {128: (2, 128, 2, 2), 256: (1, 64, 3, 1)}
# K1 in fp32 (``GridTileF32<HD>`` in csrc/flash_forward_f32.cu): (consumer
# warps of 16 Q rows, keys a slot, slots, Q tiles) per head width; one CTA
# a work item, not persistent.
GRID_TILES_F32 = {128: (7, 32, 2, 1), 256: (4, 16, 2, 1)}


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """K1's launch: ``ctas`` persistent CTAs (at most one an SM) over
    ``n_items`` work items, each a (Q tile, head, batch) triple of
    ``rows`` Q rows (:meth:`item`: causal, the heaviest Q tile first, then
    head, then batch; otherwise Q tile fastest, so that the CTAs at work
    share one head's K/V). CTA c takes, in round r, item ``r * ctas + c``
    on even rounds and ``r * ctas + ctas - 1 - c`` on odd ones (a snake).
    ``smem`` bytes of dynamic shared memory: ``q_bufs`` Q tiles and
    ``slots`` K/V slots of ``keys`` keys, ``d_head`` wide; ``threads`` a
    producer warpgroup and ``rows / 64`` consumer warpgroups. fp32
    (``elem_bytes`` 4): one CTA an item (``ctas == n_items``; the grid runs
    each head's Q tiles heaviest first), ``threads`` a producer warp and
    ``rows / 16`` consumer warps."""
    rows: int
    keys: int
    slots: int
    q_bufs: int
    smem: int
    ctas: int
    n_items: int
    q_tiles: int
    heads: int
    batch: int
    seq_q: int
    seq_kv: int
    causal: bool
    window: int
    q_offset: int
    threads: int
    d_head: int

    def item(self, w: int) -> tuple[int, int, int]:
        """(Q tile, head, batch) of item ``w`` (``item_at`` in the kernel)."""
        if not self.causal:
            hb, q_tile = divmod(w, self.q_tiles)
            return q_tile, hb % self.heads, hb // self.heads
        per_tile = self.heads * self.batch
        r, hb = divmod(w, per_tile)
        return self.q_tiles - 1 - r, hb % self.heads, hb // self.heads

    def tiles(self, q_tile: int) -> int:
        """KV tiles the kernel loads for a Q tile (``cta_tiles``): a causal
        walk ends at the diagonal, a window starts at the first key a row
        of the tile can see."""
        q0 = q_tile * self.rows
        q_min = self.q_offset + q0
        q_rows = min(self.rows, self.seq_q - q0)
        first, last = 0, -(-self.seq_kv // self.keys) - 1
        if self.causal:
            last = min(last, (q_min + q_rows - 1) // self.keys)
            if self.window:
                first = max(0, q_min - self.window + 1) // self.keys
        return max(last - first + 1, 0)

    def cta_items(self, c: int) -> list[int]:
        """The items CTA ``c`` takes, in order."""
        out, r = [], 0
        while r * self.ctas < self.n_items:
            w = r * self.ctas + (self.ctas - 1 - c if r % 2 else c)
            if w < self.n_items:
                out.append(w)
            r += 1
        return out


@functools.lru_cache(maxsize=1024)
def grid_plan(batch: int, heads: int, seq_q: int, seq_kv: int, causal: bool,
              window: int, q_offset: int, sm_count: int, d_head: int = D_HEAD,
              elem_bytes: int = 2) -> GridPlan:
    """K1's launch at head width ``d_head`` (128 or 256) for elements of
    ``elem_bytes`` bytes: 2 (bf16, fp16), ``GridTile<HD>`` and
    ``fa_flash_forward_ctas`` in ``csrc/flash_forward.cu``, min(items,
    sm_count) persistent CTAs; 4 (fp32), ``GridTileF32<HD>`` in
    ``csrc/flash_forward_f32.cu``, one CTA an item."""
    if d_head not in GRID_TILES:
        raise ValueError(f"K1 takes head widths {D_HEADS}, got {d_head}")
    if elem_bytes == 4:
        warps, keys, slots, q_bufs = GRID_TILES_F32[d_head]
        rows, threads = warps * F32_WARP_ROWS, (warps + 1) * 32
    else:
        consumers, keys, slots, q_bufs = GRID_TILES[d_head]
        rows, threads = consumers * WG_ROWS, (consumers + 1) * 128
    q_tiles = -(-seq_q // rows)
    n_items = q_tiles * heads * batch
    return GridPlan(
        rows=rows, keys=keys, slots=slots, q_bufs=q_bufs,
        smem=(q_bufs * tile_bytes(rows, d_head, elem_bytes)
              + slots * 2 * tile_bytes(keys, d_head, elem_bytes) + ALIGN_SLACK),
        ctas=n_items if elem_bytes == 4 else min(n_items, sm_count), n_items=n_items,
        q_tiles=q_tiles, heads=heads, batch=batch, seq_q=seq_q, seq_kv=seq_kv,
        causal=bool(causal), window=window if causal else 0, q_offset=q_offset,
        threads=threads, d_head=d_head)


def check_grid(plan: TilePlan) -> None:
    """Raise ValueError where CUDA cannot launch the plan's grid."""
    if max(plan.grid[1:]) > MAX_GRID_YZ:
        raise ValueError(f"heads and batch must be at most {MAX_GRID_YZ}: grid "
                         f"{plan.grid}")

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


# The C entries' arguments, one list for every library of K1 and K11.
_ARGTYPES = [_PTR] * 6 + [_I64] * 12 + [_I32] * 8 + [_F32, _F32]


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.bfloat16) -> ctypes.CDLL:
    lib = _build.load(_build.typed_source(SOURCE, dtype, KERNEL))
    lib.fa_flash_forward_ctas.restype = _I32
    lib.fa_flash_forward_ctas.argtypes = _ARGTYPES + [_I32, _I32, _PTR]
    return lib


@functools.lru_cache(maxsize=None)
def _fori_lib(d_head: int, dtype: torch.dtype = torch.bfloat16) -> ctypes.CDLL:
    lib = _build.load(_build.typed_source(SOURCES_FORI[d_head], dtype, KERNEL_FORI))
    lib.fa_flash_forward_fori.restype = _I32
    lib.fa_flash_forward_fori.argtypes = _ARGTYPES + [_I32, _I32, _PTR]
    return lib


def _strides(x):
    return [_I64(s) for s in x.stride()[:3]]


def _kernel_layout(t) -> bool:
    """Does t have the layout the kernels read: d contiguous, rows 16-byte
    aligned?"""
    return (t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _launch(q, k, v, cfg: KernelConfig, sinks, want_lse: bool, ctas: int | None = None):
    """Launch K1 or K11 from the library of q's type (bf16, fp16 or fp32;
    the output in that type). ``ctas`` (K1 only): 0 launches one CTA per
    work item (a plain grid) in place of :func:`grid_plan`'s persistent
    CTAs; fp32's K1 always runs one CTA an item."""
    d_head = q.shape[3]
    fori = cfg.kv_loop == KVLoop.FORI
    if d_head not in D_HEADS:
        raise ValueError(f"{'K11' if fori else 'K1'}'s tiles are "
                         f"{' or '.join(map(str, D_HEADS))} wide, got d_head {d_head} "
                         "(other widths: ROADMAP Queue 2, coverage item 1)")
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
    if fori:
        check_grid(fori_plan(cfg.num_kv_buffers, b, h, sq, skv, d_head, q.element_size()))
        lib, name = _fori_lib(d_head, q.dtype), KERNEL_FORI
        rc = lib.fa_flash_forward_fori(*args, d_head, cfg.num_kv_buffers, stream)
    else:
        if ctas is None:
            ctas = grid_plan(b, h, sq, skv, cfg.causal, cfg.window, cfg.q_offset,
                             sm_count(q.device), d_head, q.element_size()).ctas
        lib, name = _lib(q.dtype), KERNEL
        rc = lib.fa_flash_forward_ctas(*args, d_head, ctas, stream)
    _build.check(lib, rc, name)
    _build.launch_counts[name] += 1
    return out, lse


def _default_cfg(q) -> KernelConfig:
    return KernelConfig(d_head=q.shape[-1], dtype=DType.from_torch(q.dtype))


def _resolve(q, cfg: KernelConfig | None, scale: float | None) -> KernelConfig:
    """The call's config: ``scale``, when given, overrides ``cfg.scale``."""
    cfg = cfg or _default_cfg(q)
    return cfg if scale is None else dataclasses.replace(cfg, scale=scale)


def _forward(q, k, v, cfg: KernelConfig, sinks, want_lse: bool):
    _validate(cfg, q, k, v, sinks)
    if cfg.decompose and k.shape[2] == q.shape[2] + cfg.q_offset:
        return _banded(q, k, v, cfg, sinks)
    return _single(q, k, v, cfg, sinks, want_lse)


def _banded(q, k, v, cfg: KernelConfig, sinks):
    """The row-band dispatch; sinks fold in at the end, as in the JAX
    package's ``_cached_decomposed``: the bands are sink-free, then
    lse' = logaddexp(lse, z) and O rescales by exp(lse - lse')."""
    from .causal_decomp import causal_forward_banded

    out, lse = causal_forward_banded(q, k, v, cfg)
    if sinks is not None:
        lse_tot = torch.logaddexp(lse, sinks.float()[None, :, None])
        out = (out.float() * torch.exp(lse - lse_tot)[..., None]).to(out.dtype)
        lse = lse_tot
    return out, lse


def _single(q, k, v, cfg: KernelConfig, sinks, want_lse: bool):
    """One K1 (or K11) call on validated inputs, or its plain version."""
    if q.device.type == "cpu":
        out, lse = flash_forward_plain(q, k, v, cfg, sinks)
    elif q.device.type == "cuda":
        out, lse = _launch(q, k, v, cfg, sinks, want_lse)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out.to(cfg.resolved_out_dtype.torch_dtype), lse


def flash_forward_with_lse(q, k, v, cfg: KernelConfig | None = None,
                           sinks=None, *, scale: float | None = None):
    """Forward pass that also returns the per-row log-sum-exp.

    ``lse`` is (batch, heads, seq_q) fp32, the natural log of the sum of
    exp(scaled scores) over each row, sink term included. ``scale``
    overrides ``cfg.scale``.
    """
    return _forward(q, k, v, _resolve(q, cfg, scale), sinks, want_lse=True)


def flash_forward(q, k, v, cfg: KernelConfig | None = None, sinks=None, *,
                  scale: float | None = None):
    """softmax(Q K^T * scale) V. Inputs (batch, heads, seq, d_head).

    K/V may have fewer heads than Q (GQA: Q head h reads KV head
    h // (heads // kv_heads)). ``sinks`` ((heads,) fp32): per-head logits
    that join the softmax denominator only. ``scale`` overrides
    ``cfg.scale``. The output has q's shape and strides, in
    ``cfg.out_dtype`` (default q's dtype).
    """
    return _forward(q, k, v, _resolve(q, cfg, scale), sinks, want_lse=False)[0]


def make_flash_forward(cfg: KernelConfig, batch: int, heads: int, seq_q: int,
                       seq_kv: int, scale: float | None = None, *,
                       kv_heads: int | None = None, return_lse: bool = False,
                       has_sinks: bool = False, device="cuda",
                       interpret: bool | None = None, debug: bool = False):
    """A callable bound to one kernel and one shape, the counterpart of the
    JAX package's ``make_flash_forward`` (one ``pallas_call``): ``call(q, k, v[, sinks])``
    runs K1 (or K11 for ``kv_loop=KVLoop.FORI``) on q (batch, heads, seq_q,
    d) and k, v (batch, kv_heads, seq_kv, d) on ``device`` (the card by
    default; the plain version on the CPU) and returns the output, or
    (output, lse (batch, heads, seq_q)) with ``return_lse``. The call is
    one kernel launch: ``decompose`` does not band it. Inputs of another
    shape or device raise ``ValueError``. ``interpret`` and ``debug`` (the
    TPU's interpret mode and debug prints) are accepted and ignored."""
    del interpret, debug
    dev = resolve_device(device)
    kv_heads = kv_heads or heads
    cfg = cfg if scale is None else dataclasses.replace(cfg, scale=scale)
    q_shape = (batch, heads, seq_q, cfg.d_head)
    kv_shape = (batch, kv_heads, seq_kv, cfg.d_head)

    def call(q, k, v, *sinks):
        if len(sinks) != int(has_sinks):
            raise ValueError(f"the call takes {'one' if has_sinks else 'no'} sinks "
                             f"tensor, got {len(sinks)}")
        if (tuple(q.shape), tuple(k.shape), tuple(v.shape)) != (q_shape, kv_shape, kv_shape):
            raise ValueError(f"bound to q {q_shape} and k/v {kv_shape}, got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        if q.device.type != dev.type:
            raise ValueError(f"bound to {dev}, got tensors on {q.device}")
        s = sinks[0] if sinks else None
        _validate(cfg, q, k, v, s)
        out, lse = _single(q, k, v, cfg, s, return_lse)
        return (out, lse) if return_lse else out

    return call
