"""Quantized matmuls: int8 / packed-int4 weights, bf16 or int8 activations.

Counterpart of ``flash_attention_from_scratch_tpu/ops/quant_matmul.py``.
Weights are per-output-channel symmetric: ``values`` (K, N) int8, or
(K/2, N) for int4 half-split along K (byte (k, n) packs W[k, n] in the low
nibble and W[k + K/2, n] in the high nibble), plus ``scales`` (N,) fp32.
Four TPU kernels compute the products, and each has a Hopper kernel in
``csrc/quant_matmul.cu``:

- K6 ``_qmm_kernel_int8`` (and its loop order ``_nlast``): x @ int8 W;
- K7 ``_qmm_kernel_int4``: x @ int4 W;
- K8 ``_qmm_kernel_int8_a8``: W8A8, int8 x int8 -> exact int32, then
  ``acc * xs[row] * s[col]``;
- K9 ``_qmm_kernel_int4_a8``: W4A8, the same with int4 W.

The weight-only kernels accumulate ``x @ W`` in fp32 and scale each column
at the end; the a8 recipe quantizes activations per row
(:func:`quantize_activations`, plain jnp in the JAX package) and sums int8
products exactly in int32. On the card all four are one wgmma kernel with
the weight built in registers (dequantized to x's type for K6/K7, byte-
transposed int8 for K8/K9), launched as :func:`plan` says; x and the
output are bf16, or fp16 from the same kernels built for fp16
(``csrc/quant_matmul_f16.cu``; fp32 raises ``ValueError``); a K8/K9 call
first quantizes x with one kernel of its own (:func:`quantize_rows`). For a
CPU tensor the wrapper runs :func:`quant_matmul_plain`; for a CUDA tensor it
launches the kernels or raises (there is no plain fallback on the card).

The kernels take every (K, N) that :func:`quantize_weight` makes (int4: K
even, as the JAX package's halves need). TMA reads rows only at strides of
16-byte multiples, so :class:`QuantizedWeight` stores ``values`` of N % 16
!= 0 once as the (K, N) view of a buffer whose rows are padded to such a
stride (:func:`tma_rows`); ``shape`` and every function keep the logical
(K, N), and no call copies or pads a weight. An x of K % 8 != 0 (int8 x of
the a8 recipe: K % 16) is copied into padded rows on the call, and so is
one whose int4 high half would start off that quantum (K/2 % 8, or % 16).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from . import _build
from ..utils.device import sm_count
from .quant import div_const, pack_int4, unpack_int4_halves

__all__ = ["QuantizedWeight", "quantize_weight", "concat_weights",
           "quantize_activations", "quantize_rows", "quant_matmul",
           "quant_matmul_plain", "tma_rows", "KERNELS"]

_QMAX = {"int8": 127.0, "int4": 7.0}
SOURCE = "quant_matmul.cu"
SOURCE_F16 = _build.typed_source(SOURCE, torch.float16, "K6-K9")  # the fp16 library
# Kernel name per (weight mode, activation-quantized): the launch counters.
KERNELS = {("int8", False): "quant_matmul_int8",       # K6
           ("int4", False): "quant_matmul_int4",       # K7
           ("int8", True): "quant_matmul_int8_a8",     # K8
           ("int4", True): "quant_matmul_int4_a8"}     # K9

_I32, _PTR = ctypes.c_int, ctypes.c_void_p
ROW_BYTES = 16  # TMA's quantum of a row stride, and of a row's alignment


def _tma_readable(t) -> bool:
    """``t`` (rows, cols) is read by TMA as it lies: elements contiguous
    within a row, rows a multiple of 16 bytes apart, the first 16-byte
    aligned."""
    row = t.stride(0) * t.element_size()
    return ((t.stride(1) == 1 or t.shape[1] <= 1) and t.stride(0) >= t.shape[1]
            and row % ROW_BYTES == 0 and t.data_ptr() % ROW_BYTES == 0)


def tma_rows(values):
    """A (rows, N) int8 weight as the kernels read it: ``values`` itself when
    TMA can read it as it lies, else its (rows, N) view of a zero-padded
    (rows, N rounded up to 16) buffer, written here once. The view's values
    are ``values``'; only its row stride differs."""
    if (not isinstance(values, torch.Tensor) or values.ndim != 2
            or values.dtype != torch.int8 or _tma_readable(values)):
        return values
    rows, n = values.shape
    buf = values.new_zeros((rows, -(-n // ROW_BYTES) * ROW_BYTES))
    buf[:, :n] = values
    return buf[:, :n]


@dataclasses.dataclass
class QuantizedWeight:
    """values (K, N) int8 (int4: (K/2, N) packed) + per-column scales (N,).

    ``act`` records the matmul recipe: "bf16" = weight-only, "int8" = also
    quantize activations per row and multiply int8 x int8 (W8A8 / W4A8).
    ``values`` is laid out for the kernels when the weight is made
    (:func:`tma_rows`): a weight of N % 16 != 0 is the (K, N) view of rows
    padded to 16 bytes.
    """

    values: torch.Tensor
    scales: torch.Tensor
    mode: str
    orig_dtype: torch.dtype = torch.bfloat16
    act: str = "bf16"

    def __post_init__(self):
        self.values = tma_rows(self.values)

    @property
    def k_dim(self) -> int:
        return self.values.shape[0] * (2 if self.mode == "int4" else 1)

    @property
    def shape(self):
        return (self.k_dim, self.values.shape[1])

    def stored_columns(self, dtype=torch.float32):
        """The (K, N) unscaled values (int4 halves unpacked) in ``dtype``."""
        if self.mode == "int4":
            lo, hi = unpack_int4_halves(self.values, dtype)
            return torch.cat([lo, hi], dim=0)
        return self.values.to(dtype)

    def dequantize(self):
        return (self.stored_columns() * self.scales[None, :].float()).to(
            self.orig_dtype)


def quantize_weight(w, mode: str = "int8", act: str = "bf16") -> QuantizedWeight:
    """Symmetric per-output-channel quantization of a (K, N) weight."""
    if mode not in _QMAX:
        raise ValueError(f"unknown weight quant mode {mode!r}")
    wf = w.float()
    scale = torch.clamp_min(div_const(wf.abs().amax(dim=0), _QMAX[mode]), 1e-12)
    q = torch.round(wf / scale[None, :])
    if mode == "int8":
        vals = torch.clamp(q, -127, 127).to(torch.int8)
    else:
        q = torch.clamp(q, -7, 7)
        k = q.shape[0]
        vals = pack_int4(q[: k // 2], q[k // 2:])
    return QuantizedWeight(vals, scale, mode, w.dtype, act)


def concat_weights(ws) -> QuantizedWeight:
    """Concatenate quantized weights along N (output channels); exact, since
    the scales are per output channel."""
    modes = {w.mode for w in ws}
    ks = {w.k_dim for w in ws}
    if len(modes) != 1 or len(ks) != 1:
        raise ValueError(f"cannot concat: modes={modes} k_dims={ks}")
    return QuantizedWeight(torch.cat([w.values for w in ws], dim=1),
                           torch.cat([w.scales for w in ws], dim=0),
                           ws[0].mode, ws[0].orig_dtype, ws[0].act)


def quantize_activations(x, *, qmax: float = 127.0):
    """Per-row symmetric int8 quantization of (..., K) activations.

    Returns ``(x_q int8, scales fp32 (..., 1))``.
    """
    xf = x.float()
    scales = torch.clamp_min(div_const(xf.abs().amax(dim=-1, keepdim=True), qmax),
                             1e-12)
    x_q = torch.clamp(torch.round(xf / scales), -qmax, qmax).to(torch.int8)
    return x_q, scales


def quant_matmul_plain(x2, wq: QuantizedWeight, act_quant: bool = False,
                       out_dtype=None):
    """Plain PyTorch version on 2-D ``x2`` (m, K).

    Weight-only: the weight dequantized in fp32, an fp32 product, one cast.
    a8: the exact integer product (in float64, exact below 2**53), then
    ``acc * xs * s`` in fp32 in that order, then the cast. ``out_dtype``
    (default: x2's dtype) is the fp32 result's cast; pass torch.float32 for
    the uncast product.
    """
    out_dtype = out_dtype or x2.dtype
    if act_quant:
        x_q, xs = quantize_activations(x2)
        acc = x_q.double() @ wq.stored_columns(torch.float64)
        out = acc.float() * xs * wq.scales[None, :].float()
        return out.to(out_dtype)
    deq = wq.stored_columns() * wq.scales[None, :].float()
    return (x2.float() @ deq).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _lib(dtype: torch.dtype = torch.bfloat16) -> ctypes.CDLL:
    lib = _build.load(_build.typed_source(SOURCE, dtype, "K6-K9"))
    lib.fa_quant_matmul.restype = _I32
    lib.fa_quant_matmul.argtypes = [_PTR] * 6 + [_I32] * 10 + [_PTR]
    lib.fa_quantize_rows.restype = _I32
    lib.fa_quantize_rows.argtypes = [_PTR] * 3 + [_I32] * 2 + [_PTR]
    return lib


# The kernel's CTA geometry, as csrc/quant_matmul.cu's WTile has it (the
# kernel sizes its own ring from it; tests/test_torch_quant_matmul_plan.py
# holds these to the source). The plan needs it to count CTAs; a mismatch
# would cost speed, never correctness, since the kernel cuts the K walk
# itself.
TILE_COLS = 128        # weight columns per consumer warpgroup (WBN)
# Stored weight rows per K tile (a stage): the K values of one 128-byte x
# box row (XROW), 64 bf16 for K6/K7, 128 int8 for K8/K9.
STAGE_ROWS = {False: 64, True: 128}
TOKEN_TILES = (16, 32, 64, 128)
MAX_SPLITS = 32


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch: ``bt`` tokens and ``cols`` weight columns per CTA (``cols /
    128`` consumer warpgroups), ``per_sm`` CTAs resident on an SM, the K walk
    of ``k_tiles`` stored-row tiles cut into ``splits`` ranges of ``per``
    tiles; ``ctas`` CTAs in all."""

    design: str   # "decode" (bt <= 32: the weight stream) or "prefill"
    bt: int
    cols: int
    per_sm: int
    k_tiles: int
    splits: int
    per: int
    ctas: int


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, w4: bool, sms: int = 132, a8: bool = False) -> Plan:
    """The launch plan of x (m, K) @ W (K, N) on ``sms`` SMs: K6/K7, or
    K8/K9 with ``a8`` (whose K tiles are twice as deep).

    The token tile is the least of ``TOKEN_TILES`` that holds m (128 past
    it, with two warpgroups a CTA and one CTA an SM; below, one warpgroup
    and two CTAs an SM). When the output tiles alone are fewer than
    the CTAs the SMs hold at once, the K walk is split into as many ranges
    as fill them in one wave (at most ``MAX_SPLITS``, every range at least
    one tile), so that each CTA streams a long contiguous run of weight rows
    and none waits for a second wave.
    """
    bt = next((t for t in TOKEN_TILES if m <= t), TOKEN_TILES[-1])
    nwg = 2 if bt == 128 else 1
    per_sm = 1 if nwg == 2 else 2
    k_tiles = -(-(k // 2 if w4 else k) // STAGE_ROWS[a8])
    tiles = -(-m // bt) * -(-n // (nwg * TILE_COLS))
    want = max(1, min(k_tiles, MAX_SPLITS, (per_sm * sms) // tiles))
    per = -(-k_tiles // want)
    splits = -(-k_tiles // per)
    return Plan("decode" if bt <= 32 else "prefill", bt, nwg * TILE_COLS, per_sm,
                k_tiles, splits, per, tiles * splits)


def _aligned(t):
    """t contiguous and 16-byte aligned (TMA and the vector stores)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def quantize_rows(x2):
    """:func:`quantize_activations` of a 2-D bf16 or fp16 ``x2`` (m, K), any
    K: on a CUDA tensor one launch of the kernel of x2's type (the first of
    a K8/K9 call, whose launch count covers it), the same bytes and scales
    bit for bit; on a CPU tensor the plain version."""
    if x2.device.type == "cpu":
        return quantize_activations(x2)
    lib = _lib(x2.dtype)  # raises for fp32
    x_q, xs = _quantize_rows(x2, lib, torch.cuda.current_stream(x2.device).cuda_stream)
    return x_q[:, :x2.shape[1]], xs


def _quantize_rows(x2, lib, stream, quantum: int = 8):
    """The kernel on x2's rows, padded with zeros to a multiple of
    ``quantum`` values where K is not one (a copy of x: zeros change neither
    a row's abs-max nor any quantized value). Returns (x_q (m, K padded),
    xs (m, 1))."""
    m, k = x2.shape
    kp = -(-k // quantum) * quantum
    x_op = _aligned(x2) if kp == k else F.pad(x2, (0, kp - k))
    x_q = torch.empty((m, kp), dtype=torch.int8, device=x2.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x2.device)
    if m:
        rc = lib.fa_quantize_rows(x_op.data_ptr(), x_q.data_ptr(), xs.data_ptr(), m, kp,
                                  stream)
        _build.check(lib, rc, "quantize_rows")
    return x_q, xs


def _tma_x(x2, w4: bool, quantum: int):
    """x (m, K) as the kernels' x map reads it, rows a multiple of
    ``quantum`` values apart: (x, its row stride, the column where an int4
    weight's high half starts). x itself where TMA reads it as it lies;
    else a copy, in rows padded to the quantum where K is not a multiple of
    it; and where an int4 weight's K/2 is not, each half of x in columns of
    its own, padded (zeros), so that the high half's boxes start on the
    quantum too."""
    m, k = x2.shape
    half = k // 2
    if w4 and half % quantum:
        hq = -(-half // quantum) * quantum
        out = x2.new_zeros((m, 2 * hq))
        out[:, :half] = x2[:, :half]
        out[:, hq:hq + half] = x2[:, half:]
        return out, 2 * hq, hq
    if _tma_readable(x2) and x2.stride(0) % quantum == 0:
        return x2, x2.stride(0), half
    kp = -(-k // quantum) * quantum
    return (_aligned(x2), k, half) if kp == k else (F.pad(x2, (0, kp - k)), kp, half)


def _launch(x2, wq: QuantizedWeight, act_quant: bool):
    m, k = x2.shape
    n = wq.values.shape[1]
    lib = _lib(x2.dtype)  # x2's type (bf16, fp16) or ValueError
    values = wq.values
    if values.dtype != torch.int8 or not values.is_cuda or not wq.scales.is_cuda:
        raise ValueError("quantized values must be int8 tensors on the card")
    if not _tma_readable(values):
        raise ValueError("the weight's rows must lie 16-byte aligned, a multiple of 16 bytes "
                         "apart (QuantizedWeight lays them out so when it is made; the "
                         "kernels never copy a weight)")
    w4 = wq.mode == "int4"
    scales = _aligned(wq.scales.float())
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    p = plan(m, n, k, w4, sm_count(x2.device), act_quant)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    if act_quant:  # int8 x: rows and the high half on 16 values, quantized in that layout
        x_l, ldx, xhi = _tma_x(x2.contiguous(), w4, ROW_BYTES)
        x_op, xs = _quantize_rows(x_l, lib, stream, ROW_BYTES)
        xs_ptr, ws_dtype = xs.data_ptr(), torch.int32
    else:
        (x_op, ldx, xhi), xs_ptr, ws_dtype = _tma_x(x2, w4, 8), None, torch.float32
    ws = (torch.empty((p.splits, m, n), device=x2.device, dtype=ws_dtype)
          if p.splits > 1 else out)
    rc = lib.fa_quant_matmul(
        x_op.data_ptr(), xs_ptr, values.data_ptr(), scales.data_ptr(), out.data_ptr(),
        ws.data_ptr(), m, n, k, ldx, values.stride(0), xhi, int(w4), int(act_quant), p.bt,
        p.splits, stream)
    _build.check(lib, rc, "quant_matmul")
    _build.launch_counts[KERNELS[(wq.mode, act_quant)]] += 1
    return out


def quant_matmul(x, wq: QuantizedWeight, *, act_quant: bool = False,
                 n_inner: bool | None = None, block_m: int = 256,
                 block_k: int = 512, block_n: int | None = None):
    """``x @ W`` with W stored int8/int4; (..., K) -> (..., N) in x's dtype.

    ``act_quant=True`` quantizes x per row to int8 and multiplies int8 x
    int8 with exact int32 sums (W8A8 / W4A8). ``n_inner`` and the
    ``block_*`` sizes are the TPU kernel's loop order and tiles: accepted,
    and the Hopper kernel picks its own (the function is the same).
    """
    del n_inner, block_m, block_k, block_n
    if wq.mode not in _QMAX:
        raise ValueError(f"unknown weight quant mode {wq.mode!r}")
    k, n = wq.shape
    if x.shape[-1] != k:
        raise ValueError(f"x has K {x.shape[-1]}, the weight {k}")
    lead = x.shape[:-1]
    m = 1
    for dim in lead:
        m *= dim
    if m == 0 or n == 0:
        return x.new_zeros((*lead, n))
    x2 = x.reshape(m, k)
    if x.device.type == "cpu":
        out = quant_matmul_plain(x2, wq, act_quant)
    elif x.device.type == "cuda":
        out = _launch(x2, wq, act_quant)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out.reshape(*lead, n)
