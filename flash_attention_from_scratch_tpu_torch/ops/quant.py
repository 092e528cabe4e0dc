"""Quantized K/V formats: int8, packed int4 and fp8-e4m3, plain PyTorch.

Counterpart of ``flash_attention_from_scratch_tpu/ops/quant.py``: symmetric
abs-max scales and round-half-to-even, with the same bytes as the JAX
package (``torch.round`` and ``jnp.round`` both round half to even). Each
function copies its reference's own arithmetic: these multiply by
``1 / scale``, where the weight and cache writers divide by the scale.

There are three int4 packings in the port, and each caller pairs its own
halves: :class:`QTensor` packs along ``d`` (byte j = column j low, column
j + d/2 high), KV pages pack along the tokens of a page (byte (t, c) = token
t low, token t + page_size/2 high), and quantized weights pack along K
(``ops/quant_matmul.py``). :func:`pack_int4` and :func:`unpack_int4_halves`
only join and split the nibbles of a byte. fp8 is ``torch.float8_e4m3fn``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["QTensor", "KVQuantMode", "quantize_kv", "quantize_kv_pages",
           "unpack_int4_halves", "unpack_int4", "dequantize", "pack_int4",
           "div_const", "QMAX"]

QMAX = {"int8": 127.0, "int4": 7.0, "fp8": 448.0}  # fp8: e4m3 finite max


def div_const(x, c: float):
    """``x / c`` for a constant ``c`` as XLA compiles it under ``jit``: x
    times the fp32 reciprocal of c (which differs from a true division in
    the last bit of some values). The JAX package's abs-max scales divide
    by such constants, so the port's scales take this form to match them
    bit for bit."""
    return x * float(np.float32(1.0) / np.float32(c))


class KVQuantMode:
    INT8 = "int8"
    INT4 = "int4"
    FP8 = "fp8"


@dataclasses.dataclass
class QTensor:
    """values + per-(batch, head) fp32 scales; layout (b, h, s, d).

    For int4, ``values`` packs two signed nibbles per int8 byte along d
    (d/2 bytes per row), half-split: byte j holds column j (low nibble) and
    column j + d/2 (high nibble).
    """

    values: torch.Tensor
    scales: torch.Tensor  # (b, h) float32
    mode: str
    orig_dtype: torch.dtype = torch.bfloat16

    @property
    def shape(self):
        return self.values.shape

    @property
    def seq_len(self) -> int:
        return self.values.shape[2]


def pack_int4(lo, hi):
    """Two tensors of nibble values in [-8, 7] -> one int8 tensor of bytes
    (lo in bits 0-3, hi in bits 4-7), as ``(lo & 0xF) | ((hi & 0xF) << 4)``
    in int8 two's complement."""
    b = (lo.to(torch.int32) & 0x0F) | ((hi.to(torch.int32) & 0x0F) << 4)
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def unpack_int4_halves(packed, out_dtype=torch.float32):
    """Bytes (...) -> (lo, hi) signed nibble values, each shaped like
    ``packed``; -8 included."""
    b = packed.to(torch.int32)
    lo = ((b & 0x0F) ^ 8) - 8
    hi = (((b >> 4) & 0x0F) ^ 8) - 8
    return lo.to(out_dtype), hi.to(out_dtype)


def unpack_int4(packed, out_dtype=torch.float32):
    """Half-split int4 (..., d/2) -> (..., d): low nibbles are columns
    [0, d/2), high nibbles [d/2, d)."""
    lo, hi = unpack_int4_halves(packed, out_dtype)
    return torch.cat([lo, hi], dim=-1)


def _quantize(xf, inv, mode: str):
    if mode == "int8":
        return torch.clamp(torch.round(xf * inv), -127, 127).to(torch.int8)
    if mode == "int4":
        return torch.clamp(torch.round(xf * inv), -7, 7).to(torch.int8)
    if mode == "fp8":
        return (xf * inv).to(torch.float8_e4m3fn)
    raise ValueError(f"unknown quant mode {mode!r}")


def quantize_kv(x, mode: str = "int8") -> QTensor:
    """Symmetric per-(batch, head) quantization of a (b, h, s, d) tensor."""
    xf = x.float()
    absmax = xf.abs().amax(dim=(2, 3))  # (b, h)
    scale = torch.clamp_min(div_const(absmax, QMAX[mode]), 1e-12)
    inv = (1.0 / scale)[:, :, None, None]
    vals = _quantize(xf, inv, mode)
    if mode == "int4":
        d = vals.shape[-1]
        vals = pack_int4(vals[..., : d // 2], vals[..., d // 2:])
    return QTensor(vals, scale, mode, x.dtype)


def quantize_kv_pages(pages, mode: str = "int8"):
    """Quantize a KV page pool (kv_heads, num_pages, page_size, d).

    Scales are per (kv_head, page). int4 packs along the tokens of a page:
    byte (t, c) holds token t (low nibble) and token t + page_size/2 (high),
    the layout the paged decode kernel reads. Returns (values, scales).
    """
    xf = pages.float()
    absmax = xf.abs().amax(dim=(2, 3))  # (kv_heads, num_pages)
    scale = torch.clamp_min(div_const(absmax, QMAX[mode]), 1e-12)
    inv = (1.0 / scale)[:, :, None, None]
    vals = _quantize(xf, inv, mode)
    if mode == "int4":
        ps = vals.shape[2]
        vals = pack_int4(vals[:, :, : ps // 2], vals[:, :, ps // 2:])
    return vals, scale


def dequantize(qt: QTensor):
    """Full dequantization to ``qt.orig_dtype`` (tests and debugging)."""
    s = qt.scales[:, :, None, None]
    vals = unpack_int4(qt.values) if qt.mode == "int4" else qt.values.float()
    return (vals * s).to(qt.orig_dtype)
