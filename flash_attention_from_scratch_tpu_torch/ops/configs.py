"""Attention configuration and the analytical FLOP model.

Counterpart of ``flash_attention_from_scratch_tpu/ops/configs.py``, cut to
what changes outputs or validation, and the choice of the KV loop. The TPU
tiling knobs there (block sizes, head packing, split counts, VMEM limits)
have no counterpart: the Hopper kernels' tile sizes are constants of the
kernels (``csrc/*.cu``).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

__all__ = ["DType", "KVLoop", "KernelConfig", "MAX_KV_BUFFERS",
           "calc_self_attn_flop", "calc_causal_attn_flop"]

# The deepest K/V copy ring the FORI kernel is built for
# (``csrc/flash_forward_fori.cu``).
MAX_KV_BUFFERS = 4


class DType(enum.Enum):
    """Element types of Q/K/V."""

    FP32 = torch.float32
    BF16 = torch.bfloat16
    FP16 = torch.float16

    @property
    def torch_dtype(self) -> torch.dtype:
        return self.value

    @classmethod
    def from_torch(cls, dt: torch.dtype) -> "DType":
        try:
            return cls(dt)
        except ValueError:
            raise ValueError(f"unsupported dtype: {dt}") from None


class KVLoop(enum.Enum):
    """Which forward kernel walks the KV tiles.

    GRID: K1 (``csrc/flash_forward.cu``), whose K/V tiles stream through a
    two-stage ``cp.async`` pipeline. FORI: K11 (``csrc/flash_forward_fori.cu``),
    which drives its own K/V copies through a ring of ``num_kv_buffers``
    slots, each completed on its own ``mbarrier``; 1 is synchronous (the
    ladder's ``1_base`` rung). Both compute the same function.
    """

    GRID = "grid"
    FORI = "fori"


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """What the attention computes: mask, scale, softcap and types; and
    which forward kernel computes it.

    ``q_offset``: Q row i sits at global position ``q_offset + i`` and, under
    the causal mask, sees KV columns ``[0, q_offset + i]`` (top-left
    alignment shifted by the offset). ``window``: Q position p sees KV
    positions ``(p - window, p]``; 0 disables. ``attn_softcap``: scores
    become ``cap * tanh(s / cap)`` after scaling; 0 disables. ``scale``:
    None means ``1 / sqrt(d_head)``. ``kv_loop`` and ``num_kv_buffers``
    (1 to ``MAX_KV_BUFFERS``; read by FORI only): see :class:`KVLoop`.
    """

    d_head: int = 128
    dtype: DType = DType.BF16
    causal: bool = False
    q_offset: int = 0
    window: int = 0
    attn_softcap: float = 0.0
    scale: float | None = None
    kv_loop: KVLoop = KVLoop.GRID
    num_kv_buffers: int = 2

    def __post_init__(self):
        if not isinstance(self.kv_loop, KVLoop):
            raise ValueError(f"kv_loop must be a KVLoop, got {self.kv_loop!r}")
        if self.num_kv_buffers < 1:
            raise ValueError("num_kv_buffers must be >= 1 (1 = synchronous copies)")
        if self.num_kv_buffers > MAX_KV_BUFFERS:
            raise ValueError(
                f"num_kv_buffers must be <= {MAX_KV_BUFFERS}, the deepest ring "
                f"the FORI kernel is built for; got {self.num_kv_buffers}")
        if self.q_offset < 0:
            raise ValueError(f"q_offset must be >= 0: {self.q_offset}")
        if self.q_offset and not self.causal:
            raise ValueError("q_offset only applies to causal masking")
        if self.window < 0:
            raise ValueError(f"window must be >= 0: {self.window}")
        if self.window and not self.causal:
            raise ValueError("window only applies to causal masking")
        if self.attn_softcap < 0:
            raise ValueError(f"attn_softcap must be >= 0: {self.attn_softcap}")

    @property
    def softmax_scale(self) -> float:
        return self.scale if self.scale is not None else self.d_head ** -0.5


def calc_self_attn_flop(seq_len: int, d_head: int, n_heads: int,
                        batch: int) -> int:
    """Standard attention FLOPs: ``4*s^2*d + 6*s^2`` per head per sample."""
    return batch * n_heads * (4 * seq_len * seq_len * d_head
                              + 6 * seq_len * seq_len)


def calc_causal_attn_flop(seq_len: int, d_head: int, n_heads: int, batch: int,
                          window: int = 0) -> int:
    """Causal attention FLOPs: only visible (q, kv) pairs count.

    Same per-pair cost as :func:`calc_self_attn_flop` (4*d + 6), summed over
    ``s*(s+1)/2`` pairs, or ``w*s - w*(w-1)/2`` with a sliding window ``w``.
    """
    s = seq_len
    if window and window < s:
        pairs = window * s - window * (window - 1) // 2
    else:
        pairs = s * (s + 1) // 2
    return batch * n_heads * pairs * (4 * d_head + 6)
