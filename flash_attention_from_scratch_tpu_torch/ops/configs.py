"""Attention configuration and the analytical FLOP model.

Counterpart of ``flash_attention_from_scratch_tpu/ops/configs.py``. The
config takes every field of the JAX one. The TPU tiling and schedule knobs
there (block sizes, softmax variants, head packing, split counts, VMEM
limits) are hints the Hopper kernels ignore, validated as the JAX package
validates them: the kernels' tile sizes are their own constants
(``csrc/*.cu``), and every knob computes the same function.
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

    @property
    def min_tile(self) -> tuple[int, int]:
        """The TPU's smallest (sublane, lane) tile of this type: what the JAX
        config's ``q_splits`` check divides by."""
        return (8, 128) if self is DType.FP32 else (16, 128)

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
    None means ``1 / sqrt(d_head)``. ``out_dtype``: the output's type (None:
    ``dtype``). ``kv_loop`` and ``num_kv_buffers`` (1 to ``MAX_KV_BUFFERS``;
    read by FORI only): see :class:`KVLoop`.

    The TPU knobs (``block_q`` to ``mask_elide``, ``vmem_limit_mb``) are
    hints: the Hopper kernels ignore them, and the JAX checks on them hold.
    ``scale_q`` stays a no-op: the port scales the fp32 scores, the exact
    function. ``optimized_softmax`` defaults to False here (True in JAX,
    whose first-block specialization refuses a window), so a window needs
    no opt-out. ``decompose`` (the row-band causal dispatch) raises
    ``NotImplementedError``: ``causal_forward_banded`` is not ported yet
    (ROADMAP Queue 1).
    """

    block_q: int = 512
    block_kv: int = 1024
    d_head: int = 128
    dtype: DType = DType.BF16
    out_dtype: DType | None = None
    use_exp2: bool = True
    optimized_softmax: bool = False
    cast_p_to_dtype: bool = True
    fused_scale: bool = False
    mxu_row_sum: bool = False
    scale_q: bool = True
    kv_splits: int = 1
    q_splits: int = 1
    head_pack: int = 1
    fold_batch: bool = False
    kv_loop: KVLoop = KVLoop.GRID
    reverse_kv: bool = False
    num_kv_buffers: int = 2
    causal: bool = False
    q_offset: int = 0
    window: int = 0
    decompose: bool = False
    mask_elide: bool = False
    attn_softcap: float = 0.0
    vmem_limit_mb: int = 64
    scale: float | None = None

    def __post_init__(self):
        if not isinstance(self.kv_loop, KVLoop):
            raise ValueError(f"kv_loop must be a KVLoop, got {self.kv_loop!r}")
        if self.block_q % 8 != 0 or self.block_kv % 128 != 0:
            raise ValueError(
                f"block_q must be a multiple of 8 (sublane) and block_kv of 128 "
                f"(lane): got ({self.block_q}, {self.block_kv})")
        if self.num_kv_buffers < 1:
            raise ValueError("num_kv_buffers must be >= 1 (1 = synchronous copies)")
        if self.num_kv_buffers > MAX_KV_BUFFERS:
            raise ValueError(
                f"num_kv_buffers must be <= {MAX_KV_BUFFERS}, the deepest ring "
                f"the FORI kernel is built for; got {self.num_kv_buffers}")
        if self.scale_q and self.fused_scale:
            raise ValueError("scale_q and fused_scale are exclusive scale paths")
        if self.causal and self.reverse_kv:
            raise ValueError(
                "causal + reverse_kv unsupported: the first processed KV block "
                "must be fully visible for the online-softmax init")
        if self.decompose and not self.causal:
            raise ValueError(
                "decompose requires causal masking (non-causal shapes are "
                "already one whole-KV single-shot call)")
        if self.q_offset < 0:
            raise ValueError(f"q_offset must be >= 0: {self.q_offset}")
        if self.q_offset and not self.causal:
            raise ValueError("q_offset only applies to causal masking")
        if self.window < 0:
            raise ValueError(f"window must be >= 0: {self.window}")
        if self.window and not self.causal:
            raise ValueError("window only applies to causal masking")
        if self.window and self.optimized_softmax:
            raise ValueError(
                "window + optimized_softmax unsupported: the first-block "
                "softmax specialization assumes KV block 0 is visible, but "
                "a window can hide it")
        if self.attn_softcap < 0:
            raise ValueError(f"attn_softcap must be >= 0: {self.attn_softcap}")
        if self.attn_softcap and self.fused_scale:
            raise ValueError(
                "attn_softcap needs the scaled scores materialized; "
                "fused_scale defers the scale into the exp pass")
        if self.kv_splits < 1:
            raise ValueError("kv_splits must be >= 1")
        if self.kv_splits > 1 and (
                self.block_kv % self.kv_splits
                or (self.block_kv // self.kv_splits) % 128):
            raise ValueError(
                f"kv_splits {self.kv_splits} must divide block_kv {self.block_kv} "
                "into lane-aligned (multiple-of-128) sub-tiles")
        if self.q_splits < 1:
            raise ValueError("q_splits must be >= 1")
        if self.q_splits > 1:
            sub = self.block_q // self.q_splits
            if self.block_q % self.q_splits or sub % self.dtype.min_tile[0]:
                raise ValueError(
                    f"q_splits {self.q_splits} must divide block_q "
                    f"{self.block_q} into sublane-aligned (multiple-of-"
                    f"{self.dtype.min_tile[0]}) sub-tiles")
        if self.head_pack < 1:
            raise ValueError("head_pack must be >= 1")
        if self.decompose:
            raise NotImplementedError(
                "decompose (the row-band causal dispatch) waits on "
                "causal_forward_banded, not ported yet (ROADMAP Queue 1)")

    @property
    def resolved_out_dtype(self) -> DType:
        return self.out_dtype if self.out_dtype is not None else self.dtype

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
