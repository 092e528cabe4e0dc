"""Attention configuration, the analytical FLOP model and the config space.

Counterpart of ``flash_attention_from_scratch_tpu/ops/configs.py``. The
config takes every field of the JAX one. The TPU tiling and schedule knobs
there (block sizes, softmax variants, head packing, split counts, VMEM
limits) are hints the Hopper kernels ignore, validated as the JAX package
validates them: the kernels' tile sizes are their own constants
(``csrc/*.cu``), and every knob computes the same function.

The config-space functions (:func:`parse_short_form`, the ``calc_*`` FLOP
and intensity models, :func:`should_autotune_config` and the ``get_*``
enumerations) return the JAX package's configs and numbers, so a short form
from a JAX tool maps to the same config here. They enumerate and prune TPU
knobs by the TPU's VMEM model (:meth:`KernelConfig.vmem_bytes`); on Hopper
those knobs select no kernel, so every config of a list runs the same
kernel.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import os
import re
from typing import Sequence

import torch

__all__ = ["DType", "KVLoop", "KernelConfig", "MAX_KV_BUFFERS",
           "calc_self_attn_flop", "calc_causal_attn_flop", "calc_total_flop",
           "calc_tile_softmax_flop", "calc_arithmetic_intensity",
           "get_autotuning_kernel_configs", "get_kernel_progression_configs",
           "get_kernels_to_build", "get_kernel_configs", "parse_short_form",
           "should_autotune_config"]

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
    def short(self) -> str:
        """The dtype's name in a config's short form (the JAX package's)."""
        return _DTYPE_SHORT[self]

    @property
    def bytes(self) -> int:
        return self.value.itemsize

    @classmethod
    def from_short(cls, s: str) -> "DType":
        for d in cls:
            if d.short == s:
                return d
        raise ValueError(f"unknown dtype short form: {s!r}")

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


_DTYPE_SHORT = {DType.FP32: "f32", DType.BF16: "bf16", DType.FP16: "f16"}


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
    no opt-out. ``decompose`` (causal only) routes a self-attention call
    (``seq_kv == q_offset + seq_q``) through the row-band dispatch,
    ``ops/causal_decomp.py::causal_forward_banded``: one K1 call a band.
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

    # The TPU's largest fp32 S tile (the JAX package's measured budget): the
    # config space prunes by it, and the banded dispatch sizes its per-band
    # block_kv hint by it. Nothing on Hopper reads it.
    S_TILE_BUDGET_BYTES = 32 * 1024 * 1024

    # The JAX package's best-known TPU knobs per whole-sequence KV bucket:
    # upper seq_kv bound -> (preferred block_q, kv_splits, q_splits,
    # head_pack). TPU measurements; on Hopper they select no kernel.
    _SWEEP_TABLE = (
        (512, (512, 1, 2, 16)),
        (1024, (512, 1, 1, 8)),
        (2048, (1024, 1, 2, 4)),
        (4096, (512, 2, 2, 2)),
        (8192, (512, 4, 2, 2)),
        (None, (512, 8, 2, 1)),
    )

    @classmethod
    def for_shape(cls, seq_q: int, seq_kv: int, *, preferred_q: int | None = None,
                  preferred_kv: int | None = None, heads: int | None = None,
                  kv_heads: int | None = None, batch: int | None = None,
                  **kwargs) -> "KernelConfig":
        """The JAX package's best-known config for (seq_q, seq_kv): blocks
        clamped to the largest legal divisor of each length (whole-sequence
        KV while the fp32 S tile fits ``S_TILE_BUDGET_BYTES``), the overlap
        knobs from ``_SWEEP_TABLE`` (head packing only with ``heads`` and no
        GQA, else q_splits and kv_splits 2), the pack halved until the VMEM
        model fits. JAX's defaults (``optimized_softmax`` True) apply, so
        the config equals JAX's. On Hopper it runs K1 (K11 with
        ``kv_loop=KVLoop.FORI``); the knobs are hints. ``ValueError`` for a
        length no block tiles."""

        def clamp(pref: int, seq: int, quantum: int) -> int:
            b = min(pref, seq)
            b -= b % quantum
            while b > quantum and seq % b:
                b -= quantum
            if b < quantum or seq % b:
                raise ValueError(f"seq {seq} not tileable (quantum {quantum})")
            return b

        for bound, row in cls._SWEEP_TABLE:
            if bound is None or seq_kv <= bound:
                tbl_q, tbl_sp, tbl_qs, tbl_hp = row
                break
        dtype = kwargs.get("dtype", DType.BF16)
        bq = clamp(tbl_q if preferred_q is None else preferred_q, seq_q, dtype.min_tile[0])
        if preferred_kv is None:
            preferred_kv = max(cls.S_TILE_BUDGET_BYTES // (4 * bq), 128)
        bkv = clamp(preferred_kv, seq_kv, 128)
        grid = kwargs.get("kv_loop", KVLoop.GRID) == KVLoop.GRID
        hp = 1
        if "head_pack" not in kwargs and grid and heads and heads == (kv_heads or heads):
            pool = heads * (batch or 1)
            hp = next((c for c in (tbl_hp, tbl_hp // 2, tbl_hp // 4, 2)
                       if 1 < c <= tbl_hp and pool % c == 0), 1)
            if hp > 1:
                kwargs["head_pack"] = hp
                if batch and batch > 1 and (heads % hp or hp > heads):
                    kwargs.setdefault("fold_batch", True)
        if hp == 1 and tbl_hp > 1:
            tbl_qs = max(tbl_qs, 2)
            if bkv >= 2048:
                tbl_sp = max(tbl_sp, 2)
        if "kv_splits" not in kwargs and tbl_sp > 1 and bkv % (tbl_sp * 128) == 0:
            kwargs["kv_splits"] = tbl_sp
        if ("q_splits" not in kwargs and grid and tbl_qs > 1
                and bq % (tbl_qs * dtype.min_tile[0]) == 0):
            kwargs["q_splits"] = tbl_qs
        cfg = cls(**{"optimized_softmax": True, **kwargs, "block_q": bq, "block_kv": bkv})
        grp = heads // kv_heads if (heads and kv_heads) else 1
        if (cfg.head_pack > 1 and not cfg.fits_vmem(grp)
                and dataclasses.replace(cfg, head_pack=1).fits_vmem(grp)):
            while cfg.head_pack > 1 and not cfg.fits_vmem(grp):
                cfg = dataclasses.replace(cfg, head_pack=cfg.head_pack // 2)
        return cfg

    @property
    def resolved_out_dtype(self) -> DType:
        return self.out_dtype if self.out_dtype is not None else self.dtype

    @property
    def softmax_scale(self) -> float:
        return self.scale if self.scale is not None else self.d_head ** -0.5

    def vmem_bytes(self, group: int = 1) -> int:
        """The JAX kernel's VMEM working set of one grid step (its pipeline
        windows, accumulator, row statistics, S/P tiles and split partials),
        the JAX package's model. ``group``: the GQA group size. A TPU
        figure: the Hopper kernels' shared memory is their own plan
        (``ops/flash_forward.py::grid_plan``)."""
        b = self.dtype.bytes
        hp = self.head_pack
        kv_pack = max(1, hp // group) if group > 1 else hp
        q = hp * self.block_q * self.d_head * b * 2
        kv = kv_pack * 2 * self.block_kv * self.d_head * b * max(2, self.num_kv_buffers)
        out = hp * self.block_q * self.d_head * self.resolved_out_dtype.bytes * 2
        acc = hp * self.block_q * self.d_head * 4
        stats = 2 * hp * self.block_q * 128 * 4
        p = hp * self.block_q * self.block_kv * 4
        partials = hp * (self.kv_splits - 1) * self.block_q * (self.d_head + 2) * 4
        return q + kv + out + acc + stats + p + partials

    def fits_vmem(self, group: int = 1) -> bool:
        """Whether :meth:`vmem_bytes` fits ``vmem_limit_mb`` (a TPU check)."""
        return self.vmem_bytes(group) <= self.vmem_limit_mb * 1024 * 1024

    def short_form(self) -> str:
        """The JAX package's canonical string of the config (``scale``, a
        port-only field, is not in it), inverted by
        :func:`parse_short_form`."""
        flags = [f for f, on in (
            ("x2", self.use_exp2), ("os", self.optimized_softmax),
            ("cp", self.cast_p_to_dtype), ("fs", self.fused_scale),
            ("ms", self.mxu_row_sum), ("sq", self.scale_q)) if on]
        flags += [f"{f}{n}" for f, n in (("sp", self.kv_splits), ("qs", self.q_splits),
                                         ("hp", self.head_pack)) if n > 1]
        flags += [f for f, on in (
            ("fb", self.fold_batch), ("me", self.mask_elide), ("dc", self.decompose),
            ("rk", self.reverse_kv), ("ca", self.causal)) if on]
        flags += [f"{f}{n}" for f, n in (("qo", self.q_offset), ("wi", self.window)) if n]
        if self.attn_softcap:
            # '.' -> 'p', trailing zeros dropped (50.0 -> sc50, 30.5 -> sc30p5).
            flags.append("sc" + f"{self.attn_softcap:g}".replace(".", "p"))
        return (f"fa_{self.dtype.short}_q{self.block_q}_kv{self.block_kv}"
                f"_d{self.d_head}_{self.kv_loop.value}{self.num_kv_buffers}_"
                + ("+".join(flags) if flags else "none"))


_SHORT_RE = re.compile(
    r"fa_(?P<dtype>[a-z0-9]+)_q(?P<bq>\d+)_kv(?P<bkv>\d+)_d(?P<d>\d+)"
    r"_(?P<loop>grid|fori)(?P<nbuf>\d+)_(?P<flags>[a-z0-9+]+)")


def parse_short_form(s: str) -> KernelConfig:
    """Inverse of :meth:`KernelConfig.short_form`: the first short form found
    in ``s`` (a tool's table row, a profile entry) as a config, with the
    JAX package's parse."""
    m = _SHORT_RE.search(s)
    if not m:
        raise ValueError(f"cannot parse kernel short form from {s!r}")
    flags = set(m.group("flags").split("+")) - {"none"}
    num = {"sp": 1, "qs": 1, "hp": 1, "qo": 0, "wi": 0}
    softcap = 0.0
    for f in flags:
        if f[:2] in num and f[2:].isdigit():
            num[f[:2]] = int(f[2:])
        if f.startswith("sc") and f[2:].replace("p", "").isdigit():
            softcap = float(f[2:].replace("p", "."))
    return KernelConfig(
        kv_splits=num["sp"], q_splits=num["qs"], head_pack=num["hp"],
        q_offset=num["qo"], window=num["wi"], attn_softcap=softcap,
        block_q=int(m.group("bq")), block_kv=int(m.group("bkv")),
        d_head=int(m.group("d")), dtype=DType.from_short(m.group("dtype")),
        use_exp2="x2" in flags, optimized_softmax="os" in flags,
        cast_p_to_dtype="cp" in flags, fused_scale="fs" in flags,
        mxu_row_sum="ms" in flags, scale_q="sq" in flags, fold_batch="fb" in flags,
        mask_elide="me" in flags, decompose="dc" in flags, reverse_kv="rk" in flags,
        causal="ca" in flags, kv_loop=KVLoop(m.group("loop")),
        num_kv_buffers=int(m.group("nbuf")))


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


def calc_tile_softmax_flop(cfg: KernelConfig) -> int:
    """Softmax FLOPs of one (block_q, block_kv) tile, the JAX package's
    model: the exp2 path saves a multiply a score."""
    br, bc, d = cfg.block_q, cfg.block_kv, cfg.d_head
    if cfg.use_exp2:
        return br * (4 * bc + d + 4)
    return br * (5 * bc + d + 2)


def calc_total_flop(cfg: KernelConfig, seq_len: int, n_heads: int, batch: int) -> int:
    """Implementation FLOPs of a call (the two tile products and each
    tile's softmax over the config's TPU tiling), the JAX package's model."""
    n_q = seq_len // cfg.block_q
    n_kv = seq_len // cfg.block_kv
    gemm = 2 * (2 * cfg.block_q * cfg.block_kv * cfg.d_head)
    return batch * n_heads * n_q * n_kv * (gemm + calc_tile_softmax_flop(cfg))


def calc_arithmetic_intensity(cfg: KernelConfig, seq_len: int) -> float:
    """FLOPs per HBM byte of one (batch, head) slice under the TPU's tiling
    (Q and O move once, K and V once per Q block), the JAX package's model."""
    b = cfg.dtype.bytes
    flop = 4 * seq_len * seq_len * cfg.d_head
    n_q = seq_len // cfg.block_q
    moved = 2 * seq_len * cfg.d_head * b + 2 * seq_len * cfg.d_head * b * n_q
    return flop / moved


def _tpu_config(**kw) -> KernelConfig:
    """A config with the JAX package's defaults: ``optimized_softmax`` is
    True there (False in the port), so the enumerations below return the
    JAX package's configs."""
    return KernelConfig(**{"optimized_softmax": True, **kw})


def should_autotune_config(cfg: KernelConfig) -> bool:
    """The JAX autotuner's pruning: the TPU's VMEM model, S tiles of at
    least 128 x 128 (the MXU's width) and within the S-tile budget."""
    return (cfg.fits_vmem() and cfg.block_q >= 128 and cfg.block_kv >= 128
            and cfg.block_q * cfg.block_kv * 4 <= KernelConfig.S_TILE_BUDGET_BYTES)


def get_autotuning_kernel_configs(dtypes: Sequence[DType] = (DType.BF16,),
                                  d_head: int = 128) -> list[KernelConfig]:
    """The JAX package's autotuning sweep (block shapes, reverse KV, split
    counts, q splits and head packing), pruned by
    :func:`should_autotune_config`. On Hopper these knobs select no kernel:
    every config of the list runs K1."""
    out: list[KernelConfig] = []
    for dtype, bq, bkv, rev in itertools.product(
            dtypes, (128, 256, 512, 1024),
            (256, 512, 1024, 2048, 4096, 8192, 16384), (False, True)):
        splits = {1} | {bkv // sub for sub in (1024, 2048)
                        if bkv % sub == 0 and bkv > sub}
        for sp in sorted(splits):
            for qs, hp in ((1, 1), (2, 1), (1, 2), (2, 2)):
                if hp > 1 and rev:
                    continue
                if qs > 1 and bq % (qs * dtype.min_tile[0]):
                    continue
                cfg = _tpu_config(block_q=bq, block_kv=bkv, d_head=d_head, dtype=dtype,
                                  reverse_kv=rev, kv_splits=sp, q_splits=qs, head_pack=hp)
                if should_autotune_config(cfg):
                    out.append(cfg)
    return out


def get_kernel_progression_configs(dtype: DType = DType.BF16) -> list[tuple[str, KernelConfig]]:
    """The JAX package's optimization ladder, (rung name, config) from
    ``1_base`` to ``12_head_pack``. On Hopper only ``kv_loop`` (and
    ``num_kv_buffers`` under FORI) selects a kernel: the FORI rungs run K11
    at their ring depth, the others K1."""
    base = dict(dtype=dtype, block_q=128, block_kv=128, scale_q=False)
    big = dict(dtype=dtype, block_q=512)
    return [
        ("1_base", _tpu_config(**base, kv_loop=KVLoop.FORI, num_kv_buffers=1,
                               use_exp2=False, optimized_softmax=False)),
        ("2_pipelined", _tpu_config(**base, use_exp2=False, optimized_softmax=False)),
        ("3_exp2", _tpu_config(**base, use_exp2=True, optimized_softmax=False)),
        ("4_opt_softmax", _tpu_config(**base)),
        ("5_reverse_kv", _tpu_config(**base, reverse_kv=True)),
        ("6_manual_pipeline", _tpu_config(**base, kv_loop=KVLoop.FORI, num_kv_buffers=2)),
        ("7_autotuned", _tpu_config(**big, block_kv=1024, scale_q=False)),
        ("8_scale_q", _tpu_config(**big, block_kv=1024)),
        ("9_split_partials", _tpu_config(**big, block_kv=2048, kv_splits=2)),
        ("10_whole_kv", _tpu_config(**big, block_kv=4096, kv_splits=2)),
        ("11_q_splits", _tpu_config(**big, block_kv=4096, kv_splits=2, q_splits=2)),
        ("12_head_pack", _tpu_config(**big, block_kv=4096, kv_splits=4, head_pack=2)),
    ]


def get_kernels_to_build(dtypes: Sequence[DType] = (DType.BF16,)) -> list[KernelConfig]:
    """The ladder's configs, then the autotuning sweep's, each once (the
    JAX package's build set). On Hopper every kernel is built once
    (``ops/_build.py``), whatever the list holds."""
    seen: dict[KernelConfig, None] = {}
    for dt in dtypes:
        for _, cfg in get_kernel_progression_configs(dt):
            seen[cfg] = None
    for cfg in get_autotuning_kernel_configs(dtypes):
        seen[cfg] = None
    return list(seen)


def get_kernel_configs(kind: str | None = None) -> list[KernelConfig]:
    """The JAX package's config selection by ``kind`` (or ``$KERNELS``,
    default ``prog``): ``prog`` (the ladder), ``all`` (the build set),
    ``tune`` (the sweep), ``"<block_q>,<block_kv>"``, or short forms
    separated by ``;``."""
    kind = kind or os.environ.get("KERNELS", "prog")
    if "fa_" in kind:
        return [parse_short_form(s) for s in kind.split(";") if s.strip()]
    if kind == "prog":
        return [cfg for _, cfg in get_kernel_progression_configs()]
    if kind == "all":
        return get_kernels_to_build()
    if kind == "tune":
        return get_autotuning_kernel_configs()
    m = re.fullmatch(r"(\d+),(\d+)", kind)
    if m:
        return [_tpu_config(block_q=int(m.group(1)), block_kv=int(m.group(2)))]
    raise ValueError(f"unknown KERNELS selector: {kind!r}")
