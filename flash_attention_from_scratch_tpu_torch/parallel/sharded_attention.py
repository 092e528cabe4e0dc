"""Flash attention over (batch, heads) shards.

Counterpart of ``flash_attention_from_scratch_tpu/parallel/sharded_attention.py``.
There ``shard_map`` hands every device its (batch/dp, heads/tp) block of the
global arrays; here every rank already holds its block, and runs the
single-device ``flash_attention`` (K1 forward, K3 or K2 backward) on it.
Attention is independent over batch and heads, so the forward needs no
collective; the surrounding projections' all-reduces are the model's
(``models/llama.py``).
"""

from __future__ import annotations

from ..ops.autodiff import flash_attention
from ..ops.configs import KernelConfig
from .collectives import copy_to
from .mesh import DATA_AXIS, Mesh

__all__ = ["shard_mapped_attention"]


def shard_mapped_attention(q, k, v, cfg: KernelConfig, mesh: Mesh, sinks=None):
    """This rank's block of the JAX ``shard_mapped_attention``.

    q, k, v: the rank's (batch/dp, heads/tp, seq, d) block of the global
    inputs (Q heads and KV heads both split over tp, so each rank keeps its
    GQA groups whole). ``sinks``: the rank's slice of the (heads,) sink
    logits (spec ``P("tp")``); they are replicated over dp, so their
    gradient is summed over dp, as ``shard_map``'s transpose sums it.
    Returns the rank's block of the output.
    """
    if sinks is not None:
        sinks = copy_to(sinks, mesh, DATA_AXIS)
    return flash_attention(q, k, v, cfg, sinks)
