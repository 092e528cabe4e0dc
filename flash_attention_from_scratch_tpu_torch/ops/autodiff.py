"""Differentiable flash attention: kernel forward (K1, or K11 for a config
with ``kv_loop=KVLoop.FORI``) and backward (K2/K3).

Counterpart of ``flash_attention_from_scratch_tpu/ops/autodiff.py``. The
forward saves only (O, LSE); the backward recomputes S and P tile by tile
(``ops/flash_backward.py``). Sinks need no kernel change: the forward's LSE
holds the sink term, so the recomputed P rows sum to 1 - sink weight and
dS = P * (dP - D) still holds (the sink carries no value, so it adds to
neither O nor D). The sink's own gradient is one plain pass:
``d(z_h) = -sum_{b, rows} exp(z_h - lse) * D``.

A config with ``decompose=True`` runs the row-band forward
(``ops/causal_decomp.py``); each band's LSE is the full problem's for its
rows, so the backward is the standard K2/K3 on the whole problem.

On the card fp32 runs the forward (K1's or K11's fp32 library); its
backward raises ``ValueError`` before any work, naming the ROADMAP item that
brings fp32 to K2/K3.
"""

from __future__ import annotations

import torch

from . import _build
from .configs import KernelConfig
from .flash_backward import flash_backward
from .flash_forward import flash_forward_with_lse

__all__ = ["flash_attention"]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sinks, cfg):
        out, lse = flash_forward_with_lse(q, k, v, cfg, sinks)
        ctx.save_for_backward(q, k, v, out, lse, sinks)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, sinks = ctx.saved_tensors
        if q.device.type == "cuda":  # a type K2/K3 has no library for raises here
            _build.typed_source("flash_backward.cu", q.dtype, "flash_attention's backward (K2/K3)")
        dq, dk, dv = flash_backward(q, k, v, out, lse, g, ctx.cfg)
        dsinks = None
        if sinks is not None and ctx.needs_input_grad[3]:
            # The sink's softmax weight is w = exp(z - lse) per row; it
            # carries no value, so dS_sink = w * (0 - D).
            d_row = (g.float() * out.float()).sum(-1)
            w = torch.exp(sinks.float()[None, :, None] - lse)
            dsinks = -(w * d_row).sum((0, 2)).to(sinks.dtype)
        return dq, dk, dv, dsinks, None


def flash_attention(q, k, v, cfg: KernelConfig | None = None, sinks=None):
    """Differentiable flash attention: ``flash_forward`` with a kernel
    backward.

    ``sinks`` ((heads,) fp32, optional): per-head sink logits, a learned
    parameter differentiated with q, k and v. The backward runs the kernel
    :func:`~.flash_backward.fused_choice` picks: K3 with the causal mask or
    in PyTorch's deterministic mode, else K2.
    """
    return _FlashAttention.apply(q, k, v, sinks, cfg)
