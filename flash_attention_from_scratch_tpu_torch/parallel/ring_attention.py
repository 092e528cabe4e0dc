"""Ring attention: flash attention over sequence shards.

Counterpart of ``flash_attention_from_scratch_tpu/parallel/ring_attention.py``.
Every rank holds the Q, K and V rows of its sequence shard (rank i: global
positions ``i * L .. (i + 1) * L - 1``); the K/V shards rotate around the
ring of the mesh axis while each rank runs the single-device kernels on its
resident Q. Partial results merge through the forward kernel's LSE:

    m = max(lse_a, lse_b);  w = exp(lse - m)
    o = (o_a w_a + o_b w_b) / (w_a + w_b);  lse = m + log(w_a + w_b)

Hop 0 is the diagonal (causal when the attention is); at hop t a rank holds
the shard that began at rank ``i - t`` (mod P). Without a window that shard
lies wholly in the past, so the plain non-causal kernel runs; with one the
hop runs the causal kernel at ``q_offset = t * L`` and the window, which
recreates the global distance between rows and keys, and the ring stops
after the hops the window can reach (``_max_hop``). The backward uses the
saved global LSE, with which each (Q shard, K/V shard) pair's gradients
from the single-device kernels are exact parts of the whole: dQ adds up in
place, dK/dV travel with their shard and take one jump home at the end.

One difference from JAX, with equal results: a causal JAX ring computes
every hop on every device and masks a hop that lies in the future (``i <
t``) out of the merge (its LSE set to -1e30, so ``w_b = exp(-1e30 - m) = 0``
and ``w_a = 1``) and out of the gradients (times 0). Here such a rank skips
that hop's kernels, which leaves o, lse, dq, dk and dv bit for bit what the
masked merge gives; the ring still rotates. :func:`launch_plan` states each
rank's kernels.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from ..ops.configs import KernelConfig, KVLoop
from ..ops.flash_backward import KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED, flash_backward, fused_choice
from ..ops.flash_forward import KERNEL as KERNEL_FORWARD, flash_forward_with_lse
from .collectives import _permute, reduce_from, ring_perm
from .mesh import SEQ_AXIS, Mesh

__all__ = ["ring_flash_attention", "launch_plan"]


def _merge(o_a, lse_a, o_b, lse_b):
    """LSE-weighted merge of two normalized partial attentions (fp32 o)."""
    m = torch.maximum(lse_a, lse_b)
    w_a = torch.exp(lse_a - m)
    w_b = torch.exp(lse_b - m)
    denom = w_a + w_b
    o = (o_a * w_a[..., None] + o_b * w_b[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def _max_hop(window: int, shard_len: int, n_shards: int) -> int:
    """Hops that can contribute under a sliding window: hop t's closest
    pair is ``t * L - (L - 1)`` apart, so hops with ``(t - 1) * L >=
    window`` lie below every row's window."""
    if not window:
        return n_shards
    return min(n_shards, (window - 1) // shard_len + 2)


def _hop_cfg(base: KernelConfig, causal: bool, window: int, t: int,
             shard_len: int) -> KernelConfig:
    """The kernel config of hop t >= 1: the plain kernel without a window,
    else the causal kernel at ``q_offset = t * shard_len`` with the window."""
    if not (causal and window):
        return base
    return dataclasses.replace(base, causal=True, q_offset=t * shard_len, window=window,
                               optimized_softmax=False)


def _ring(cfg: KernelConfig, causal: bool, shard_len: int, n_shards: int, idx: int):
    """[(hop, its config)] that rank ``idx`` computes, and the hop count."""
    base = dataclasses.replace(cfg, causal=False, window=0, q_offset=0,
                               kv_loop=KVLoop.GRID, decompose=False)
    diag = dataclasses.replace(base, causal=causal, window=cfg.window)
    hops = _max_hop(cfg.window if causal else 0, shard_len, n_shards)
    run = [(t, diag if t == 0 else _hop_cfg(base, causal, cfg.window, t, shard_len))
           for t in range(hops) if not causal or t <= idx]
    return run, hops


def launch_plan(cfg: KernelConfig, n_shards: int, shard_len: int,
                idx: int) -> collections.Counter:
    """Kernel launches of rank ``idx`` in one forward and backward of
    :func:`ring_flash_attention`: K1 for each hop it computes; per hop, K3's
    two kernels where the hop's config is causal and K2 where it is not
    (``ops/flash_backward.py::fused_choice``)."""
    plan = collections.Counter()
    for _, hop in _ring(cfg, cfg.causal, shard_len, n_shards, idx)[0]:
        plan[KERNEL_FORWARD] += 1
        if fused_choice(None, hop.causal):
            plan[KERNEL_FUSED] += 1
        else:
            plan[KERNEL_DKV] += 1
            plan[KERNEL_DQ] += 1
    return plan


def _forward(q, k, v, sinks, cfg, mesh, axis, causal):
    n, idx = mesh.size(axis), mesh.coord(axis)
    run, hops = _ring(cfg, causal, q.shape[2], n, idx)
    todo = dict(run)
    o, lse = flash_forward_with_lse(q, k, v, todo[0])
    o = o.float()
    kk, vv = k, v
    for t in range(1, hops):
        kk, vv = _permute([kk, vv], mesh, axis, ring_perm(n))
        if t in todo:  # else the shard lies in the future: JAX's merge weight 0
            o_t, lse_t = flash_forward_with_lse(q, kk, vv, todo[t])
            o, lse = _merge(o, lse, o_t.float(), lse_t)
    if sinks is not None:
        # The sink joins the merged (global) LSE once, after the ring.
        lse_tot = torch.logaddexp(lse, sinks.float()[None, :, None])
        o = o * torch.exp(lse - lse_tot)[..., None]
        lse = lse_tot
    return o.to(q.dtype), lse


def _backward(q, k, v, sinks, out, lse, do, cfg, mesh, axis, causal, want_dsinks):
    n, idx = mesh.size(axis), mesh.coord(axis)
    run, hops = _ring(cfg, causal, q.shape[2], n, idx)
    todo = dict(run)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvv = torch.zeros_like(dkk)
    kk, vv = k, v
    for t in range(hops):
        if t > 0:
            kk, vv, dkk, dvv = _permute([kk, vv, dkk, dvv], mesh, axis, ring_perm(n))
        if t in todo:
            dq_t, dk_t, dv_t = flash_backward(q, kk, vv, out, lse, do, todo[t])
            dq += dq_t.float()
            dkk += dk_t.float()
            dvv += dv_t.float()
    if hops > 1:
        # Each buffer sits hops - 1 ranks past its shard's home.
        dkk, dvv = _permute([dkk, dvv], mesh, axis, ring_perm(n, -(hops - 1)))
    dsinks = None
    if want_dsinks:
        # d(sink) = -sum over rows of exp(z - lse) * D, summed over the ring.
        d_row = (do.float() * out.float()).sum(-1)
        w = torch.exp(sinks.float()[None, :, None] - lse)
        dsinks = reduce_from(-(w * d_row).sum((0, 2)), mesh, axis).to(sinks.dtype)
    return dq.to(q.dtype), dkk.to(k.dtype), dvv.to(v.dtype), dsinks


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sinks, cfg, mesh, axis, causal):
        out, lse = _forward(q, k, v, sinks, cfg, mesh, axis, causal)
        ctx.save_for_backward(q, k, v, sinks, out, lse)
        ctx.args = (cfg, mesh, axis, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, sinks, out, lse = ctx.saved_tensors
        want = sinks is not None and ctx.needs_input_grad[3]
        return (*_backward(q, k, v, sinks, out, lse, g, *ctx.args, want),
                None, None, None, None)


def ring_flash_attention(q, k, v, cfg: KernelConfig, mesh: Mesh, axis: str = SEQ_AXIS, *,
                         causal: bool | None = None, sinks=None):
    """Flash attention over the sequence shards of ``mesh[axis]``.

    q (batch, heads, L, d), k and v (batch, kv_heads, L, d): this rank's
    shard, global positions ``coord * L`` on. ``causal`` defaults to
    ``cfg.causal``. Returns the rank's shard of the output; differentiable
    (the backward runs its own ring). ``sinks`` ((heads,) fp32,
    differentiable, replicated over the ring): they join the merged LSE once
    after the ring, and their gradient is summed over the ring, as JAX's
    psum does. A ``q_offset`` raises ``NotImplementedError`` and a window
    without causal ``ValueError``, as in JAX.
    """
    if causal is None:
        causal = cfg.causal
    if cfg.q_offset:
        raise NotImplementedError(f"ring attention with q_offset (got {cfg.q_offset})")
    if cfg.window and not causal:
        raise ValueError("window requires causal (config invariant)")
    return _RingAttention.apply(q, k, v, sinks, cfg, mesh, axis, causal)
