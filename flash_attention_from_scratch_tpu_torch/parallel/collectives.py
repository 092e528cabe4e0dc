"""Collectives over a :class:`~.mesh.Mesh` axis, with their autograd
transposes.

They stand in for ``jax.lax.ppermute``, ``psum`` and ``all_gather`` inside
the JAX package's ``shard_map`` bodies, and for the transposes ``shard_map``
and GSPMD derive from the specs:

- :func:`ppermute`: each rank sends to its destination in ``perm`` and
  receives from its source (zeros where none sends to it, as in JAX); the
  backward is the reverse permutation.
- :func:`copy_to` and :func:`reduce_from`, Megatron's pair: identity forward
  with the gradient summed over the axis, and the sum over the axis forward
  with the gradient passed through. Around a column-parallel product sits
  the first, after a row-parallel product the second.
- :func:`all_gather` along a dim; the backward takes this rank's slice (the
  gradient of a replicated result is the same on every rank).
- :func:`vocab_parallel_cross_entropy`: the cross-entropy of logits split
  over the vocabulary, from three all-reduces of one value a row (Megatron's
  form), in place of gathering the logits.

Each returns its input unchanged without a mesh or on an axis of size 1.
Every collective a rank issues (forward or backward) adds one to
:data:`calls` under the JAX HLO op's name ("all-reduce", "all-gather",
"collective-permute"): ``tools/scaling_report.py`` reads a step's count
there. Under gloo a CUDA tensor is copied into pinned host memory, the collective
runs there, and the result is copied back: explicitly, with every byte
moved either way counted in ``mesh.staged_bytes``. Under NCCL the tensors
stay on their cards.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, Mesh

__all__ = ["ppermute", "copy_to", "reduce_from", "all_gather", "ring_perm",
           "vocab_parallel_cross_entropy", "calls"]

# Collectives issued by this process, by kind (a batch of sends and
# receives is one "collective-permute"); cleared by its readers.
calls: collections.Counter = collections.Counter()


def ring_perm(n: int, shift: int = 1) -> list[tuple[int, int]]:
    """The permutation that sends coordinate j to j + shift (mod n)."""
    return [(j, (j + shift) % n) for j in range(n)]


def _buffer(mesh: Mesh, x):
    """A contiguous copy of x for the collective to work on: in pinned host
    memory when gloo carries a CUDA tensor."""
    if mesh.backend != "gloo" or x.device.type != "cuda":
        return x.contiguous().clone()
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    mesh.staged_bytes += buf.numel() * buf.element_size()
    return buf


def _like(buf):
    return torch.empty(buf.shape, dtype=buf.dtype, device=buf.device,
                       pin_memory=buf.device.type == "cpu" and buf.is_pinned())


def _home(mesh: Mesh, buf, x):
    """buf back on x's device."""
    if buf.device == x.device:
        return buf
    mesh.staged_bytes += buf.numel() * buf.element_size()
    return buf.to(x.device, non_blocking=True)


def _all_reduce(x, mesh: Mesh, axis: str, op=dist.ReduceOp.SUM):
    calls["all-reduce"] += 1
    buf = _buffer(mesh, x)
    dist.all_reduce(buf, op=op, group=mesh.group(axis))
    return _home(mesh, buf, x)


def _all_gather(x, mesh: Mesh, axis: str, dim: int):
    calls["all-gather"] += 1
    buf = _buffer(mesh, x)
    outs = [_like(buf) for _ in range(mesh.size(axis))]
    dist.all_gather(outs, buf, group=mesh.group(axis))
    return _home(mesh, torch.cat(outs, dim), x)


def _permute(xs, mesh: Mesh, axis: str, perm):
    """ppermute of several tensors in one batch of sends and receives."""
    me = mesh.coord(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    ops, outs = [], []
    for tag, x in enumerate(xs):
        buf = _buffer(mesh, x)
        if dst == [me]:
            outs.append(buf)
            continue
        out = _like(buf).zero_()
        if dst:
            ops.append(dist.P2POp(dist.isend, buf, peer=mesh.peer(axis, dst[0]),
                                  group=mesh.group(axis), tag=tag))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, peer=mesh.peer(axis, src[0]),
                                  group=mesh.group(axis), tag=tag))
        outs.append(out)
    if ops:
        calls["collective-permute"] += 1
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [_home(mesh, o, x) for o, x in zip(outs, xs)]


def _inactive(mesh, axis) -> bool:
    return mesh is None or mesh.size(axis) == 1


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute([x], mesh, axis, perm)[0]

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return _permute([g], ctx.mesh, ctx.axis, back)[0], None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.start, ctx.n, ctx.dim = mesh.coord(axis) * x.shape[dim], x.shape[dim], dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None


def ppermute(x, mesh: Mesh, axis: str, perm):
    """``jax.lax.ppermute``: ``perm`` is a list of (source, destination)
    coordinates on ``axis``; a rank no one sends to gets zeros."""
    if _inactive(mesh, axis):
        return x
    return _Permute.apply(x, mesh, axis, [tuple(p) for p in perm])


def copy_to(x, mesh: Mesh, axis: str = MODEL_AXIS):
    """Identity; the gradient is summed over ``axis`` (an input replicated
    over the axis that each rank uses for its own shard of the work)."""
    return x if _inactive(mesh, axis) else _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh: Mesh, axis: str = MODEL_AXIS):
    """The sum over ``axis`` (``psum``); the gradient passes through."""
    return x if _inactive(mesh, axis) else _ReduceFrom.apply(x, mesh, axis)


def all_gather(x, mesh: Mesh, axis: str, dim: int):
    """The ranks' tensors along ``axis``, concatenated on ``dim`` in
    coordinate order; the gradient is this rank's slice."""
    return x if _inactive(mesh, axis) else _AllGather.apply(x, mesh, axis, dim % x.dim())


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, mesh, axis):
        n = logits.shape[-1]
        m = _all_reduce(logits.amax(-1), mesh, axis, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[:, None])
        total = _all_reduce(e.sum(-1), mesh, axis)
        local = targets - mesh.coord(axis) * n
        mine = (local >= 0) & (local < n)
        rows = torch.arange(logits.shape[0], device=logits.device)
        hit = torch.where(mine, logits[rows, local.clamp(0, n - 1)], 0.0)
        target = _all_reduce(hit, mesh, axis)
        ctx.save_for_backward(e / total[:, None], local, mine)
        return torch.log(total) + m - target

    @staticmethod
    def backward(ctx, g):
        p, local, mine = ctx.saved_tensors
        rows = torch.arange(p.shape[0], device=p.device)
        grad = p.clone()
        grad[rows[mine], local[mine]] -= 1.0
        return grad * g[:, None], None, None, None


def vocab_parallel_cross_entropy(logits, targets, mesh: Mesh, axis: str = MODEL_AXIS):
    """Per-row cross-entropy (N,) of fp32 ``logits`` (N, V / tp), this
    rank's vocabulary slice (``coord * V / tp`` on), against ``targets``
    (N,) in the whole vocabulary: log-sum-exp from the max and the sum of
    exponentials all-reduced over ``axis``, minus the target's logit from
    the rank that holds it. Every rank returns the same values; the
    gradient is the rank's slice of softmax - onehot. Without the axis, the
    plain ``F.cross_entropy``."""
    if _inactive(mesh, axis):
        return torch.nn.functional.cross_entropy(logits, targets, reduction="none")
    return _VocabParallelCE.apply(logits, targets, mesh, axis)
