"""Pipeline parallelism: GPipe over a "pp" axis of ranks.

Counterpart of ``flash_attention_from_scratch_tpu/parallel/pipeline.py``.
The layer stack splits into ``n_stages`` contiguous stages
(:func:`stack_pipeline_params`), rank i of the "pp" axis holds stage i
(:func:`shard_pipeline_params`), and the batch splits into ``n_micro``
microbatches that run as a bucket brigade over n_micro + n_stages - 1
steps: at step t, stage i applies its layers to microbatch t - i and hands
the result to stage i + 1 with ``collectives.ppermute`` (no wraparound).
Autograd runs the backward through the reverse permutations: a pipelined
backward with the same schedule reversed.

JAX runs every stage at every step under a mask and discards the fill and
drain steps' results; here a rank runs its kernels only on the steps whose
microbatch exists (:func:`launch_plan`), which gives the same outputs bit
for bit, and the brigade's sends go only between stages that hold one.
After the last step the last stage's outputs are summed over "pp" to every
rank (JAX's ``psum``), and every rank applies the final norm and the LM head
to the same values.

Unlike JAX's stage, which drops ``embed_scale``, the final softcap, RoPE
scaling and the per-layer windows and uses ``@`` for the LM head
(``parallel/pipeline.py:75-115`` there), a stage here applies the port's
own layer (``models/llama.py::_layer``), so :func:`pipeline_loss_fn`
equals ``models.llama.loss_fn`` on every config.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from ..models.llama import LlamaConfig, _embed, _layer, _lm_logits, rms_norm, rope_tables
from ..ops.flash_backward import KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED, fused_choice
from ..ops.flash_forward import KERNEL as KERNEL_FORWARD
from .collectives import copy_to, ppermute, reduce_from
from .mesh import Mesh

__all__ = ["PIPELINE_AXIS", "stack_pipeline_params", "shard_pipeline_params",
           "pipeline_forward", "pipeline_loss_fn", "launch_plan"]

PIPELINE_AXIS = "pp"


def stack_pipeline_params(params: dict, n_stages: int) -> dict:
    """The layer list as stage-stacked leaves: ``stages[key]`` of shape
    (n_stages, L / n_stages, ...), stage s holding layers s * L / n_stages
    on; the other leaves as they are. ``ValueError`` when the layers do not
    split evenly."""
    layers = params["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not split into {n_stages} stages")
    per = len(layers) // n_stages
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stages"] = {key: torch.stack([torch.stack([layers[s * per + i][key]
                                                    for i in range(per)])
                                       for s in range(n_stages)])
                     for key in layers[0]}
    return out


def shard_pipeline_params(params: dict, mesh: Mesh) -> dict:
    """This rank's slice of stage-stacked parameters on the mesh's device:
    its own stage of every ``stages`` leaf, (1, L / n_stages, ...) as JAX's
    ``P("pp")`` shard, and every other leaf whole. Each leaf is a copy, so
    no two ranks or runs share a tensor an optimizer steps in place."""
    s = mesh.coord(PIPELINE_AXIS)
    out = {k: v.to(mesh.device, copy=True) for k, v in params.items() if k != "stages"}
    out["stages"] = {k: v[s:s + 1].to(mesh.device, copy=True).contiguous()
                     for k, v in params["stages"].items()}
    return out


def launch_plan(n_layers: int, n_stages: int, n_micro: int) -> collections.Counter:
    """A rank's kernel launches in one :func:`pipeline_loss_fn` and its
    backward: K1 once a layer of its stage a microbatch, and per such call
    K3's two kernels (or K2, per ``fused_choice`` for the causal model).
    Equal on every stage; a rank idles n_stages - 1 of the
    n_micro + n_stages - 1 steps (the GPipe bubble)."""
    calls = n_micro * (n_layers // n_stages)
    plan = collections.Counter({KERNEL_FORWARD: calls})
    if fused_choice(None, True):
        plan[KERNEL_FUSED] = calls
    else:
        plan[KERNEL_DKV] = plan[KERNEL_DQ] = calls
    return plan


class _Join(torch.autograd.Function):
    """``x`` unchanged; the gradient of ``x`` passes and ``dep`` gets zeros.
    It ties ``dep`` into x's graph, so that the backward reaches every node
    behind ``dep`` (each holding a collective all ranks must take part in)
    at the point where the forward used ``x``."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _join(x, dep):
    return _Join.apply(x, dep) if torch.is_grad_enabled() and dep.requires_grad else x


def _stage_apply(stage, x, cfg: LlamaConfig, cos, sin, first: int):
    """The stage's layers (leaves (depth, ...)) on x, layer i as the model's
    layer ``first + i`` (its window)."""
    depth = next(iter(stage.values())).shape[0]
    for i in range(depth):
        x = _layer({k: w[i] for k, w in stage.items()}, x, cfg, cos, sin, first + i)
    return x


def _staged(stages, stream, cfg: LlamaConfig, mesh: Mesh, cos, sin):
    """The GPipe brigade over ``stream`` (n_micro, mb, seq, dim); returns
    (n_micro, mb, seq, dim), the last stage's outputs, on every rank.

    Each rank's steps form one chain in the autograd graph: what a step
    receives (zeros where the rank only sends) carries on into the next
    step's input, through the stage where the step holds a microbatch and
    unchanged where it does not. So every rank's backward takes its
    permutations in reverse step order and every send meets its receive.
    """
    n_micro = stream.shape[0]
    n_stages, me = mesh.size(PIPELINE_AXIS), mesh.coord(PIPELINE_AXIS)
    stage = {k: w[0] for k, w in stages.items()}
    first = me * next(iter(stage.values())).shape[0]
    carry = _join(torch.zeros_like(stream[0]), stream)  # rank 0 reads the stream
    outs = []
    for t in range(n_micro + n_stages - 1):
        m = t - me
        if 0 <= m < n_micro:
            x_in = _join(stream[m], carry) if me == 0 else carry
            y = _stage_apply(stage, x_in, cfg, cos, sin, first)
            if me == n_stages - 1:
                outs.append(y)
        else:
            y = carry
        perm = [(i, i + 1) for i in range(n_stages - 1) if 0 <= t - i < n_micro]
        if any(me in pair for pair in perm):
            carry = ppermute(y, mesh, PIPELINE_AXIS, perm)
        else:  # nothing to send or receive: the chain goes on through y
            carry = y
    out = torch.stack(outs) if outs else torch.zeros_like(stream)
    return reduce_from(_join(out, carry), mesh, PIPELINE_AXIS)


def _hidden(params: dict, tokens, cfg: LlamaConfig, mesh: Mesh, n_micro: int):
    """The final-normed hidden states (batch, seq, dim) of the pipeline,
    the same on every rank (:func:`pipeline_forward`)."""
    n_stages = mesh.size(PIPELINE_AXIS)
    batch, seq = tokens.shape
    if batch % n_micro:
        raise ValueError(f"batch {batch} does not split into {n_micro} microbatches")
    depth = next(iter(params["stages"].values())).shape[1]
    if depth * n_stages != cfg.n_layers:
        raise ValueError(f"{n_stages} stages of {depth} layers do not make the model's "
                         f"{cfg.n_layers}")
    x = copy_to(_embed(params, tokens, cfg), mesh, PIPELINE_AXIS)
    cos, sin = rope_tables(seq, cfg.d_head, cfg.rope_theta, cfg, device=x.device)
    stream = x.reshape(n_micro, batch // n_micro, seq, cfg.dim)
    out = _staged(params["stages"], stream, cfg, mesh, cos, sin).reshape(batch, seq, cfg.dim)
    return rms_norm(out, params["final_norm"], cfg.norm_eps)


def pipeline_forward(params: dict, tokens, cfg: LlamaConfig, mesh: Mesh, n_micro: int):
    """tokens (batch, seq) -> logits (batch, seq, vocab) fp32, the same on
    every rank.

    ``params``: this rank's :func:`shard_pipeline_params` (or, on a mesh of
    one stage, :func:`stack_pipeline_params`'s tree); ``tokens`` the same on
    every rank. The batch must split into ``n_micro`` microbatches
    (``ValueError``), and ``seq`` be a multiple of the flash kernel's tile
    (64). The embedding is read on every rank and fed to stage 0; its
    gradient is summed over "pp" (``copy_to``), as ``shard_map``'s
    transpose sums a replicated input's. The final norm and the LM head run
    on every rank on the same summed output, so their gradients are each
    rank's own, unsummed.
    """
    return _lm_logits(params, _hidden(params, tokens, cfg, mesh, n_micro), cfg)


def pipeline_loss_fn(params: dict, tokens, cfg: LlamaConfig, mesh: Mesh, n_micro: int):
    """Next-token cross-entropy through the pipeline, the mean over all
    positions (fp32), the same on every rank; ``tokens`` (batch, seq + 1).
    The LM head and the loss run a microbatch at a time (the sum of each
    one's losses over the count), so one microbatch's fp32 logits are live
    at a time rather than the batch's."""
    h = _hidden(params, tokens[:, :-1], cfg, mesh, n_micro)
    targets = tokens[:, 1:]
    total = 0.0
    for hm, tm in zip(h.chunk(n_micro), targets.chunk(n_micro)):
        logits = _lm_logits(params, hm, cfg)
        total = total + F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tm.reshape(-1),
                                        reduction="sum")
    return total / targets.numel()
