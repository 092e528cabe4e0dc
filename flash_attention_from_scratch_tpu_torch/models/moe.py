"""Mixture-of-Experts Llama: routed SwiGLU experts with capacity dispatch.

Counterpart of ``flash_attention_from_scratch_tpu/models/moe.py``: the
Llama block with its MLP replaced by a top-k routed expert layer, GShard /
Switch style. Routing builds static-shape dispatch and combine tensors
(T, E, C) for T tokens, E experts and C slots an expert, and the expert FFN
runs as one batched product over all experts; a token over an expert's
capacity is dropped there (its other routes still carry it). Every shape is
a function of T alone, so a decode step that routes stays capturable in a
CUDA graph (``models/step_graphs.py``): nothing is read on the host and no
shape depends on the routing.

Dispatch and combine are the dense (T, E, C) products, as in the JAX
package: the same slots, drops and combine weights, and the same rounding
(the combine weights cast to the activations' dtype before their product).
The JAX package computes them with ``jnp.einsum`` outside any Pallas kernel,
so they are plain PyTorch products here.

Expert parallelism: on a mesh with an "ep" axis (``EXPERT_AXIS``;
``parallel.mesh.make_axis_mesh``) each rank holds E / ep experts on the
leading axis (:func:`shard_moe_params`, specs :func:`moe_param_specs`).
The tokens are the same on every rank, as JAX's replicated tokens (``P()``
in its expert-parallel test): every rank runs the router, the capacity and
the routing identically, so the routes are bit for bit one device's; a rank
then dispatches, runs and combines only its own experts, and the combined
outputs are summed over "ep" (``reduce_from``). GSPMD places that sum in
JAX; it is an all-reduce, not an all-to-all (the tokens are not sharded).
Attention runs replicated, as JAX's ``moe_loss_fn`` does with no mesh.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..parallel.collectives import copy_to, reduce_from
from ..utils.device import resolve_device
from .llama import (
    LlamaConfig, _attention, _dense_init, _mm, _o_proj, init_params, rms_norm,
    rope_tables,
)

__all__ = ["MoEConfig", "init_moe_params", "moe_forward", "moe_loss_fn",
           "EXPERT_AXIS", "moe_param_specs", "shard_moe_params"]

EXPERT_AXIS = "ep"


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    n_experts: int = 8
    expert_top_k: int = 2
    # Slots an expert = ceil(top_k * tokens / n_experts * this), see _capacity.
    capacity_factor: float = 1.25
    # Weight of the Switch load-balancing loss in moe_loss_fn.
    router_aux_weight: float = 0.01


def init_moe_params(cfg: MoEConfig, generator: torch.Generator, device="cuda") -> dict:
    """Llama parameters with each layer's MLP replaced by a router and
    stacked experts: ``router`` (dim, n_experts) fp32 (``_dense_init``: a
    bf16 tie would flip which expert a token visits) and ``experts`` with
    ``w_gate``, ``w_up`` (E, dim, hidden) and ``w_down`` (E, hidden, dim),
    normal / sqrt(fan_in) in the model dtype. The JAX package's tree and
    distributions, drawn from ``generator`` (on ``device``; the card by
    default), not its draws."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, dev)
    dt = cfg.dtype.torch_dtype
    e, d, h = cfg.n_experts, cfg.dim, cfg.hidden_dim

    def stacked(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return (w / math.sqrt(fan_in)).to(dt)

    for layer in params["layers"]:
        for k in ("w_gate", "w_up", "w_down"):
            del layer[k]
        layer["router"] = _dense_init(generator, (d, e), torch.float32, dev)
        layer["experts"] = {"w_gate": stacked((e, d, h), d),
                            "w_up": stacked((e, d, h), d),
                            "w_down": stacked((e, h, d), h)}
    return params


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Slots an expert for ``n_tokens`` routed together: the JAX package's
    expression, rounded up to a multiple of 8, at least 8."""
    cap = math.ceil(cfg.expert_top_k * n_tokens / cfg.n_experts
                    * cfg.capacity_factor)
    return max(8, cap + (-cap) % 8)


def _route(cfg: MoEConfig, gates, capacity: int):
    """Top-k capacity dispatch (GShard) of ``gates`` (T, E) softmax router
    probabilities, fp32.

    Returns (dispatch (T, E, C) 0/1, combine (T, E, C), aux loss), all in
    ``gates``' dtype. A token's top-k values are renormalised to sum to 1.
    Slots go by routing rank: every token's first choice claims one before
    any second choice, and within a rank by token order. Ties in a row go
    to the lower expert index, as ``jax.lax.top_k`` breaks them (a stable
    descending sort; ``torch.topk`` promises no order). The aux loss is the
    Switch loss, E * sum_e f_e p_e, with f from first choices. One-hots are
    comparisons with an ``arange``: no host read, so it captures in a graph.
    """
    t, e = gates.shape
    dev = gates.device
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :cfg.expert_top_k], idx[:, :cfg.expert_top_k]
    top_vals = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)

    experts = torch.arange(e, device=dev)
    slots = torch.arange(capacity, device=dev)
    dispatch = gates.new_zeros((t, e, capacity))
    combine = gates.new_zeros((t, e, capacity))
    counts = torch.zeros(e, dtype=torch.int64, device=dev)
    for j in range(cfg.expert_top_k):
        onehot = (top_idx[:, j, None] == experts).to(torch.int64)  # (T, E)
        pos = torch.cumsum(onehot, dim=0) - 1 + counts
        counts = counts + onehot.sum(0)
        keep = (pos < capacity) & (onehot > 0)
        slot = ((pos.clamp(0, capacity - 1)[..., None] == slots).to(gates.dtype)
                * keep[..., None])
        dispatch = dispatch + slot
        combine = combine + slot * top_vals[:, j, None, None]

    first = (top_idx[:, :1] == experts).to(gates.dtype)
    aux = e * torch.sum(first.mean(0) * gates.mean(0))
    return dispatch, combine, aux


def _ep_size(mesh) -> int:
    """The mesh's "ep" size (1 without a mesh); a mesh with any other axis
    raises ``NotImplementedError``: the JAX package has no specs for MoE
    under dp, tp or sp (``llama_param_specs`` fails on MoE layers), its
    ``moe_forward(mesh=)`` hands the mesh to an attention that needs dp/tp
    axes, and under sp its capacity would count global tokens while a rank
    holds its shard (ROADMAP.md watch list)."""
    if mesh is None:
        return 1
    if set(mesh.axis_names) - {EXPERT_AXIS}:
        raise NotImplementedError(
            f"MoE layers on a mesh of axes {mesh.axis_names}: only an \"ep\" mesh is "
            "supported (JAX has no specs for MoE under dp/tp/sp; ROADMAP.md watch list)")
    return mesh.size(EXPERT_AXIS)


def _expert_inputs(combine, xt, mesh):
    """combine and the dispatch's rows as a rank reads its own experts'
    slots of them: the gradient each rank's experts give is summed over
    "ep" here, once, before it reaches the gates and x (the aux loss, which
    reads the gates on every rank, stays outside the sum)."""
    return copy_to(combine, mesh, EXPERT_AXIS), copy_to(xt, mesh, EXPERT_AXIS)


def _moe_mlp(cfg: MoEConfig, layer, x, mesh=None):
    """Routed SwiGLU experts. x (B, S, D) -> (out (B, S, D), aux loss).

    All B * S rows route together (one capacity). The router runs in fp32
    on an fp32 copy of x; dispatch and combine are cast to x's dtype; the
    experts apply ``silu(gate)`` in fp32, whatever ``cfg.mlp_act`` says (as
    in the JAX package). With an "ep" ``mesh``, x is the same on every rank
    and ``layer["experts"]`` holds this rank's E / ep experts
    (:func:`shard_moe_params`): the routing runs whole on every rank, the
    rank's experts take their slots, and the outputs are summed over "ep".
    """
    b, s, d = x.shape
    t, e = b * s, cfg.n_experts
    ep = _ep_size(mesh)
    xt = x.reshape(t, d)
    gates = torch.softmax(xt.float() @ layer["router"].float(), dim=-1)
    capacity = _capacity(cfg, t)
    dispatch, combine, aux = _route(cfg, gates, capacity)
    xd = xt
    if ep > 1:
        combine, xd = _expert_inputs(combine, xt, mesh)
        n = e // ep
        lo = mesh.coord(EXPERT_AXIS) * n
        dispatch, combine, e = dispatch[:, lo:lo + n], combine[:, lo:lo + n], n

    w = layer["experts"]
    xe = (dispatch.to(x.dtype).reshape(t, e * capacity).t() @ xd).view(e, capacity, d)
    gate = torch.bmm(xe, w["w_gate"])
    up = torch.bmm(xe, w["w_up"])
    hidden = F.silu(gate.float()).to(x.dtype) * up
    ye = torch.bmm(hidden, w["w_down"])
    out = combine.to(x.dtype).reshape(t, e * capacity) @ ye.view(e * capacity, d)
    return reduce_from(out, mesh, EXPERT_AXIS).view(b, s, d), aux


def moe_forward(params, tokens, cfg: MoEConfig, mesh=None):
    """tokens (batch, seq) -> (logits (batch, seq, vocab) fp32, aux loss).

    The JAX ``moe_forward``'s function: the embedding row without
    ``embed_scale``, no sandwich norms, and the lm_head product without the
    final softcap (the serving path, ``models/decode.py``, applies all
    three). ``seq`` must be a multiple of the flash kernel's tile (64).
    Attention goes through autograd's flash kernels when a gradient is
    needed (``_attention``). ``mesh``: an "ep" mesh (expert parallelism,
    :func:`_moe_mlp`; ``params`` this rank's :func:`shard_moe_params`,
    ``tokens`` the same on every rank, and every rank gets the whole
    logits); a mesh with another axis raises ``NotImplementedError``.
    """
    _ep_size(mesh)
    x = params["embed"][tokens]
    cos, sin = rope_tables(tokens.shape[1], cfg.d_head, cfg.rope_theta, cfg,
                           device=x.device)
    aux_total = 0.0
    for li, layer in enumerate(params["layers"]):
        out, _, _ = _attention(layer, rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                               cfg, cos, sin, li)
        x = x + _o_proj(layer, out)
        h, aux = _moe_mlp(cfg, layer, rms_norm(x, layer["mlp_norm"], cfg.norm_eps), mesh)
        x = x + h
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _mm(x, params["lm_head"]).float(), aux_total / cfg.n_layers


def moe_loss_fn(params, tokens, cfg: MoEConfig, mesh=None):
    """Next-token cross-entropy (the mean over all positions) plus
    ``router_aux_weight`` times the aux loss; ``tokens`` (batch, seq + 1).
    ``mesh``: as in :func:`moe_forward`; every rank returns the same loss,
    and its gradients are the whole gradients of the replicated leaves and
    its own experts' slices."""
    logits, aux = moe_forward(params, tokens[:, :-1], cfg, mesh)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          tokens[:, 1:].reshape(-1))
    return nll + cfg.router_aux_weight * aux


def moe_param_specs(params) -> dict:
    """The JAX ``moe_param_specs``: ``("ep",)`` (a ``PartitionSpec``'s
    entries) on every leaf under ``experts``, ``()`` (replicated) on every
    other, in the tree of ``params``."""
    def spec(x, under_experts):
        if isinstance(x, dict):
            return {k: spec(v, under_experts or k == "experts") for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [spec(v, under_experts) for v in x]
        return (EXPERT_AXIS,) if under_experts else ()

    return spec(params, False)


def shard_moe_params(params, mesh) -> dict:
    """This rank's MoE parameters on the mesh's device: E / ep experts of
    every ``experts`` leaf (rank r the ones from r * E / ep), every other
    leaf whole. Each leaf is a copy. ``ValueError`` where ep does not
    divide the experts."""
    ep, r = mesh.size(EXPERT_AXIS), mesh.coord(EXPERT_AXIS)

    def place(x, spec):
        if isinstance(x, dict):
            return {k: place(v, spec[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [place(v, sp) for v, sp in zip(x, spec)]
        if spec:
            if x.shape[0] % ep:
                raise ValueError(f"{x.shape[0]} experts do not split over ep={ep}")
            n = x.shape[0] // ep
            x = x[r * n:(r + 1) * n]
        return x.to(mesh.device, copy=True).contiguous()

    return place(params, moe_param_specs(params))
