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

Expert parallelism (``EXPERT_AXIS``, ``moe_param_specs``,
``shard_moe_params``) belongs to the parallel layer, which is not ported
yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .llama import (
    LlamaConfig, _attention, _dense_init, _mm, _o_proj, init_params, rms_norm,
    rope_tables,
)

__all__ = ["MoEConfig", "init_moe_params", "moe_forward", "moe_loss_fn"]


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


def _moe_mlp(cfg: MoEConfig, layer, x):
    """Routed SwiGLU experts. x (B, S, D) -> (out (B, S, D), aux loss).

    All B * S rows route together (one capacity). The router runs in fp32
    on an fp32 copy of x; dispatch and combine are cast to x's dtype; the
    experts apply ``silu(gate)`` in fp32, whatever ``cfg.mlp_act`` says (as
    in the JAX package).
    """
    b, s, d = x.shape
    t, e = b * s, cfg.n_experts
    xt = x.reshape(t, d)
    gates = torch.softmax(xt.float() @ layer["router"].float(), dim=-1)
    capacity = _capacity(cfg, t)
    dispatch, combine, aux = _route(cfg, gates, capacity)

    w = layer["experts"]
    xe = (dispatch.to(x.dtype).view(t, e * capacity).t() @ xt).view(e, capacity, d)
    gate = torch.bmm(xe, w["w_gate"])
    up = torch.bmm(xe, w["w_up"])
    hidden = F.silu(gate.float()).to(x.dtype) * up
    ye = torch.bmm(hidden, w["w_down"])
    out = combine.to(x.dtype).view(t, e * capacity) @ ye.view(e * capacity, d)
    return out.view(b, s, d), aux


def moe_forward(params, tokens, cfg: MoEConfig):
    """tokens (batch, seq) -> (logits (batch, seq, vocab) fp32, aux loss).

    The JAX ``moe_forward``'s function: the embedding row without
    ``embed_scale``, no sandwich norms, and the lm_head product without the
    final softcap (the serving path, ``models/decode.py``, applies all
    three). ``seq`` must be a multiple of the flash kernel's tile (64).
    Attention goes through autograd's flash kernels when a gradient is
    needed (``_attention``).
    """
    x = params["embed"][tokens]
    cos, sin = rope_tables(tokens.shape[1], cfg.d_head, cfg.rope_theta, cfg,
                           device=x.device)
    aux_total = 0.0
    for li, layer in enumerate(params["layers"]):
        out, _, _ = _attention(layer, rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                               cfg, cos, sin, li)
        x = x + _o_proj(layer, out)
        h, aux = _moe_mlp(cfg, layer, rms_norm(x, layer["mlp_norm"], cfg.norm_eps))
        x = x + h
        aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _mm(x, params["lm_head"]).float(), aux_total / cfg.n_layers


def moe_loss_fn(params, tokens, cfg: MoEConfig):
    """Next-token cross-entropy (the mean over all positions) plus
    ``router_aux_weight`` times the aux loss; ``tokens`` (batch, seq + 1)."""
    logits, aux = moe_forward(params, tokens[:, :-1], cfg)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          tokens[:, 1:].reshape(-1))
    return nll + cfg.router_aux_weight * aux
