"""Training step: AdamW over the Llama loss.

Counterpart of ``flash_attention_from_scratch_tpu/models/train.py``. The
JAX step is a pure function of (params, opt_state, tokens); here the
optimizer owns its state and updates the parameter tensors in place, which
keeps one copy of the weights on the card. Under a mesh each rank steps its
own shard of the parameters (``parallel.mesh.shard_params``).

An fp16 model trains through ``make_train_step(cfg, optimizer)`` with an
optimizer that keeps no second moment, such as ``torch.optim.SGD`` (the
counterpart of ``optax.sgd``): :func:`make_optimizer` raises on fp16 leaves
(see there).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import reduce_from
from ..parallel.mesh import DATA_AXIS, SEQ_AXIS
from .llama import LlamaConfig, loss_fn

__all__ = ["make_optimizer", "make_train_step", "param_leaves", "sum_data_gradients"]


def param_leaves(params):
    """The tensors of a parameter tree (dicts and lists), in tree order."""
    if isinstance(params, dict):
        for v in params.values():
            yield from param_leaves(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from param_leaves(v)
    else:
        yield params


def make_optimizer(params, lr: float = 3e-4,
                   weight_decay: float = 0.1) -> torch.optim.AdamW:
    """AdamW over every leaf of ``params``, as ``optax.adamw(lr, b1=0.9,
    b2=0.95, weight_decay=0.1)``: eps 1e-8 outside the square root, decay
    on every leaf (no mask), moments in the parameter dtype.

    Marks every leaf as requiring grad. ``step`` updates the leaves in
    place: the tree the caller holds is the trained one.

    Raises ``ValueError`` on fp16 leaves, where the JAX package's
    ``optax.adamw`` (and this AdamW, which copies it) gives non-finite
    parameters on the first step: eps = 1e-8 rounds to 0 in fp16, and
    (1 - b2) g^2 underflows to 0 for |g| below about 8e-4, so the update
    m / (sqrt(v) + eps) divides by 0. Train fp16 with
    ``make_train_step(cfg, torch.optim.SGD(leaves, lr))``.
    """
    leaves = list(param_leaves(params))
    if any(p.dtype == torch.float16 for p in leaves):
        raise ValueError(
            "make_optimizer: AdamW over fp16 parameters gives non-finite parameters on "
            "the first step (eps 1e-8 and the second moment (1 - b2) g^2 underflow to 0 "
            "in fp16, as in optax.adamw); train fp16 with make_train_step(cfg, "
            "torch.optim.SGD(...)) or keep the parameters in bf16 or fp32")
    for p in leaves:
        p.requires_grad_(True)
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=weight_decay)


def sum_data_gradients(params, mesh) -> None:
    """Sum each gradient over the data axes (dp, sp), in place.

    Under a mesh every rank's gradients are its rows' share of the global
    loss's; summed over the ranks that hold other rows of the same shard,
    each is the whole gradient of that shard, the same on all of them, as
    JAX's ``jax.grad`` of the sharded loss. The attention sums the sinks'
    gradient over its own axis already (the ring over sp,
    ``shard_mapped_attention`` over dp, as JAX's psum and ``shard_map``
    transpose do), so they skip that axis.
    """
    sink_axis = SEQ_AXIS if SEQ_AXIS in mesh.axis_names else DATA_AXIS
    named = [(k, params[k]) for k in params if k != "layers"]
    named += [kv for layer in params["layers"] for kv in layer.items()]
    for axis in (DATA_AXIS, SEQ_AXIS):
        if mesh.size(axis) == 1:
            continue
        for key, p in named:
            if p.grad is not None and not (key == "attn_sinks" and axis == sink_axis):
                p.grad.copy_(reduce_from(p.grad, mesh, axis))


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer,
                    remat: bool = False, mesh=None):
    """Returns ``step(params, tokens) -> loss``, the loss before the update.

    ``params`` must be the tree ``optimizer`` was made over; ``tokens``
    (batch, seq + 1). ``remat=True`` checkpoints each layer. The model's
    causal attention backward runs the split kernels (K3), the faster on
    the card, whose sums have a fixed order
    (``ops/flash_backward.py::fused_choice``). With ``mesh`` every rank
    passes the same global ``tokens`` and its parameter shard: the loss is
    the global mean, the gradients are summed over dp and sp
    (:func:`sum_data_gradients`), and each rank's AdamW updates its shard.
    """

    def step(params, tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg, remat=remat, mesh=mesh)
        loss.backward()
        if mesh is not None:
            sum_data_gradients(params, mesh)
        optimizer.step()
        return loss.detach()

    return step
