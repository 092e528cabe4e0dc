"""Training step: AdamW over the Llama loss.

Counterpart of ``flash_attention_from_scratch_tpu/models/train.py`` without
a mesh. The JAX step is a pure function of (params, opt_state, tokens); here
the optimizer owns its state and updates the parameter tensors in place,
which keeps one copy of the weights on the card.
"""

from __future__ import annotations

import torch

from .llama import LlamaConfig, loss_fn

__all__ = ["make_optimizer", "make_train_step", "param_leaves"]


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
    """
    leaves = list(param_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=weight_decay)


def make_train_step(cfg: LlamaConfig, optimizer: torch.optim.Optimizer,
                    remat: bool = False):
    """Returns ``step(params, tokens) -> loss``, the loss before the update.

    ``params`` must be the tree ``optimizer`` was made over; ``tokens``
    (batch, seq + 1). ``remat=True`` checkpoints each layer. The model's
    causal attention backward runs the split kernels (K3), the faster on
    the card, whose sums have a fixed order
    (``ops/flash_backward.py::fused_choice``).
    """

    def step(params, tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, tokens, cfg, remat=remat)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
