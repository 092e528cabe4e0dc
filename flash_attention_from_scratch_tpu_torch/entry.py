"""The forward of the flagship model's small config, as one callable.

Counterpart of the JAX package's ``__graft_entry__.entry()``: the same
2-layer config (vocab 512, dim 1024, 8 query and 4 KV heads of width 128,
hidden 1024) and a (2, 256) token batch. The weights are random from a
``torch.Generator`` seeded 0 and the tokens from one seeded 1: the JAX
package's distributions, not its draws.
"""

from __future__ import annotations

import torch

from .models.llama import LlamaConfig, forward, init_params
from .utils.device import resolve_device

__all__ = ["entry", "small_config"]


def small_config(n_heads: int = 8, n_kv_heads: int = 4) -> LlamaConfig:
    return LlamaConfig(vocab_size=512, dim=n_heads * 128, n_layers=2, n_heads=n_heads,
                       n_kv_heads=n_kv_heads, d_head=128, hidden_dim=1024)


def entry(device="cuda"):
    """(fn, example_args): ``fn(params, tokens)`` is the model's forward,
    logits (2, 256, 512) fp32, on ``device`` (the card by default; raises
    without one; ``"cpu"`` runs the plain kernel versions)."""
    dev = resolve_device(device)
    cfg = small_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)
