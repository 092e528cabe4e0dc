"""Multi-LoRA: per-request low-rank adapters batched into one decode step.

Counterpart of ``flash_attention_from_scratch_tpu/models/lora.py``. One
base model serves many fine-tunes: each adapter is a pair of stacked
low-rank factors a projection, ``A (n_adapters, in, r)`` and ``B
(n_adapters, r, out)``, and every row of a batch picks its own adapter by
id: a gather and two skinny batched products a projection, while the base
weights (dense or quantized) are read once for the whole batch. The deltas
add on the side in the activations' dtype, the QLoRA-style serving
arrangement. Adapter id -1 is the base model: its rows multiply like the
others and are zeroed after, so a step's shapes do not depend on the ids
(and a CUDA graph can take them as a static input).

The JAX package computes the two products outside any Pallas kernel, so
they stay plain PyTorch products here.

Under a tp mesh each adapter is sharded like its base weight
(:func:`shard_lora`): a rank's q, k and v deltas are its heads' columns,
and its wo delta is its head rows' part of the product, which joins wo's
partial product before the sum over tp (the delta is linear in the rows).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.quant_matmul import QuantizedWeight
from ..parallel.mesh import MODEL_AXIS
from ..utils.device import resolve_device
from .llama import LlamaConfig, params_from_jax

__all__ = ["LORA_KEYS", "init_lora_adapters", "lora_delta", "from_peft_state_dicts",
           "lora_from_jax", "merged_params", "n_adapters", "shard_lora"]

# Projections that carry adapters (the common attention-only default).
LORA_KEYS = ("wq", "wk", "wv", "wo")

_OUT_DIM = {"wq": lambda c: c.n_heads * c.d_head,
            "wk": lambda c: c.n_kv_heads * c.d_head,
            "wv": lambda c: c.n_kv_heads * c.d_head,
            "wo": lambda c: c.dim}
_IN_DIM = {"wq": lambda c: c.dim, "wk": lambda c: c.dim,
           "wv": lambda c: c.dim, "wo": lambda c: c.n_heads * c.d_head}


def init_lora_adapters(cfg: LlamaConfig, n_adapters: int, rank: int,
                       generator: torch.Generator, *, alpha: float | None = None,
                       zero_b: bool = True, device="cuda"):
    """Stacked adapters for every layer's attention projections:
    ``{"alpha": alpha / rank (a 0-d fp32 tensor), "layers": [{key: (A, B)}]}``
    with A ~ N(0, 1/in) and B zero (the standard init: the adapters start as
    the identity), or B ~ N(0, 1/rank) with ``zero_b=False``. The JAX
    package's distributions, drawn from ``generator`` (which must live on
    ``device``; the card by default), not its draws."""
    alpha = float(alpha if alpha is not None else rank)
    dev = resolve_device(device)
    dt = cfg.dtype.torch_dtype

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
                / math.sqrt(fan_in)).to(dt)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {}
        for k in LORA_KEYS:
            din, dout = _IN_DIM[k](cfg), _OUT_DIM[k](cfg)
            a = normal((n_adapters, din, rank), din)
            b = (torch.zeros((n_adapters, rank, dout), dtype=dt, device=dev) if zero_b
                 else normal((n_adapters, rank, dout), rank))
            layer[k] = (a, b)
        layers.append(layer)
    return {"alpha": torch.tensor(alpha / rank, dtype=torch.float32, device=dev),
            "layers": layers}


def n_adapters(lora) -> int:
    """Adapters of a stack (0 for None)."""
    return 0 if lora is None else lora["layers"][0]["wq"][0].shape[0]


_PEFT_NAMES = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj"}


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def from_peft_state_dicts(cfg: LlamaConfig, state_dicts, *, rank: int, alpha: float,
                          dtype=torch.bfloat16, device="cuda"):
    """Stack trained HF PEFT LoRA checkpoints into the serving layout.

    ``state_dicts``: one plain mapping of tensors (or arrays) per adapter, a
    PEFT ``state_dict()``'s keys (``...layers.N.self_attn.q_proj.lora_A.weight``,
    lora_A (r, in) and lora_B (out, r) in torch Linear layout); no ``peft``
    import is needed. Projections an adapter does not target get zero
    factors (the identity). Every adapter must have rank ``rank``
    (``ValueError`` otherwise). Returns the stack ``GenerationServer(lora=)``
    takes, in ``dtype`` on ``device`` (the card by default).
    """
    dev = resolve_device(device)
    n = len(state_dicts)
    layers = []
    for li in range(cfg.n_layers):
        layer = {}
        for ours, theirs in _PEFT_NAMES.items():
            din, dout = _IN_DIM[ours](cfg), _OUT_DIM[ours](cfg)
            a = np.zeros((n, din, rank), np.float32)
            b = np.zeros((n, rank, dout), np.float32)
            for ai, sd in enumerate(state_dicts):
                hit = [k for k in sd if f"layers.{li}." in k and f"{theirs}.lora_A" in k]
                if not hit:
                    continue
                a_t = _to_numpy(sd[hit[0]])  # (r, in)
                b_t = _to_numpy(sd[hit[0].replace("lora_A", "lora_B")])  # (out, r)
                if a_t.shape[0] != rank:
                    raise ValueError(f"adapter {ai} {theirs} rank {a_t.shape[0]} != {rank}")
                a[ai] = a_t.T
                b[ai] = b_t.T
            layer[ours] = tuple(torch.from_numpy(x).to(dev, dtype) for x in (a, b))
        layers.append(layer)
    return {"alpha": torch.tensor(alpha / rank, dtype=torch.float32, device=dev),
            "layers": layers}


def lora_from_jax(tree, device="cuda"):
    """The JAX package's adapter stack (``{"alpha", "layers": [{key: (A,
    B)}]}``, numpy or JAX leaves) as the port's, leaves in their dtype
    (``models.llama.params_from_jax``'s conversion)."""
    return {"alpha": params_from_jax(np.asarray(tree["alpha"], np.float32), device),
            "layers": [{k: tuple(params_from_jax(x, device) for x in ab)
                        for k, ab in layer.items()} for layer in tree["layers"]]}


# The dim of A (0) or B (1) a tp rank slices, as its base weight: wq, wk, wv
# column-parallel (B's output columns), wo row-parallel (A's input rows).
_TP_SLICE = {"wq": (1, 2), "wk": (1, 2), "wv": (1, 2), "wo": (0, 1)}


def shard_lora(lora, mesh):
    """This rank's adapters under a tp ``mesh`` (``parallel.mesh.make_mesh``),
    on the mesh's device: for ``wq``/``wk``/``wv`` B's columns of the rank's
    q or kv heads (A whole), for ``wo`` A's rows of the rank's q heads (B
    whole), ``alpha`` whole. Each leaf is a copy."""
    from ..parallel.mesh import MODEL_AXIS

    tp, r = mesh.size(MODEL_AXIS), mesh.coord(MODEL_AXIS)

    def part(ab, key):
        which, dim = _TP_SLICE[key]
        out = []
        for i, x in enumerate(ab):
            if i == which and tp > 1:
                n = x.shape[dim] // tp
                x = x.narrow(dim, r * n, n)
            out.append(x.to(mesh.device, copy=True).contiguous())
        return tuple(out)

    return {"alpha": lora["alpha"].to(mesh.device, copy=True),
            "layers": [{k: part(ab, k) for k, ab in layer.items()}
                       for layer in lora["layers"]]}


def lora_delta(lora, li: int, name: str, x, adapter_ids):
    """Per-row adapter delta of projection ``name`` of layer ``li``, the
    JAX package's function: x (batch, s, in), ``adapter_ids`` (batch,) int
    (-1: none). The ids clamped at 0 gather A and B, two batched products
    in x's dtype, the result in fp32 times alpha, zero where the id is -1,
    cast to x's dtype: (batch, s, out). 0.0 without ``lora`` or without an
    adapter on ``name``."""
    if lora is None or name not in lora["layers"][li]:
        return 0.0
    a, b = lora["layers"][li][name]
    safe = adapter_ids.clamp(min=0).long()
    h = torch.bmm(x, a[safe])          # (batch, s, r)
    out = torch.bmm(h, b[safe]).float() * lora["alpha"]
    out = torch.where((adapter_ids >= 0)[:, None, None], out, 0.0)
    return out.to(x.dtype)


def _merge(w, delta):
    if isinstance(w, QuantizedWeight):
        return (w.stored_columns() * w.scales[None, :].float() + delta).to(w.orig_dtype)
    return (w.float() + delta).to(w.dtype)


def merged_params(params, lora, adapter: int):
    """The dense model of adapter ``adapter``: every adapted projection (or
    its columns of a fused ``wqkv``) as W + alpha * A_i @ B_i in fp32, cast
    to W's dtype; a quantized W is dequantized first (so the result is a
    dense weight). The oracle of multi-LoRA serving: the served tokens of
    that adapter's rows, teacher-forced through ``forward``."""
    alpha = float(lora["alpha"])
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for li, layer in enumerate(params["layers"]):
        new = dict(layer)
        deltas = {k: (a[adapter].float() @ b[adapter].float()) * alpha
                  for k, (a, b) in lora["layers"][li].items()}
        for k, d in deltas.items():
            if k in layer:
                new[k] = _merge(layer[k], d)
        if "wqkv" in layer:
            new["wqkv"] = _merge(layer["wqkv"], torch.cat([deltas[k] for k in ("wq", "wk", "wv")],
                                                          dim=1))
        out["layers"].append(new)
    return out
