"""Checkpoint and resume of training state, on ``torch.save``.

Counterpart of ``flash_attention_from_scratch_tpu/utils/checkpoint.py``
(Orbax there): a state tree (dicts, lists and tuples of tensors and plain
values, such as ``{"params": params, "opt": optimizer.state_dict()}``) is
saved under ``path/step_XXXXXXXX``, and the latest step is the highest
number among the ``step_*`` entries, as in the JAX package.

The file is read back with ``torch.load(weights_only=True)``, which refuses
custom classes, so a :class:`~..ops.quant_matmul.QuantizedWeight` is stored
as a tagged dict of its tensors and its mode, recipe and original dtype,
and rebuilt on restore.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ..ops.quant_matmul import QuantizedWeight

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_FILE = "state.pt"
_QW = "__quantized_weight__"  # the tag of a stored QuantizedWeight


def _step_dir(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step:08d}")


def _pack(x):
    """``x`` as a tree of what ``torch.load(weights_only=True)`` takes."""
    if isinstance(x, QuantizedWeight):
        return {_QW: True, "values": x.values, "scales": x.scales, "mode": x.mode,
                "act": x.act, "orig_dtype": str(x.orig_dtype).removeprefix("torch.")}
    if isinstance(x, dict):
        return {k: _pack(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_pack(v) for v in x)
    return x


def _place(x, template, where: str):
    """The loaded tree ``x`` with each tensor on its template leaf's device
    and in its dtype; a stored QuantizedWeight rebuilt on the template's
    device. The two trees must have one structure (``ValueError``)."""
    if isinstance(x, dict) and x.get(_QW):
        if not isinstance(template, QuantizedWeight):
            raise ValueError(f"checkpoint {where}: a QuantizedWeight where the template "
                             f"has {type(template).__name__}")
        dev = template.values.device
        return QuantizedWeight(x["values"].to(dev), x["scales"].to(dev), x["mode"],
                               getattr(torch, x["orig_dtype"]), x["act"])
    if isinstance(x, dict):
        if not isinstance(template, dict) or template.keys() != x.keys():
            raise ValueError(f"checkpoint {where}: keys {sorted(map(str, x))} against the "
                             f"template's {type(template).__name__}")
        return {k: _place(v, template[k], f"{where}[{k!r}]") for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        if not isinstance(template, (list, tuple)) or len(template) != len(x):
            raise ValueError(f"checkpoint {where}: {len(x)} items against the template's "
                             f"{type(template).__name__}")
        return type(x)(_place(v, t, f"{where}[{i}]")
                       for i, (v, t) in enumerate(zip(x, template)))
    if isinstance(x, torch.Tensor):
        if not isinstance(template, torch.Tensor) or template.shape != x.shape:
            raise ValueError(f"checkpoint {where}: a tensor of shape {tuple(x.shape)} "
                             f"against the template's {getattr(template, 'shape', template)}")
        return x.to(device=template.device, dtype=template.dtype)
    return x


def save_checkpoint(path: str, state: Any, step: int) -> str:
    """Save ``state`` under ``path/step_XXXXXXXX`` (written to a temporary
    file, then renamed over any earlier one). Returns the directory."""
    d = _step_dir(path, step)
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, _FILE + ".tmp")
    torch.save(_pack(state), tmp)
    os.replace(tmp, os.path.join(d, _FILE))
    return d


def latest_step(path: str) -> int | None:
    """Highest step number saved under ``path`` (None if empty or missing)."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(path: str, template: Any, step: int | None = None) -> Any:
    """Restore the state saved at ``step`` (default: the latest).

    ``template`` is a tree of the saved structure (the state as it was
    saved, or one like it): each restored tensor takes its template leaf's
    device and dtype. No checkpoint raises ``FileNotFoundError``.
    """
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path!r}")
    state = torch.load(os.path.join(_step_dir(path, step), _FILE), map_location="cpu",
                       weights_only=True)
    return _place(state, template, "state")
