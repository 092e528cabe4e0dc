"""Device selection for the port's entry points."""

from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "sm_count"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present, so an entry point never runs on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "versions of the kernels on the CPU")
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA device ``device``."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
