"""The card's identity and a measured matmul ceiling.

Counterpart of ``flash_attention_from_scratch_tpu/utils/chip.py``. The
published peaks of the card a kernel is held against live beside each
measurement (``chip_smoke.py``); this module names the card and measures
the rate a large bf16 ``torch.matmul`` (cuBLAS) sustains on it, the
yardstick ``tools/bench_quant.py`` divides by.
"""

from __future__ import annotations

import functools
import subprocess

import torch

from ..dispatch import median_runtime

__all__ = ["device_kind", "measured_matmul_tflops"]


def device_kind() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (for
    example ``NVIDIA H100 80GB HBM3, 700.00 W``): a card set below its full
    power limit runs slower under load, so every time stands beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


_MATMUL_N = 8192


@functools.lru_cache(maxsize=1)
def measured_matmul_tflops() -> float:
    """TFLOP/s of an 8192-cubed bf16 ``torch.matmul`` on the card, timed
    with CUDA events: the tensor-core rate this card sustains, a ceiling
    for attention kernels measured on it. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("measured_matmul_tflops needs a CUDA device")
    n = _MATMUL_N
    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randn(n, n, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    secs = median_runtime(lambda: torch.matmul(a, b))
    return 2 * n ** 3 / secs / 1e12
