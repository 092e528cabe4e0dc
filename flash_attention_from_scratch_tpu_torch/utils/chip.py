"""The card's identity and a measured matmul ceiling.

Counterpart of ``flash_attention_from_scratch_tpu/utils/chip.py``: the
card's name and power limit, the published peaks of an NVIDIA H100 SXM
(``tools/bench_decode.py``'s roofline), and the rate a large bf16
``torch.matmul`` (cuBLAS) sustains on the card, the yardstick
``tools/bench_quant.py`` divides by.
"""

from __future__ import annotations

import functools
import subprocess

import torch

from ..dispatch import median_runtime

__all__ = ["device_kind", "measured_matmul_tflops", "chip_sol_tflops",
           "chip_int8_tops", "hbm_gbps"]


def chip_sol_tflops() -> float:
    """Dense bf16 tensor-core peak of an NVIDIA H100 SXM at its full 700 W
    power limit, in TFLOP/s (NVIDIA's data sheet): 989."""
    return 989.0


def chip_int8_tops() -> float:
    """Dense int8 tensor-core peak of an NVIDIA H100 SXM at 700 W, in TOP/s
    (NVIDIA's data sheet): 1979."""
    return 1979.0


def hbm_gbps() -> float:
    """HBM3 bandwidth of an NVIDIA H100 SXM (80 GB), in GB/s (NVIDIA's data
    sheet): 3350."""
    return 3350.0


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
