"""Build and load the port's native code: CUDA kernels and the scheduler.

Each source in ``csrc/`` becomes a shared library with a plain C interface,
loaded with ``ctypes``: ``*.cu`` through ``nvcc`` for ``sm_90a``, ``*.cpp``
through ``g++``. Libraries are built at first use into
``build/torch_kernels/`` at the root of the checkout, named by a hash of
their source and the ``csrc/`` headers it includes, so an edited source or
header is rebuilt and an unchanged one is not.
Several sources build in parallel (:func:`build`).

Every kernel entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception. ``launch_counts``
holds, per kernel, the launches its wrapper has made.

A kernel's activation type is fixed when its library is built: a source
builds its bf16 kernels, ``<stem>_f16.cu`` (the source built with
``FA_F16``) the fp16 ones, a library of its own, and for K1 and K11
``<stem>_f32.cu`` their fp32 kernels, on a main loop of their own
(``csrc/flash_f32.cuh``; :func:`typed_source`).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

import torch

__all__ = ["build", "load", "check", "typed_source", "launch_counts", "BUILD_DIR",
           "ROADMAP_FP32", "FP32_SOURCES"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "torch_kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

# Kernel name -> launches made by its wrapper (the wrapper adds one where it
# launches, and nowhere else).
launch_counts: collections.Counter = collections.Counter()

# Where the kernels get the type they refuse on the card: the ROADMAP
# sub-item that brings each source's fp32 library.
ROADMAP_FP32 = "fp32 with exact products: ROADMAP Queue 1, item {}"
_FP32_ITEMS = {"paged_attention.cu": "4c-2", "quant_matmul.cu": "4c-2",
               "flash_backward.cu": "4c-3", "flash_backward_d256.cu": "4c-3",
               "flash_quant.cu": "4c-3", "flash_quant_d256.cu": "4c-3"}
# The sources with an fp32 library ``<stem>_f32.cu`` (K1 and K11).
FP32_SOURCES = ("flash_forward.cu", "flash_forward_fori.cu", "flash_forward_fori_d256.cu")


def typed_source(source: str, dtype: torch.dtype, kernel: str) -> str:
    """The ``csrc/`` source whose library holds ``kernel``'s kernels for
    activations of ``dtype`` on the card: ``source`` itself for bf16, its
    fp16 library ``<stem>_f16.cu`` for fp16, and for K1's and K11's sources
    (:data:`FP32_SOURCES`) their fp32 library ``<stem>_f32.cu``. Any other
    type raises ``ValueError`` (fp32 naming the ROADMAP sub-item that will
    bring it); no wrapper converts a type for its kernel."""
    stem, ext = os.path.splitext(source)
    if dtype == torch.bfloat16:
        return source
    if dtype == torch.float16:
        return f"{stem}_f16{ext}"
    if dtype == torch.float32 and source in FP32_SOURCES:
        return f"{stem}_f32{ext}"
    if dtype == torch.float32:
        raise ValueError(f"{kernel} takes bf16 and fp16 on the card, got {dtype} "
                         f"({ROADMAP_FP32.format(_FP32_ITEMS[source])})")
    raise ValueError(f"{kernel} takes bf16, fp16 and (K1, K11) fp32 on the card, got "
                     f"{dtype} (not a type the JAX package's kernels take)")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def _source_hash(src: str) -> str:
    """sha256 over a source and, recursively, the local headers it
    includes (``#include "..."``, resolved beside the including file)."""
    digest, seen = hashlib.sha256(), set()

    def add(path: str) -> None:
        if path in seen:
            return
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        digest.update(text)
        for inc in _LOCAL_INCLUDE.findall(text):
            add(os.path.join(os.path.dirname(path), inc.decode()))

    add(src)
    return digest.hexdigest()[:16]


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(_CSRC, name)
    tag = _source_hash(src)
    stem = os.path.splitext(name)[0]
    return src, os.path.join(BUILD_DIR, f"{stem}_{tag}.so")


def build(names) -> dict[str, str]:
    """Build the named ``csrc/`` sources that are not built yet, in parallel.

    Returns {name: compiler output} for the sources built by this call (with
    ``nvcc``, the registers, shared memory and spills of each kernel).
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, so = _target(name)
        if os.path.exists(so):
            continue
        # Build to a unique path, then rename: atomic against processes
        # building the same source at once.
        tmp = f"{so}.{os.getpid()}.tmp"
        if name.endswith(".cu"):
            cmd = [_nvcc(), *NVCC_FLAGS, src, "-o", tmp]
        else:
            cmd = ["g++", *GXX_FLAGS, src, "-o", tmp]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>``, built if needed."""
    build([name])
    lib = ctypes.CDLL(_target(name)[1])
    if name.endswith(".cu"):
        lib.fa_error_string.restype = ctypes.c_char_p
        lib.fa_error_string.argtypes = [ctypes.c_int]
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.fa_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
