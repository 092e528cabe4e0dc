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

__all__ = ["build", "load", "check", "launch_counts", "BUILD_DIR"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "torch_kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

# Kernel name -> launches made by its wrapper (the wrapper adds one where it
# launches, and nowhere else).
launch_counts: collections.Counter = collections.Counter()


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
