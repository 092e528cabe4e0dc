"""ctypes binding of the native paged-KV scheduler (``csrc/paged_runtime.cpp``).

Counterpart of ``flash_attention_from_scratch_tpu/serving/runtime.py`` over
the port's own copy of the same C++ source, built with ``g++`` into the
build directory (``ops/_build.py``). Bound here: admission, allocation,
commit, early finish, the speculative-decoding pair (``grow_batch``,
``commit_n``) and the counters the serving path reads. The prefix-cache
entry points of the same library are not bound yet (see ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np

from ..ops import _build

__all__ = ["PagedEngine", "Batch"]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_runtime.cpp")
    i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    lib.fa_engine_create.restype = vp
    lib.fa_engine_create.argtypes = [i32] * 4
    lib.fa_engine_destroy.argtypes = [vp]
    lib.fa_engine_add_request.restype = i32
    lib.fa_engine_add_request.argtypes = [vp, i64, i32, i32]
    lib.fa_engine_step.restype = i32
    lib.fa_engine_step.argtypes = [vp]
    lib.fa_engine_commit_tokens.restype = i32
    lib.fa_engine_commit_tokens.argtypes = [vp, ctypes.POINTER(i64), i32]
    lib.fa_engine_batch_size.restype = i32
    lib.fa_engine_batch_size.argtypes = [vp]
    lib.fa_engine_batch.argtypes = [vp, ctypes.POINTER(i64),
                                    ctypes.POINTER(i32), ctypes.POINTER(i32), i32]
    for name in ("fa_engine_free_pages", "fa_engine_waiting"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [vp]
    lib.fa_engine_preempt_count.restype = i64
    lib.fa_engine_preempt_count.argtypes = [vp]
    lib.fa_engine_finish.restype = i32
    lib.fa_engine_finish.argtypes = [vp, i64]
    lib.fa_engine_grow_batch.restype = i32
    lib.fa_engine_grow_batch.argtypes = [vp, i32]
    lib.fa_engine_commit_n.restype = i32
    lib.fa_engine_commit_n.argtypes = [vp, i64, i32]
    return lib


@dataclasses.dataclass
class Batch:
    """One decode step's batch composition."""

    ids: np.ndarray          # (n,) int64 sequence ids
    lengths: np.ndarray      # (n,) int32 current total length per sequence
    page_tables: np.ndarray  # (n, max_pages_per_seq) int32, -1 padded


class PagedEngine:
    """Continuous-batching scheduler over a paged KV pool (native core)."""

    def __init__(self, num_pages: int, page_size: int, max_batch: int,
                 max_pages_per_seq: int | None = None):
        self._lib = _lib()
        self.max_pages_per_seq = max_pages_per_seq or num_pages
        self._h = ctypes.c_void_p(
            self._lib.fa_engine_create(num_pages, page_size, max_batch,
                                       self.max_pages_per_seq))
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_batch = max_batch

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fa_engine_destroy(self._h)
            self._h = None

    def add_request(self, seq_id: int, prompt_len: int, max_new_tokens: int):
        rc = self._lib.fa_engine_add_request(self._h, seq_id, prompt_len,
                                             max_new_tokens)
        if rc != 0:
            raise ValueError(
                f"request {seq_id} rejected: duplicate id, or "
                f"{prompt_len}+{max_new_tokens} tokens cannot fit the pool / "
                f"the {self.max_pages_per_seq}-page per-sequence table / "
                f"the admission watermark")

    def step(self) -> Batch:
        """Admit + allocate for one decode step; returns the running batch."""
        n = self._lib.fa_engine_step(self._h)
        if n < 0:
            raise RuntimeError("scheduler deadlock: a sequence cannot grow")
        ids = np.zeros(n, np.int64)
        lens = np.zeros(n, np.int32)
        pages = np.zeros((n, self.max_pages_per_seq), np.int32)
        if n:
            self._lib.fa_engine_batch(
                self._h,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                pages.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self.max_pages_per_seq)
        return Batch(ids, lens, pages)

    def finish(self, seq_id: int):
        """Finish a sequence early (stop token), freeing its pages now."""
        if self._lib.fa_engine_finish(self._h, seq_id) != 0:
            raise KeyError(f"unknown sequence {seq_id}")

    def commit(self) -> list[int]:
        """Record one generated token per running sequence; returns finished ids."""
        cap = self.max_batch
        buf = (ctypes.c_int64 * cap)()
        n = self._lib.fa_engine_commit_tokens(self._h, buf, cap)
        return [buf[i] for i in range(min(n, cap))]

    def grow_batch(self, n: int) -> bool:
        """Reserve slots for n more tokens per running sequence (speculative
        draft headroom). All or nothing, and never preempts: False means the
        pool cannot cover it and the caller decodes one token instead."""
        return self._lib.fa_engine_grow_batch(self._h, n) == 0

    def commit_n(self, seq_id: int, n: int) -> bool:
        """Commit n accepted tokens of one sequence; True if it finished
        (budget reached, pages freed)."""
        rc = self._lib.fa_engine_commit_n(self._h, seq_id, n)
        if rc < 0:
            raise KeyError(f"unknown or idle sequence {seq_id}")
        return rc == 1

    @property
    def running(self) -> int:
        """Number of sequences in the current batch."""
        return self._lib.fa_engine_batch_size(self._h)

    @property
    def free_pages(self) -> int:
        return self._lib.fa_engine_free_pages(self._h)

    @property
    def waiting(self) -> int:
        return self._lib.fa_engine_waiting(self._h)

    @property
    def preempt_count(self) -> int:
        return self._lib.fa_engine_preempt_count(self._h)
