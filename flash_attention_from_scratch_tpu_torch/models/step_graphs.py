"""Captured decode steps: the port's form of the JAX package's ``jax.jit``.

The JAX package jits ``decode_step``, ``verify_step`` and ``decode_loop``
with the cache donated (``jax.jit(..., donate_argnames=("cache",))`` in its
``models/decode.py``), so a whole step is one dispatch. The PyTorch
counterpart for a step of fixed shapes is a ``torch.cuda.CUDAGraph``:
:class:`StepGraphs` captures the eager step (``models/decode.py::_step``)
once per (batch, t, pages per sequence) and the decode loop once per step
count, over static token, length and page-table buffers. The server's
steps and loops also take each row's key and position as static buffers
and pick their tokens inside the graph (``models/decode.py::pick_keyed``
and ``loop_pick``: greedy, or sampled on the noise of ``sample_noise``);
temperature and top-k are fixed per object. With LoRA adapters
(``models/lora.py``, fixed per object and read by address) each row's
adapter id is one more static buffer of the decode steps and loops; an
object without adapters captures the graphs it captured before them.
The graphs write the cache's pools in place (the donation) and share one
memory pool. A call
copies its inputs into the static buffers, replays the graph and returns
its static outputs, which the next call of the same shape overwrites.

Capture needs the kernels' libraries built and their one-time set-up done,
so each shape's first call runs the eager step once on a side stream (with
the call's own inputs: the replay that follows writes the same pages with
the same values), then captures. A capture that fails raises; nothing
falls back to eager. Launches are counted per replay: the kernels' wrappers
count on the host, once, at capture (``ops/_build.py::launch_counts``), so
each graph keeps the counts its capture added and adds them again on every
replay; the warm-up's and the capture's own counts are taken back.

Every graph also adds the number of non-finite logits it computed to one
device counter (:meth:`StepGraphs.nonfinite_logits`): a served token of
``pick_step`` or a loop is picked on the card, from logits no caller sees.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from ..ops import _build
from ..ops.quant import KVQuantMode
from .decode import (
    PagedKVCache, _step, check_no_sinks, loop_pick, pick_keyed, pick_loop,
)
from .llama import LlamaConfig

__all__ = ["StepGraphs"]


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: dict       # name -> static device tensor the graph reads
    outputs: tuple     # static device tensors the graph writes
    launches: collections.Counter  # kernel launches of one replay


class StepGraphs:
    """CUDA graphs of the decode step, the verify step and the decode loop
    of one model over one paged cache.

    ``params``, ``cfg`` and ``cache`` are fixed for the object's life: the
    graphs hold the addresses of the weights and of the cache's pools.
    ``attn_int8`` selects the paged kernel's int8 compute (int8 cache
    only). ``temperature`` and ``top_k`` shape every pick the graphs make
    (greedy at ``temperature <= 0``). ``lora``: the adapters every step
    applies, each row by its id (``adapter_ids`` of the calls, (batch,)
    int, -1 for the base model; required with ``lora``); single-token
    steps and loops only, as in serving (a verify step of t > 1 raises
    ``ValueError``). ``graphs`` counts the captures made and ``replays``
    the replays.
    """

    def __init__(self, params, cfg: LlamaConfig, cache: PagedKVCache, *,
                 attn_int8: bool = False, temperature: float = 0.0,
                 top_k: int = 0, lora=None):
        check_no_sinks(cfg)
        if attn_int8 and cache.mode != KVQuantMode.INT8:
            raise ValueError(f"attn_int8 requires an int8 KV cache; mode={cache.mode!r}")
        self.device = cache.k_pages[0].device
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need the cache on the card, not {self.device}")
        self.params, self.cfg, self.cache = params, cfg, cache
        self.attn_int8 = attn_int8
        self.temperature, self.top_k = temperature, top_k
        self.lora = lora
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs: dict = {}
        self._nonfinite = torch.zeros((), dtype=torch.int64, device=self.device)
        self.replays = 0

    @property
    def graphs(self) -> int:
        return len(self._graphs)

    def nonfinite_logits(self) -> int:
        """Non-finite logits the replays have computed so far (a host read)."""
        return int(self._nonfinite)

    def _logits(self, tokens, lengths, page_tables, adapter_ids=None):
        logits, _ = _step(self.params, tokens, self.cfg, self.cache, lengths,
                          page_tables, self.lora, None, self.attn_int8, adapter_ids)
        self._nonfinite.add_((~torch.isfinite(logits)).sum())
        return logits

    def _capture(self, body, inputs: dict) -> _Graph:
        static = {name: x.to(self.device, copy=True) for name, x in inputs.items()}
        counted = collections.Counter(_build.launch_counts)
        nonfinite = self._nonfinite.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            body(**static)  # builds, plans, tensor maps, cuBLAS set-up
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._nonfinite.copy_(nonfinite)
        _restore(counted)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            outputs = body(**static)
        launches = _build.launch_counts - counted
        _restore(counted)
        return _Graph(graph, static, outputs, launches)

    def _replay(self, key, body, inputs: dict) -> tuple:
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(body, inputs)
        for name, x in inputs.items():
            g.inputs[name].copy_(x)
        g.graph.replay()
        _build.launch_counts.update(g.launches)
        self.replays += 1
        return g.outputs

    def _adapters(self, inputs: dict, adapter_ids, t: int) -> dict:
        """``inputs`` plus the adapter ids' static buffer when LoRA is on."""
        if self.lora is None:
            return inputs
        if adapter_ids is None:
            raise ValueError("a StepGraphs with lora needs adapter_ids, one a row")
        if t > 1:
            raise ValueError("LoRA serving runs single-token steps: no verify "
                             f"step of t = {t} (as in the JAX package)")
        return {**inputs, "adapter_ids": adapter_ids}

    def verify_step(self, tokens, lengths, page_tables, adapter_ids=None):
        """:func:`~.decode.verify_step` by replay: tokens (batch, t) at
        positions lengths - t + j; returns logits (batch, t, vocab) fp32
        (a static buffer)."""
        key = ("step", self.lora is not None) + tuple(tokens.shape) + (page_tables.shape[1],)
        inputs = {"tokens": tokens, "lengths": lengths, "page_tables": page_tables}
        return self._replay(key, lambda **kw: (self._logits(**kw),),
                            self._adapters(inputs, adapter_ids, tokens.shape[1]))[0]

    def decode_step(self, tokens, lengths, page_tables, adapter_ids=None):
        """:func:`~.decode.decode_step` by replay: tokens (batch,), lengths
        including them; returns logits (batch, vocab) fp32 (a view of a
        static buffer)."""
        return self.verify_step(tokens[:, None], lengths, page_tables, adapter_ids)[:, 0]

    def pick_step(self, tokens, lengths, page_tables, draft_lens, row_keys, pos0,
                  adapter_ids=None):
        """A decode (t = 1) or verify step by replay with the server's pick
        inside the graph: :func:`~.decode.pick_keyed` on the step's logits,
        the drafts ``tokens[:, 1:]`` (``draft_lens`` real ones a row) and
        each row's key and position (each (batch,)); greedy at
        ``temperature <= 0``. Returns (tokens (batch, t), n_emit (batch,)),
        static buffers."""
        def body(tokens, lengths, page_tables, draft_lens, row_keys, pos0,
                 adapter_ids=None):
            logits = self._logits(tokens, lengths, page_tables, adapter_ids)
            return pick_keyed(logits, tokens[:, 1:], draft_lens, row_keys, pos0,
                              self.temperature, self.top_k)

        key = ("pick", self.lora is not None) + tuple(tokens.shape) + (page_tables.shape[1],)
        return self._replay(key, body, self._adapters({
            "tokens": tokens, "lengths": lengths, "page_tables": page_tables,
            "draft_lens": draft_lens, "row_keys": row_keys, "pos0": pos0},
            adapter_ids, tokens.shape[1]))

    def decode_loop(self, tokens, lengths, page_tables, steps: int, *,
                    row_keys=None, pos0=None, adapter_ids=None):
        """:func:`~.decode.decode_loop` by replay: ``steps`` decode steps in
        one graph, each step's pick the next step's token on the card
        (greedy, or with ``row_keys`` and ``pos0`` sampled at positions
        pos0 + i). ``lengths`` are the committed lengths, excluding the
        tokens generated here. Returns (tokens (batch, steps), lengths +
        steps), static buffers."""
        inputs = {"tokens": tokens, "lengths": lengths, "page_tables": page_tables}
        if row_keys is not None:
            inputs.update(row_keys=row_keys, pos0=pos0)

        def body(tokens, lengths, page_tables, row_keys=None, pos0=None, adapter_ids=None):
            pick = loop_pick(row_keys, pos0, self.temperature, self.top_k)
            return pick_loop(lambda toks, lens: self._logits(
                toks[:, None], lens, page_tables, adapter_ids)[:, 0], pick, tokens,
                lengths, steps)

        key = ("loop", steps, tokens.shape[0], page_tables.shape[1], row_keys is not None,
               self.lora is not None)
        return self._replay(key, body, self._adapters(inputs, adapter_ids, 1))


def _restore(counts: collections.Counter) -> None:
    """Set the launch counts back to ``counts`` (the same Counter object)."""
    _build.launch_counts.clear()
    _build.launch_counts.update(counts)
