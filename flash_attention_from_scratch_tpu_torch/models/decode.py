"""Llama decode path over the paged KV cache.

Counterpart of ``flash_attention_from_scratch_tpu/models/decode.py``:
:func:`prefill` runs each prompt through the flash forward kernel and
scatters its K/V into pages, and :func:`prefill_chunked` does so a chunk at
a time, each chunk attending to the pages of the ones before it;
:func:`decode_step` writes each new token's K/V into its page and then
runs the paged decode kernel for the whole batch; :func:`verify_step` does
the same for t tokens per sequence in one pass (speculative verify), and
:func:`spec_accept_sample` accepts drafts, greedily or by the
delta-proposal rule (:func:`pick_keyed`: the server's pick of a decode
or verify step); :func:`decode_loop` runs several decode steps, each
feeding its pick (the argmax, or :func:`sample_token`) to the next.
:func:`prefill`, :func:`decode_step`, :func:`verify_step` and
:func:`decode_loop` take LoRA adapters (``models/lora.py``) with one
adapter id a row (-1: the base model), under a tp mesh too (each rank's
adapter shard, ``models.lora.shard_lora``): each adapted projection's
delta adds to q, k and v after the projection and to the output projection
before the residual (under tp, to a rank's partial product before its sum). A MoE
layer (``experts``, ``models/moe.py``) routes through its experts in
every one of these functions (:func:`_mlp`).
These functions run eagerly; ``models/step_graphs.py`` captures the decode
steps and the loop as CUDA graphs (the JAX package's ``jax.jit``).

Sampling draws its noise from :func:`sample_noise`, a counter-based hash of
(sequence key, position, stream, index) in integer tensor ops: the same
bits on the CPU and on the card, no ``torch.Generator``, nothing read on the
host, so it is captured in a CUDA graph like any other op. torch cannot
reproduce ``jax.random``: the port samples from the JAX package's
distributions, not with its draws.

The cache is dense (the model's dtype) or quantized: int8, fp8 e4m3 or
int4 packed along the tokens of a page, with fp32 scales per (kv_head,
page). A sequence's scale per KV head is calibrated on its prompt at
prefill and stored on every page it fills; each decode step quantizes the
new token with the scale on the sequence's first page and stamps it on the
page it writes, so earlier tokens are never quantized again.

Unlike the JAX package, whose arrays are immutable, the pages are written in
place: ``prefill`` and ``decode_step`` mutate the cache they are given and
return that same object.
"""

from __future__ import annotations

import dataclasses

import torch

import torch.nn.functional as F

from ..ops.flash_forward import flash_forward
from ..ops.paged_attention import paged_decode_attention
from ..ops.quant import QMAX, KVQuantMode, div_const, pack_int4, unpack_int4_halves
from ..parallel.collectives import all_gather
from ..parallel.mesh import MODEL_AXIS
from ..utils.device import resolve_device
from .llama import (
    LlamaConfig, _attention, _embed, _lm_logits, _mlp as _dense_mlp, _q_scale_ratio,
    _qkv, _residual_tail, apply_rope, local_heads, rms_norm, rope_inv_freq, rope_tables,
)
from .lora import lora_delta
from .moe import _moe_mlp

__all__ = ["PagedKVCache", "init_cache", "prefill", "prefill_chunked",
           "decode_step", "verify_step", "decode_loop", "spec_accept_sample",
           "greedy_token", "sample_token", "pick_keyed", "sample_noise", "noise_bits",
           "row_keys", "lora_fn", "check_mesh"]


def check_mesh(params, mesh) -> None:
    """Serving under a mesh runs tensor parallelism on dense or quantized
    Llama weights, with or without LoRA adapters (``models.lora.shard_lora``);
    MoE layers under a mesh raise ``NotImplementedError``: the JAX package
    has no tp specs for them (ROADMAP.md watch list)."""
    if mesh is not None and any("experts" in layer for layer in params["layers"]):
        raise NotImplementedError("MoE layers under a tp mesh: the JAX package has no "
                                  "specs for them (ROADMAP.md watch list)")


def lora_fn(lora, li: int, adapter_ids):
    """``adapt(name, x)``: the LoRA delta of projection ``name`` of layer
    ``li`` for x's rows (:func:`~.lora.lora_delta`); None without ``lora``.
    ``adapter_ids`` (batch,) int, -1 for the base model, is required with
    ``lora`` (``ValueError``)."""
    if lora is None:
        return None
    if adapter_ids is None:
        raise ValueError("serving with lora needs adapter_ids, one a row (-1: none)")
    return lambda name, x: lora_delta(lora, li, name, x, adapter_ids)


def _mlp(layer, h, cfg):
    """The serving path's MLP: dense, or routed experts when the layer
    carries them (``models/moe.py::_moe_mlp``), as in the JAX package's
    decode path. All rows of a call route together: a prefill's padded
    prompt, a chunk, or a decode step's whole padded batch (batch-level
    capacity, max(8, ~top_k * rows / E) slots an expert). The aux loss is
    dropped. ``models.llama.forward`` stays dense, as JAX's does."""
    if "experts" in layer:
        return _moe_mlp(cfg, layer, h)[0]
    return _dense_mlp(layer, h, cfg)


def check_no_sinks(cfg: LlamaConfig) -> None:
    """Serving refuses attention sinks: the paged kernel has no sink term
    (nor has the JAX one), so decode would drop what prefill applied."""
    if cfg.attn_sinks:
        raise ValueError("serving a config with attn_sinks=True is not supported: "
                         "the paged decode kernel has no sink term (ROADMAP Queue 3)")


@dataclasses.dataclass
class PagedKVCache:
    """Per-layer paged KV pools (+ per-(head, page) scales when quantized).

    Pools are (kv_heads, num_pages, rows, d) with rows = page_size, or
    page_size // 2 for int4; scales are (kv_heads, num_pages) fp32 (empty
    lists when dense: nothing reads them).
    """

    k_pages: list
    v_pages: list
    k_scales: list
    v_scales: list
    mode: str = "dense"

    @property
    def page_size(self) -> int:
        rows = self.k_pages[0].shape[2]
        return rows * 2 if self.mode == KVQuantMode.INT4 else rows

    @property
    def num_pages(self) -> int:
        return self.k_pages[0].shape[1]

    def layer_scales(self, li: int):
        """(k_scales, v_scales) of layer ``li``; (None, None) when dense."""
        if self.mode == "dense":
            return None, None
        return self.k_scales[li], self.v_scales[li]

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in self.k_pages + self.v_pages
                   + self.k_scales + self.v_scales)


_STORE = {KVQuantMode.INT8: torch.int8, KVQuantMode.INT4: torch.int8,
          KVQuantMode.FP8: torch.float8_e4m3fn}


def init_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
               mode: str = "dense", device="cuda", mesh=None) -> PagedKVCache:
    """Zeroed pools (and unit scales); with a tp ``mesh``, this rank's KV
    heads only (the JAX cache's shard, spec ``P("tp")`` on the head dim)."""
    if mode == "dense":
        store, rows = cfg.dtype.torch_dtype, page_size
    elif mode in _STORE:
        store = _STORE[mode]
        rows = page_size // 2 if mode == KVQuantMode.INT4 else page_size
    else:
        raise ValueError(f"unknown cache mode {mode!r}")
    dev = resolve_device(device)
    shape = (local_heads(cfg, mesh)[1], num_pages, rows, cfg.d_head)

    def pools(make, want=True):
        return [make() for _ in range(cfg.n_layers)] if want else []

    quant = mode != "dense"
    return PagedKVCache(
        pools(lambda: torch.zeros(shape, dtype=store, device=dev)),
        pools(lambda: torch.zeros(shape, dtype=store, device=dev)),
        pools(lambda: torch.ones(shape[:2], dtype=torch.float32, device=dev), quant),
        pools(lambda: torch.ones(shape[:2], dtype=torch.float32, device=dev), quant),
        mode=mode)


def _quantize_rows(x, scale, mode: str):
    """Quantize (..., d) rows by a broadcastable symmetric scale (x / scale,
    the JAX writers' division). int4 returns unpacked values in [-7, 7]; the
    writers pack them for the page layout."""
    xf = x.float() / scale
    if mode == KVQuantMode.INT8:
        return torch.clamp(torch.round(xf), -127, 127).to(torch.int8)
    if mode == KVQuantMode.INT4:
        return torch.clamp(torch.round(xf), -7, 7).to(torch.int8)
    if mode == KVQuantMode.FP8:
        # Decode reuses the prefill scale, so values can pass the e4m3 range;
        # clamp rather than rely on the cast's behaviour out of range.
        return torch.clamp(xf, -448.0, 448.0).to(torch.float8_e4m3fn)
    return x


def _head_scale(x, mode: str):
    """Per-KV-head symmetric scale of a (kv_heads, ..., d) tensor."""
    absmax = x.float().abs().amax(dim=tuple(range(1, x.ndim)))
    return torch.clamp_min(div_const(absmax, QMAX[mode]), 1e-12)


def _raw(t):
    """fp8 tensors as their bytes, for indexed writes (fp8 indexing kernels
    are not in every PyTorch build); other tensors as they are."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _write_prompt_layer(cache: PagedKVCache, li: int, k, v, page_table,
                        prompt_len: int, page0: int = 0):
    """Scatter one prompt's K/V (kv_heads, prompt_len, d) into its pages.

    ``page0``: the first page-table slot written (chunked prefill writes
    chunk c from slot c * chunk_tokens / page_size; ``prompt_len`` is then
    the chunk's row count). The rows are zero-padded to whole pages; the
    tail slots of the last page belong to this sequence and are overwritten
    by decode writes before attention can see them (lengths mask the rest).
    Only table entries [page0, page0 + ceil(prompt_len / page_size)) are
    read. A quantized cache calibrates one scale per KV head on the rows
    written at page0 == 0; later chunks take the scale on the sequence's
    first page, as decode does. Every page written is stamped with the
    scale. int4 pairs token t with token t + page_size/2 of the same page
    into one byte row.
    """
    ps = cache.page_size
    n_used = -(-prompt_len // ps)
    pages = page_table[page0:page0 + n_used].long()
    quant = cache.mode != "dense"
    ks, vs = cache.layer_scales(li)
    for pool, scales, vals in ((cache.k_pages[li], ks, k),
                               (cache.v_pages[li], vs, v)):
        kvh, _, d = vals.shape
        if quant:
            if page0 == 0:
                sc = _head_scale(vals, cache.mode)  # (kv_heads,)
            else:
                sc = scales[:, page_table[:1].long()][:, 0]
            vals = _quantize_rows(vals, sc[:, None, None], cache.mode)
            scales[:, pages] = sc[:, None].expand(kvh, n_used)
        padded = vals.new_zeros((kvh, n_used * ps, d))
        padded[:, :prompt_len] = vals
        by_page = padded.view(kvh, n_used, ps, d)
        if cache.mode == KVQuantMode.INT4:
            by_page = pack_int4(by_page[:, :, : ps // 2], by_page[:, :, ps // 2:])
        _raw(pool)[:, pages] = _raw(by_page)


def prefill(params, tokens, cfg: LlamaConfig, cache: PagedKVCache,
            page_table, prompt_len: int | None = None, *, lora=None,
            adapter_ids=None, mesh=None):
    """Run one prompt (1, padded_len) through the model, filling its pages.

    ``tokens`` may be right-padded so the flash kernel's tile (64) divides
    it; ``prompt_len`` is the true length: only its K/V rows go to pages
    and the returned logits are row ``prompt_len - 1``. ``page_table``:
    (pages_per_seq,) int, -1 padded. ``lora`` with ``adapter_ids`` (1,)
    int runs the prompt through that adapter (-1: the base model). Writes
    the pages in place and returns (logits (vocab,) fp32, cache). A config
    with attention sinks raises ``ValueError`` (:func:`check_no_sinks`).
    With a tp ``mesh`` every rank runs the prompt on its heads and its
    cache (``init_cache(..., mesh=)``), and gets the whole logits row.
    """
    check_no_sinks(cfg)
    check_mesh(params, mesh)
    s = tokens.shape[1]
    prompt_len = prompt_len or s
    x = all_gather(_embed(params, tokens, cfg), mesh, MODEL_AXIS, -1)  # (1, s, dim)
    cos, sin = rope_tables(s, cfg.d_head, cfg.rope_theta, cfg, device=x.device)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        adapt = lora_fn(lora, li, adapter_ids)
        out, k, v = _attention(layer, h, cfg, cos, sin, li, adapt, mesh)
        x = _residual_tail(cfg, layer, x, out, None if adapt is None else adapt("wo", out),
                           mlp=_mlp, mesh=mesh)
        # Only rows [0, prompt_len) go to pages. Causality keeps them
        # independent of the padding rows in a dense model; in a MoE model
        # the padding tokens route too and claim expert slots (a padding
        # token's first choice can take the slot a real token's second
        # choice would have had), as in the JAX package, which pads alike.
        _write_prompt_layer(cache, li, k[0, :, :prompt_len],
                            v[0, :, :prompt_len], page_table, prompt_len)
    x = rms_norm(x[:, prompt_len - 1], params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x, cfg, mesh)[0], cache


def _gather_prefix(cache: PagedKVCache, li: int, page_table, start: int,
                   compute_dtype):
    """The first ``start`` cached tokens of a sequence as dense K/V.

    Chunked prefill attends each chunk to [prefix | chunk]; the prefix comes
    from the pages earlier chunks wrote, dequantized as decode reads them
    (a quantized cache rounds once, at write time). Returns (k, v), each
    (kv_heads, start, d_head) in ``compute_dtype``.
    """
    ps = cache.page_size
    n = -(-start // ps)
    idx = page_table[:n].long()
    ks, vs = cache.layer_scales(li)

    def read(pool, scales):
        got = pool[:, idx]  # (kv_heads, n, rows, d)
        if cache.mode == KVQuantMode.INT4:
            lo, hi = unpack_int4_halves(got, compute_dtype)
            got = torch.cat([lo, hi], dim=2)  # the page's tokens in order
        elif cache.mode != "dense":
            got = got.to(compute_dtype)
        if cache.mode != "dense":
            got = got * scales[:, idx][:, :, None, None].to(compute_dtype)
        kvh, _, _, d = got.shape
        return got.reshape(kvh, n * ps, d)[:, :start].to(compute_dtype)

    return read(cache.k_pages[li], ks), read(cache.v_pages[li], vs)


def _prefill_one_chunk(params, tokens_chunk, cfg: LlamaConfig,
                       cache: PagedKVCache, page_table, start: int,
                       write_len: int, want_logit_row: int):
    """One chunk of :func:`prefill_chunked`.

    tokens_chunk: (1, chunk_len), rows [0, write_len) real. Each layer
    writes the chunk's K/V to its pages first, then attends causally over
    [prefix | chunk] with ``q_offset = start`` (the flash forward kernel,
    K1), the prefix read back from the pages. Returns (logits (vocab,) fp32
    at ``want_logit_row``, or zeros when it is negative; cache).
    """
    x = _embed(params, tokens_chunk, cfg)  # (1, c, dim)
    c = tokens_chunk.shape[1]
    compute_dtype = cfg.dtype.torch_dtype
    cos, sin = rope_tables(start + c, cfg.d_head, cfg.rope_theta, cfg,
                           device=x.device)
    cos, sin = cos[start:], sin[start:]
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        q = apply_rope(q.view(1, c, cfg.n_heads, cfg.d_head).transpose(1, 2), cos, sin)
        k = apply_rope(k.view(1, c, cfg.n_kv_heads, cfg.d_head).transpose(1, 2),
                       cos, sin)
        v = v.view(1, c, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
        if cfg.attn_scale:
            q = (q.float() * _q_scale_ratio(cfg)).to(q.dtype)
        # The chunk's K/V go to the pages first, so that the prefix later
        # chunks read back is what decode will read.
        _write_prompt_layer(cache, li, k[0, :, :write_len], v[0, :, :write_len],
                            page_table, write_len, page0=start // cache.page_size)
        if start:
            k_pref, v_pref = _gather_prefix(cache, li, page_table, start,
                                            compute_dtype)
            k = torch.cat([k_pref[None], k.to(compute_dtype)], dim=2)
            v = torch.cat([v_pref[None], v.to(compute_dtype)], dim=2)
        attn = dataclasses.replace(cfg.attn_config(li), q_offset=start)
        out = flash_forward(q, k, v, attn)
        out = out.transpose(1, 2).reshape(1, c, cfg.n_heads * cfg.d_head)
        x = _residual_tail(cfg, layer, x, out, mlp=_mlp)
    if want_logit_row < 0:
        return torch.zeros(cfg.vocab_size, dtype=torch.float32, device=x.device), cache
    x = rms_norm(x[:, want_logit_row], params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x, cfg)[0], cache


def prefill_chunked(params, tokens, cfg: LlamaConfig, cache: PagedKVCache,
                    page_table, prompt_len: int | None = None,
                    chunk_tokens: int = 1024, start_tokens: int = 0):
    """:func:`prefill` in chunks of ``chunk_tokens``: activation memory
    bounded by the chunk, not the prompt.

    Each chunk attends causally over [cached prefix | chunk] (``q_offset``),
    writes its K/V pages, and only the chunk holding ``prompt_len - 1``
    computes logits. The function of :func:`prefill` for a dense cache; a
    quantized cache calibrates its scales on the first chunk (decode
    inherits them the same way), so later chunks round with chunk 0's
    scale. ``chunk_tokens`` must be a multiple of 128 and of the page size
    (chunks write whole pages); ``start_tokens`` skips chunks whose pages
    already hold the prompt's K/V (a multiple of ``chunk_tokens``, below
    ``prompt_len``). Each violation raises ``ValueError``, as in the JAX
    package. Writes the pages in place and returns (logits (vocab,) fp32,
    cache).
    """
    check_no_sinks(cfg)
    ps = cache.page_size
    if chunk_tokens % 128 or chunk_tokens % ps:
        raise ValueError(
            f"chunk_tokens ({chunk_tokens}) must be a multiple of 128 and "
            f"of page_size ({ps})")
    if start_tokens % chunk_tokens:
        raise ValueError(
            f"start_tokens ({start_tokens}) must be a multiple of "
            f"chunk_tokens ({chunk_tokens})")
    s = tokens.shape[1]
    prompt_len = prompt_len or s
    if not start_tokens < prompt_len:
        raise ValueError(f"start_tokens ({start_tokens}) must leave at "
                         f"least the last prompt token to compute")
    for start in range(start_tokens, prompt_len, chunk_tokens):
        write_len = min(prompt_len - start, chunk_tokens)
        last = start + chunk_tokens >= prompt_len
        chunk = tokens[:, start:min(start + chunk_tokens, s)]
        chunk = F.pad(chunk, (0, -chunk.shape[1] % 128))  # the tail to the quantum
        logits, cache = _prefill_one_chunk(
            params, chunk, cfg, cache, page_table, start, write_len,
            (prompt_len - 1 - start) if last else -1)
    return logits, cache


def decode_step(params, tokens, cfg: LlamaConfig, cache: PagedKVCache,
                lengths, page_tables, *, lora=None, adapter_ids=None, mesh=None,
                attn_int8: bool = False):
    """One decode step for the whole running batch.

    Args:
      tokens: (batch,) int: the most recent token of each sequence.
      lengths: (batch,) int32: sequence length *including* these tokens.
      page_tables: (batch, pages_per_seq) int32, -1 padded.
      lora, adapter_ids: LoRA adapters (``models/lora.py``) and each row's
        adapter id, (batch,) int (-1: the base model).
      attn_int8: int8-compute attention (``int8_compute`` in the paged
        kernel); the cache must be int8.
      mesh: tensor parallelism (``parallel.mesh.make_mesh(1, tp)``): each
        rank holds its shard of ``params`` and of the cache's KV heads, runs
        the paged kernel on its Q heads, sums the residual over tp after
        ``wo`` and ``w_down`` and gathers the logits over the vocab, so
        every rank picks the same token.

    Each token's K/V is written to its page before attention, so the paged
    kernel sees the current token. Writes the pages in place and returns
    (logits (batch, vocab) fp32, cache).
    """
    logits, cache = _step(params, tokens[:, None], cfg, cache, lengths,
                          page_tables, lora, mesh, attn_int8, adapter_ids)
    return logits[:, 0], cache


def verify_step(params, tokens, cfg: LlamaConfig, cache: PagedKVCache,
                lengths, page_tables, *, attn_int8: bool = False, lora=None,
                adapter_ids=None, mesh=None):
    """Score t tokens per sequence in one forward pass (speculative verify).

    The multi-token form of :func:`decode_step`: token j of a row's t
    inputs sits at position ``lengths - t + j`` (``lengths`` includes the t
    tokens; the scheduler has allocated their slots). All t tokens' K/V are
    written to their pages, then the paged kernel runs with t query tokens
    (a causal mask within the new tokens).

    Args:
      tokens: (batch, t) int: [previous committed token, draft_1..t-1].

    Writes the pages in place and returns (logits (batch, t, vocab) fp32,
    cache): logits[:, j] is the next-token distribution after token j, so
    row j verifies draft j + 1 and the last row gives the bonus or
    correction token. Unlike the JAX ``verify_step``, which indexes the
    embedding table directly, the embedding goes through ``_embed``, so
    ``cfg.embed_scale`` applies as in :func:`decode_step`. ``lora`` and
    ``adapter_ids`` as in :func:`decode_step`, each row's adapter on all of
    its t tokens (the JAX ``verify_step`` takes no adapters; the server runs
    no speculative steps with them, as JAX's). ``mesh`` as in
    :func:`decode_step`.
    """
    return _step(params, tokens, cfg, cache, lengths, page_tables, lora, mesh,
                 attn_int8, adapter_ids)


def decode_loop(params, tokens, cfg: LlamaConfig, cache: PagedKVCache,
                lengths, page_tables, steps: int, *, row_keys=None, pos0=None,
                temperature: float = 0.0, top_k: int = 0, mesh=None,
                attn_int8: bool = False, lora=None, adapter_ids=None):
    """``steps`` decode steps, each feeding its pick to the next.

    Args:
      tokens: (batch,) int: the last committed token of each sequence.
      lengths: (batch,) int32: committed length of each sequence, *excluding*
        the tokens this call generates (unlike :func:`decode_step`, whose
        lengths include the token being decoded).
      page_tables: (batch, pages_per_seq) int32 covering ``lengths +
        steps``: the pages for the whole chunk are allocated beforehand.
      row_keys: optional (batch,) int64 sequence keys (:func:`row_keys`, the
        port's form of the JAX ``fold_in(key, sid)``).
      pos0: (batch,) int: generated-token count of each row at the call's
        start; step i samples row r at position ``pos0[r] + i``.
      lora, adapter_ids: as in :func:`decode_step`, for every step.

    Token selection stays on the device: no host round trip between steps.
    Greedy at ``temperature <= 0`` or without ``row_keys`` (as in the JAX
    package); else :func:`sample_token` on the Gumbels of (row key,
    position), so a loop of n steps picks what n single steps would.
    Sampling without ``pos0`` raises ``ValueError``. Writes the pages in
    place and returns (tokens (batch, steps), cache, lengths + steps).
    """
    if temperature > 0.0 and row_keys is not None and pos0 is None:
        raise ValueError("sampling in decode_loop needs pos0 beside row_keys")

    def step(toks, lens):
        return decode_step(params, toks, cfg, cache, lens, page_tables, lora=lora,
                           adapter_ids=adapter_ids, mesh=mesh, attn_int8=attn_int8)[0]

    out, lengths = pick_loop(
        step, loop_pick(row_keys, pos0, temperature, top_k), tokens, lengths, steps)
    return out, cache, lengths


def loop_pick(row_keys, pos0, temperature: float, top_k: int):
    """The pick of step i of a decode loop, ``pick(logits, i) -> tokens``:
    the argmax at ``temperature <= 0`` or without ``row_keys``, else
    :func:`sample_token` on the Gumbels of (row_keys, pos0 + i)."""
    if temperature <= 0.0 or row_keys is None:
        return lambda logits, i: greedy_token(logits)

    def pick(logits, i):
        _, gumbel = sample_noise(row_keys, pos0 + i, STREAM_SAMPLE, logits.shape[-1])
        return sample_token(logits, gumbel, temperature, top_k)

    return pick


def pick_loop(step, pick, tokens, lengths, steps: int):
    """The body of :func:`decode_loop` over ``step(tokens, lengths) ->
    logits``: each step's lengths one longer, ``pick(logits, i)`` the next
    tokens. Returns (tokens (batch, steps), lengths + steps)."""
    out = []
    for i in range(steps):
        lengths = lengths + 1
        tokens = pick(step(tokens, lengths), i)
        out.append(tokens)
    return torch.stack(out, dim=1), lengths


def _step(params, tokens, cfg: LlamaConfig, cache: PagedKVCache, lengths,
          page_tables, lora, mesh, attn_int8: bool, adapter_ids=None):
    """The body of :func:`decode_step` and :func:`verify_step`: tokens
    (batch, t) at positions lengths - t + j; ``lora`` with one adapter id a
    row."""
    check_no_sinks(cfg)
    check_mesh(params, mesh)
    if attn_int8 and cache.mode != KVQuantMode.INT8:
        raise ValueError(f"attn_int8 requires an int8 KV cache; mode={cache.mode!r}")
    batch, t = tokens.shape
    ps = cache.page_size
    hq, hkv = local_heads(cfg, mesh)
    x = all_gather(_embed(params, tokens, cfg), mesh, MODEL_AXIS, -1)  # (batch, t, dim)
    pos = (lengths.long()[:, None] - t
           + torch.arange(t, device=x.device)[None, :])  # (batch, t)

    # Per-token rope rows from fp32 positions, broadcast over heads.
    angles = pos.float()[..., None] * rope_inv_freq(cfg, x.device)[None, None, :]
    cos = torch.cos(angles)[:, None]  # (batch, 1, t, d/2)
    sin = torch.sin(angles)[:, None]

    page_of = page_tables.long().gather(1, pos // ps)  # (batch, t)
    slot_of = pos % ps
    first_page = page_tables[:, 0].long()  # owner of each sequence's scale

    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h, cfg)
        adapt = lora_fn(lora, li, adapter_ids)
        if adapt is not None:
            q, k, v = q + adapt("wq", h), k + adapt("wk", h), v + adapt("wv", h)
        q = apply_rope(q.view(batch, t, hq, cfg.d_head).transpose(1, 2),
                       cos, sin)  # (b, H, t, d)
        k = apply_rope(k.view(batch, t, hkv, cfg.d_head).transpose(1, 2),
                       cos, sin)  # (b, kv_heads, t, d)
        v = v.view(batch, t, hkv, cfg.d_head).transpose(1, 2)
        # Write before attend: the new tokens must be in their pages.
        _write_rows(cache, li, k, v, page_of, slot_of, first_page)
        ks, vs = cache.layer_scales(li)
        q = q.contiguous() if t > 1 else q[:, :, 0].contiguous()
        out = paged_decode_attention(
            q, cache.k_pages[li], cache.v_pages[li], lengths, page_tables,
            mode=cache.mode, k_scales=ks, v_scales=vs, int8_compute=attn_int8,
            window=cfg.layer_window(li),
            softcap=cfg.attn_softcap, scale=cfg.attn_scale or None)
        out = out.view(batch, hq, t, cfg.d_head).transpose(1, 2)
        out = out.reshape(batch, t, hq * cfg.d_head).to(x.dtype)
        x = _residual_tail(cfg, layer, x, out, None if adapt is None else adapt("wo", out),
                           mlp=_mlp, mesh=mesh)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x, cfg, mesh), cache


def _write_rows(cache: PagedKVCache, li: int, k, v, page_of, slot_of,
                first_page):
    """Write each sequence's new K/V rows (batch, kv_heads, t, d) in place,
    token j at (page_of[b, j], slot_of[b, j]).

    Quantized: the rows take the scale on their sequence's first page, and
    each page written is stamped with that scale (a page handed out again
    keeps a stale scale until then). int4 sets one nibble of a byte row:
    the low nibble for slots below page_size/2, else the high. Slots s and
    s + page_size/2 share a byte row, and with t > page_size/2 both can be
    written in one call; so each row writes the whole byte, its own nibble
    and its partner's (the token page_size/2 later or earlier, when it is
    in the call) or else the byte's old nibble: both writers of a byte then
    write the same value and no nibble is lost. Padding rows of a batch all
    write the same scratch slots with the same values, so duplicate indices
    there are harmless.
    """
    t = k.shape[2]
    half = cache.page_size // 2
    pages, slots = page_of.reshape(-1), slot_of.reshape(-1)
    ks, vs = cache.layer_scales(li)
    for pool, scales, vals in ((cache.k_pages[li], ks, k),
                               (cache.v_pages[li], vs, v)):
        if cache.mode != "dense":
            seq_scale = scales[:, first_page]  # (kv_heads, batch)
            vals = _quantize_rows(vals, seq_scale.T[:, :, None, None], cache.mode)
            scales[:, pages] = seq_scale.repeat_interleave(t, dim=1)
        vals = vals.transpose(0, 1)  # (kv_heads, batch, t, d)
        if cache.mode != KVQuantMode.INT4:
            _raw(pool)[:, pages, slots] = _raw(vals.flatten(1, 2))
            continue
        is_hi = (slot_of >= half)[None, :, :, None]
        j = torch.arange(t, device=slot_of.device)[None, :]
        partner = torch.where(slot_of >= half, j - half, j + half)  # (batch, t)
        has = ((partner >= 0) & (partner < t))[None, :, :, None]
        pvals = vals.gather(2, partner.clamp(0, t - 1)[None, :, :, None].expand_as(vals))
        byte_rows = slots % half
        old = pool[:, pages, byte_rows].view(vals.shape)
        lo = torch.where(is_hi, torch.where(has, pvals, old), vals)
        hi = torch.where(is_hi, vals, torch.where(has, pvals, old >> 4))
        pool[:, pages, byte_rows] = pack_int4(lo, hi).flatten(1, 2)


def spec_accept_sample(logits, drafts, draft_lens, temperature: float = 0.0,
                       top_k: int = 0, *, uniforms=None, gumbel=None):
    """Speculative acceptance: greedy, or the JAX package's delta-proposal
    sampling, which keeps the target distribution exactly.

    Args:
      logits: (batch, t, vocab) fp32 from :func:`verify_step`, t = k + 1.
      drafts: (batch, k) int, zero-padded past ``draft_lens``.
      draft_lens: (batch,) int: real draft tokens per row (padding slots
        are never accepted).
      temperature, top_k: the shaping of :func:`sample_token` (the top-k
        filter first, then logits / max(temperature, 1e-6)).
      uniforms: (batch, k) in (0, 1): draft j + 1 is accepted while
        ``uniforms[:, j] < p_j(d_{j+1})``, the JAX rule (its uniforms are
        ``jax.random.uniform(fold_in(key, 0), (k,))``), so that under the
        JAX package's noise this function gives its tokens. None (the
        server's rule, :func:`pick_keyed`): accepted while it is the
        Gumbel-max sample of row j under ``gumbel[:, j]``, an event of the
        same probability p_j(d_{j+1}).
      gumbel: Gumbel noise of the emitted token, (batch, vocab) (the JAX
        ``fold_in(key, 1)`` draw) or (batch, t, vocab), of which row
        ``n_acc`` is taken. Without ``uniforms`` it must be (batch, t,
        vocab): with each row's Gumbels the ones :func:`sample_token` would
        use at that position, a step emits exactly the tokens plain
        sampling would (the correction is the sample itself whenever that
        is not the refused draft).

    Greedy at ``temperature <= 0`` (no noise read): draft j + 1 is accepted
    while it equals the argmax of row j. Sampled: after the first refusal
    the emitted token is drawn from row n_acc's distribution with the
    refused draft masked out (the residual), only where a real draft token
    was refused (``n_acc < draft_lens``); after a fully accepted draft it
    is drawn from row n_acc's plain distribution (the bonus). Returns
    (tokens (batch, t), n_emit (batch,)): row i emits tokens[i, :n_emit[i]],
    the accepted drafts and then that token.
    """
    batch, t, vocab = logits.shape
    k = t - 1
    dev = logits.device
    drafts = drafts.to(dev, torch.int64)
    draft_lens = draft_lens.to(dev)
    logits = top_k_filter(logits, top_k)
    if temperature <= 0.0:
        preds = torch.argmax(logits, dim=-1)  # (batch, t)
        match = preds[:, :k] == drafts
    else:
        if gumbel is None or (uniforms is None and gumbel.dim() != 3):
            raise ValueError("sampled acceptance needs gumbel (batch, t, vocab), "
                             "or uniforms and gumbel")
        scaled = logits / max(temperature, 1e-6)
        if uniforms is not None:
            p_draft = torch.softmax(scaled[:, :k], dim=-1).gather(
                -1, drafts[..., None])[..., 0]  # (batch, k)
            match = uniforms.to(dev) < p_draft
        else:
            match = torch.argmax(scaled[:, :k] + gumbel[:, :k], dim=-1) == drafts
    steps = torch.arange(k, device=dev)[None, :]
    match = match & (steps < draft_lens[:, None])
    # First refusal per row (k when the whole draft is accepted).
    refused = torch.cat([~match, torch.ones((batch, 1), dtype=torch.bool, device=dev)],
                        dim=1)
    n_acc = torch.argmax(refused.to(torch.int8), dim=1)
    padded = torch.cat([drafts, drafts.new_zeros((batch, 1))], dim=1)
    if temperature <= 0.0:
        tail = preds.gather(1, n_acc[:, None])
    else:
        row = logits.gather(1, n_acc[:, None, None].expand(batch, 1, vocab))[:, 0]
        refused_draft = padded.gather(1, n_acc[:, None])  # (batch, 1)
        was_rejected = (n_acc < draft_lens)[:, None]
        onehot = torch.arange(vocab, device=dev)[None, :] == refused_draft
        residual = row.masked_fill(was_rejected & onehot, float("-inf"))
        if gumbel.dim() == 3:
            gumbel = gumbel.gather(1, n_acc[:, None, None].expand(batch, 1, vocab))[:, 0]
        tail = torch.argmax(residual / max(temperature, 1e-6) + gumbel, dim=-1)[:, None]
    pos = torch.arange(t, device=dev)[None, :]
    toks = torch.where(pos < n_acc[:, None], padded, 0)
    toks = torch.where(pos == n_acc[:, None], tail, toks)
    return toks, n_acc + 1


def pick_keyed(logits, drafts, draft_lens, row_keys, pos0, temperature: float,
               top_k: int):
    """The server's pick in a decode step (t = 1, no drafts) or a verify
    step: :func:`spec_accept_sample` with row j of each sequence drawn from
    the Gumbels of (row key, pos0 + j) on stream 0, the ones
    :func:`sample_token` uses at that position, so a token does not depend
    on the step that drew it; greedy at ``temperature <= 0`` (no noise
    made). ``logits`` (batch, t, vocab), ``drafts`` (batch, t - 1),
    ``draft_lens``, ``row_keys`` and ``pos0`` (batch,), all on one device.
    Returns (tokens (batch, t), n_emit (batch,))."""
    gumbel = None
    if temperature > 0.0:
        pos = pos0[:, None] + torch.arange(logits.shape[1], device=pos0.device)[None, :]
        _, gumbel = sample_noise(row_keys[:, None], pos, STREAM_SAMPLE, logits.shape[-1])
    return spec_accept_sample(logits, drafts, draft_lens, temperature, top_k,
                              gumbel=gumbel)


def greedy_token(logits):
    """Argmax over the last axis."""
    return torch.argmax(logits, dim=-1)


def top_k_filter(logits, top_k: int):
    """The JAX package's top-k filter: logits below the k-th largest of
    their row become -inf; ties at the k-th value stay (by value, not by
    the index set ``torch.topk`` returns). ``top_k`` 0: unchanged."""
    if not top_k:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def sample_token(logits, gumbel, temperature: float = 1.0, top_k: int = 0):
    """Temperature / top-k sampling of ``logits`` (..., vocab) fp32 with the
    Gumbel noise ``gumbel`` (the same shape; :func:`sample_noise`).

    The top-k filter first (:func:`top_k_filter`), then
    ``argmax(logits / max(temperature, 1e-6) + gumbel)``: the Gumbel-max
    draw, which is what ``jax.random.categorical(key, x)`` computes
    (``argmax(gumbel(key, x.shape) + x)``). So with JAX's Gumbels passed in
    the token equals the JAX ``sample_token``'s. ``temperature <= 0`` is
    the greedy argmax (the noise is not read).
    """
    logits = top_k_filter(logits, top_k)
    if temperature <= 0.0:
        return greedy_token(logits)
    return torch.argmax(logits / max(temperature, 1e-6) + gumbel, dim=-1)


# The noise stream of every sampled token (sample_noise's ``stream`` keeps
# other draws at one (sequence, position) apart). Speculative steps draw
# from it too (pick_keyed: their acceptance is coupled to the plain
# sample), so the server has no other stream.
STREAM_SAMPLE = 0

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for x in [0, 2**32) and a 32-bit constant c, by
    16-bit halves of c: every intermediate stays below 2**49, so int64
    tensors never overflow and the CPU and the card agree bit for bit."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """MurmurHash3's 32-bit finalizer: a bijection of [0, 2**32) in which
    every output bit depends on every input bit. Takes int64 tensors (or
    Python ints) holding 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def row_keys(seed: int, seq_ids):
    """The 32-bit key of each sequence (int64 tensor of ``seq_ids``' shape)
    under ``seed``: the port's form of the JAX ``fold_in(PRNGKey(seed),
    sid)``. Both 32-bit halves of seed and id enter (ids may be negative)."""
    sid = torch.as_tensor(seq_ids, dtype=torch.int64)
    s = _mix32(_mix32(((seed >> 32) & _M32) ^ 0x243F6A88) ^ (seed & _M32))
    return _mix32(_mix32(s ^ ((sid >> 32) & _M32)) ^ (sid & _M32))


def noise_bits(keys, positions, stream: int, n: int):
    """32-bit hash values (int64, in [0, 2**32)), shape (*batch, n): a pure
    function of (key, position, stream, index < n), with ``keys`` and
    ``positions`` int64 tensors broadcast to one shape ``batch``. Each
    (key, position, stream) gives a counter base; index i hashes base +
    i * 0x9E3779B9 (a Weyl sequence) through two finalizer rounds."""
    keys = torch.as_tensor(keys, dtype=torch.int64)
    pos = torch.as_tensor(positions, dtype=torch.int64, device=keys.device)
    base = _mix32(keys ^ _mix32((pos & _M32) ^ _mix32(stream + 1)))
    salt = _mix32(base ^ 0x5BD1E995)
    idx = _mul32(torch.arange(n, dtype=torch.int64, device=keys.device), 0x9E3779B9)
    x = _mix32((base[..., None] + idx) & _M32)
    return _mix32(x ^ salt[..., None])


def sample_noise(keys, positions, stream: int, n: int):
    """(uniforms, gumbels), each fp32 (*batch, n), from :func:`noise_bits`:
    ``u = (2 * (bits >> 9) + 1) / 2**24`` lies in (0, 1) (23 random bits,
    exact in fp32), and the Gumbel is ``-log(-log u)``.

    A pure function of (key, position, stream, index): no
    ``torch.Generator``, no host read, capturable in a CUDA graph. Keys come
    from :func:`row_keys`; the positions a server uses are the generated
    token's index in its sequence (JAX's ``fold_in(fold_in(key, sid),
    pos)``), so a preempted sequence replays its draws. torch cannot
    reproduce ``jax.random``: these draws follow the JAX package's
    distributions, not its numbers.
    """
    bits = noise_bits(keys, positions, stream, n)
    u = ((bits >> 9) * 2 + 1).to(torch.float32) * (2.0 ** -24)
    return u, -torch.log(-torch.log(u))
