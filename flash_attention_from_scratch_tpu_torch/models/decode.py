"""Llama decode path over the paged KV cache.

Counterpart of ``flash_attention_from_scratch_tpu/models/decode.py``:
:func:`prefill` runs each prompt through the flash forward kernel and
scatters its K/V into pages, and :func:`prefill_chunked` does so a chunk at
a time, each chunk attending to the pages of the ones before it;
:func:`decode_step` writes each new token's K/V into its page and then
runs the paged decode kernel for the whole batch; :func:`verify_step` does
the same for t tokens per sequence in one pass (speculative verify), and
:func:`spec_accept_sample` accepts drafts greedily; :func:`decode_loop`
runs several greedy decode steps, each feeding its argmax to the next.
These functions run eagerly; ``models/step_graphs.py`` captures the decode
steps and the loop as CUDA graphs (the JAX package's ``jax.jit``).

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
from ..utils.device import resolve_device
from .llama import (
    LlamaConfig, _attention, _embed, _lm_logits, _q_scale_ratio, _qkv,
    _residual_tail, apply_rope, rms_norm, rope_inv_freq, rope_tables,
)

__all__ = ["PagedKVCache", "init_cache", "prefill", "prefill_chunked",
           "decode_step", "verify_step", "decode_loop", "spec_accept_sample",
           "greedy_token"]


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (see ROADMAP.md, Queue 1)")


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
               mode: str = "dense", device="cuda") -> PagedKVCache:
    if mode == "dense":
        store, rows = cfg.dtype.torch_dtype, page_size
    elif mode in _STORE:
        store = _STORE[mode]
        rows = page_size // 2 if mode == KVQuantMode.INT4 else page_size
    else:
        raise ValueError(f"unknown cache mode {mode!r}")
    dev = resolve_device(device)
    shape = (cfg.n_kv_heads, num_pages, rows, cfg.d_head)

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
            mesh=None):
    """Run one prompt (1, padded_len) through the model, filling its pages.

    ``tokens`` may be right-padded so the flash kernel's tile (64) divides
    it; ``prompt_len`` is the true length: only its K/V rows go to pages
    and the returned logits are row ``prompt_len - 1``. ``page_table``:
    (pages_per_seq,) int, -1 padded. Writes the pages in place and returns
    (logits (vocab,) fp32, cache). A config with attention sinks raises
    ``ValueError`` (:func:`check_no_sinks`).
    """
    check_no_sinks(cfg)
    if lora is not None:
        raise _not_ported("LoRA serving")
    if mesh is not None:
        raise _not_ported("tensor-parallel serving")
    s = tokens.shape[1]
    prompt_len = prompt_len or s
    x = _embed(params, tokens, cfg)  # (1, s, dim)
    cos, sin = rope_tables(s, cfg.d_head, cfg.rope_theta, cfg, device=x.device)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        out, k, v = _attention(layer, h, cfg, cos, sin, li)
        x = _residual_tail(cfg, layer, x, out)
        # Causality makes rows [0, prompt_len) independent of the padding
        # rows, so scattering just those rows keeps the cache exact.
        _write_prompt_layer(cache, li, k[0, :, :prompt_len],
                            v[0, :, :prompt_len], page_table, prompt_len)
    x = rms_norm(x[:, prompt_len - 1], params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x, cfg)[0], cache


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
        x = _residual_tail(cfg, layer, x, out)
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
                lengths, page_tables, *, lora=None, mesh=None,
                attn_int8: bool = False):
    """One decode step for the whole running batch.

    Args:
      tokens: (batch,) int: the most recent token of each sequence.
      lengths: (batch,) int32: sequence length *including* these tokens.
      page_tables: (batch, pages_per_seq) int32, -1 padded.
      attn_int8: int8-compute attention (``int8_compute`` in the paged
        kernel); the cache must be int8.

    Each token's K/V is written to its page before attention, so the paged
    kernel sees the current token. Writes the pages in place and returns
    (logits (batch, vocab) fp32, cache).
    """
    logits, cache = _step(params, tokens[:, None], cfg, cache, lengths,
                          page_tables, lora, mesh, attn_int8)
    return logits[:, 0], cache


def verify_step(params, tokens, cfg: LlamaConfig, cache: PagedKVCache,
                lengths, page_tables, *, attn_int8: bool = False, lora=None,
                mesh=None):
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
    ``cfg.embed_scale`` applies as in :func:`decode_step`.
    """
    return _step(params, tokens, cfg, cache, lengths, page_tables, lora, mesh,
                 attn_int8)


def decode_loop(params, tokens, cfg: LlamaConfig, cache: PagedKVCache,
                lengths, page_tables, steps: int, *, row_keys=None, pos0=None,
                temperature: float = 0.0, top_k: int = 0, mesh=None,
                attn_int8: bool = False, lora=None, adapter_ids=None):
    """``steps`` greedy decode steps, each feeding its argmax to the next.

    Args:
      tokens: (batch,) int: the last committed token of each sequence.
      lengths: (batch,) int32: committed length of each sequence, *excluding*
        the tokens this call generates (unlike :func:`decode_step`, whose
        lengths include the token being decoded).
      page_tables: (batch, pages_per_seq) int32 covering ``lengths +
        steps``: the pages for the whole chunk are allocated beforehand.

    Token selection stays on the device: no host round trip between
    steps. Sampling (``temperature > 0``, ``top_k`` or ``row_keys``, with
    ``pos0``) is not ported yet and raises ``NotImplementedError`` (ROADMAP
    Queue 1, the samplers). Writes the pages in place and returns
    (tokens (batch, steps), cache, lengths + steps).
    """
    del pos0, adapter_ids  # read by the samplers and LoRA, neither ported
    if temperature > 0.0 or top_k or row_keys is not None:
        raise _not_ported("sampling in decode_loop (temperature > 0, top_k, "
                          "row_keys; the samplers)")

    def step(toks, lens):
        return decode_step(params, toks, cfg, cache, lens, page_tables,
                           lora=lora, mesh=mesh, attn_int8=attn_int8)[0]

    out, lengths = greedy_loop(step, tokens, lengths, steps)
    return out, cache, lengths


def greedy_loop(step, tokens, lengths, steps: int):
    """The body of :func:`decode_loop` over ``step(tokens, lengths) ->
    logits``: each step's lengths one longer, its argmax the next tokens.
    Returns (tokens (batch, steps), lengths + steps)."""
    out = []
    for _ in range(steps):
        lengths = lengths + 1
        tokens = greedy_token(step(tokens, lengths))
        out.append(tokens)
    return torch.stack(out, dim=1), lengths


def _step(params, tokens, cfg: LlamaConfig, cache: PagedKVCache, lengths,
          page_tables, lora, mesh, attn_int8: bool):
    """The body of :func:`decode_step` and :func:`verify_step`: tokens
    (batch, t) at positions lengths - t + j."""
    check_no_sinks(cfg)
    if lora is not None:
        raise _not_ported("LoRA serving")
    if mesh is not None:
        raise _not_ported("tensor-parallel serving")
    if attn_int8 and cache.mode != KVQuantMode.INT8:
        raise ValueError(f"attn_int8 requires an int8 KV cache; mode={cache.mode!r}")
    batch, t = tokens.shape
    ps = cache.page_size
    x = _embed(params, tokens, cfg)  # (batch, t, dim)
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
        q = apply_rope(q.view(batch, t, cfg.n_heads, cfg.d_head).transpose(1, 2),
                       cos, sin)  # (b, H, t, d)
        k = apply_rope(k.view(batch, t, cfg.n_kv_heads, cfg.d_head).transpose(1, 2),
                       cos, sin)  # (b, kv_heads, t, d)
        v = v.view(batch, t, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
        # Write before attend: the new tokens must be in their pages.
        _write_rows(cache, li, k, v, page_of, slot_of, first_page)
        ks, vs = cache.layer_scales(li)
        q = q.contiguous() if t > 1 else q[:, :, 0].contiguous()
        out = paged_decode_attention(
            q, cache.k_pages[li], cache.v_pages[li], lengths, page_tables,
            mode=cache.mode, k_scales=ks, v_scales=vs, int8_compute=attn_int8,
            window=cfg.layer_window(li),
            softcap=cfg.attn_softcap, scale=cfg.attn_scale or None)
        out = out.view(batch, cfg.n_heads, t, cfg.d_head).transpose(1, 2)
        out = out.reshape(batch, t, cfg.n_heads * cfg.d_head).to(x.dtype)
        x = _residual_tail(cfg, layer, x, out)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x, cfg), cache


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


def spec_accept_sample(logits, drafts, draft_lens, temperature: float = 0.0):
    """Greedy speculative acceptance (the JAX ``spec_accept_sample`` at
    ``temperature <= 0``).

    Args:
      logits: (batch, t, vocab) fp32 from :func:`verify_step`, t = k + 1.
      drafts: (batch, k) int, zero-padded past ``draft_lens``.
      draft_lens: (batch,) int: real draft tokens per row (padding slots
        are never accepted).

    Draft j + 1 is accepted while it equals the argmax of row j; the first
    refused row, or row k after a fully accepted draft, contributes its
    argmax. Returns (tokens (batch, t), n_emit (batch,)): row i emits
    tokens[i, :n_emit[i]], the accepted drafts and then that token.
    ``temperature > 0`` (sampled acceptance) raises ``NotImplementedError``:
    its draws come from ``jax.random``, which the port cannot reproduce.
    """
    if temperature > 0.0:
        raise NotImplementedError(
            "sampled speculative acceptance (temperature > 0) is not ported yet "
            "(ROADMAP Queue 1 item 6, the samplers)")
    batch, t, _ = logits.shape
    k = t - 1
    preds = torch.argmax(logits, dim=-1)  # (batch, t)
    drafts = drafts.to(preds.device, preds.dtype)
    steps = torch.arange(k, device=preds.device)[None, :]
    match = (preds[:, :k] == drafts) & (steps < draft_lens.to(preds.device)[:, None])
    # First refusal per row (k when the whole draft is accepted).
    refused = torch.cat([~match, torch.ones((batch, 1), dtype=torch.bool,
                                            device=preds.device)], dim=1)
    n_acc = torch.argmax(refused.to(torch.int8), dim=1)
    tail = preds.gather(1, n_acc[:, None])
    pos = torch.arange(t, device=preds.device)[None, :]
    padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    toks = torch.where(pos < n_acc[:, None], padded, 0)
    toks = torch.where(pos == n_acc[:, None], tail, toks)
    return toks, n_acc + 1


def greedy_token(logits):
    """Argmax over the last axis."""
    return torch.argmax(logits, dim=-1)
