"""Llama decode path over the paged KV cache.

Counterpart of ``flash_attention_from_scratch_tpu/models/decode.py``:
:func:`prefill` runs each prompt through the flash forward kernel and
scatters its K/V into pages; :func:`decode_step` writes each new token's K/V
into its page and then runs the paged decode kernel for the whole batch;
:func:`verify_step` does the same for t tokens per sequence in one pass
(speculative verify), and :func:`spec_accept_sample` accepts drafts
greedily.

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

from ..ops.paged_attention import paged_decode_attention
from ..ops.quant import QMAX, KVQuantMode, div_const, pack_int4
from ..utils.device import resolve_device
from .llama import (
    LlamaConfig, _attention, _embed, _lm_logits, _qkv, _residual_tail,
    apply_rope, rms_norm, rope_inv_freq, rope_tables,
)

__all__ = ["PagedKVCache", "init_cache", "prefill", "decode_step",
           "verify_step", "spec_accept_sample", "greedy_token"]


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
                        prompt_len: int):
    """Scatter one prompt's K/V (kv_heads, prompt_len, d) into its pages.

    The prompt is zero-padded to whole pages; the tail slots of the last
    page belong to this sequence and are overwritten by decode writes
    before attention can see them (lengths mask the rest). Only the first
    ceil(prompt_len / page_size) table entries are read. A quantized cache
    calibrates one scale per KV head on the prompt and stores it on every
    page written; int4 pairs token t with token t + page_size/2 of the same
    page into one byte row.
    """
    ps = cache.page_size
    n_used = -(-prompt_len // ps)
    pages = page_table[:n_used].long()
    quant = cache.mode != "dense"
    ks, vs = cache.layer_scales(li)
    for pool, scales, vals in ((cache.k_pages[li], ks, k),
                               (cache.v_pages[li], vs, v)):
        kvh, _, d = vals.shape
        if quant:
            sc = _head_scale(vals, cache.mode)  # (kv_heads,)
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
    cos, sin = rope_tables(s, cfg, device=x.device)
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
        q, k, v = _qkv(layer, h)
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
