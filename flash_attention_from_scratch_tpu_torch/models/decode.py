"""Llama decode path over the paged KV cache.

Counterpart of ``flash_attention_from_scratch_tpu/models/decode.py`` for a
dense cache: :func:`prefill` runs each prompt through the flash forward
kernel and scatters its K/V into pages; :func:`decode_step` writes each new
token's K/V into its page and then runs the paged decode kernel for the
whole batch.

Unlike the JAX package, whose arrays are immutable, the pages are written in
place: ``prefill`` and ``decode_step`` mutate the cache they are given and
return that same object.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.paged_attention import paged_decode_attention
from ..utils.device import resolve_device
from .llama import (
    LlamaConfig, _attention, _embed, _lm_logits, _qkv, _residual_tail,
    apply_rope, rms_norm, rope_inv_freq, rope_tables,
)

__all__ = ["PagedKVCache", "init_cache", "prefill", "decode_step",
           "greedy_token"]


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (see ROADMAP.md, Queue 1)")


@dataclasses.dataclass
class PagedKVCache:
    """Per-layer paged KV pools, each (kv_heads, num_pages, page_size, d)."""

    k_pages: list
    v_pages: list

    @property
    def page_size(self) -> int:
        return self.k_pages[0].shape[2]

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size()
                   for x in self.k_pages + self.v_pages)


def init_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
               mode: str = "dense", device="cuda") -> PagedKVCache:
    if mode != "dense":
        raise _not_ported(f"cache mode {mode!r}")
    dev = resolve_device(device)
    shape = (cfg.n_kv_heads, num_pages, page_size, cfg.d_head)
    dt = cfg.dtype.torch_dtype
    return PagedKVCache(
        [torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)],
        [torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)])


def _write_prompt_layer(cache: PagedKVCache, li: int, k, v, page_table,
                        prompt_len: int):
    """Scatter one prompt's K/V (kv_heads, prompt_len, d) into its pages.

    The prompt is zero-padded to whole pages; the tail slots of the last
    page belong to this sequence and are overwritten by decode writes
    before attention can see them (lengths mask the rest). Only the first
    ceil(prompt_len / page_size) table entries are read.
    """
    ps = cache.page_size
    n_used = -(-prompt_len // ps)
    pages = page_table[:n_used].long()
    for pool, vals in ((cache.k_pages[li], k), (cache.v_pages[li], v)):
        kvh, _, d = vals.shape
        padded = vals.new_zeros((kvh, n_used * ps, d))
        padded[:, :prompt_len] = vals
        pool[:, pages] = padded.view(kvh, n_used, ps, d)


def prefill(params, tokens, cfg: LlamaConfig, cache: PagedKVCache,
            page_table, prompt_len: int | None = None, *, lora=None,
            mesh=None):
    """Run one prompt (1, padded_len) through the model, filling its pages.

    ``tokens`` may be right-padded so the flash kernel's tile (64) divides
    it; ``prompt_len`` is the true length: only its K/V rows go to pages
    and the returned logits are row ``prompt_len - 1``. ``page_table``:
    (pages_per_seq,) int, -1 padded. Writes the pages in place and returns
    (logits (vocab,) fp32, cache).
    """
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

    Each token's K/V is written to its page before attention, so the paged
    kernel sees the current token. Writes the pages in place and returns
    (logits (batch, vocab) fp32, cache).
    """
    if lora is not None:
        raise _not_ported("LoRA serving")
    if mesh is not None:
        raise _not_ported("tensor-parallel serving")
    if attn_int8:
        raise _not_ported("int8-compute attention")
    batch = tokens.shape[0]
    ps = cache.page_size
    x = _embed(params, tokens, cfg)[:, None, :]  # (batch, 1, dim)
    pos = lengths.long() - 1  # position of the current token

    # Per-sequence rope rows from fp32 positions, broadcast over heads.
    angles = pos.float()[:, None] * rope_inv_freq(cfg, x.device)[None, :]
    cos = torch.cos(angles)[:, None, None, :]  # (batch, 1, 1, d/2)
    sin = torch.sin(angles)[:, None, None, :]

    page_of_pos = page_tables.long().gather(1, (pos // ps)[:, None])[:, 0]
    slot_of_pos = pos % ps

    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(layer, h)
        q = apply_rope(q.view(batch, 1, cfg.n_heads, cfg.d_head).transpose(1, 2),
                       cos, sin)[:, :, 0]  # (b, H, d)
        k = apply_rope(k.view(batch, 1, cfg.n_kv_heads, cfg.d_head).transpose(1, 2),
                       cos, sin)[:, :, 0]  # (b, kv_heads, d)
        v = v.view(batch, cfg.n_kv_heads, cfg.d_head)
        # Write before attend: the new token must be in its page.
        cache.k_pages[li][:, page_of_pos, slot_of_pos] = k.transpose(0, 1)
        cache.v_pages[li][:, page_of_pos, slot_of_pos] = v.transpose(0, 1)
        out = paged_decode_attention(
            q.contiguous(), cache.k_pages[li], cache.v_pages[li], lengths,
            page_tables, window=cfg.layer_window(li), softcap=cfg.attn_softcap,
            scale=cfg.attn_scale or None)  # (b, H, d)
        out = out.reshape(batch, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
        x = _residual_tail(cfg, layer, x, out)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x[:, 0], cfg), cache


def greedy_token(logits):
    """Argmax over the last axis."""
    return torch.argmax(logits, dim=-1)
