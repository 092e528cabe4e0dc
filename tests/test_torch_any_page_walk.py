"""K4/K5's walks at every page size: the plan, the gather walk's indexing,
and a served model, against the JAX package's server.

- ``plan`` is launchable at every page size from 1 to 1,024 in every
  format and head width: the chunk walk's chunks are a multiple of 8 that
  tiles the page, or the gather walk (tiles of 64 positions across pages);
  its ring, tiles and merge scratch fit a block, and its splits cover the
  table; the gather walk splits finer.
- The gather walk's copies and conversion, written out in Python as the
  kernel indexes them (its source lines are asserted), put every
  position's row in its slot row once.
- A tiny Mistral-shaped model (sliding window, GQA) with a 1,002-word
  head, int8 weights, served at pages of 1 (dense cache) and 12 (int8
  cache), both servers on the CPU (the JAX one on its per-page kernel, K5,
  in interpret mode): the same greedy tokens for every request.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

import flash_attention_from_scratch_tpu.ops.paged_attention as jax_pa
from flash_attention_from_scratch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, init_params as jax_init_params,
    quantize_params as jax_quantize_params,
)
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.serving.generate import (
    GenerationServer as JaxGenerationServer,
)
from flash_attention_from_scratch_tpu_torch.models.llama import LlamaConfig, params_from_jax
from flash_attention_from_scratch_tpu_torch.ops import paged_attention as pa
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.ops.quant import unpack_int4_halves
from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

SRC = (pathlib.Path(pa.__file__).parent.parent / "csrc" / pa.SOURCE).read_text()


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4], ids=["dense", "int8", "fp8", "int4",
                                                      "int8c"])
def test_plan_is_launchable_at_every_page_size(mode, d_head):
    """Pages of 1 to 1,024 tokens (int4: even) on a 2,048-token table: the
    chunk walk's chunks are a multiple of 8 that tiles the page, else the
    gather walk; the ring holds 2-8 slots, and the ring, tiles and merge
    scratch fit a block with the CTAs an SM the plan counts."""
    geo = pa.geometry(d_head)
    store = 1 if mode == pa.MODE_INT8C else mode
    for ps in range(2 if store == 3 else 1, 1025, 2 if store == 3 else 1):
        cols = -(-2048 // ps)
        p = pa.plan(8, 8, 4, cols, ps, mode, 132, 0, d_head)
        ct = pa.chunk_tokens(store, ps)
        assert p.gather == (ct == 0) and p.chunk_tokens == ct
        if ct:
            assert ct % 8 == 0 and ps % ct == 0 and (store == 3 or ct <= pa.TILE_TOKENS)
        else:
            assert p.slot_bytes == 2 * pa.TILE_TOKENS * pa.gather_row_bytes(store, d_head)
        assert pa.MIN_SLOTS <= p.slots <= pa.MAX_SLOTS
        assert p.smem + pa.STATIC_RESERVE <= pa.SMEM_LIMIT, (ps, p)
        assert p.smem >= pa.ALIGN_SLACK + geo.q_tile_bytes + geo.merge_bytes
        assert 1 <= p.ctas_per_sm <= geo.ctas_per_sm
        assert p.ctas_per_sm * (p.smem + pa.STATIC_RESERVE + pa.CTA_RESERVED) <= pa.SM_SMEM
        assert p.splits * p.pages_per_split >= cols and p.grid[2] <= 65535


def test_plan_splits_the_gather_walk_finer():
    """The gather walk takes a split a ``MIN_SPLIT_TOKENS["gather"]`` table
    tokens (a copy a page makes its walk dearer than the chunk walk's), the
    chunk walk its own: at OpenHermes R1's step (8 sequences, 8 KV heads, 4
    rows, 2,032 one-token pages) 9 splits, at the same tokens in pages of
    64 still 2; at R2's (4 sequences, 12 int8 pages of 96) 6."""
    assert pa.MIN_SPLIT_TOKENS == {"dense": 1024, "quantized": 512, "gather": 128}
    assert pa.plan(8, 8, 4, 2032, 1, 0, 132).splits == 9
    assert pa.plan(8, 8, 4, 32, 64, 0, 132).splits == 2
    assert pa.plan(4, 8, 4, 12, 96, 1, 132).splits == 6


def _gather_slot(pages, page_table, pos, valid, ps, store):
    """The kernel's gather walk for one tile, written out: the copies of
    ``issue`` (each page's run [a, e) of the tile; int4 by half, stored row
    t or t - ps/2), then the conversion's nibble pick, as fp32 token rows
    (TILE_TOKENS, d); rows past ``valid`` stay NaN."""
    slot = np.full((pa.TILE_TOKENS, pages.shape[-1]), np.nan)
    filled = np.zeros(pa.TILE_TOKENS, int)
    for c in range(pos // ps, (pos + valid - 1) // ps + 1):
        page = pages[page_table[c]]
        a, e = max(pos, c * ps) - c * ps, min(pos + valid, (c + 1) * ps) - c * ps
        if store == 3:
            half = ps // 2
            runs = [(a, min(e, half), 0), (max(a, half), e, half)]
        else:
            runs = [(a, e, 0)]
        for first, end, shift in runs:
            for tok in range(first, end):  # slot row c * ps + tok - pos <- stored row tok - shift
                row = c * ps + tok - pos
                raw = page[tok - shift]
                if store == 3:  # the conversion: the high nibble past half a page
                    lo, hi = unpack_int4_halves(torch.from_numpy(raw[None]))
                    raw = (hi if (pos + row) % ps >= ps // 2 else lo)[0].numpy()
                slot[row] = raw
                filled[row] += 1
    return slot, filled


@pytest.mark.parametrize("store", [0, 3], ids=["rows", "int4"])
@pytest.mark.parametrize("ps", [2, 4, 12, 100, 200, 514])
def test_gather_walk_puts_each_position_in_its_slot_row_once(ps, store):
    """Every tile of a split that starts at a page boundary and ends below
    the length: each position's token lands in slot row (position - tile
    start) exactly once, rows past the tile's valid ones get nothing; the
    copies the Python walk makes are the source's."""
    assert "const int a = max(pos, c * ps) - c * ps, e = min(pos + valid, (c + 1) * ps) - c * ps;" in SRC
    assert "if (a < lo_end) copy(off, a, c * ps + a, lo_end - a);" in SRC
    assert "if (hi_begin < e) copy(off, hi_begin - half, c * ps + hi_begin, e - hi_begin);" in SRC
    assert "STORE == INT4 && (pos + tok) % ps >= ps / 2, f);" in SRC
    rng = np.random.default_rng(ps)
    n_pages = 7
    tokens = rng.integers(-8, 8, (n_pages, ps, 3)).astype(np.int8)
    if store == 3:  # int4 pages: token t low nibble, t + ps/2 high, of stored row t
        stored = ((tokens[:, : ps // 2] & 0x0F) | (tokens[:, ps // 2:] << 4)).astype(np.int8)
    else:
        stored = tokens
    table = rng.permutation(n_pages)
    pos_begin, pos_end = 2 * ps, 6 * ps - 3  # columns 2..5, the last cut short
    for pos in range(pos_begin, pos_end, pa.TILE_TOKENS):
        valid = min(pa.TILE_TOKENS, pos_end - pos)
        slot, filled = _gather_slot(stored, table, pos, valid, ps, store)
        assert (filled[:valid] == 1).all() and not filled[valid:].any()
        for row in range(valid):
            p = pos + row
            np.testing.assert_array_equal(slot[row], tokens[table[p // ps], p % ps])


SHAPE = dict(vocab_size=1002, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, d_head=128,
             hidden_dim=512, rope_theta=10000.0, sliding_window=16)
PROMPTS = {1: list(range(10, 30)), 2: list(range(40, 45)), 3: [(7 * i + 3) % 1002
                                                              for i in range(33)]}


@pytest.mark.parametrize("page_size,kv_mode", [(1, "dense"), (12, "int8")],
                         ids=["page1-dense", "page12-int8"])
def test_ragged_vocab_mistral_serves_at_any_page_size(page_size, kv_mode, monkeypatch):
    """Both servers on the same fp32 model with int8 weights (the JAX
    package's ``quantize_params``, the 1,002-wide head included, carried
    across by ``params_from_jax``), a sliding window of 16 that the longer
    prompts pass: the same greedy tokens for every request."""
    jcfg = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    cfg = LlamaConfig(**SHAPE, dtype=DType.FP32)
    jparams = jax_quantize_params(jax_init_params(jcfg, jax.random.PRNGKey(5)), "int8")
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    assert params["lm_head"].shape == (256, 1002)
    per_seq = -(-40 // page_size)
    kw = dict(num_pages=3 * per_seq + 2, page_size=page_size, max_batch=3,
              pages_per_seq=per_seq, mode=kv_mode)
    monkeypatch.setattr(jax_pa, "_FULL_VARIANT_VMEM_CAP", 0)
    jax_pa._build_decode_call.cache_clear()
    try:
        servers = [JaxGenerationServer(jparams, jcfg, **kw),
                   GenerationServer(params, cfg, device="cpu", **kw)]
        for server in servers:
            for sid, prompt in PROMPTS.items():
                server.submit(sid, prompt, 5)
        want, got = (server.run() for server in servers)
    finally:
        jax_pa._build_decode_call.cache_clear()
    assert got == want
    assert all(len(toks) == 5 for toks in got.values())
