"""K4/K5's launch plan, ``ops/paged_attention.py::plan``: a pure function
of shapes.

It takes integers only (never the lengths or the page table, so the host
reads no device value and a decode step can be captured in a CUDA graph);
its splits cover every page-table column exactly once; its ring, tiles and
merge scratch fit an H100 block's shared memory for every page format at
page sizes 64 and 128 (and the tests' 16), two CTAs an SM at head width 128
and one at 256, and at every page size from 1 to 1,024 on either walk (the
chunk walk, or the gather walk of 64-position tiles across pages); at the
serving run's shapes it picks the split counts measured fastest; its
workspace holds every split's partial; and the geometry it counts with is
the kernel's own: the constants are read from ``csrc/paged_attention.cu``.
"""

import inspect
import pathlib
import re

import pytest

from flash_attention_from_scratch_tpu_torch.ops import paged_attention as pa

SRC = (pathlib.Path(pa.__file__).parent.parent / "csrc" / pa.SOURCE).read_text()
H100_SMS = 132
MODE_NUMS = {**{name: num for name, (num, _) in pa.MODES.items()}, "int8c": pa.MODE_INT8C}
WIDTHS = [128, 256]


def _int(pattern):
    found = re.findall(pattern, SRC)
    assert len(found) == 1, pattern
    return int(found[0])


def test_plan_takes_integers_only():
    sig = inspect.signature(pa.plan)
    assert list(sig.parameters) == ["batch", "kv_heads", "rows", "pages_per_seq",
                                    "page_size", "mode", "sm_count", "splits", "d_head"]
    assert all(p.annotation in (int, "int") for p in sig.parameters.values())
    assert sig.parameters["d_head"].default == 128


@pytest.mark.parametrize("d_head", WIDTHS)
def test_plan_constants_are_the_kernels(d_head):
    """``Geo<D>`` and the file's constants, read from the source, are the
    plan's at each head width."""
    geo = pa.geometry(d_head)
    assert _int(r"constexpr int NWARPS = (\d+);") == pa.NWARPS
    assert pa.NWARPS * pa.MMA_ROWS * (geo.merge_stride + 2) * 4 == geo.merge_bytes
    for name in ("MMA_ROWS", "TILE_TOKENS", "RING_BYTES", "RAW_RING_BYTES", "MIN_SLOTS",
                 "MAX_SLOTS", "ALIGN_SLACK", "SMEM_LIMIT", "STATIC_RESERVE",
                 "INT4_WHOLE_PAGE", "FAC_BYTES"):
        assert _int(rf"constexpr int {name} = (\d+);") == getattr(pa, name), name
    assert "template <int D>\nstruct Geo {" in SRC
    assert f"static_assert(D == 128 || D == 256" in SRC and pa.D_HEADS == (128, 256)
    assert "CTAS_PER_SM = D == 128 ? 2 : 1;" in SRC
    assert geo.ctas_per_sm == {128: 2, 256: 1}[d_head]
    assert re.search(r"RING = RING_BYTES \* \(D / 128\);", SRC)
    assert re.search(r"RAW_RING = RAW_RING_BYTES \* \(D / 128\);", SRC)
    assert (geo.ring_bytes, geo.raw_ring_bytes) == (pa.RING_BYTES * d_head // 128,
                                                    pa.RAW_RING_BYTES * d_head // 128)
    assert re.search(r"STAGE_BYTES = 2 \* TILE_TOKENS \* D \* 2;", SRC)
    assert re.search(r"Q_TILE_BYTES = MMA_ROWS \* D \* 2;", SRC)
    assert re.search(r"MERGE_STRIDE = D \+ 8;", SRC) and geo.merge_stride == d_head + 8
    assert re.search(r"MERGE_BYTES = NWARPS \* MMA_ROWS \* \(MERGE_STRIDE \+ 2\) \* 4;", SRC)
    assert geo.stage_bytes == 2 * pa.TILE_TOKENS * d_head * 2
    assert geo.q_tile_bytes == pa.MMA_ROWS * d_head * 2
    assert "__launch_bounds__(NTHREADS, Geo<D>::CTAS_PER_SM)" in SRC
    assert "__launch_bounds__(D)" in SRC  # the merge: one thread a column
    assert f"split_launch<{d_head}>(p, batch, heads, mode, s)" in SRC
    assert f"paged_decode_merge_kernel<{d_head}>" in SRC
    assert "__shared__ __align__(8) uint64_t full[MAX_SLOTS];" in SRC
    assert "__shared__ float q_fac_s[MMA_ROWS];" in SRC
    assert 8 * pa.MAX_SLOTS + 4 * pa.MMA_ROWS <= pa.STATIC_RESERVE
    for name, num in MODE_NUMS.items():
        assert re.search(rf"\b{name.upper()} = {num}\b", SRC), name
    # The host side sizes the ring, the tiles and the rows as plan() does.
    assert "if (store == INT4 || page_size <= TILE_TOKENS) return page_size;" in SRC
    assert "return page_size % TILE_TOKENS == 0 ? TILE_TOKENS : 0;" in SRC
    assert "if (ct % 8 || (store == INT4 && page_size > INT4_WHOLE_PAGE)) return 0;" in SRC
    assert "const int ct = walk_chunk_tokens(store, p.page_size);" in SRC
    assert "return store == DENSE ? 2 * d : d;" in SRC  # gather_row_bytes
    assert "return std::max(MIN_SLOTS, std::min(MAX_SLOTS, budget / slot_bytes));" in SRC
    assert "std::max((raw ? G::STAGE_BYTES : 0) + slots * slot_bytes, G::MERGE_BYTES);" in SRC
    assert ("std::max(G::STAGE_BYTES + FAC_BYTES + slots * slot_bytes, G::MERGE_BYTES);"
            in SRC)
    assert "const bool gather = ct == 0;" in SRC
    assert "2 * TILE_TOKENS * gather_row_bytes(store, D)" in SRC
    assert "ring_slots(raw || gather ? Geo<D>::RAW_RING : Geo<D>::RING, slot_bytes)" in SRC
    assert "float* fac = reinterpret_cast<float*>(stage + G::STAGE_BYTES);" in SRC
    assert "uint8_t* ring = stage + G::STAGE_BYTES + FAC_BYTES;" in SRC
    assert pa.FAC_BYTES == 2 * pa.TILE_TOKENS * 4  # a K and a V factor a token
    assert "const int row_blocks = (rows + MMA_ROWS - 1) / MMA_ROWS;" in SRC
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT - STATIC_RESERVE" in SRC
    assert "if (smem > SMEM_LIMIT - STATIC_RESERVE" in SRC


@pytest.mark.parametrize("d_head", WIDTHS)
@pytest.mark.parametrize("page_size", [16, 64, 128])
@pytest.mark.parametrize("mode", sorted(MODE_NUMS))
def test_plan_fits_shared_memory(mode, page_size, d_head):
    """Every page format: chunks of up to 64 tokens (an int4 page whole) in
    a ring of 2-8 slots, the quantized formats' bf16 tile, the Q tile and
    the merge scratch fit a block, two CTAs an SM at d 128, one at d 256
    (whose ring budget is twice d 128's)."""
    geo = pa.geometry(d_head)
    for rows in (1, 4, 16, 32, 64):
        p = pa.plan(8, 8, rows, 64, page_size, MODE_NUMS[mode], H100_SMS, d_head=d_head)
        tokens = page_size if mode == "int4" else min(page_size, 64)
        assert p.chunk_tokens == tokens and p.d_head == d_head
        per_token = {"dense": 2 * d_head, "int4": d_head // 2}.get(mode, d_head)
        assert p.slot_bytes == 2 * tokens * per_token
        assert pa.MIN_SLOTS <= p.slots <= pa.MAX_SLOTS
        budget = geo.ring_bytes if mode == "dense" else geo.raw_ring_bytes
        assert p.slots == max(pa.MIN_SLOTS, min(pa.MAX_SLOTS, budget // p.slot_bytes))
        tiles = 0 if mode == "dense" else geo.stage_bytes
        assert p.smem == (pa.ALIGN_SLACK + geo.q_tile_bytes
                          + max(tiles + p.slots * p.slot_bytes, geo.merge_bytes))
        assert p.smem + pa.STATIC_RESERVE <= pa.SMEM_LIMIT, p
        assert p.ctas_per_sm == {128: 2, 256: 1}[d_head], p
        assert p.ctas_per_sm * (p.smem + pa.STATIC_RESERVE + pa.CTA_RESERVED) <= pa.SM_SMEM
        if d_head == 128:  # the default is d 128's plan, unchanged
            assert p == pa.plan(8, 8, rows, 64, page_size, MODE_NUMS[mode], H100_SMS)


def test_plan_d128_is_unchanged():
    """d 128's geometry is the one its kernel was measured with: 3 dense
    slots of 64 tokens in 103,424 bytes, two CTAs an SM; int8 4 slots."""
    p = pa.plan(8, 8, 4, 64, 64, 0, H100_SMS)
    assert (p.slots, p.slot_bytes, p.smem, p.ctas_per_sm) == (3, 32768, 103424, 2)
    q = pa.plan(8, 8, 4, 64, 64, 1, H100_SMS)
    assert (q.slots, q.slot_bytes, q.smem, q.ctas_per_sm) == (4, 16384, 103424, 2)


@pytest.mark.parametrize("d_head", WIDTHS)
@pytest.mark.parametrize("splits", [0, 1, 3])
def test_plan_workspace_holds_every_partial(d_head, splits):
    """The workspace the wrapper allocates: each split's O (d_head fp32
    values a row), then its m and l, for every (sequence, KV head, row);
    nothing with one split."""
    for batch, kv_heads, rows in ((8, 8, 2), (3, 4, 16), (1, 1, 1)):
        p = pa.plan(batch, kv_heads, rows, 40, 64, 0, H100_SMS, splits, d_head)
        n_o, n_ml = p.workspace_floats(batch, kv_heads, rows)
        if p.splits == 1:
            assert (n_o, n_ml) == (0, 0)
            continue
        assert n_o == batch * kv_heads * p.splits * rows * d_head
        assert n_ml == batch * kv_heads * p.splits * rows * 2


def test_plan_chunks():
    """The chunk walk: whole pages of 8-64 tokens (a multiple of 8), 64-token
    chunks of larger pages (a multiple of 64), whole int4 pages up to 256
    tokens; 0 (the gather walk) for every other page size: 1-7, 12, 96,
    100, 200, an int4 page of 12 or 512."""
    assert [pa.chunk_tokens(0, ps) for ps in (8, 16, 64, 128, 256, 96)] == [8, 16, 64, 64,
                                                                           64, 0]
    assert [pa.chunk_tokens(3, ps) for ps in (16, 128, 256)] == [16, 128, 256]
    for mode in (0, 1, 2, 4):
        assert [pa.chunk_tokens(mode, ps) for ps in (1, 4, 7, 12, 40, 72, 100, 200, 1024)] == [
            0, 0, 0, 0, 40, 0, 0, 0, 64]
    assert [pa.chunk_tokens(3, ps) for ps in (2, 12, 40, 72, 96, 200, 264, 512)] == [
        0, 0, 40, 72, 96, 200, 0, 0]


@pytest.mark.parametrize("pages_per_seq", [1, 2, 3, 9, 17, 64, 257])
@pytest.mark.parametrize("batch", [1, 8, 16, 64])
def test_plan_splits_cover_every_column_once(batch, pages_per_seq):
    """The plan's split count and forced ones (1, 2, 5, more than the
    columns): every page-table column in exactly one split, no split
    without a column."""
    for forced in (0, 1, 2, 5, 1000):
        p = pa.plan(batch, 8, 4, pages_per_seq, 64, 0, H100_SMS, forced)
        cols = [c for s in range(p.splits) for c in p.columns(s, pages_per_seq)]
        assert cols == list(range(pages_per_seq)), (p, forced)
        assert all(len(p.columns(s, pages_per_seq)) for s in range(p.splits))
        assert p.splits * p.pages_per_split >= pages_per_seq
        if forced:
            assert p.splits <= forced
        assert p.grid == (batch, 8, p.splits * p.row_blocks)


@pytest.mark.parametrize("rows,blocks", [(1, 1), (4, 1), (12, 1), (16, 1), (17, 2), (32, 2),
                                         (64, 4)])
def test_plan_rows(rows, blocks):
    """One 16-row tile (mma.sync's M) a CTA, every page format: a decode
    step's 4 rows and a verify call's 16 (4 heads a KV head, t = 4) in one
    CTA and one copy of each page; 32 rows (t = 8) in two."""
    for mode in MODE_NUMS.values():
        assert pa.plan(2, 8, rows, 64, 64, mode, H100_SMS).row_blocks == blocks


def test_plan_at_gemma2_9b_decode():
    """Gemma-2-9B's decode (8 sequences x 8 KV heads, 2 rows a KV head, 79
    pages of 64, d 256): one CTA an SM, so about half of d 128's split
    count for the same shapes; still more than one split, so the decode
    graphs launch the merge."""
    p = pa.plan(8, 8, 2, 79, 64, 0, H100_SMS, d_head=256)
    assert (p.splits, p.pages_per_split, p.ctas_per_sm) == (4, 20, 1), p
    for mode in (1, 2, 3, 4):
        assert pa.plan(8, 8, 2, 79, 64, mode, H100_SMS, d_head=256).splits == 5
    with pytest.raises(ValueError, match="head widths"):
        pa.plan(8, 8, 2, 79, 64, 0, H100_SMS, d_head=384)


def test_plan_at_the_serving_shapes():
    """8 sequences x 8 KV heads, 64 pages of 64 (the bf16 run and its t = 4
    verify call): dense pages 4 splits of 1024 tokens, quantized ones 8 of
    512, near two waves of the 264 CTA slots (short sequences leave most
    of their splits empty). Run A's 16 x 8 heads, 9 pages of 128: dense
    one split, the quantized formats 2 (one wave)."""
    for rows in (4, 16):
        p = pa.plan(8, 8, rows, 64, 64, 0, H100_SMS)
        assert (p.splits, p.pages_per_split, p.row_blocks) == (4, 16, 1), p
    for mode in (1, 2, 3, 4):
        p = pa.plan(8, 8, 4, 64, 64, mode, H100_SMS)
        assert (p.splits, p.pages_per_split) == (8, 8), p
        assert 8 * 8 * p.splits >= p.ctas_per_sm * H100_SMS
    assert pa.plan(16, 8, 4, 9, 128, 0, H100_SMS).splits == 1
    for mode in range(1, 5):
        p = pa.plan(16, 8, 4, 9, 128, mode, H100_SMS)
        assert (p.splits, p.pages_per_split) == (2, 5), p
        assert 16 * 8 * p.splits <= p.ctas_per_sm * H100_SMS


def test_plan_never_splits_past_the_table():
    p = pa.plan(1, 1, 1, 3, 1024, 0, H100_SMS)
    assert p.splits == 3 and p.pages_per_split == 1
    assert pa.plan(1, 1, 1, 3, 64, 0, H100_SMS).splits == 1  # 192 tokens
    assert pa.plan(512, 8, 4, 64, 64, 0, H100_SMS).splits == 1
    assert pa.plan(1, 1, 1, 0, 64, 0, H100_SMS).splits == 1
