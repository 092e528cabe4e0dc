"""K4/K5's launch plan, ``ops/paged_attention.py::plan``: a pure function
of shapes.

It takes integers only (never the lengths or the page table, so the host
reads no device value and a decode step can be captured in a CUDA graph);
its splits cover every page-table column exactly once; its ring, tiles and
merge scratch fit an H100 block's shared memory for every page format at
page sizes 64 and 128 (and the tests' 16), two CTAs an SM; at the serving
run's shapes it picks the split counts measured fastest; and the geometry
it counts with is the kernel's own: the constants are read from
``csrc/paged_attention.cu``.
"""

import inspect
import pathlib
import re

import pytest

from flash_attention_from_scratch_tpu_torch.ops import paged_attention as pa

SRC = (pathlib.Path(pa.__file__).parent.parent / "csrc" / pa.SOURCE).read_text()
H100_SMS = 132
MODE_NUMS = {**{name: num for name, (num, _) in pa.MODES.items()}, "int8c": pa.MODE_INT8C}


def _int(pattern):
    found = re.findall(pattern, SRC)
    assert len(found) == 1, pattern
    return int(found[0])


def test_plan_takes_integers_only():
    sig = inspect.signature(pa.plan)
    assert list(sig.parameters) == ["batch", "kv_heads", "rows", "pages_per_seq",
                                    "page_size", "mode", "sm_count", "splits"]
    assert all(p.annotation in (int, "int") for p in sig.parameters.values())


def test_plan_constants_are_the_kernels():
    assert _int(r"constexpr int NWARPS = (\d+);") * pa.MMA_ROWS * (pa.MERGE_STRIDE + 2) * 4 \
        == pa.MERGE_BYTES
    for name in ("MMA_ROWS", "TILE_TOKENS", "RING_BYTES", "RAW_RING_BYTES", "MIN_SLOTS",
                 "MAX_SLOTS", "ALIGN_SLACK", "SMEM_LIMIT", "STATIC_RESERVE"):
        assert _int(rf"constexpr int {name} = (\d+);") == getattr(pa, name), name
    assert _int(r"constexpr int D = (\d+);") == pa.D_HEAD
    assert re.search(r"STAGE_BYTES = 2 \* TILE_TOKENS \* D \* 2;", SRC)
    assert re.search(r"Q_TILE_BYTES = MMA_ROWS \* D \* 2;", SRC)
    assert re.search(r"MERGE_STRIDE = D \+ 8;", SRC) and pa.MERGE_STRIDE == pa.D_HEAD + 8
    assert re.search(r"MERGE_BYTES = NWARPS \* MMA_ROWS \* \(MERGE_STRIDE \+ 2\) \* 4;", SRC)
    assert pa.STAGE_BYTES == 2 * pa.TILE_TOKENS * pa.D_HEAD * 2
    assert pa.Q_TILE_BYTES == pa.MMA_ROWS * pa.D_HEAD * 2
    assert f"__launch_bounds__(NTHREADS, {pa.CTAS_PER_SM})" in SRC
    assert "__shared__ __align__(8) uint64_t full[MAX_SLOTS];" in SRC
    assert "__shared__ float q_fac_s[MMA_ROWS];" in SRC
    assert 8 * pa.MAX_SLOTS + 4 * pa.MMA_ROWS <= pa.STATIC_RESERVE
    for name, num in MODE_NUMS.items():
        assert re.search(rf"\b{name.upper()} = {num}\b", SRC), name
    # The host side sizes the ring, the tiles and the rows as plan() does.
    assert "if (store == INT4 || page_size <= TILE_TOKENS) return page_size;" in SRC
    assert "return page_size % TILE_TOKENS == 0 ? TILE_TOKENS : 0;" in SRC
    assert "return std::max(MIN_SLOTS, std::min(MAX_SLOTS, budget / slot_bytes));" in SRC
    assert "std::max((raw ? STAGE_BYTES : 0) + slots * slot_bytes, MERGE_BYTES);" in SRC
    assert "ring_slots(raw ? RAW_RING_BYTES : RING_BYTES, slot_bytes)" in SRC
    assert "const int row_blocks = (rows + MMA_ROWS - 1) / MMA_ROWS;" in SRC
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT - STATIC_RESERVE" in SRC
    assert "if (smem > SMEM_LIMIT - STATIC_RESERVE" in SRC


@pytest.mark.parametrize("page_size", [16, 64, 128])
@pytest.mark.parametrize("mode", sorted(MODE_NUMS))
def test_plan_fits_shared_memory(mode, page_size):
    """Every page format: chunks of up to 64 tokens (an int4 page whole) in
    a ring of 2-8 slots, the quantized formats' bf16 tile, the Q tile and
    the merge scratch fit a block, two CTAs an SM."""
    for rows in (1, 4, 16, 32, 64):
        p = pa.plan(8, 8, rows, 64, page_size, MODE_NUMS[mode], H100_SMS)
        tokens = page_size if mode == "int4" else min(page_size, 64)
        assert p.chunk_tokens == tokens
        per_token = {"dense": 256, "int4": 64}.get(mode, 128)
        assert p.slot_bytes == 2 * tokens * per_token
        assert pa.MIN_SLOTS <= p.slots <= pa.MAX_SLOTS
        tiles = 0 if mode == "dense" else pa.STAGE_BYTES
        assert p.smem == (pa.ALIGN_SLACK + pa.Q_TILE_BYTES
                          + max(tiles + p.slots * p.slot_bytes, pa.MERGE_BYTES))
        assert p.smem + pa.STATIC_RESERVE <= pa.SMEM_LIMIT, p
        assert p.ctas_per_sm == 2, p
        assert p.ctas_per_sm * (p.smem + pa.STATIC_RESERVE + pa.CTA_RESERVED) <= pa.SM_SMEM


def test_plan_chunks():
    """64-token chunks of larger pages (a multiple of 64), whole int4 pages,
    and 0 for a page size the kernel does not take."""
    assert [pa.chunk_tokens(0, ps) for ps in (8, 16, 64, 128, 256, 96)] == [8, 16, 64, 64,
                                                                           64, 0]
    assert [pa.chunk_tokens(3, ps) for ps in (16, 128, 256)] == [16, 128, 256]


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
