"""The launch plans of the wgmma attention main loop, pure functions:
K11's (``ops/flash_forward.py::fori_plan``), K10's
(``ops/flash_quant.py::plan``) and K1's (``ops/flash_forward.py::grid_plan``),
each at head widths 128 and 256.

Every ring depth and every K10 mode fits the H100's 232,448 bytes of shared
memory a block (with the kernels' static barriers), the grid covers every
Q row of every sequence length the wrappers take with no empty CTA, the KV
tiles cover every key, and the geometry the plans count with is the
kernels' own: the constants are read from the CUDA sources, which size
their shared memory from them.
"""

import math
import pathlib
import re

import pytest

from flash_attention_from_scratch_tpu_torch.ops import flash_forward as ff
from flash_attention_from_scratch_tpu_torch.ops import flash_quant as fq
from flash_attention_from_scratch_tpu_torch.ops.configs import MAX_KV_BUFFERS

CSRC = pathlib.Path(ff.__file__).parent.parent / "csrc"
MAIN_LOOP = (CSRC / "flash_wgmma.cuh").read_text()
FORI = (CSRC / ff.SOURCE_FORI).read_text()
QUANT = (CSRC / fq.SOURCE).read_text()
WIDTHS = [128, 256]
STATIC_BARRIERS = 16 * 8  # the kernels' __shared__ mbarriers, at most
K10_MODES = [("int8", False), ("fp8", False), ("int4", False), ("int8", True)]


def _int(src, pattern):
    found = re.findall(pattern, src)
    assert len(found) == 1, pattern
    return int(found[0])


def test_main_loop_constants_are_the_plans():
    assert _int(MAIN_LOOP, r"constexpr int WG_ROWS = (\d+);") == ff.WG_ROWS
    assert _int(MAIN_LOOP, r"constexpr int CONSUMER_WGS = (\d+);") == ff.CONSUMER_WGS
    assert _int(MAIN_LOOP, r"constexpr int SMEM_LIMIT = (\d+);") == ff.SMEM_LIMIT
    assert _int(MAIN_LOOP, r"constexpr int ALIGN_SLACK = (\d+);") == ff.ALIGN_SLACK
    assert _int(MAIN_LOOP, r"constexpr int D = (\d+);") == ff.D_HEAD
    assert ff.D_HEADS == fq.D_HEADS == (128, 256)
    assert re.search(r"THREADS = \(CONSUMER_WGS \+ 1\) \* 128;", MAIN_LOOP)
    assert ff.TILE_THREADS == (ff.CONSUMER_WGS + 1) * 128
    # CtaShape<HD>, the CTA of K10 and K11: two consumer warpgroups at d 128,
    # one at d 256.
    shape = re.search(r"struct CtaShape \{(.*?)\n\};", MAIN_LOOP, re.S).group(1)
    assert "CONSUMERS = HD == 128 ? CONSUMER_WGS : 1;" in shape
    assert "BQ = CONSUMERS * WG_ROWS;" in shape
    assert "THREADS = (CONSUMERS + 1) * 128;" in shape
    assert "ARRIVALS = CONSUMERS * 4;" in shape
    assert ff.FORI_TILES[128][0] == fq.QUANT_TILES[128][0] == ff.CONSUMER_WGS
    assert ff.FORI_TILES[256][0] == fq.QUANT_TILES[256][0] == 1


def _library(src_name, macro, d_head):
    """The source of the library built at ``d_head``: the width's own file
    defines ``macro`` and includes the shared source."""
    text = (CSRC / src_name).read_text()
    if d_head == 128:
        assert f"#ifndef {macro}\n#define {macro} 128\n#endif" in text
    else:
        assert f"#define {macro} {d_head}" in text and '#include "' in text
    return text


@pytest.mark.parametrize("d_head", WIDTHS)
@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
def test_fori_plan_mirrors_the_kernel(nbuf, d_head):
    """``ForiTile<NB, HD>``: BK keys a slot (128, halved at depth 4 and
    again at d 256), a bf16 Q tile of CtaShape<HD>'s rows and NB K+V slots;
    d 128's plan is the one its kernel was measured with."""
    deep, shallow = map(int, re.findall(
        r"BK = \(NB == 4 \? (\d+) : (\d+)\) / \(HD / 128\);", FORI)[0])
    keys = (deep if nbuf == 4 else shallow) // (d_head // 128)
    assert f"case {nbuf}: return launch<{nbuf}, FORI_HD>" in FORI
    _library(ff.SOURCES_FORI[d_head], "FORI_HD", d_head)
    assert re.search(r"SMEM = Q_BYTES \+ NB \* SLOT \+ ALIGN_SLACK;", FORI)
    assert re.search(r"SLOT = 2 \* bf16_tile_bytes\(BK, HD\);", FORI)
    assert re.search(r"Q_BYTES = bf16_tile_bytes\(CtaShape<HD>::BQ, HD\);", FORI)
    assert "__launch_bounds__(ForiTile<NB, HD>::THREADS, 1)" in FORI
    p = ff.fori_plan(nbuf, 4, 32, 4096, 4096, d_head)
    rows = ff.FORI_TILES[d_head][0] * ff.WG_ROWS
    assert (p.rows, p.keys, p.slots) == (rows, keys, nbuf)
    assert p.smem == rows * d_head * 2 + nbuf * 2 * (keys * d_head * 2) + ff.ALIGN_SLACK
    assert p.smem + STATIC_BARRIERS <= ff.SMEM_LIMIT, p
    if d_head == 128:
        assert (p.threads, p.rows) == (ff.TILE_THREADS, ff.TILE_ROWS)
        assert p.keys == (64 if nbuf == 4 else 128)
        assert p == ff.fori_plan(nbuf, 4, 32, 4096, 4096)
    else:
        assert (p.threads, p.rows, p.keys) == (256, 64, 32 if nbuf == 4 else 64)


def _by_width(tile, name, d_head):
    """``NAME = HD == 128 ? a : b;``: a at d 128, b at 256."""
    a, b = re.findall(rf"\b{name} = HD == 128 \? (\d+) : (\d+);", tile)[0]
    return int(a) if d_head == 128 else int(b)


@pytest.mark.parametrize("d_head", WIDTHS)
@pytest.mark.parametrize("kv_mode,i8c", K10_MODES)
def test_quant_plan_mirrors_the_kernel(kv_mode, i8c, d_head):
    """``UpcastTile<QT, KV, HD>`` and ``I8Tile<HD>``: their keys, slots and
    raw slots (a quantized Q's raw tile passes through an upcast raw slot),
    on CtaShape<HD>'s rows; d 128's plan is the one its kernel was measured
    with."""
    assert _int(QUANT, r"constexpr int BKQ = (\d+);") == fq.SEQ_QUANTUM == fq.I8_P_GROUP
    upcast = re.search(r"struct UpcastTile : CtaShape<HD> \{(.*?)\};", QUANT, re.S).group(1)
    i8 = re.search(r"struct I8Tile : CtaShape<HD> \{(.*?)\};", QUANT, re.S).group(1)
    _library(fq.SOURCES[d_head], "QUANT_HD", d_head)
    p = fq.plan(kv_mode, i8c, 4, 32, 4096, 4096, d_head)
    d, rows = d_head, fq.QUANT_TILES[d_head][0] * ff.WG_ROWS
    if i8c:
        keys = fq.I8_P_GROUP
        assert "SLOT = 2 * BKQ * HD;" in i8 and "RAW = BKQ * HD;" in i8
        assert p.slots == _by_width(i8, "SLOTS", d_head)
        raw_slots = _int(i8, r"RAW_SLOTS = (\d+);")
        assert p.smem == rows * d + p.slots * 2 * keys * d + raw_slots * keys * d + 1024
    else:
        keys = _by_width(upcast, "BK", d_head)
        assert p.slots == _int(upcast, r"\bSLOTS = (\d+);")
        raw_slots = _int(upcast, r"RAW_SLOTS = (\d+);")
        row = d // 2 if kv_mode == "int4" else d
        assert p.smem == (2 * rows * d + p.slots * 2 * (2 * keys * d)
                          + raw_slots * 2 * keys * row + 1024)
        assert rows * d <= 2 * keys * row  # a raw slot holds a raw Q tile
    assert p.smem + STATIC_BARRIERS <= ff.SMEM_LIMIT, p
    assert p.keys == keys and p.rows == rows and p.threads == (rows // 64 + 1) * 128
    assert p.kv_tiles * p.keys == 4096
    if d_head == 128:
        assert p == fq.plan(kv_mode, i8c, 4, 32, 4096, 4096)
        assert (p.rows, p.keys, p.threads) == (ff.TILE_ROWS, 128, ff.TILE_THREADS)
    else:
        assert p.threads == 256 and p.keys == (128 if i8c else 64)


@pytest.mark.parametrize("d_head", [64, 192, 384, 512])
def test_plans_refuse_other_head_widths(d_head):
    """K10's and K11's plans (and K1's) take d 128 and 256 only."""
    with pytest.raises(ValueError, match="head widths"):
        ff.fori_plan(2, 1, 8, 256, 256, d_head)
    with pytest.raises(ValueError, match="head widths"):
        fq.plan("int8", False, 1, 8, 256, 256, d_head)
    with pytest.raises(ValueError, match="head widths"):
        fq.plan("int8", True, 1, 8, 256, 256, d_head)


def _covers(p, seq_q, seq_kv):
    x = p.grid[0]
    assert x * p.rows >= seq_q > (x - 1) * p.rows, (p, seq_q)  # no empty CTA
    assert p.kv_tiles * p.keys >= seq_kv > (p.kv_tiles - 1) * p.keys, (p, seq_kv)


@pytest.mark.parametrize("d_head", WIDTHS)
@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
def test_fori_grid_covers_every_seq(nbuf, d_head):
    for seq_q in range(ff.SEQ_QUANTUM, 8192 + 1, ff.SEQ_QUANTUM):
        seq_kv = seq_q + 128
        p = ff.fori_plan(nbuf, 2, 8, seq_q, seq_kv, d_head)
        assert p.grid[1:] == (8, 2)
        _covers(p, seq_q, seq_kv)
        # The last tile holds 64 zero-filled keys exactly when seq_kv is an
        # odd multiple of 64 and the slot is 128 keys (d 128; d 256's slots
        # are 64 or 32 keys, which divide every seq_kv).
        assert p.kv_tiles * p.keys - seq_kv in ((0, 64) if p.keys == 128 else (0,))


@pytest.mark.parametrize("d_head", WIDTHS)
@pytest.mark.parametrize("kv_mode,i8c", K10_MODES)
def test_quant_grid_covers_every_seq(kv_mode, i8c, d_head):
    for seq in range(fq.SEQ_QUANTUM, 8192 + 1, fq.SEQ_QUANTUM):
        p = fq.plan(kv_mode, i8c, 3, 16, seq, seq, d_head)
        assert p.grid[1:] == (16, 3) and p.kv_tiles * p.keys == seq
        _covers(p, seq, seq)


@pytest.mark.parametrize("seq_q,tiles", [(192, 2), (640, 5), (4096, 32), (64, 1)])
def test_ragged_q_tiles(seq_q, tiles):
    """A seq_q that is a multiple of 64 but not of 128 leaves the second
    consumer warpgroup of the last CTA past the end (the kernel neither
    stores nor reads those rows)."""
    p = ff.fori_plan(2, 1, 1, seq_q, 256)
    assert p.grid[0] == tiles == math.ceil(seq_q / ff.TILE_ROWS)
    assert (seq_q % ff.TILE_ROWS == ff.WG_ROWS) == (seq_q % 128 == 64)


def test_check_grid_refuses_what_cuda_cannot_launch():
    ff.check_grid(ff.fori_plan(2, ff.MAX_GRID_YZ, ff.MAX_GRID_YZ, 64, 64))
    with pytest.raises(ValueError, match="at most"):
        ff.check_grid(ff.fori_plan(2, ff.MAX_GRID_YZ + 1, 8, 64, 64))
    with pytest.raises(ValueError, match="at most"):
        ff.check_grid(fq.plan("int8", False, 1, ff.MAX_GRID_YZ + 1, 128, 128))


# ---------------------------------------------------------------------------
# K1's persistent launch (``ops/flash_forward.py::grid_plan``).

GRID = (CSRC / ff.SOURCE).read_text()
H100_SMS = 132
# (batch, heads, seq_q, seq_kv, causal, window, q_offset): the serving run's
# prefill prompts (b 1, 32 heads, padded to 128), training's shape, ragged
# and windowed ones, and one with fewer items than SMs.
GRID_SHAPES = [(1, 32, s, s, True, 0, 0) for s in (256, 640, 1024, 1536, 2048, 2560,
                                                      3072, 4096)] + [
    (2, 32, 2048, 2048, True, 0, 0), (4, 32, 4096, 4096, False, 0, 0),
    (2, 8, 192, 320, True, 70, 128), (3, 4, 1088, 1088, True, 300, 0),
    (1, 2, 64, 64, True, 0, 0), (2, 16, 512, 1024, True, 0, 512)]


def _tile_field(tile, name, d_head):
    """``NAME = HD == 128 ? a : b;`` of ``GridTile<HD>``: a at d 128, b at 256."""
    a, b = re.findall(rf"\b{name} = HD == 128 \? (\d+) : (\d+);", tile)[0]
    return int(a) if d_head == 128 else int(b)


@pytest.mark.parametrize("d_head", WIDTHS)
def test_grid_plan_mirrors_the_kernel(d_head):
    """``GridTile<HD>``: at d 128 two consumer warpgroups, 2 slots of 128
    keys and 2 Q tiles; at d 256 one consumer warpgroup, 3 slots of 64 keys
    and one Q tile; sized from the same constants, within a block's shared
    memory; at most one CTA an SM."""
    tile = re.search(r"struct GridTile \{(.*?)\n\};", GRID, re.S).group(1)
    consumers, keys, slots, q_bufs = ff.GRID_TILES[d_head]
    assert _tile_field(tile, "CONSUMERS", d_head) == consumers
    assert _tile_field(tile, "NB", d_head) == slots
    assert _tile_field(tile, "BK", d_head) == keys
    assert _tile_field(tile, "Q_BUFS", d_head) == q_bufs
    assert re.search(r"BQ = CONSUMERS \* WG_ROWS;", tile)
    assert re.search(r"THREADS = \(CONSUMERS \+ 1\) \* 128;", tile)
    assert re.search(r"SMEM = Q_BUFS \* Q_BYTES \+ NB \* SLOT \+ ALIGN_SLACK;", tile)
    assert re.search(r"SLOT = 2 \* bf16_tile_bytes\(BK, HD\);", tile)
    assert re.search(r"Q_BYTES = bf16_tile_bytes\(BQ, HD\);", tile)
    assert '#include "flash_wgmma.cuh"' in GRID
    assert "__launch_bounds__(GridTile<HD>::THREADS, 1)" in GRID
    assert f"return launch<{d_head}>(" in GRID
    assert re.search(r"ctas > 0 \? std::min\(ctas, p\.items\) : p\.items", GRID)
    # The item order (item_at): causal by Q tile, heaviest first; else Q
    # tile fastest.
    assert "return Item{w - hb * p.q_tiles, hb % p.heads, hb / p.heads};" in GRID
    assert "return Item{p.q_tiles - 1 - r, hb % p.heads, hb / p.heads};" in GRID
    rows = consumers * ff.WG_ROWS
    for shape in GRID_SHAPES:
        p = ff.grid_plan(*shape, H100_SMS, d_head)
        assert (p.rows, p.keys, p.slots, p.q_bufs, p.d_head) == (rows, keys, slots, q_bufs,
                                                                 d_head)
        assert p.smem == (q_bufs * rows * d_head * 2 + slots * 2 * keys * d_head * 2
                          + ff.ALIGN_SLACK)
        assert p.smem + STATIC_BARRIERS <= ff.SMEM_LIMIT
        assert p.ctas == min(p.n_items, H100_SMS) and p.threads == (consumers + 1) * 128
        if d_head == 128:  # d 128's plan is the one its kernel was measured with
            assert p.smem == 2 * ff.TILE_ROWS * 128 * 2 + 2 * 2 * 128 * 128 * 2 + ff.ALIGN_SLACK
            assert p.threads == ff.TILE_THREADS and p == ff.grid_plan(*shape, H100_SMS)
    with pytest.raises(ValueError, match="head widths"):
        ff.grid_plan(*GRID_SHAPES[0], H100_SMS, 384)


def test_k1_has_no_warp_level_body():
    """K1 runs the wgmma main loop: no mma.sync, ldmatrix or cp.async of its
    own."""
    for body in ("mma.sync", "ldmatrix", "cp.async.cg", "cp_async"):
        assert body not in GRID, body
    assert "consume_bf16<" in GRID and "store_rows(" in GRID


@pytest.mark.parametrize("d_head", WIDTHS)
@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_grid_plan_takes_every_item_once(shape, d_head):
    """Every (Q tile, head, batch) item is taken by exactly one CTA, and
    every CTA takes one."""
    p = ff.grid_plan(*shape, H100_SMS, d_head)
    batch, heads = shape[:2]
    taken = [w for c in range(p.ctas) for w in p.cta_items(c)]
    assert sorted(taken) == list(range(p.n_items))
    items = {p.item(w) for w in taken}
    assert items == {(qt, h, b) for qt in range(p.q_tiles) for h in range(heads)
                     for b in range(batch)}
    assert all(p.cta_items(c) for c in range(p.ctas))


@pytest.mark.parametrize("d_head", WIDTHS)
@pytest.mark.parametrize("shape", GRID_SHAPES)
def test_grid_plan_is_heaviest_first_and_balanced(shape, d_head):
    """Items come heaviest first (non-increasing KV tiles; a window's tiles
    differ by at most one beyond its start), and no CTA's load (KV tiles)
    exceeds the largest item plus the mean over the CTAs."""
    p = ff.grid_plan(*shape, H100_SMS, d_head)
    if not p.causal:  # equal items, Q tile fastest: neighbours share K/V
        assert [p.item(w) for w in range(p.q_tiles)] == [(qt, 0, 0)
                                                        for qt in range(p.q_tiles)]
    work = [p.tiles(p.item(w)[0]) for w in range(p.n_items)]
    slack = 1 if p.window else 0
    assert all(a + slack >= b for a, b in zip(work, work[1:])), work
    loads = [sum(work[w] for w in p.cta_items(c)) for c in range(p.ctas)]
    assert max(loads) <= max(work) + slack * len(p.cta_items(0)) + sum(work) / p.ctas


def test_grid_plan_walks_the_kernels_tiles():
    """The KV tiles an item loads: all of them without the causal mask, up to
    the diagonal with it, from the window's first visible tile with one."""
    full = ff.grid_plan(1, 1, 512, 512, False, 0, 0, H100_SMS)
    assert [full.tiles(qt) for qt in range(4)] == [4, 4, 4, 4]
    causal = ff.grid_plan(1, 1, 512, 512, True, 0, 0, H100_SMS)
    assert [causal.tiles(qt) for qt in range(4)] == [1, 2, 3, 4]
    window = ff.grid_plan(1, 1, 512, 512, True, 130, 0, H100_SMS)
    assert [window.tiles(qt) for qt in range(4)] == [1, 2, 3, 3]
    offset = ff.grid_plan(1, 1, 192, 320, True, 70, 128, H100_SMS)
    assert [offset.tiles(qt) for qt in range(2)] == [2, 2]
    assert ff.grid_plan(1, 1, 512, 512, False, 130, 0, H100_SMS).window == 0


def test_grid_plan_walks_the_kernels_tiles_d256():
    """The same walks at d 256, on 64-row items and 64-key tiles."""
    def tiles(*shape):
        p = ff.grid_plan(*shape, H100_SMS, 256)
        return [p.tiles(qt) for qt in range(p.q_tiles)]

    assert tiles(1, 1, 512, 512, False, 0, 0) == [8] * 8
    assert tiles(1, 1, 512, 512, True, 0, 0) == list(range(1, 9))
    assert tiles(1, 1, 512, 512, True, 130, 0) == [1, 2, 3, 4, 4, 4, 4, 4]
    assert tiles(1, 1, 192, 320, True, 70, 128) == [3, 3, 3]
