"""The launch plans of the wgmma attention main loop, pure functions:
K11's (``ops/flash_forward.py::fori_plan``) and K10's
(``ops/flash_quant.py::plan``).

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
    assert _int(MAIN_LOOP, r"constexpr int D = (\d+);") == ff.D_HEAD == fq.D_HEAD
    assert re.search(r"THREADS = \(CONSUMER_WGS \+ 1\) \* 128;", MAIN_LOOP)
    assert ff.TILE_THREADS == (ff.CONSUMER_WGS + 1) * 128


@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
def test_fori_plan_mirrors_the_kernel(nbuf):
    """``ForiTile<NB>``: BK keys a slot, a bf16 Q tile and NB K+V slots."""
    keys = _int(FORI, r"BK = NB == 4 \? 64 : (\d+);") if nbuf < 4 else _int(
        FORI, r"BK = NB == 4 \? (\d+) : 128;")
    assert f"case {nbuf}: return launch<{nbuf}>" in FORI
    assert re.search(r"SMEM = Q_BYTES \+ NB \* SLOT \+ ALIGN_SLACK;", FORI)
    assert re.search(r"SLOT = 2 \* bf16_tile_bytes\(BK\);", FORI)
    p = ff.fori_plan(nbuf, 4, 32, 4096, 4096)
    assert (p.rows, p.keys, p.slots) == (ff.TILE_ROWS, keys, nbuf)
    assert p.smem == 2 * ff.TILE_ROWS * 128 + nbuf * 2 * (2 * keys * 128) + ff.ALIGN_SLACK
    assert p.smem + STATIC_BARRIERS <= ff.SMEM_LIMIT, p
    assert p.threads == ff.TILE_THREADS


@pytest.mark.parametrize("kv_mode,i8c", K10_MODES)
def test_quant_plan_mirrors_the_kernel(kv_mode, i8c):
    """``UpcastTile<QT, KV>`` and ``I8Tile``: their slots and raw slots
    (a quantized Q's raw tile passes through an upcast raw slot)."""
    assert _int(QUANT, r"constexpr int BKQ = (\d+);") == fq.SEQ_QUANTUM == fq.I8_P_GROUP
    upcast = re.search(r"struct UpcastTile \{(.*?)\};", QUANT, re.S).group(1)
    i8 = re.search(r"struct I8Tile \{(.*?)\};", QUANT, re.S).group(1)
    p = fq.plan(kv_mode, i8c, 4, 32, 4096, 4096)
    keys, d = fq.SEQ_QUANTUM, fq.D_HEAD
    if i8c:
        assert p.slots == _int(i8, r"\bSLOTS = (\d+);")
        raw_slots = _int(i8, r"RAW_SLOTS = (\d+);")
        assert p.smem == ff.TILE_ROWS * d + p.slots * 2 * keys * d + raw_slots * keys * d + 1024
    else:
        assert p.slots == _int(upcast, r"\bSLOTS = (\d+);")
        raw_slots = _int(upcast, r"RAW_SLOTS = (\d+);")
        row = d // 2 if kv_mode == "int4" else d
        assert p.smem == (2 * ff.TILE_ROWS * d + p.slots * 2 * (2 * keys * d)
                          + raw_slots * 2 * keys * row + 1024)
        assert ff.TILE_ROWS * d <= 2 * keys * row  # a raw slot holds a raw Q tile
    assert p.smem + STATIC_BARRIERS <= ff.SMEM_LIMIT, p
    assert p.keys == keys and p.rows == ff.TILE_ROWS


def _covers(p, seq_q, seq_kv):
    x = p.grid[0]
    assert x * p.rows >= seq_q > (x - 1) * p.rows, (p, seq_q)  # no empty CTA
    assert p.kv_tiles * p.keys >= seq_kv > (p.kv_tiles - 1) * p.keys, (p, seq_kv)


@pytest.mark.parametrize("nbuf", range(1, MAX_KV_BUFFERS + 1))
def test_fori_grid_covers_every_seq(nbuf):
    for seq_q in range(ff.SEQ_QUANTUM, 8192 + 1, ff.SEQ_QUANTUM):
        seq_kv = seq_q + 128
        p = ff.fori_plan(nbuf, 2, 8, seq_q, seq_kv)
        assert p.grid[1:] == (8, 2)
        _covers(p, seq_q, seq_kv)
        # The last tile holds 64 zero-filled keys exactly when seq_kv is an
        # odd multiple of 64 and the slot is 128 keys.
        assert p.kv_tiles * p.keys - seq_kv in ((0, 64) if p.keys == 128 else (0,))


@pytest.mark.parametrize("kv_mode,i8c", K10_MODES)
def test_quant_grid_covers_every_seq(kv_mode, i8c):
    for seq in range(fq.SEQ_QUANTUM, 8192 + 1, fq.SEQ_QUANTUM):
        p = fq.plan(kv_mode, i8c, 3, 16, seq, seq)
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
