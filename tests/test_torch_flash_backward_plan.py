"""The launch plan of the flash backward kernels K2 and K3, pure functions
(``ops/flash_backward.py::plan`` and ``dkv_q_tiles``).

The geometry the plan counts with is the kernel's own (the constants are
read from ``csrc/flash_backward.cu``, which sizes its shared memory from
them); every launch fits the H100's 232,448 bytes of shared memory a block
with the kernels' static barriers; the grids cover every row of every
sequence length the wrapper takes, ragged ones included; and the dK/dV
walk's visible Q tiles are exactly those where the plain version's mask
leaves a nonzero, so a kernel that follows them skips no gradient and
visits no empty tile.
"""

import pathlib
import re

import pytest
import torch

from flash_attention_from_scratch_tpu_torch.ops import flash_backward as fb
from flash_attention_from_scratch_tpu_torch.ops import flash_forward as ff
from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig

CSRC = pathlib.Path(fb.__file__).parent.parent / "csrc"
SOURCE = (CSRC / fb.SOURCE).read_text()
STATIC_BARRIERS = 16 * 8  # the kernels' __shared__ mbarriers, at most


def _tile(name):
    found = re.findall(rf"#define {name} ([\w, ]+)\n", SOURCE)
    assert len(found) == 1, name
    return tuple(int(x) if x.strip().isdigit() else x.strip() for x in found[0].split(","))


def _int(pattern):
    found = re.findall(pattern, SOURCE)
    assert len(found) == 1, pattern
    return int(found[0])


def test_tiles_are_the_sources():
    assert set(fb.FUSED_TILE) == set(fb.DKV_TILE) == set(fb.DQ_SLOTS) == set(ff.D_HEADS)
    for d in ff.D_HEADS:
        assert _tile(f"FUSED_TILE_{d}") == (*fb.FUSED_TILE[d], "true", d)
        assert _tile(f"DKV_TILE_{d}") == (*fb.DKV_TILE[d], "false", d)
        assert _tile(f"DQ_TILE_{d}") == (fb.DQ_SLOTS[d], fb.DQ_KEYS[d], d)
    # Each width's library builds flash_backward.cu with its BACKWARD_HD,
    # and the three entry points launch that width's tiles.
    assert set(fb.SOURCES) == set(ff.D_HEADS) and fb.SOURCES[128] == fb.SOURCE
    assert _int(r"#define BACKWARD_HD (\d+)") == 128
    wide = (CSRC / fb.SOURCES[256]).read_text()
    assert re.findall(r"#define BACKWARD_HD (\d+)", wide) == ["256"]
    assert re.findall(r'#include "(\S+)"', wide) == [fb.SOURCE]
    assert len(re.findall(r"launch_\w+<TILE_OF\(\w+_TILE, BACKWARD_HD\)>", SOURCE)) == 3
    assert re.search(r"static constexpr int BK = BK_;", SOURCE)
    assert re.search(r"static constexpr int BQ = WG_ROWS;", SOURCE)
    assert ff.WG_ROWS == fb.DKV_Q_ROWS == 64  # wgmma's M: K2's dQ product takes Q rows as M
    assert re.search(r"static constexpr int SPLIT = HD / 128;", SOURCE)
    assert re.search(r"static constexpr int BKV = NC / SPLIT \* WG_ROWS;", SOURCE)
    assert re.search(r"static_assert\(HD == 128 \|\| \(HD == 256 && NC == 2\)", SOURCE)
    assert _int(r"constexpr int SM_SMEM = (\d+);") == fb.SM_SMEM
    assert len(re.findall(r"THREADS = NC \* 128;", SOURCE)) == 1
    assert re.search(r"static constexpr int BQ = WG_ROWS;  // Q rows per CTA", SOURCE)
    assert len(re.findall(r"THREADS = 128;", SOURCE)) == 1
    assert re.search(r"DS_BUFS = NC;", SOURCE)
    assert re.search(r"KV_BYTES = bf16_tile_bytes\(BKV, HD\);", SOURCE)
    assert re.search(r"SLOT = 2 \* bf16_tile_bytes\(BQ, HD\);", SOURCE)
    assert re.search(r"SLOT = 2 \* bf16_tile_bytes\(BK, HD\);", SOURCE)
    assert re.search(r"Q_BYTES = bf16_tile_bytes\(BQ, HD\);", SOURCE)
    assert re.search(r"SMEM =\s+2 \* KV_BYTES \+ NS \* \(SLOT \+ STATS\) \+ DS_BUFS \* DS_BYTES "
                     r"\+ STAGE \+ ALIGN_SLACK;", SOURCE)
    assert re.search(r"STAGE = kDQ \? NC \* 4 \* WARP_STAGE : 0;", SOURCE)
    assert _int(r"constexpr int WARP_STAGE = 16 \* 64 \* (\d+);") == 4
    assert re.search(r"SMEM = 2 \* Q_BYTES \+ NS \* SLOT \+ ALIGN_SLACK;", SOURCE)
    assert re.search(r"return nc == 1 && 2 \* \(smem \+ 1024\) <= SM_SMEM \? 2 : 1;", SOURCE)
    assert re.search(r"PER_SM = per_sm\(NC, SMEM\);", SOURCE)
    assert re.search(r"PER_SM = per_sm\(1, SMEM\);", SOURCE)


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_plan_mirrors_the_kernels(fused, d_head):
    """Shared memory, threads and rows of each launch, from the sources'
    tile structs: K and V tiles of 64 KV rows a row group (at d 128 a
    consumer warpgroup; at d 256 two warpgroups that split dK's and dV's
    columns), ring slots of Q and dO with their LSE and D rows, K2's two
    dS^T buffers and a dQ stage a warp; the dQ kernel's Q and dO tiles and
    its K/V slots (128 keys at d 128, 64 at d 256)."""
    launches = fb.plan(fused, 2, 32, 8, 2048, 2048, d_head)
    assert len(launches) == (1 if fused else 2)
    nc, slots = (fb.FUSED_TILE if fused else fb.DKV_TILE)[d_head]
    bq, row = fb.DKV_Q_ROWS, 2 * d_head  # bytes of a bf16 row
    bkv = nc * 64 * 128 // d_head
    dkv = launches[0]
    assert (dkv.rows, dkv.keys, dkv.slots, dkv.threads) == (bq, bkv, slots, nc * 128)
    ds = nc * (bkv * bq * 2 + 4 * 16 * 64 * 4) if fused else 0
    assert dkv.smem == (2 * bkv * row + slots * (2 * bq * row + 2 * bq * 4) + ds
                        + ff.ALIGN_SLACK)
    if not fused:
        dq = launches[1]
        keys, dq_slots = fb.DQ_KEYS[d_head], fb.DQ_SLOTS[d_head]
        assert (dq.rows, dq.keys, dq.slots, dq.threads) == (64, keys, dq_slots, 128)
        assert dq.smem == 2 * 64 * row + dq_slots * 2 * keys * row + ff.ALIGN_SLACK
    for launch in launches:
        assert launch.smem + STATIC_BARRIERS <= ff.SMEM_LIMIT, launch
        # One warpgroup a CTA: two CTAs an SM where their shared memory fits
        # (d 128), else one.
        assert fb.per_sm(launch.threads // 128, launch.smem) == (
            2 if launch.threads == 128 and d_head == 128 else 1)


def test_d256_plans_fit_and_other_widths_are_refused():
    """At d 256 every launch fits a CTA's shared memory with its barriers,
    has at most 256 threads (two warpgroups: 255 registers a thread) and
    a grid CUDA launches, from one KV tile to the 65,535 the grid allows;
    ``fused_backward_fits`` says so, and says no past the grid and at d
    384, where the plans raise."""
    for seq in (64, 192, 8192, 65535 * 64):
        for fused in (True, False):
            for launch in fb.plan(fused, 1, 16, 8, seq, seq, 256):
                assert launch.smem + STATIC_BARRIERS <= ff.SMEM_LIMIT, launch
                assert launch.threads <= 256
                assert launch.kv_tiles * launch.keys >= seq
                ff.check_grid(launch)
        assert fb.fused_backward_fits(seq, 256)
    assert not fb.fused_backward_fits(65536 * 64, 256)
    assert not fb.fused_backward_fits(1024, 384) and not fb.fused_backward_fits(1024, 64)
    for fused in (True, False):
        with pytest.raises(ValueError, match="128 or 256 wide"):
            fb.plan(fused, 1, 16, 8, 1024, 1024, 384)


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_grids_cover_every_seq(fused, d_head):
    """Every KV row and (split) every Q row has a CTA, and none is empty;
    the dK/dV grid's slowest axis is the KV tile (heaviest causal first)."""
    for seq_q in range(64, 4096 + 1, 64):
        seq_kv = seq_q + 64 * (seq_q // 64 % 3)  # ragged against 128-row tiles too
        launches = fb.plan(fused, 3, 16, 4, seq_q, seq_kv, d_head)
        dkv = launches[0]
        assert dkv.grid[:2] == (4, 3)
        tiles = dkv.grid[2]
        assert tiles == dkv.kv_tiles and tiles * dkv.keys >= seq_kv > (tiles - 1) * dkv.keys
        assert seq_q % dkv.rows == 0  # Q tiles of the dK/dV walk are never ragged
        if not fused:
            dq = launches[1]
            x = dq.grid[0]
            assert dq.grid[1:] == (16, 3)
            assert x * dq.rows >= seq_q > (x - 1) * dq.rows
            assert dq.kv_tiles * dq.keys >= seq_kv > (dq.kv_tiles - 1) * dq.keys


def test_check_grid_refuses_what_cuda_cannot_launch():
    with pytest.raises(ValueError, match="at most"):
        ff.check_grid(fb.plan(True, ff.MAX_GRID_YZ + 1, 8, 8, 64, 64)[0])
    with pytest.raises(ValueError, match="at most"):
        ff.check_grid(fb.plan(False, 1, ff.MAX_GRID_YZ + 1, 1, 64, 64)[1])
    for launch in fb.plan(False, ff.MAX_GRID_YZ, ff.MAX_GRID_YZ, 1, 64, 64):
        ff.check_grid(launch)


WALK_CASES = [
    (256, 256, dict()), (256, 256, dict(causal=True)),
    (512, 1024, dict(causal=True, q_offset=512)),
    (256, 256, dict(causal=True, window=100)),
    (192, 320, dict(causal=True, q_offset=128, window=70)),
    (320, 320, dict(causal=True, window=64)),
    (128, 384, dict(causal=True, q_offset=256, window=1)),
    (512, 512, dict(causal=True, q_offset=64, window=200)),
]


@pytest.mark.parametrize("d_head", [128, 256])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("seq_q,seq_kv,kw", WALK_CASES)
def test_dkv_walk_visits_exactly_the_visible_tiles(fused, seq_q, seq_kv, kw, d_head):
    """For each CTA of the dK/dV launch, the Q tiles of its walk are those
    holding a (Q row, key) pair that ``flash_backward_plain``'s mask keeps
    (``_visible``), among the CTA's keys below seq_kv (at d 256 a CTA owns
    64 keys)."""
    cfg = KernelConfig(**kw)
    dkv = fb.plan(fused, 1, 1, 1, seq_q, seq_kv, d_head)[0]
    mask = (fb._visible(seq_q, seq_kv, cfg, "cpu") if cfg.causal
            else torch.ones(seq_q, seq_kv, dtype=torch.bool))
    for tile in range(dkv.kv_tiles):
        kv0 = tile * dkv.keys
        kv_end = min(kv0 + dkv.keys, seq_kv)
        want = [t for t in range(seq_q // dkv.rows)
                if bool(mask[t * dkv.rows:(t + 1) * dkv.rows, kv0:kv_end].any())]
        got = list(fb.dkv_q_tiles(cfg, kv0, kv_end, dkv.rows, seq_q))
        assert got == want, (tile, got, want)
