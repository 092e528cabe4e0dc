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

SOURCE = (pathlib.Path(fb.__file__).parent.parent / "csrc" / fb.SOURCE).read_text()
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
    assert _tile("FUSED_TILE") == (*fb.FUSED_TILE, "true")
    assert _tile("DKV_TILE") == (*fb.DKV_TILE, "false")
    assert _int(r"static constexpr int BK = (\d+);") == fb.DQ_KEYS
    assert re.search(r"static constexpr int BQ = WG_ROWS;", SOURCE)
    assert ff.WG_ROWS == fb.DKV_Q_ROWS == 64  # wgmma's M: K2's dQ product takes Q rows as M
    assert _tile("DQ_SLOTS") == (fb.DQ_SLOTS,)
    assert _int(r"constexpr int SM_SMEM = (\d+);") == fb.SM_SMEM
    assert len(re.findall(r"THREADS = NC \* 128;", SOURCE)) == 1
    assert re.search(r"static constexpr int BQ = WG_ROWS;  // Q rows per CTA", SOURCE)
    assert len(re.findall(r"THREADS = 128;", SOURCE)) == 1
    assert re.search(r"DS_BUFS = NC;", SOURCE)
    assert re.search(r"SMEM =\s+2 \* KV_BYTES \+ NS \* \(SLOT \+ STATS\) \+ DS_BUFS \* DS_BYTES "
                     r"\+ STAGE \+ ALIGN_SLACK;", SOURCE)
    assert re.search(r"STAGE = kDQ \? NC \* 4 \* WARP_STAGE : 0;", SOURCE)
    assert _int(r"constexpr int WARP_STAGE = 16 \* 64 \* (\d+);") == 4
    assert re.search(r"SMEM = 2 \* Q_BYTES \+ NS \* SLOT \+ ALIGN_SLACK;", SOURCE)
    assert re.search(r"return nc == 1 && 2 \* \(smem \+ 1024\) <= SM_SMEM \? 2 : 1;", SOURCE)
    assert re.search(r"PER_SM = per_sm\(NC, SMEM\);", SOURCE)
    assert re.search(r"PER_SM = per_sm\(1, SMEM\);", SOURCE)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_plan_mirrors_the_kernels(fused):
    """Shared memory, threads and rows of each launch, from the sources'
    tile structs: K and V tiles of 64 KV rows a consumer warpgroup, ring
    slots of Q and dO with their LSE and D rows, K2's two dS^T buffers;
    the dQ kernel's Q and dO tiles and 64-key K/V slots."""
    launches = fb.plan(fused, 2, 32, 8, 2048, 2048)
    assert len(launches) == (1 if fused else 2)
    nc, slots = fb.FUSED_TILE if fused else fb.DKV_TILE
    bq = fb.DKV_Q_ROWS
    dkv = launches[0]
    assert (dkv.rows, dkv.keys, dkv.slots, dkv.threads) == (bq, nc * 64, slots, nc * 128)
    ds = nc * (nc * 64 * bq * 2 + 4 * 16 * 64 * 4) if fused else 0
    assert dkv.smem == (2 * nc * 64 * 256 + slots * (2 * bq * 256 + 2 * bq * 4) + ds
                        + ff.ALIGN_SLACK)
    if not fused:
        dq = launches[1]
        assert (dq.rows, dq.keys, dq.slots, dq.threads) == (64, 128, fb.DQ_SLOTS, 128)
        assert dq.smem == 2 * 64 * 256 + fb.DQ_SLOTS * 2 * 128 * 256 + ff.ALIGN_SLACK
    for launch in launches:
        assert launch.smem + STATIC_BARRIERS <= ff.SMEM_LIMIT, launch
        # One warpgroup a CTA: two CTAs an SM, each with its shared memory.
        assert fb.per_sm(launch.threads // 128, launch.smem) == (2 if launch.threads == 128 else 1)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_grids_cover_every_seq(fused):
    """Every KV row and (split) every Q row has a CTA, and none is empty;
    the dK/dV grid's slowest axis is the KV tile (heaviest causal first)."""
    for seq_q in range(64, 4096 + 1, 64):
        seq_kv = seq_q + 64 * (seq_q // 64 % 3)  # ragged against 128-row tiles too
        launches = fb.plan(fused, 3, 16, 4, seq_q, seq_kv)
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


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
@pytest.mark.parametrize("seq_q,seq_kv,kw", WALK_CASES)
def test_dkv_walk_visits_exactly_the_visible_tiles(fused, seq_q, seq_kv, kw):
    """For each CTA of the dK/dV launch, the Q tiles of its walk are those
    holding a (Q row, key) pair that ``flash_backward_plain``'s mask keeps
    (``_visible``), among the CTA's keys below seq_kv."""
    cfg = KernelConfig(**kw)
    dkv = fb.plan(fused, 1, 1, 1, seq_q, seq_kv)[0]
    mask = (fb._visible(seq_q, seq_kv, cfg, "cpu") if cfg.causal
            else torch.ones(seq_q, seq_kv, dtype=torch.bool))
    for tile in range(dkv.kv_tiles):
        kv0 = tile * dkv.keys
        kv_end = min(kv0 + dkv.keys, seq_kv)
        want = [t for t in range(seq_q // dkv.rows)
                if bool(mask[t * dkv.rows:(t + 1) * dkv.rows, kv0:kv_end].any())]
        got = list(fb.dkv_q_tiles(cfg, kv0, kv_end, dkv.rows, seq_q))
        assert got == want, (tile, got, want)
