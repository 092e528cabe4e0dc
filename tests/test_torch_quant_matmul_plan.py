"""K6-K9's launch plan (``ops/quant_matmul.py::plan``), a pure function.

At every Llama-3-8B weight shape and at the ragged shapes of the ``cuda``
tests, for the weight-only kernels (K6, K7) and the int8-activation ones
(K8, K9, ``a8``): the split of the K walk covers every stored-row tile
exactly once with no empty split, the token tile, the warpgroups per CTA and
the design follow m, the CTA geometry and K tile depth the plan counts with
are the kernel's own (read from its source, which sizes the ring from
them), and on the H100's 132 SMs every SM gets work; where the output tiles
alone are fewer than the CTAs the SMs hold at once (decode), the split fills
them in one whole wave.
"""

import math
import pathlib
import re

import pytest

from flash_attention_from_scratch_tpu_torch.ops import quant_matmul as qm

SMS = 132
LLAMA_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
RAGGED_SHAPES = [(512, 320), (544, 336)]  # (K, N): no 64-row or 128-column multiple
ROWS = [1, 16, 17, 32, 64, 100, 1000, 1024]
SOURCE = pathlib.Path(qm.__file__).parent.parent / "csrc" / qm.SOURCE
RECIPES = [(False, False), (True, False), (False, True), (True, True)]  # (w4, a8)
RECIPE_IDS = ["K6", "K7", "K8", "K9"]


@pytest.mark.parametrize("w4,a8", RECIPES, ids=RECIPE_IDS)
@pytest.mark.parametrize("k,n", LLAMA_SHAPES + RAGGED_SHAPES)
def test_plan_covers_every_k_tile_once(k, n, w4, a8):
    for m in ROWS:
        p = qm.plan(m, n, k, w4, SMS, a8)
        assert p.k_tiles == math.ceil((k // 2 if w4 else k) / qm.STAGE_ROWS[a8])
        ranges = [range(z * p.per, min(p.k_tiles, (z + 1) * p.per)) for z in range(p.splits)]
        assert all(len(r) > 0 for r in ranges), (m, p)
        assert [t for r in ranges for t in r] == list(range(p.k_tiles)), (m, p)
        assert 1 <= p.splits <= qm.MAX_SPLITS
        tiles = math.ceil(m / p.bt) * math.ceil(n / p.cols)
        assert p.ctas == tiles * p.splits


@pytest.mark.parametrize("w4,a8", RECIPES, ids=RECIPE_IDS)
@pytest.mark.parametrize("m", [16, 1024], ids=["decode", "prefill"])
@pytest.mark.parametrize("k,n", LLAMA_SHAPES)
def test_plan_fills_the_sms_in_whole_waves(k, n, m, w4, a8):
    p = qm.plan(m, n, k, w4, SMS, a8)
    slots, tiles = p.per_sm * SMS, p.ctas // p.splits
    assert p.ctas >= 0.9 * SMS, p  # every SM but a few has a CTA
    if tiles < slots:  # split into one wave that the SMs hold at once
        assert p.ctas <= slots, p
        assert p.splits == min(p.k_tiles, qm.MAX_SPLITS) or 2 * p.ctas > slots, p
    else:
        assert p.splits == 1, p


@pytest.mark.parametrize("m", ROWS)
def test_plan_picks_the_design_by_m(m):
    for w4, a8 in RECIPES:
        p = qm.plan(m, 4096, 4096, w4, SMS, a8)
        assert p.bt in qm.TOKEN_TILES
        assert p.bt >= min(m, 128) and (p.bt == 16 or p.bt // 2 < m)
        assert p.design == ("decode" if m <= 32 else "prefill")
        assert (p.cols, p.per_sm) == ((256, 1) if p.bt == 128 else (128, 2))


def _source_int(src, pattern):
    found = re.findall(pattern, src)
    assert len(found) == 1, pattern
    return int(found[0])


@pytest.mark.parametrize("bt", qm.TOKEN_TILES)
def test_plan_mirrors_the_kernels_tile_geometry(bt):
    """The kernel (``WTile`` in its source) sizes its ring for PER_SM CTAs
    an SM of NWG warpgroups of WBN columns, walking K in stages of ROWS
    stored rows (the K values of an x box row of XROW bytes: XROW / 2 bf16,
    XROW int8), each whole weight boxes of WROWS rows; the plan counts CTAs
    and K tiles with the same numbers."""
    src = SOURCE.read_text()
    assert f"case {bt}: return launch<W4, A8, {bt}, EDGE>" in src
    two_groups = bt >= _source_int(src, r"NWG = BT >= (\d+) \? 2 : 1;")
    per_sm = _source_int(src, r"PER_SM = NWG == 2 \? (\d+) : 2;" if two_groups
                         else r"PER_SM = NWG == 2 \? 1 : (\d+);")
    cols = (2 if two_groups else 1) * _source_int(src, r"constexpr int WBN = (\d+);")
    assert qm.TILE_COLS == _source_int(src, r"constexpr int WBN = (\d+);")
    xrow = _source_int(src, r"constexpr int XROW = (\d+);")
    assert "ROWS = A8 ? XROW : XROW / 2;" in src
    box_rows = _source_int(src, r"constexpr int WROWS = (\d+);")
    for w4, a8 in RECIPES:
        rows = xrow if a8 else xrow // 2
        assert qm.STAGE_ROWS[a8] == rows and rows % box_rows == 0
        p = qm.plan(bt, 4096, 4096, w4, SMS, a8)
        assert (p.bt, p.cols, p.per_sm) == (bt, cols, per_sm)
        assert p.k_tiles == (2048 if w4 else 4096) // rows


def test_plan_at_decode_streams_from_more_ctas_than_prefill():
    """The same weight at m 16 is split at least as finely as at m 1024,
    where the token tiles alone give the CTAs."""
    for k, n in LLAMA_SHAPES:
        for w4, a8 in RECIPES:
            assert qm.plan(16, n, k, w4, a8=a8).splits >= qm.plan(1024, n, k, w4, a8=a8).splits


@pytest.mark.parametrize("w4", [False, True], ids=["K8", "K9"])
def test_a8_plan_walks_half_the_k_tiles_of_the_weight_only_plan(w4):
    """K8/K9 stage 128 stored rows where K6/K7 stage 64: the same weight has
    half as many K tiles (rounded up), with the same token tile and CTA
    geometry."""
    for k, n in LLAMA_SHAPES + RAGGED_SHAPES:
        for m in ROWS:
            wonly, a8 = qm.plan(m, n, k, w4, SMS), qm.plan(m, n, k, w4, SMS, True)
            assert a8.k_tiles == math.ceil(wonly.k_tiles / 2)
            assert (a8.bt, a8.cols, a8.per_sm) == (wonly.bt, wonly.cols, wonly.per_sm)
