"""K6/K7's launch plan (``ops/quant_matmul.py::plan``), a pure function.

At every Llama-3-8B weight shape and at the ragged shapes of the ``cuda``
tests: the split of the K walk covers every stored-row tile exactly once
with no empty split, the token tile, the warpgroups per CTA and the design
follow m, the CTA geometry the plan counts with is the kernel's own (read
from its source, which sizes the ring from it), and on the H100's 132 SMs
every SM gets work; where the output tiles alone are fewer than the CTAs
the SMs hold at once (decode), the split fills them in one whole wave.
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


@pytest.mark.parametrize("w4", [False, True], ids=["K6", "K7"])
@pytest.mark.parametrize("k,n", LLAMA_SHAPES + RAGGED_SHAPES)
def test_plan_covers_every_k_tile_once(k, n, w4):
    for m in ROWS:
        p = qm.plan(m, n, k, w4, SMS)
        assert p.k_tiles == math.ceil((k // 2 if w4 else k) / qm.WONLY_ROWS)
        ranges = [range(z * p.per, min(p.k_tiles, (z + 1) * p.per)) for z in range(p.splits)]
        assert all(len(r) > 0 for r in ranges), (m, p)
        assert [t for r in ranges for t in r] == list(range(p.k_tiles)), (m, p)
        assert 1 <= p.splits <= qm.MAX_SPLITS
        tiles = math.ceil(m / p.bt) * math.ceil(n / p.cols)
        assert p.ctas == tiles * p.splits


@pytest.mark.parametrize("w4", [False, True], ids=["K6", "K7"])
@pytest.mark.parametrize("m", [16, 1024], ids=["decode", "prefill"])
@pytest.mark.parametrize("k,n", LLAMA_SHAPES)
def test_plan_fills_the_sms_in_whole_waves(k, n, m, w4):
    p = qm.plan(m, n, k, w4, SMS)
    slots, tiles = p.per_sm * SMS, p.ctas // p.splits
    assert p.ctas >= 0.9 * SMS, p  # every SM but a few has a CTA
    if tiles < slots:  # split into one wave that the SMs hold at once
        assert p.ctas <= slots, p
        assert p.splits == min(p.k_tiles, qm.MAX_SPLITS) or 2 * p.ctas > slots, p
    else:
        assert p.splits == 1, p


@pytest.mark.parametrize("m", ROWS)
def test_plan_picks_the_design_by_m(m):
    for w4 in (False, True):
        p = qm.plan(m, 4096, 4096, w4, SMS)
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
    an SM of NWG warpgroups of WBN columns, walking K in tiles of WROWS
    stored rows; the plan counts CTAs and K tiles with the same numbers."""
    src = SOURCE.read_text()
    assert f"case {bt}: return launch_wonly<W4, {bt}>" in src
    two_groups = bt >= _source_int(src, r"NWG = BT >= (\d+) \? 2 : 1;")
    per_sm = _source_int(src, r"PER_SM = NWG == 2 \? (\d+) : 2;" if two_groups
                         else r"PER_SM = NWG == 2 \? 1 : (\d+);")
    cols = (2 if two_groups else 1) * _source_int(src, r"constexpr int WBN = (\d+);")
    rows = _source_int(src, r"constexpr int WROWS = (\d+);")
    for w4 in (False, True):
        p = qm.plan(bt, 4096, 4096, w4, SMS)
        assert (p.bt, p.cols, p.per_sm) == (bt, cols, per_sm)
        assert p.k_tiles == (2048 if w4 else 4096) // rows


def test_plan_at_decode_streams_from_more_ctas_than_prefill():
    """The same weight at m 16 is split at least as finely as at m 1024,
    where the token tiles alone give the CTAs."""
    for k, n in LLAMA_SHAPES:
        for w4 in (False, True):
            assert qm.plan(16, n, k, w4).splits >= qm.plan(1024, n, k, w4).splits
