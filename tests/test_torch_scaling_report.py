"""The port's ``tools/scaling_report.py`` (2 gloo ranks on the CPU) vs the
JAX package's, and the port's ``entry.dryrun_multichip`` (4 gloo ranks).

At ``tests/test_scaling_report.py``'s config (W8A8 weights, int8 KV, tp 1
and 2): each row's ``param_bytes_per_dev`` and ``kv_bytes_per_dev`` equal
JAX ``tp_decode_report``'s exactly (rank 0's placed shards, as JAX counts
device 0's); the collectives a step issues equal the port's stated plan (2
all-reduces a layer and 2 all-gathers at tp 2, none at tp 1; JAX reads its
own from the compiled HLO, where XLA merges the embedding's gather); JAX's
own asserts hold on the port's rows. The dry run runs every part and prints
JAX's lines.
"""

import re

import jax
import pytest

from flash_attention_from_scratch_tpu.models.llama import LlamaConfig as JaxConfig
from flash_attention_from_scratch_tpu.tools.scaling_report import tp_decode_report as jax_report
from flash_attention_from_scratch_tpu_torch.entry import dryrun_multichip
from flash_attention_from_scratch_tpu_torch.models.llama import LlamaConfig
from flash_attention_from_scratch_tpu_torch.tools.scaling_report import (
    collective_plan, tp_decode_report)

SHAPE = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, d_head=128,
             hidden_dim=512)
KW = dict(batch=4, context=128, weights="int8", kv="int8", single_chip_ms=10.0,
          hbm_gbps_val=819.0)


@pytest.fixture(scope="module")
def rows(cpu_mesh_devices):
    want = jax_report(JaxConfig(**SHAPE, block_q=128, block_kv=128), (1, 2), **KW)
    got = tp_decode_report(LlamaConfig(**SHAPE), (1, 2), device="cpu", backend="gloo",
                           timeout=300, **KW)
    return got, want


@pytest.mark.parametrize("i", [0, 1], ids=["tp1", "tp2"])
def test_rank_bytes_equal_jax(rows, i):
    got, want = rows
    for key in ("tp", "param_bytes_per_dev", "kv_bytes_per_dev", "step_bytes_per_dev",
                "byte_ratio_vs_tp1"):
        assert got[i][key] == want[i][key], key
    assert set(want[i]) <= set(got[i])  # JAX's row keys, and the port's own


@pytest.mark.parametrize("i", [0, 1], ids=["tp1", "tp2"])
def test_collectives_equal_the_plan(rows, i):
    got, want = rows
    assert got[i]["collectives"] == collective_plan(LlamaConfig(**SHAPE), got[i]["tp"])
    assert set(got[i]["collectives"]) == set(want[i]["collectives"])
    assert got[i]["executed"] and got[i]["staged_bytes"] == 0


def test_jax_asserts_hold_on_the_port_rows(rows):
    r1, r2 = rows[0]
    assert r1["executed"] and r2["executed"]
    assert 0.45 < r2["byte_ratio_vs_tp1"] < 0.56, r2
    assert r2["collectives"]["all-reduce"] > 0, r2["collectives"]
    assert sum(r1["collectives"].values()) == 0, r1["collectives"]
    assert r2["projected_scaling_vs_tp1"] > 1.3, r2


def test_dryrun_multichip_runs_every_part(capsys):
    lines = dryrun_multichip(4, device="cpu", backend="gloo", timeout=300)
    assert capsys.readouterr().out.splitlines() == lines
    patterns = [r"mesh=\(1,4\) loss=\d+\.\d{4}",
                r"sink\+window train step over \(dp=1,tp=4\) loss=\d+\.\d{4}",
                r"TP prefill \+ paged decode over tp=4 ok",
                r"ring attention over sp=4 ok",
                r"MoE train step over ep=4 \(8 experts\) loss=\d+\.\d{4}",
                r"pipeline train step over pp=4 \(4 microbatches\) loss=\d+\.\d{4}"]
    assert len(lines) == len(patterns)
    for line, pattern in zip(lines, patterns):
        assert re.fullmatch(r"dryrun_multichip\(4\): " + pattern, line), line
