"""The port's bench tools: numerics on the CPU, and no silent CPU timing.

``tools/bench_quant.py``'s numerics check runs the plain version of K10 on
the CPU and must pass the adaptive 2x rule for every variant (the same rule
the tool applies on the card). The timing paths measure the card only:
without one they raise. Every tool's ``--help`` exits 0, and the JAX
tool's options that drive the TPU alone exit with a pointer to ROADMAP.
"""

import pytest
import torch

from flash_attention_from_scratch_tpu_torch import dispatch
from flash_attention_from_scratch_tpu_torch.tools import bench_attention, bench_quant


def test_numerics_check_on_the_cpu():
    rows = bench_quant.numerics_check(device="cpu", seq=256, heads=2)
    assert [r["variant"] for r in rows] == list(bench_quant.VARIANTS)
    for r in rows:
        assert r["adaptive_ok"], r
        # The kernel's error is inside the quantization noise it reports.
        assert r["kernel_err"] <= max(2 * r["bf16_baseline_err"], 1e-6), r


def test_tool_inputs_on_the_cpu():
    """The inputs each tool times: its batch for the length, K/V heads, and
    the variants' quantized kinds."""
    q, k, v = bench_quant.bench_inputs(256, heads=2, device="cpu")
    assert q.shape == k.shape == (4, 2, 256, 128) and q.dtype == torch.bfloat16
    q, k, v = bench_attention.bench_inputs(512, heads=4, kv_heads=2, device="cpu")
    assert q.shape == (16, 4, 512, 128) and k.shape == v.shape == (16, 2, 512, 128)
    assert set(bench_quant.VARIANTS) < set(bench_quant.CHECK_VARIANTS)
    for name, (kv_mode, q_kind, _) in bench_quant.CHECK_VARIANTS.items():
        qq, kq, vq = bench_quant.quantize_inputs(q, k, v, name)
        assert kq.mode == vq.mode == kv_mode, name
        assert (qq is q) if q_kind == "bf16" else qq.mode == q_kind, name


@pytest.mark.parametrize("tool", [bench_quant, bench_attention],
                         ids=["bench_quant", "bench_attention"])
def test_help_exits_zero(tool, capsys):
    with pytest.raises(SystemExit) as exc:
        tool.main(["--help"])
    assert exc.value.code == 0
    assert "usage" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--kernels", "prog"], ["--host-timing"], ["--grad"]])
def test_bench_attention_tpu_options_point_to_roadmap(flag):
    with pytest.raises(SystemExit, match="ROADMAP"):
        bench_attention.main(flag)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_timing_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError):
        bench_quant.bench_quant([256], heads=2)
    with pytest.raises(RuntimeError):
        bench_attention.bench([256], heads=2, fori=True)
    with pytest.raises(RuntimeError):
        dispatch.median_runtime(lambda: None)
    with pytest.raises(RuntimeError):
        bench_quant.main(["--seq-lens", "256"])
    with pytest.raises(RuntimeError):
        bench_attention.main(["--fori"])
