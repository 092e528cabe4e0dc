"""The port's kernel tools against the JAX tools, on the CPU.

``bench_ladder``'s rungs build the JAX tool's configs (by short form) at
every default length, and name the kernel each runs; ``bench_backward``'s
variant table, band counts and forward configs are the JAX tool's (read by
running the JAX ``bench_backward`` with its kernels and timer stubbed);
``bench_train``'s FLOP model and model config equal the JAX tool's;
``KernelConfig.for_shape`` equals JAX's. ``autotune``'s guard flags an
impossible time and its CSV rows round-trip through ``parse_short_form``;
``sanity_check`` and ``debug_steps`` run with ``--device cpu`` (the plain
versions), ``sanity_check`` failing on a planted error and returning 2
when no config matches; ``profile_trace``'s summary reads a synthetic
Chrome trace. Every timing path raises without a card, and no tool's
default output names an existing file of the repository.
"""

import argparse
import csv
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops import flash_backward as jax_fb
from flash_attention_from_scratch_tpu.ops.configs import KernelConfig as JaxKernelConfig
from flash_attention_from_scratch_tpu.tools import bench_backward as jax_bench_backward
from flash_attention_from_scratch_tpu.tools import bench_ladder as jax_bench_ladder
from flash_attention_from_scratch_tpu.tools import bench_train as jax_bench_train
from flash_attention_from_scratch_tpu_torch.ops.configs import (
    KernelConfig, get_kernel_configs, parse_short_form,
)
from flash_attention_from_scratch_tpu_torch.tools import (
    autotune, bench_attention, bench_backward, bench_ladder, bench_sweep, bench_train,
    debug_steps, profile_trace, quant_trace, sanity_check,
)
from flash_attention_from_scratch_tpu_torch.utils import testing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_TOOLS = (bench_ladder, bench_sweep, bench_backward, bench_train, autotune, sanity_check,
             debug_steps, profile_trace, quant_trace)


def _short(build, *args):
    try:
        return build(*args).short_form()
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("seq", bench_ladder.DEFAULT_SEQ_LENS)
def test_ladder_rungs_are_jax(seq):
    """Each rung's label and config at (seq, 16 heads, the table's batch)
    equal the JAX tool's; rungs 01 and 06 run K11 at depths 1 and 2, the
    rest K1, three launches a seq."""
    assert [r[0] for r in bench_ladder.RUNGS] == [r[0] for r in jax_bench_ladder.RUNGS]
    batch = testing.BATCH_SIZE_FOR_SEQ_LEN[seq]
    for (label, build), (_, jax_build) in zip(bench_ladder.RUNGS, jax_bench_ladder.RUNGS):
        assert _short(build, seq, 16, batch) == _short(jax_build, seq, 16, batch), label
    cfgs = [build(seq, 16, batch) for _, build in bench_ladder.RUNGS]
    kernels = [bench_attention.kernel_of(c) for c in cfgs]
    assert kernels == ["flash_forward_fori_nb1"] + ["flash_forward"] * 4 + [
        "flash_forward_fori_nb2"] + ["flash_forward"] * 6
    assert len({bench_attention.launch_key(c) for c in cfgs}) == 3
    assert bench_ladder._sp_for(seq) == jax_bench_ladder._sp_for(seq)
    assert bench_ladder._hp_for(seq) == jax_bench_ladder._hp_for(seq)


@pytest.mark.parametrize("heads,kv_heads,batch", [(16, 16, None), (32, 8, 2), (16, 16, 16),
                                                  (1, 1, 1)])
def test_for_shape_is_jax(heads, kv_heads, batch):
    for seq in (128, 512, 1024, 1536, 2048, 4096, 8192, 16384, 32768):
        for kw in ({}, {"causal": True}):
            want = JaxKernelConfig.for_shape(seq, seq, heads=heads, kv_heads=kv_heads,
                                             batch=batch, **kw).short_form()
            assert KernelConfig.for_shape(seq, seq, heads=heads, kv_heads=kv_heads,
                                          batch=batch, **kw).short_form() == want


def _jax_backward_table(monkeypatch, seq, heads, kv_heads, causal):
    """What the JAX ``bench_backward`` runs at ``seq``: [(label, what)]
    with what the TPU tiles of a bound K2/K3 call or the banded call's
    band count, and the short forms of its forward configs (for_shape's,
    then the timed forward's), its kernels and timer stubbed."""
    calls, forwards = [], []
    small = jnp.zeros((1, 1, 8, 128), jnp.bfloat16)
    monkeypatch.setattr(jax_bench_backward, "generate_qkv",
                        lambda *a, **kw: (small, small, small))
    monkeypatch.setattr(jax_bench_backward, "measured_matmul_tflops", lambda: 1.0)
    monkeypatch.setattr(jax_bench_backward, "chain_runtime",
                        lambda step, *args, **kw: (step(*args), 1.0)[1])

    def forward(q, k, v, cfg):
        forwards.append(cfg.short_form())
        return small, jnp.zeros((1, 1, 8), jnp.float32)

    monkeypatch.setattr(jax_bench_backward, "flash_forward_with_lse", forward)

    def fused(*a, block_q, block_kv, splits):
        calls.append(("fused", (block_q, block_kv, splits)))
        return lambda q, k, v, *rest: (q, k, v)

    def split(*a, block_q, block_kv, splits):
        calls.append(("split", (block_q, block_kv, splits)))
        return (lambda q, *rest: q), (lambda q, k, v, *rest: (k, v))

    def banded(q, k, v, o, lse, do, cfg, interpret, bands):
        calls.append(("banded", bands))
        return q, k, v

    monkeypatch.setattr(jax_fb, "make_flash_backward_fused", fused)
    monkeypatch.setattr(jax_fb, "make_flash_backward", split)
    monkeypatch.setattr(jax_fb, "flash_backward", banded)
    rows = jax_bench_backward.bench_backward([seq], heads=heads, kv_heads=kv_heads,
                                             causal=causal, log=lambda *a: None)
    # A banded step runs once a row; a bound call is made once a row.
    return [(r["variant"], c) for r, c in zip(rows, calls)], forwards


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seq,heads,kv_heads", [(2048, 16, 16), (4096, 32, 8), (8192, 16, 16)])
def test_backward_table_is_jax(monkeypatch, causal, seq, heads, kv_heads):
    """The variants run at ``seq`` (labels, kernels, the TPU tiles of
    the K2/K3 rows, the banded rows' band counts) and the forward the rows
    time equal the JAX tool's."""
    want, forwards = _jax_backward_table(monkeypatch, seq, heads, kv_heads, causal)
    got = []
    for label, fused, bq, bkv, extra in bench_backward.variants(causal):
        if fused == "banded":
            bands = bench_backward.band_count(seq, extra)
            if bands is not None:
                got.append((label, ("banded", bands)))
        else:
            got.append((label, ("fused" if fused else "split",
                                (min(bq, seq), min(bkv, seq), extra))))
    assert got == want
    cfg = KernelConfig.for_shape(seq, seq, heads=heads, kv_heads=kv_heads, causal=causal)
    assert cfg.short_form() == forwards[0]
    fwd = bench_backward.forward_config(cfg, seq, heads, kv_heads, causal)
    assert {fwd.short_form()} == set(forwards[1:])
    assert fwd.decompose == (causal and seq >= 2048)


class _Stop(Exception):
    pass


ARGVS = {
    "defaults": [],
    "llama3-8b": ["--dim", "4096", "--layers", "8", "--heads", "32", "--kv-heads", "8",
                  "--hidden", "14336", "--vocab", "128256", "--seq", "2048", "--batch", "2"],
    "narrow-heads": ["--dim", "1024", "--heads", "16", "--kv-heads", "4", "--layers", "3",
                     "--hidden", "2816", "--seq", "4096", "--batch", "1"],
}
FIELDS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "d_head", "hidden_dim")


@pytest.mark.parametrize("name", list(ARGVS))
def test_bench_train_config_and_flops_are_jax(monkeypatch, name):
    """The JAX tool's ``main`` builds its model config from the same
    arguments (stopped before its weights): the port's has the same fields
    (the ``d_head`` rule too) and the same FLOPs a step."""
    made = []

    def config(**kw):
        made.append(jax_llama.LlamaConfig(**kw))
        return made[-1]

    def stop(*a, **kw):
        raise _Stop

    no_cache = type("Config", (), {"update": staticmethod(lambda *a: None)})
    monkeypatch.setattr(jax_bench_train, "jax",
                        type("Jax", (), {"config": no_cache, "random": jax.random}))
    monkeypatch.setattr(jax_bench_train, "LlamaConfig", config)
    monkeypatch.setattr(jax_bench_train, "init_params", stop)
    with pytest.raises(_Stop):
        jax_bench_train.main(ARGVS[name])
    args = bench_train.parser().parse_args(ARGVS[name])
    cfg = bench_train.config_from_args(args)
    assert {f: getattr(cfg, f) for f in FIELDS} == {f: getattr(made[0], f) for f in FIELDS}
    for batch, seq in ((args.batch, args.seq), (3, 1024)):
        assert bench_train.train_flops(cfg, batch, seq) == jax_bench_train.train_flops(
            made[0], batch, seq)


def test_autotune_guard_flags_an_impossible_time():
    """A time above the ceiling is measured again, the slower kept; still
    above, it is a timing artifact; below, it passes."""
    times = iter([1e-9, 2e-9])
    secs, error = autotune.guarded_seconds(lambda: next(times), 1e12, 100.0)
    assert secs == 2e-9 and error.startswith("timing artifact")
    times = iter([1e-9, 1.0])
    assert autotune.guarded_seconds(lambda: next(times), 1e12, 100.0) == (1.0, "")
    assert autotune.guarded_seconds(lambda: 1.0, 1e12, 100.0) == (1.0, "")


def _cpu_tools(monkeypatch, module, secs):
    """``module``'s card queries stubbed: the CPU, a stubbed timer of
    ``secs`` a call and a matmul rate of 1 TFLOP/s."""
    monkeypatch.setattr(module, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(module, "device_kind", lambda: "cpu")
    monkeypatch.setattr(module, "measured_matmul_tflops", lambda: 1.0)
    monkeypatch.setattr(module, "median_runtime", lambda fn, iters=5: (fn(), secs)[1])
    monkeypatch.setattr(module, "generate_qkv",
                        lambda *a, **kw: testing.generate_qkv(*a, **{**kw, "device": "cpu"}))


@pytest.mark.parametrize("secs,artifact", [(2e-4, False), (1e-9, True)],
                         ids=["plausible", "impossible"])
def test_autotune_rows_round_trip(monkeypatch, tmp_path, capsys, secs, artifact):
    """``main`` on the plain versions with a stubbed timer: a row a config
    that tiles the seq, each naming its kernel, the impossible time a
    timing artifact at 0 TFLOP/s; the CSV's configs parse back to
    themselves."""
    _cpu_tools(monkeypatch, autotune, secs)
    path = tmp_path / "tune.csv"
    assert autotune.main(["--kernels", "prog", "--seq", "512", "--heads", "1", "--batch", "1",
                          "--csv", str(path), "--json"]) == 0
    with open(path) as f:
        rows = list(csv.DictReader(f))
    want = [c.short_form() for c in get_kernel_configs("prog")
            if 512 % c.block_q == 0 and 512 % c.block_kv == 0]
    assert sorted(r["config"] for r in rows) == sorted(want)
    for r in rows:
        assert parse_short_form(r["config"]).short_form() == r["config"]
        assert r["kernel"] == bench_attention.kernel_of(parse_short_form(r["config"]))
        assert r["error"].startswith("timing artifact") == artifact
        assert (float(r["tflops"]) == 0.0) == artifact
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(printed) == len(rows)


def test_sanity_check_on_the_cpu(monkeypatch, capsys):
    """``--small --device cpu`` passes; a planted error in ``flash_forward``
    fails it; no config of the dtype returns 2."""
    assert sanity_check.main(["--small", "--device", "cpu"]) == 0
    assert "6 of 6 configs passed" in capsys.readouterr().out
    assert sanity_check.main(["--small", "--device", "cpu", "--dtype", "f32"]) == 2
    real = sanity_check.flash_forward
    monkeypatch.setattr(sanity_check, "flash_forward",
                        lambda q, k, v, cfg: real(q, k, v, cfg) + 0.25)
    assert sanity_check.main(["--small", "--device", "cpu", "--kernel", "1"]) == 1


@pytest.mark.parametrize("kernel", [0, 4], ids=["fori", "grid-reverse-kv"])
def test_debug_steps_on_the_cpu(capsys, kernel):
    """``--small --device cpu`` returns 0 with one diff-map entry per Q
    block and per KV step, each small (the plain version against the fp32
    mirror)."""
    assert debug_steps.main(["--small", "--device", "cpu", "--kernel", str(kernel),
                             "--trace"]) == 0
    out = capsys.readouterr().out
    result = json.loads(out.splitlines()[-1])
    cfg = get_kernel_configs("prog")[kernel]
    assert result["config"] == cfg.short_form()
    assert len(result["per_q_block_max_diff"]) == 512 // cfg.block_q
    assert len(result["per_kv_step_max_diff"]) == 512 // cfg.block_kv
    assert max(result["per_q_block_max_diff"] + result["per_kv_step_max_diff"]) < 0.02
    assert out.count("-- q_block") == (512 // cfg.block_q) * (512 // cfg.block_kv)


def _event(name, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": 0, "dur": dur, "pid": 0, "tid": 7}


def test_profile_trace_summary_reads_a_chrome_trace(tmp_path):
    """Device time and count by kernel name from the trace's kernel events
    (the CPU's operators and the runtime's calls left out), the top 10 by
    time; a trace without the launched kernel is reported, not zero."""
    events = [_event("void flash_forward_kernel<128>(Params)", 120.5) for _ in range(5)]
    events += [_event("elementwise_kernel", 2.0), _event("aten::empty", 50.0, "cpu_op"),
               _event("cudaLaunchKernel", 9.0, "cuda_runtime")]
    events += [_event(f"k{i}", 1.0 / (i + 1)) for i in range(12)]
    (tmp_path / "run").mkdir()
    with open(tmp_path / "run" / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    summary = profile_trace.summarize_trace(str(tmp_path))
    totals = summary["device_event_totals_ns"]
    assert totals[0] == {"name": "void flash_forward_kernel<128>(Params)",
                         "total_ns": 602500, "count": 5}
    assert totals[1] == {"name": "elementwise_kernel", "total_ns": 2000, "count": 1}
    assert len(totals) == 10 and "aten::empty" not in {t["name"] for t in totals}
    assert profile_trace._traced(summary, "flash_forward") == (True, "")
    ok, why = profile_trace._traced(summary, "flash_forward_fori")
    assert not ok and "flash_forward_fori_kernel" in why
    assert profile_trace.summarize_trace(str(tmp_path / "none")) == {"trace": None}


TIMING_ARGS = {bench_ladder: ["--seq-lens", "512"], bench_sweep: ["--seq-lens", "512"],
               bench_backward: ["--seq-lens", "2048"], bench_train: ["--layers", "1"],
               autotune: ["--seq", "512"], sanity_check: ["--small"],
               debug_steps: ["--small"], profile_trace: ["--seq", "512"],
               quant_trace: ["--seq", "512"]}


@pytest.mark.parametrize("tool", NEW_TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_new_tools_need_a_card(monkeypatch, tool):
    """Without a card each tool's main raises the missing-card error before
    it times or writes anything (``sanity_check`` and ``debug_steps`` run
    on the CPU only when asked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(TIMING_ARGS[tool])


def test_timing_functions_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bench_ladder.bench_ladder([512], heads=1),
                 lambda: bench_sweep.sweep([512], heads=1),
                 lambda: bench_backward.bench_backward([2048], heads=1),
                 lambda: autotune.tune(get_kernel_configs("prog")[:1], 512, 1, 1),
                 lambda: quant_trace.ablation(512)):
        with pytest.raises(RuntimeError):
            call()


@pytest.mark.parametrize("tool", NEW_TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_default_outputs_name_no_file_of_the_repo(monkeypatch, tool):
    """Every path-like default of a tool's options is unset or a directory
    the repository ignores (the JAX tools' defaults are the TPU's records
    under ``profiles/``)."""
    seen = []

    def parse(self, argv=None, namespace=None):
        seen.append(self)
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Stop):
        tool.main([])
    with open(os.path.join(ROOT, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    for action in seen[0]._actions:
        default = action.default
        if isinstance(default, str) and ("/" in default or "." in default):
            assert not os.path.isfile(os.path.join(ROOT, default)), (action.dest, default)
            assert default.rstrip("/") in ignored, (action.dest, default)
