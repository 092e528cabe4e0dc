"""The port's bench tools: numerics on the CPU, and no silent CPU timing.

``tools/bench_quant.py``'s numerics check runs the plain version of K10 on
the CPU and must pass the adaptive 2x rule for every variant (the same rule
the tool applies on the card). The timing paths measure the card only:
without one they raise. Every tool's ``--help`` exits 0 (the kernel tools'
and the port's ``bench`` too: their other tests are in
tests/test_torch_kernel_tools.py and tests/test_torch_port_tools.py).
``bench_attention`` resolves ``--kernels``, ``--dtype``, ``--causal``,
``--window`` and ``--fori`` to the configs the JAX tool's ``main`` builds
from the same arguments, times ``--grad`` on JAX's FLOP model, and counts
the bytes of the tiles the launched kernel copies.
The serving tools: ``bench_decode``'s parameter counts equal the JAX
tool's on the same parameters, and ``bench_serving``'s run function drains
a tiny CPU run and prints every key of the JAX tool's JSON line.
"""

import ast
import json
import pathlib

import jax
import pytest
import torch

from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops.configs import parse_short_form as jax_parse_short_form
from flash_attention_from_scratch_tpu.tools import bench_attention as jax_bench_attention
from flash_attention_from_scratch_tpu.tools import bench_decode as jax_bench_decode
from flash_attention_from_scratch_tpu_torch import bench as port_bench
from flash_attention_from_scratch_tpu_torch import dispatch
from flash_attention_from_scratch_tpu_torch.models import llama
from flash_attention_from_scratch_tpu_torch.ops import flash_forward as ff
from flash_attention_from_scratch_tpu_torch.ops.configs import (
    KernelConfig, KVLoop, parse_short_form,
)
from flash_attention_from_scratch_tpu_torch.tools import (
    autotune, bench_attention, bench_backward, bench_decode, bench_ladder, bench_quant,
    bench_serving, bench_sweep, bench_train, check_races, debug_steps, mosaic_dump,
    onchip_checklist, profile_trace, quant_trace, sanity_check, tune_bands, tune_short_seq,
)


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


HELP_TOOLS = (bench_quant, bench_attention, autotune, bench_backward, bench_ladder, bench_sweep,
              bench_train, debug_steps, profile_trace, quant_trace, sanity_check, check_races,
              mosaic_dump, onchip_checklist, tune_bands, tune_short_seq, port_bench)


@pytest.mark.parametrize("tool", HELP_TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_help_exits_zero(tool, capsys):
    with pytest.raises(SystemExit) as exc:
        tool.main(["--help"])
    assert exc.value.code == 0
    assert "usage" in capsys.readouterr().out


D256_FORMS = "fa_bf16_q128_kv128_d256_fori2_ca;fa_bf16_q128_kv128_d256_grid2_ca"


def _jax_main_configs(monkeypatch, argv):
    """The configs the JAX tool's ``main`` hands its ``bench`` for ``argv``
    (its chip queries, timing and compile-cache settings stubbed out)."""
    seen = []
    monkeypatch.setattr(jax_bench_attention, "bench",
                        lambda configs, *a, **kw: seen.extend(configs) or {})
    for name, value in (("chip_sol_tflops", 1.0), ("measured_matmul_tflops", 1.0),
                        ("device_kind", "cpu"), ("_git_commit", "none")):
        monkeypatch.setattr(jax_bench_attention, name, lambda value=value: value)
    no_cache = type("Config", (), {"update": staticmethod(lambda *a: None)})
    monkeypatch.setattr(jax_bench_attention, "jax", type("Jax", (), {"config": no_cache}))
    assert jax_bench_attention.main(argv) == 0
    return [c.short_form() for c in seen]


def _port_main_configs(monkeypatch, argv):
    """The configs the port's ``main`` resolves for ``argv`` (``bench``
    resolves them; its card queries stubbed out)."""
    seen = []

    def bench(seq_lens, **kw):
        seen.extend(bench_attention.resolve_configs(
            kw["kernels"], kw["dtype"], kw["causal"], kw["window"], kw["fori"],
            kw["num_kv_buffers"]))
        return {}

    monkeypatch.setattr(bench_attention, "bench", bench)
    for name, value in (("measured_matmul_tflops", 1.0), ("device_kind", "cpu"),
                        ("_git_commit", "none"), ("resolve_device", None)):
        monkeypatch.setattr(bench_attention, name, lambda *a, value=value: value)
    assert bench_attention.main(argv) == 0
    return [c.short_form() for c in seen]


@pytest.mark.parametrize("argv", [
    ["--kernels", "prog"], ["--kernels", D256_FORMS], ["--causal", "--fori"],
    ["--kernels", "all", "--window", "300"], ["--kernels", "256,512", "--dtype", "f16"]],
    ids=["prog", "d256-short-forms", "causal-fori", "all-window", "blocks-f16"])
def test_bench_attention_resolves_configs_as_jax(monkeypatch, argv):
    """``--kernels`` (with ``--dtype``), patched by ``--causal``,
    ``--window`` and ``--fori``, gives the JAX tool's configs in its order,
    by short form; the configs share few launches (``prog``'s 12 are 3)."""
    want = _jax_main_configs(monkeypatch, argv)
    got = _port_main_configs(monkeypatch, argv)
    assert got == want
    launches = {bench_attention.launch_key(parse_short_form(s)) for s in got}
    if argv == ["--kernels", "prog"]:
        assert len(got) == 12 and {k[0] for k in launches} == {
            "flash_forward", "flash_forward_fori_nb1", "flash_forward_fori_nb2"}
    if argv[-1] == D256_FORMS:
        assert {k[:2] for k in launches} == {("flash_forward_fori_nb2", 256),
                                             ("flash_forward", 256)}
    if "--fori" in argv:
        assert got and all(k[0].startswith("flash_forward_fori") for k in launches)
    if "all" in argv:
        assert len(got) > 100 and len(launches) <= 3


@pytest.mark.parametrize("form", [
    "fa_bf16_q128_kv128_d256_fori2_ca", "fa_bf16_q512_kv1024_d128_grid2_x2+os+cp",
    "fa_bf16_q128_kv128_d128_grid2_x2+cp+ca+wi300"])
def test_bench_attention_grad_flop_model_is_jax(form):
    """``--grad``'s FLOP model is the JAX tool's: its forward model x3.5."""
    cfg, jcfg = parse_short_form(form), jax_parse_short_form(form)
    for seq, heads, batch in ((512, 16, 16), (4096, 16, 2)):
        want = int(jax_bench_attention._flops(jcfg, seq, heads, batch) * 3.5)
        assert int(bench_attention.flops(cfg, seq, heads, batch, grad=True)) == want
        assert bench_attention.flops(cfg, seq, heads, batch) == jax_bench_attention._flops(
            jcfg, seq, heads, batch)


def test_bench_attention_bytes_count_the_launched_tiles():
    """GB/s counts K and V once per tile the launched kernel copies: every
    (Q tile, KV tile) pair without a mask (d 256's 64-row Q tiles copy K
    and V twice as often as d 128's 128-row ones), the plan's causal walk
    with one, K11's own slots (halved at depth 4)."""
    b, h, s = 2, 4, 1024
    for d, rows in ((128, 128), (256, 64)):
        qo = 2 * b * h * s * d * 2
        full = bench_attention._bytes(KernelConfig(d_head=d), b, h, s, 132)
        assert full == qo + 2 * b * h * (s // rows) * s * d * 2
        p = ff.grid_plan(b, h, s, s, True, 0, 0, 132, d)
        tiles = sum(p.tiles(qt) for qt in range(p.q_tiles))
        causal = bench_attention._bytes(KernelConfig(d_head=d, causal=True), b, h, s, 132)
        assert causal == qo + 2 * b * h * tiles * p.keys * d * 2
    for nbuf, keys in ((2, 128), (4, 64)):
        cfg = KernelConfig(causal=True, kv_loop=KVLoop.FORI, num_kv_buffers=nbuf)
        diag = sum(q0 // keys + 1 for q0 in range(127, s, 128))
        assert bench_attention._bytes(cfg, b, h, s, 132) == (
            2 * b * h * s * 128 * 2 + 2 * b * h * diag * keys * 128 * 2)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("flag", [["--kernels", "prog"], ["--host-timing"], ["--grad"]])
def test_bench_attention_options_need_a_card(monkeypatch, flag):
    """The JAX tool's options run on the card: without one each raises the
    missing-card error."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_attention.main(flag)


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


TINY = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, d_head=128,
            hidden_dim=256)


def _jax_json_keys(tool: str) -> set:
    """The keys of the result line the JAX tool prints (the largest dict
    literal it hands ``json.dumps``; ``--trace``'s summary is another),
    read from its source."""
    src = pathlib.Path(jax_bench_decode.__file__).with_name(f"{tool}.py").read_text()
    dicts = [{k.value for k in node.args[0].keys if isinstance(k, ast.Constant)}
             for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
             and node.args and isinstance(node.args[0], ast.Dict)]
    return max(dicts, key=len)


@pytest.mark.parametrize("recipe", ["bf16", "int8", "int4 fused"])
def test_bench_decode_param_counts_match_jax(recipe):
    """``_param_bytes`` and ``_dense_matmul_params`` of the same tiny
    parameters (bf16, int8, int4 with fused projections) equal the JAX
    tool's."""
    jcfg = jax_llama.LlamaConfig(**TINY)
    key = jax.random.PRNGKey(0)
    mode = recipe.split()[0]
    jparams = (jax_llama.init_params(jcfg, key) if mode == "bf16"
               else jax_llama.init_quantized_params(jcfg, key, mode))
    if "fused" in recipe:
        jparams = jax_llama.fuse_projections(jparams)
    params = llama.params_from_jax(jax.device_get(jparams), device="cpu")
    assert bench_decode._param_bytes(params) == jax_bench_decode._param_bytes(jparams)
    assert (bench_decode._dense_matmul_params(params)
            == jax_bench_decode._dense_matmul_params(jparams))


@pytest.mark.parametrize("batch", [1, 16])
def test_bench_decode_step_bytes_gather_the_embedding(batch):
    """The roofline's weight bytes a step: the JAX tool's parameter bytes
    less the embedding table, plus the batch's gathered rows of it."""
    jcfg = jax_llama.LlamaConfig(**TINY)
    jparams = jax_llama.init_quantized_params(jcfg, jax.random.PRNGKey(0), "int8")
    params = llama.params_from_jax(jax.device_get(jparams), device="cpu")
    row = jcfg.dim * params["embed"].element_size()
    assert (bench_decode.weight_bytes_per_step(params, batch)
            == jax_bench_decode._param_bytes(jparams) - (jcfg.vocab_size - batch) * row)


def test_bench_decode_matmul_rows():
    """The tensor-core bound pads m to the port's row tiles: the quantized
    kernels' token tile, 64-row tiles for cuBLAS."""
    assert [bench_decode.matmul_rows(m, True) for m in (1, 16, 17, 100, 200)] == [
        16, 16, 32, 128, 256]
    assert [bench_decode.matmul_rows(m, False) for m in (1, 16, 65)] == [64, 64, 128]
    assert set(bench_decode.MODELS) == set(jax_bench_decode.MODELS)


def _serving_args(*extra):
    return bench_serving.parser().parse_args(
        ["--requests", "3", "--prompt", "80", "--new", "5", "--max-batch", "2",
         "--page-size", "64", "--chunk", "4", *extra])


@pytest.mark.parametrize("extra", [(), ("--prefix-cache", "--shared-prefix", "64"),
                                   ("--temperature", "0.8", "--top-k", "20", "--kv", "dense",
                                    "--weights", "bf16")],
                         ids=["default", "prefix_cache", "sampled"])
def test_bench_serving_runs_on_the_cpu(extra):
    """The run function drains a tiny CPU run and prints one JSON line with
    every key of the JAX tool's (and its device, the CPU)."""
    lines = []
    line = bench_serving.run(_serving_args(*extra), device="cpu",
                             cfg=llama.LlamaConfig(**TINY), log=lines.append)
    assert lines and json.loads(lines[0]) == line
    assert _jax_json_keys("bench_serving") <= set(line)
    assert line["total_new_tokens"] == 15 and line["device"] == "cpu"
    assert (line["prefix_hits_pages"] > 0) == ("--prefix-cache" in extra)
    assert line["ttft_ms_p50"] > 0 and line["tpot_ms_p99"] >= 0


def test_bench_decode_prints_the_jax_keys():
    """bench_decode's JSON line has every key of the JAX tool's (read from
    the source: the tool times the card only)."""
    src = pathlib.Path(bench_decode.__file__).read_text()
    for key in _jax_json_keys("bench_decode"):
        assert f'"{key}":' in src, key


def test_serving_tools_need_a_card(monkeypatch, capsys):
    for tool in (bench_decode, bench_serving):
        with pytest.raises(SystemExit) as exc:
            tool.main(["--help"])
        assert exc.value.code == 0 and "usage" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="ROADMAP"):
        bench_decode.main(["--trace", "trace_dir"])
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError):
        bench_decode.main(["--model", "tiny"])
    with pytest.raises(RuntimeError):
        bench_serving.main(["--model", "tiny"])
