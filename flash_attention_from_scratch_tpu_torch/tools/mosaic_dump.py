"""Kernel SASS introspection: dump, histogram, diff, slice and gate the built kernels.

Counterpart of ``flash_attention_from_scratch_tpu/tools/mosaic_dump.py``. The
JAX tool reads the Mosaic MLIR a TPU kernel lowers to; on Hopper what a
kernel compiles to is SASS, so this tool dumps SASS: each ``csrc/`` library
is built from the repository's sources (``ops/_build.py``, into the ignored
``build/torch_kernels/``) and read back with the CUDA toolkit's
``cuobjdump`` (``-sass`` for the instructions, ``-res-usage`` for each
kernel's registers, stack, shared and local bytes). The module keeps the
JAX tool's name and public functions:

- :func:`lower_kernel` gives, for the kernel symbol a config launches (K1,
  or K11 at its ring depth, at the config's head width), its SASS, its
  resources and the ``nvcc`` version;
- :func:`op_histogram` counts SASS opcodes by base mnemonic
  (``HGMMA.64x128x16.F32.BF16`` counts as ``HGMMA``; predicates dropped),
  or by full form with ``full=True``;
- :func:`diff_histograms` is the JAX tool's markdown delta table;
- :func:`slice_ir` is the def-use slice over SASS registers (the
  reference's ``ptx_sass_filter`` role);
- :func:`check_regression` is the JAX tool's op-count gate, with its
  thresholds (total growth 5%, one opcode ``max(8, 25%)``), which also
  fails on a rise in a kernel's registers, stack or local bytes (where
  ptxas spills) over the committed figures.

The committed baseline is one small JSON file per library under the
package's ``kernel_sass/``: each kernel symbol's opcode histogram, total and
resources, and the ``nvcc`` version. Symbols are keyed with the anonymous
namespace's per-file hash taken out (:func:`stable_name`). ``--check``
reads it. A dump writes its JSON, with the full SASS text, to the ignored
build directory (``--out``); it writes the committed baseline only when
``--baseline`` names it, so a dump after a regression never moves the gate.
Full SASS text is never committed. Never written: the JAX package's
``kernel_ir/``.

A shrink always passes; after a deliberate kernel change re-dump the
libraries it touches (``--kernels all-libraries`` re-dumps every one) with
``--baseline flash_attention_from_scratch_tpu_torch/kernel_sass`` to move
the baseline, and commit the JSON.

Usage (on the card):
    python -m flash_attention_from_scratch_tpu_torch.tools.mosaic_dump --check
    python -m flash_attention_from_scratch_tpu_torch.tools.mosaic_dump --kernels all-libraries
    python -m flash_attention_from_scratch_tpu_torch.tools.mosaic_dump --kernels prog
    python -m flash_attention_from_scratch_tpu_torch.tools.mosaic_dump --kernels all-libraries \\
        --baseline flash_attention_from_scratch_tpu_torch/kernel_sass
    python -m flash_attention_from_scratch_tpu_torch.tools.mosaic_dump \\
        --diff build/kernel_sass/a.sass build/kernel_sass/b.sass
    python -m flash_attention_from_scratch_tpu_torch.tools.mosaic_dump \\
        --slice build/kernel_sass/flash_forward.sass R24 --depth 4
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import functools
import glob
import json
import os
import re
import subprocess
import sys

from ..ops import _build
from ..ops import flash_backward, flash_forward, flash_quant, paged_attention, quant_matmul
from ..ops.configs import DType, KVLoop, get_kernel_configs
from ..utils.device import resolve_device

__all__ = ["lower_kernel", "op_histogram", "diff_histograms", "slice_ir",
           "check_regression", "compare_symbol", "dump_library", "kernel_symbol",
           "sass_by_function", "resource_usage", "stable_name", "LIBRARIES",
           "KERNEL_SASS_DIR", "DUMP_DIR", "main"]

# Every CUDA library of the port: K1; K11 at d 128 and 256; K2/K3 at d 128
# and 256; K10 at d 128 and 256; K4/K5 and their merge; K6-K9 with their
# finalize and quantize_rows_kernel; the fp16 libraries of K1, K11,
# K2/K3, K10, K4/K5 and K6-K9 (each bf16 source built with FA_F16); and the
# fp32 libraries of K1 and K11 (the fp32 main loop, csrc/flash_f32.cuh).
LIBRARIES = tuple(dict.fromkeys((
    flash_forward.SOURCE, *flash_forward.SOURCES_FORI.values(),
    *flash_backward.SOURCES.values(), *flash_quant.SOURCES.values(),
    paged_attention.SOURCE, quant_matmul.SOURCE,
    flash_forward.SOURCE_F16, *flash_forward.SOURCES_FORI_F16.values(),
    *flash_backward.SOURCES_F16.values(), *flash_quant.SOURCES_F16.values(),
    paged_attention.SOURCE_F16, quant_matmul.SOURCE_F16,
    flash_forward.SOURCE_F32, *flash_forward.SOURCES_FORI_F32.values())))

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_SASS_DIR = os.path.join(_PKG, "kernel_sass")
DUMP_DIR = os.path.join("build", "kernel_sass")  # ignored: full SASS text goes here


def _cuda_tool(name: str) -> str:
    """A CUDA toolkit program beside ``nvcc`` (``cuobjdump``)."""
    return os.path.join(os.path.dirname(_build._nvcc()), name)


def _library(source: str) -> str:
    """Path of the shared library built from ``csrc/<source>`` (built if
    needed)."""
    _build.build([source])
    return _build._target(source)[1]


def _run(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


@functools.lru_cache(maxsize=1)
def nvcc_version() -> str:
    """The release line of ``nvcc --version`` (``Cuda compilation tools,
    release 12.9, V12.9.86``)."""
    lines = _run(_build._nvcc(), "--version").strip().splitlines()
    return next((ln for ln in lines if "release" in ln), lines[-1])


def split_functions(sass: str) -> dict[str, str]:
    """{kernel symbol: its SASS} of one ``cuobjdump -sass`` listing."""
    parts = re.split(r"\n\s*Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


def sass_by_function(source: str) -> dict[str, str]:
    """{kernel symbol: its SASS} of the built library of ``source``."""
    return split_functions(_run(_cuda_tool("cuobjdump"), "-sass", _library(source)))


_RES_RE = re.compile(r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)")


def parse_resource_usage(text: str) -> dict[str, dict]:
    """{kernel symbol: {reg, stack, shared, local}} of one ``cuobjdump
    -res-usage`` listing."""
    return {m[0]: dict(reg=int(m[1]), stack=int(m[2]), shared=int(m[3]), local=int(m[4]))
            for m in _RES_RE.findall(text)}


def resource_usage(source: str) -> dict[str, dict]:
    """{kernel symbol: its registers, stack, shared and local bytes} of the
    built library of ``source``: stack and local memory are where ptxas
    spills."""
    return parse_resource_usage(_run(_cuda_tool("cuobjdump"), "-res-usage", _library(source)))


_ANON_RE = re.compile(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def stable_name(symbol: str) -> str:
    """``symbol`` with its anonymous namespace's per-file hash replaced by
    ``_GLOBAL__N_``, so that a kernel keeps its key when its file
    changes."""
    return _ANON_RE.sub("_GLOBAL__N_", symbol)


def kernel_symbol(cfg) -> tuple[str, str]:
    """(library source, pattern of the mangled symbol) of the kernel
    ``flash_forward`` launches for ``cfg`` at its head width and type: K11
    at its ring depth for a FORI config, else K1 (a banded config runs K1 a
    band); fp16 from its library, fp32 the fp32 main loop's kernel at the
    ring depth (K1's: ``GRID_TILES_F32``)."""
    d = cfg.d_head
    fori = cfg.kv_loop == KVLoop.FORI
    source = _build.typed_source(flash_forward.SOURCES_FORI[d] if fori else flash_forward.SOURCE,
                                 cfg.dtype.torch_dtype, "K11" if fori else "K1")
    if cfg.dtype == DType.FP32:
        nb = cfg.num_kv_buffers if fori else flash_forward.GRID_TILES_F32[d][2]
        return source, f"flash_f32_kernelILi{nb}ELi{d}E"
    if fori:
        return source, f"flash_forward_fori_kernelILi{cfg.num_kv_buffers}ELi{d}E"
    return source, f"flash_forward_kernelILi{d}E"


def lower_kernel(cfg, seq: int = 2048, heads: int = 4, batch: int = 1) -> dict:
    """The SASS of the kernel symbol ``cfg`` launches: {"source", "symbol",
    "sass", "resources", "nvcc"}. ``seq``, ``heads`` and ``batch`` are the
    JAX tool's (its lowering depends on the shape); a CUDA kernel's SASS
    does not, so they are accepted and unused. Raises where the config's
    head width has no kernel."""
    del seq, heads, batch
    if cfg.d_head not in flash_forward.D_HEADS:
        raise ValueError(f"no kernel at head width {cfg.d_head}")
    source, pattern = kernel_symbol(cfg)
    sass = sass_by_function(source)
    symbol = next(s for s in sass if pattern in s)
    return {"source": source, "symbol": symbol, "sass": sass[symbol],
            "resources": resource_usage(source)[symbol], "nvcc": nvcc_version()}


# One instruction: /*addr*/ [@[!]pred] OPCODE[.modifiers] operands ;
_INSN_RE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P(?:T|\d+)\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Za-z0-9_]+)*)"
    r"([^;]*);")
_REG_RE = re.compile(r"\b(U?R\d+|U?P\d)\b")


def op_histogram(sass: str, full: bool = False) -> collections.Counter:
    """Histogram of SASS opcodes: base mnemonics (``HGMMA``), or the full
    forms with their modifiers (``HGMMA.64x128x16.F32.BF16``) when
    ``full``. Predicates and operands are dropped."""
    counts: collections.Counter = collections.Counter()
    for m in _INSN_RE.finditer(sass):
        counts[m.group(2) if full else m.group(2).split(".", 1)[0]] += 1
    return counts


def diff_histograms(before: collections.Counter, after: collections.Counter) -> str:
    """Markdown delta table (analogue of compare_sass_instruction_counts.py)."""
    ops = sorted(set(before) | set(after),
                 key=lambda o: -(abs(after.get(o, 0) - before.get(o, 0))))
    lines = ["| op | before | after | delta |", "|---|---|---|---|"]
    for op in ops:
        b, a = before.get(op, 0), after.get(op, 0)
        if b == a == 0:
            continue
        lines.append(f"| {op} | {b} | {a} | {a - b:+d} |")
    total_b, total_a = sum(before.values()), sum(after.values())
    lines.append(f"| **total** | {total_b} | {total_a} | {total_a - total_b:+d} |")
    return "\n".join(lines)


# Opcodes whose first operand is not a register they write (stores,
# reductions to memory, copies, barriers, control flow).
_NO_DEST = {"ST", "STG", "STS", "STL", "STSM", "RED", "REDG", "UTMALDG", "UTMASTG",
            "UTMAREDG", "UTMAPF", "UTMACCTL", "UBLKCP", "UBLKRED", "UBLKPF", "BRA", "BRX",
            "JMP", "JMX", "CALL", "RET", "EXIT", "BAR", "BSSY", "BSYNC", "WARPSYNC",
            "MEMBAR", "FENCE", "NOP", "YIELD", "DEPBAR", "ERRBAR", "CCTL", "CCTLL",
            "WARPGROUP", "BPT", "KILL", "NANOSLEEP", "ACQBULK", "ARRIVES"}


def _instructions(sass: str) -> list[tuple[int, str, set, set]]:
    """[(line index, address, registers written, registers read)] in text
    order. The first register operand is the one written, except for
    ``_NO_DEST`` opcodes; every other register is read (an accumulator
    named again, as HGMMA's, is both)."""
    out = []
    for i, line in enumerate(sass.splitlines()):
        m = _INSN_RE.search(line)
        if not m:
            continue
        pred = re.search(r"@!?(U?P\d)\s", line[:m.start(2)])
        operands = m.group(3).split(",")
        regs0 = _REG_RE.findall(operands[0]) if operands and operands[0].strip() else []
        defs: set = set()
        uses = set(_REG_RE.findall(",".join(operands[1:])))
        if pred:
            uses.add(pred.group(1))
        dest = operands[0].strip()
        if (m.group(2).split(".", 1)[0] in _NO_DEST or not regs0 or "[" in dest):
            uses.update(regs0)
        else:
            defs.add(regs0[0])
            uses.update(regs0[1:])
        out.append((i, m.group(1), defs, uses))
    return out


def slice_ir(sass: str, reg: str, *, forward: bool = False,
             max_depth: int | None = None) -> str:
    """Def-use slice of a SASS listing around one register.

    The counterpart of the JAX tool's slice over Mosaic SSA values, and of
    the reference's PTX->SASS dependency slicer (``ptx_sass_filter``).
    ``reg`` is a register (``R24``, ``P0``, ``UR4``), optionally with an
    instruction address (``R24@0x0a30``) to seed at that definition rather
    than the last one (backward) or the first one (forward). SASS is not
    SSA, so the walk follows the text order of one function (branches not
    followed):

    - backward (default): the instructions whose results feed ``reg``,
      each register traced to its nearest earlier definition, back to
      registers defined before the listing starts (kernel arguments come
      in as constants, so these are rare);
    - forward: the instructions that read ``reg`` or a register computed
      from it, until each is overwritten.

    Returns the sliced instructions in text order, each prefixed with its
    line number and distance (in def-use hops) from the seed.
    """
    lines = sass.splitlines()
    insns = _instructions(sass)
    name, _, addr = reg.partition("@")
    addr = addr.lower().removeprefix("0x").zfill(4) if addr else ""
    defining = [j for j, (_, a, defs, _) in enumerate(insns)
                if name in defs and (not addr or int(a, 16) == int(addr, 16))]
    used = any(name in u for _, _, _, u in insns)
    if not defining and not used:
        return f"// {name}: not found in the listing"
    depth_of: dict[int, int] = {}
    loose: set = set()
    if forward:
        start = defining[0] if defining else -1
        tainted = {name: 0}
        for i, _, defs, uses in insns[start + 1:]:
            hit = [tainted[u] for u in uses if u in tainted]
            if hit:
                d = min(hit)
                depth_of[i] = d
                for r in defs:
                    if max_depth is None or d + 1 <= max_depth:
                        tainted[r] = d + 1
                    else:
                        tainted.pop(r, None)
            else:
                for r in defs:
                    tainted.pop(r, None)
    else:
        if not defining:
            return f"// backward slice of {name}: 0 ops\n// bottomed out at: {name}"
        start = defining[-1]
        i0, _, _, uses0 = insns[start]
        depth_of[i0] = 0
        wanted = {u: 1 for u in uses0} if max_depth is None or max_depth >= 1 else {}
        for i, _, defs, uses in reversed(insns[:start]):
            hit = [wanted.pop(r) for r in defs if r in wanted]
            if not hit:
                continue
            d = min(hit)
            depth_of[i] = d
            if max_depth is None or d + 1 <= max_depth:
                for u in uses:
                    wanted[u] = min(wanted.get(u, d + 1), d + 1)
        loose = set(wanted)
    out = [f"// {'forward' if forward else 'backward'} slice of {name}: {len(depth_of)} ops"]
    for i in sorted(depth_of):
        out.append(f"{i + 1:>6} [d{depth_of[i]}] {lines[i].strip()}")
    if loose:
        out.append("// bottomed out at registers defined before the listing: "
                   + ", ".join(sorted(loose)))
    return "\n".join(out)


def dump_library(source: str) -> dict:
    """One library's baseline: {"library", "nvcc", "symbols": {stable name:
    {"ops", "total", "reg", "stack", "shared", "local"}}}, from a build of
    the repository's ``csrc/<source>``."""
    sass = sass_by_function(source)
    usage = resource_usage(source)
    symbols = {}
    for sym, text in sorted(sass.items()):
        hist = op_histogram(text)
        symbols[stable_name(sym)] = {"ops": dict(sorted(hist.items())),
                                     "total": sum(hist.values()), **usage.get(sym, {})}
    return {"library": source, "nvcc": nvcc_version(), "symbols": symbols}


def compare_symbol(name: str, old: dict, new: dict, total_growth: float = 0.05,
                   op_growth: float = 0.25, op_slack: int = 8) -> list[str]:
    """Why one symbol's fresh figures ``new`` regress against its committed
    ``old`` ones (empty: within budget): total ops grown more than
    ``total_growth``; an opcode grown more than ``max(op_slack, op_growth *
    old)``; more registers; more stack or local bytes (spills)."""
    msgs = []
    t_old, t_new = old["total"], new["total"]
    if t_new > t_old * (1 + total_growth):
        msgs.append(f"total ops {t_old} -> {t_new} (+{100 * (t_new - t_old) / t_old:.1f}%)")
    for op, n_new in new["ops"].items():
        n_old = old["ops"].get(op, 0)
        if n_new > n_old + max(op_slack, op_growth * n_old):
            msgs.append(f"{op} {n_old} -> {n_new}")
    for key, what in (("reg", "registers"), ("stack", "stack bytes"),
                      ("local", "local bytes")):
        if new.get(key, 0) > old.get(key, 0):
            msgs.append(f"{what} {old.get(key, 0)} -> {new[key]}")
    return msgs


def check_regression(sass_dir: str = KERNEL_SASS_DIR, total_growth: float = 0.05,
                     op_growth: float = 0.25, op_slack: int = 8, log=print,
                     dump=dump_library) -> list[str]:
    """Op-count, register and spill gate against the committed baselines.

    The JAX tool's gate with its thresholds: every ``<library>.json``
    under ``sass_dir`` is rebuilt from the repository's sources and dumped
    (``dump``; the libraries in threads, each a few ``cuobjdump``
    processes) and each of its symbols compared by :func:`compare_symbol`.
    A symbol the baseline has and the build lacks, or the reverse, fails
    too (re-dump after adding or removing a kernel). Returns the failure
    messages (empty: green). A shrink always passes; re-dump to ratchet the
    baseline down.
    """
    failures = []
    paths = sorted(glob.glob(os.path.join(sass_dir, "*.json")))
    if not paths:
        return [f"no committed baseline (*.json) under {sass_dir}"]
    baselines = []
    for path in paths:
        with open(path) as f:
            baselines.append(json.load(f))
    with concurrent.futures.ThreadPoolExecutor(len(baselines)) as pool:
        dumps = list(pool.map(dump, [b["library"] for b in baselines]))
    for committed, fresh in zip(baselines, dumps):
        if fresh["nvcc"] != committed["nvcc"]:
            log(f"  {committed['library']}: nvcc {fresh['nvcc']!r}, "
                f"baseline from {committed['nvcc']!r}")
        old, new = committed["symbols"], fresh["symbols"]
        for name in sorted(set(old) | set(new)):
            if name not in new:
                msgs = ["not built any more (re-dump the library)"]
            elif name not in old:
                msgs = ["no baseline (re-dump the library)"]
            else:
                msgs = compare_symbol(name, old[name], new[name], total_growth,
                                      op_growth, op_slack)
            if msgs:
                failures.append(f"{committed['library']} {name}: " + "; ".join(msgs))
                log(f"  {name}: REGRESSED ({'; '.join(msgs)})")
                if name in old and name in new:
                    log(diff_histograms(collections.Counter(old[name]["ops"]),
                                        collections.Counter(new[name]["ops"])))
            else:
                log(f"  {name}: ok ({old[name]['total']} -> {new[name]['total']} ops, "
                    f"{new[name].get('reg')} registers)")
    return failures


def _write_baseline(baseline_dir: str, source: str) -> dict:
    lib = dump_library(source)
    os.makedirs(baseline_dir, exist_ok=True)
    path = os.path.join(baseline_dir, os.path.splitext(source)[0] + ".json")
    with open(path, "w") as f:
        json.dump(lib, f, indent=1, sort_keys=True)
        f.write("\n")
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="prog",
                    help="configs as in bench_attention (prog | all | tune | ...), or "
                         "all-libraries for every kernel symbol of every library")
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--seq", type=int, default=2048,
                    help="the JAX tool's dump shape; SASS does not depend on it")
    ap.add_argument("--out", default=DUMP_DIR, help="full SASS text goes here")
    ap.add_argument("--baseline", default=None,
                    help="per-library JSON baselines: read by --check (default the "
                         "committed kernel_sass/), written by a dump only when given "
                         "(a dump's JSON otherwise goes to --out)")
    ap.add_argument("--diff", nargs=2, metavar=("BEFORE", "AFTER"),
                    help="diff opcode histograms of two SASS dumps")
    ap.add_argument("--slice", nargs=2, metavar=("FILE", "REG"),
                    help="def-use slice of a register (R24, or R24@0x0a30) in a SASS dump "
                         "(ptx_sass_filter analogue)")
    ap.add_argument("--forward", action="store_true",
                    help="slice consumers instead of producers")
    ap.add_argument("--depth", type=int, default=None,
                    help="max def-use hops for --slice")
    ap.add_argument("--check", action="store_true",
                    help="regression gate: rebuild the committed libraries and fail on "
                         "opcode growth, more registers or a spill")
    args = ap.parse_args(argv)

    if args.diff:
        hists = []
        for path in args.diff:
            with open(path) as f:
                hists.append(op_histogram(f.read()))
        print(diff_histograms(*hists))
        return 0
    if args.slice:
        with open(args.slice[0]) as f:
            print(slice_ir(f.read(), args.slice[1], forward=args.forward,
                           max_depth=args.depth))
        return 0

    resolve_device("cuda")  # the kernels build with the card's toolkit, for its machine
    if args.check:
        failures = check_regression(args.baseline or KERNEL_SASS_DIR)
        if failures:
            print(f"\n{len(failures)} kernel(s) regressed:")
            for f in failures:
                print(f"  {f}")
            return 1
        print("\nall committed kernels within op-count, register and spill budget")
        return 0

    os.makedirs(args.out, exist_ok=True)
    baseline = args.baseline or args.out
    if args.kernels == "all-libraries":
        _build.build(LIBRARIES)
        for source in LIBRARIES:
            lib = _write_baseline(baseline, source)
            text = _run(_cuda_tool("cuobjdump"), "-sass", _library(source))
            with open(os.path.join(args.out, os.path.splitext(source)[0] + ".sass"), "w") as f:
                f.write(text)
            total = sum(s["total"] for s in lib["symbols"].values())
            print(f"{source}: {len(lib['symbols'])} symbols, {total} instructions, "
                  f"registers {sorted({s.get('reg') for s in lib['symbols'].values()})}")
        return 0

    dtype = DType.from_short(args.dtype)
    sources = set()
    for cfg in get_kernel_configs(args.kernels):
        if cfg.dtype != dtype:
            continue
        name = cfg.short_form()
        dump = lower_kernel(cfg, seq=args.seq)
        sources.add(dump["source"])
        with open(os.path.join(args.out, f"{name}.sass"), "w") as f:
            f.write(dump["sass"])
        hist = op_histogram(dump["sass"])
        top = ", ".join(f"{op}:{n}" for op, n in hist.most_common(8))
        print(f"{name}: {stable_name(dump['symbol'])}")
        print(f"  sass ops: {sum(hist.values())} total; top: {top}; "
              f"resources {dump['resources']}")
    for source in sorted(sources):
        _write_baseline(baseline, source)
    return 0


if __name__ == "__main__":
    sys.exit(main())
