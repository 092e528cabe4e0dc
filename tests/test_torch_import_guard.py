"""The port never reaches JAX or the JAX package, nor a package the card's
machine lacks.

Every module of ``flash_attention_from_scratch_tpu_torch`` and
``chip_smoke.py`` is imported in a fresh interpreter in which ``jax``,
``flash_attention_from_scratch_tpu``, ``transformers``, ``safetensors``,
``orbax`` and ``peft`` are blocked (``sys.modules[name] = None`` makes any
import of them raise ``ImportError``). The test fails if an import raises,
or if any module of those names was loaded.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flash_attention_from_scratch_tpu", "transformers",
           "safetensors", "orbax", "peft")
for name in BLOCKED:
    sys.modules[name] = None
import flash_attention_from_scratch_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
need = {pkg.__name__ + "." + m for m in ("models.lora", "ops.causal_decomp", "entry",
                                         "models.moe", "models.convert",
                                         "utils.checkpoint", "parallel.mesh",
                                         "parallel.collectives",
                                         "parallel.sharded_attention",
                                         "parallel.ring_attention", "parallel.launch",
                                         "tools.bench_ring", "parallel.pipeline",
                                         "tools.scaling_report")}
assert need <= set(names), need - set(names)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in BLOCKED]
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    # Every module of the port was imported: ops, models, serving, utils.
    assert int(proc.stdout.split()[-1]) >= 20, proc.stdout
