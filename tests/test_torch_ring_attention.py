"""The port's ring attention (4 gloo ranks on the CPU) vs the JAX package.

One group of 4 ranks (``parallel.launch.spawn``, one for the whole module)
runs every case of ``tests/torch_parallel_ranks.py::RING_FORWARD`` and
``RING_BACKWARD`` on its 128-row shard of a 512-token sequence, on the
plain versions of K1, K2 and K3; the JAX side runs in this process on the
virtual CPU devices. Tolerances:

- forward: the JAX ring test's rule, the adaptive rule over the whole
  output against JAX's ``reference_pair`` (``reference_attention`` in bf16
  and in fp32 on the same bf16-rounded inputs); and within 0.03 of the JAX
  ring itself (``ring_flash_attention`` on an ("sp",) mesh of 4, interpret
  mode), the JAX windowed ring test's bound between a ring and a
  single-chip kernel. Not the rule per 64-row band: a ring rounds each
  hop's partial output to bf16 before the merge, and the JAX ring itself
  exceeds the band rule against these references (by 1.2-1.4x here);
- backward: the JAX ring backward tests' rule, dq, dk and dv each by the
  adaptive rule over the whole tensor against ``jax.grad`` of JAX's
  ``reference_attention`` in bf16 and fp32; d(sinks) by the JAX sink
  test's rule (2x the baseline, or 2% of the gradient's scale: D is
  rebuilt from the saved bf16 O).

``_max_hop`` equals JAX's, each rank's kernel plan follows the hops it
computes (``launch_plan``), and ``tools/bench_ring.py``'s step (every Q
shard's hops and merges on one device) passes the adaptive rule against
JAX's ``reference_pair``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from flash_attention_from_scratch_tpu.ops.configs import KernelConfig as JaxKernelConfig
from flash_attention_from_scratch_tpu.ops.reference import (
    reference_attention as jax_reference, reference_pair as jax_reference_pair,
)
from flash_attention_from_scratch_tpu.parallel.ring_attention import (
    _max_hop as jax_max_hop, ring_flash_attention as jax_ring,
)
from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
    KERNEL_DKV, KERNEL_DQ, KERNEL_FUSED,
)
from flash_attention_from_scratch_tpu_torch.ops.flash_forward import KERNEL
from flash_attention_from_scratch_tpu_torch.parallel.launch import spawn
from flash_attention_from_scratch_tpu_torch.parallel.ring_attention import (
    _max_hop, launch_plan, ring_flash_attention,
)
from flash_attention_from_scratch_tpu_torch.tools.bench_ring import ring_sim_step
from flash_attention_from_scratch_tpu_torch.utils.testing import adaptive_tolerance_check

import torch_parallel_ranks as ranks


@pytest.fixture(scope="module")
def ring_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring")
    staged = spawn(ranks.ring_ranks, ranks.RING_WORLD, backend="gloo", device="cpu",
                   args=(str(out),), timeout=240)
    assert staged == [0] * ranks.RING_WORLD  # CPU tensors are never staged
    return str(out)


def _gathered(ring_dir, case):
    parts = ranks.load(ring_dir, case, ranks.RING_WORLD)
    out = torch.cat([p["out"] for p in parts], 2)
    if "grads" not in parts[0]:
        return out, None
    grads = [torch.cat([p["grads"][i] for p in parts], 2) for i in range(3)]
    if len(parts[0]["grads"]) == 4:
        grads.append(parts[0]["grads"][3])
    return out, grads


def _jax_inputs(name, table):
    heads, kv_heads, kw, sinks = table[name]
    q, k, v, do = (jnp.asarray(x, jnp.bfloat16) for x in ranks.ring_inputs(heads, kv_heads))
    z = None if sinks is None else jnp.asarray(sinks, jnp.float32)
    return (q, k, v, do), kw, z


def _ref_kw(kw, z):
    return dict(causal=kw.get("causal", False), window=kw.get("window", 0), sinks=z)


def _check(got, ref16, ref32, what):
    """The adaptive rule over the whole tensor (``ref16`` is JAX bf16)."""
    ok, kerr, berr = adaptive_tolerance_check(
        got, torch.from_numpy(np.asarray(ref16, np.float32)).bfloat16(),
        torch.from_numpy(np.asarray(ref32, np.float32)))
    assert ok, (what, kerr, berr)
    return kerr, berr


@pytest.mark.parametrize("name", list(ranks.RING_FORWARD))
def test_ring_forward_matches_jax(ring_dir, name, cpu_mesh_devices):
    (q, k, v, _), kw, z = _jax_inputs(name, ranks.RING_FORWARD)
    mesh = Mesh(np.asarray(cpu_mesh_devices[:4]), ("sp",))
    cfg = JaxKernelConfig(block_q=128, block_kv=128, optimized_softmax=not kw.get("window"),
                          **kw)
    ring = np.asarray(jax_ring(q, k, v, cfg, mesh, interpret=True, sinks=z), np.float32)
    ref16, ref32 = jax_reference_pair(q, k, v, **_ref_kw(kw, z))
    got, _ = _gathered(ring_dir, f"fwd_{name}")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(q.shape)
    _check(got, ref16, ref32, name)
    drift = float(np.abs(got.float().numpy() - ring).max())
    assert drift < 0.03, (name, drift)


@pytest.mark.parametrize("name", list(ranks.RING_BACKWARD))
def test_ring_backward_matches_jax_autodiff(ring_dir, name):
    (q, k, v, do), kw, z = _jax_inputs(name, ranks.RING_BACKWARD)
    args = (q, k, v) + (() if z is None else (z,))
    argnums = tuple(range(len(args)))

    def ref(*xs):
        return jax_reference(*xs[:3], **_ref_kw(kw, xs[3] if len(xs) > 3 else None))

    ref16 = jax.grad(lambda *xs: jnp.sum(ref(*xs) * do), argnums=argnums)(*args)
    ref32 = jax.grad(lambda *xs: jnp.sum(ref(*xs) * do.astype(jnp.float32)),
                     argnums=argnums)(*(x.astype(jnp.float32) for x in args))
    _, grads = _gathered(ring_dir, f"bwd_{name}")
    for what, g, r16, r32 in zip("qkv", grads, ref16, ref32):
        assert g.dtype == torch.bfloat16
        _check(g, r16, r32, f"{name} d{what}")
    if z is not None:
        ok, kerr, berr = adaptive_tolerance_check(
            grads[3], torch.from_numpy(np.asarray(ref16[3])),
            torch.from_numpy(np.asarray(ref32[3])))
        scale = float(jnp.max(jnp.abs(ref32[3])))
        assert ok or kerr <= max(2 * berr, 0.02 * scale), (kerr, berr, scale)


@pytest.mark.parametrize("window,shard,n", [(0, 128, 8), (128, 128, 8), (129, 128, 8),
                                            (4096, 4096, 32), (10**9, 128, 8),
                                            (4096, 4096, 4), (200, 128, 4)])
def test_max_hop_matches_jax(window, shard, n):
    assert _max_hop(window, shard, n) == jax_max_hop(window, shard, n)


# (config, n_shards, per-rank plan as {kernel: launches}): hops a rank
# computes are the diagonal and, when causal, only the past (t <= rank).
PLAN_CASES = [
    (dict(causal=True), 4, lambda r: {KERNEL: r + 1, KERNEL_DKV: 1, KERNEL_DQ: 1,
                                      KERNEL_FUSED: r}),
    (dict(), 4, lambda r: {KERNEL: 4, KERNEL_FUSED: 4}),
    (dict(causal=True, window=4096), 4, lambda r: {KERNEL: 1 + (r >= 1),
                                                   KERNEL_DKV: 1 + (r >= 1),
                                                   KERNEL_DQ: 1 + (r >= 1)}),
]


@pytest.mark.parametrize("kw,n,want", PLAN_CASES, ids=["causal", "full", "window"])
def test_launch_plan_per_rank(kw, n, want):
    """At shard length 4096: the causal ring's rank r runs K1 on the
    diagonal and its r past hops, K3 on the diagonal and K2 on the plain
    hops; a window of one shard reaches one hop back (K3 on it)."""
    for r in range(n):
        got = {k: c for k, c in launch_plan(KernelConfig(**kw), n, 4096, r).items() if c}
        assert got == {k: c for k, c in want(r).items() if c}, (kw, r)


def test_ring_refuses_what_jax_refuses():
    q = torch.zeros((1, 1, 64, 128), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="q_offset"):
        ring_flash_attention(q, q, q, KernelConfig(causal=True, q_offset=64), None)
    with pytest.raises(ValueError, match="window requires causal"):
        ring_flash_attention(q, q, q, KernelConfig(causal=True, window=8), None,
                             causal=False)


@pytest.mark.parametrize("n", [2, 4])
def test_bench_ring_step_matches_reference(n):
    q, k, v, _ = ranks.ring_inputs(2, 2)
    got = ring_sim_step(KernelConfig(), n, ranks.RING_SEQ // n)(
        *(ranks.bf16(x) for x in (q, k, v)))
    ref16, ref32 = jax_reference_pair(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    _check(got, ref16, ref32, n)
