"""The port's GPipe pipeline (``parallel/pipeline.py``, 4 gloo ranks on the
CPU) vs the JAX package.

One group of 4 ranks for the whole module
(``tests/torch_parallel_ranks.py::pipe_ranks``) runs every case on the
fp32 config of ``tests/test_pipeline.py``, on the JAX package's own random
parameters (``params_from_jax``); the JAX side runs in this process on the
virtual CPU devices, in interpret mode. Bounds are the JAX tests':

- the stacked leaves' shapes equal ``stack_pipeline_params``'s;
- the logits of a pp 4 pipeline over 4 microbatches and of a pp 2 one over
  2 equal JAX ``pipeline_forward``'s within atol 2e-3, rtol 2e-3, on every
  rank;
- every rank's loss within 1e-3 of JAX's ``loss_fn`` and every gradient (a
  rank's own stage, and the replicated leaves whole) within atol 2e-3, rtol
  2e-2 of ``jax.grad`` of JAX's ``loss_fn`` (``tests/test_pipeline.py:104``;
  JAX's own pipeline-gradient test is marked slow). The embedding's
  gradient not summed over "pp", or the LM head's summed, fails that check;
- a batch that does not split into the microbatches raises ``ValueError``,
  and so does a mesh smaller than the group unless built with ``sub=True``;
- with ``embed_scale``, a final softcap, RoPE scaling and a window cycle
  (which JAX's stage drops) the pipeline equals the port's own ``loss_fn``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.parallel import pipeline as jax_pipeline
from flash_attention_from_scratch_tpu_torch.models.llama import params_from_jax
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.parallel.launch import spawn
from flash_attention_from_scratch_tpu_torch.parallel.pipeline import stack_pipeline_params

import torch_parallel_ranks as ranks

SHAPE = dict(vocab_size=128, dim=256, n_layers=4, n_heads=2, n_kv_heads=1, d_head=128,
             hidden_dim=256)
VARIANT = dict(embed_scale=True, final_softcap=30.0, window_pattern=(64, 0),
               rope_scale_factor=8.0, rope_orig_ctx=64)
WORLD = ranks.PIPE_WORLD


@pytest.fixture(scope="module")
def jax_side(cpu_mesh_devices):
    cfg = jax_llama.LlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    params = jax.device_put(jax_llama.init_params(cfg, jax.random.PRNGKey(0)),
                            cpu_mesh_devices[0])
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 128), 0, cfg.vocab_size)
    tokens129 = jax.random.randint(jax.random.PRNGKey(2), (4, 129), 0, cfg.vocab_size)
    out = {"params": params, "tokens": np.asarray(tokens), "tokens129": np.asarray(tokens129),
           "stacked": {n: {k: v.shape for k, v in
                           jax_pipeline.stack_pipeline_params(params, n)["stages"].items()}
                       for n in (4, 2)}}
    for n in (4, 2):
        mesh = Mesh(np.asarray(cpu_mesh_devices[:n]), ("pp",))
        staged = jax_pipeline.shard_pipeline_params(
            jax_pipeline.stack_pipeline_params(params, n), mesh)
        with mesh:
            out[f"fwd_pp{n}"] = np.asarray(jax_pipeline.pipeline_forward(
                staged, jax.device_put(tokens, NamedSharding(mesh, P())), cfg, mesh,
                n_micro=n, interpret=True))
    out["loss"], grads = jax.value_and_grad(jax_llama.loss_fn)(
        params, jnp.asarray(tokens129), cfg, interpret=True)
    out["grads"] = jax.device_get(grads)
    return out


@pytest.fixture(scope="module")
def rank_dir(tmp_path_factory, jax_side):
    setup = {"params": params_from_jax(jax.device_get(jax_side["params"]), device="cpu"),
             "cfg": {**SHAPE, "dtype": DType.FP32}, "variant": VARIANT,
             "tokens": torch.tensor(jax_side["tokens"]).long(),
             "tokens129": torch.tensor(jax_side["tokens129"]).long()}
    out = tmp_path_factory.mktemp("pipeline")
    staged = spawn(ranks.pipe_ranks, WORLD, backend="gloo", device="cpu",
                   args=(str(out), setup), timeout=300)
    assert staged == [0] * WORLD  # CPU tensors are never staged
    return str(out)


@pytest.mark.parametrize("n", [4, 2])
def test_stacked_shapes_equal_jax(jax_side, n):
    params = params_from_jax(jax.device_get(jax_side["params"]), device="cpu")
    got = stack_pipeline_params(params, n)
    assert {k: tuple(v.shape) for k, v in got["stages"].items()} == {
        k: tuple(s) for k, s in jax_side["stacked"][n].items()}
    assert got["stages"]["wq"].shape[:2] == (n, 4 // n)
    with pytest.raises(ValueError, match="3 stages"):
        stack_pipeline_params(params, 3)


@pytest.mark.parametrize("n", [4, 2])
def test_pipeline_logits_match_jax(rank_dir, jax_side, n):
    parts = ranks.load(rank_dir, f"fwd_pp{n}", n)
    for part in parts:
        assert torch.equal(part, parts[0])  # every rank: the psum's whole output
    np.testing.assert_allclose(parts[0].numpy(), jax_side[f"fwd_pp{n}"], atol=2e-3, rtol=2e-3)


def _grad_failures(parts, jax_side):
    """(rank, leaf) pairs outside atol 2e-3, rtol 2e-2 of JAX's gradient: a
    rank's stage leaf against its layer's, the other leaves whole."""
    want = jax_side["grads"]
    bad = []
    for rank, part in enumerate(parts):
        for name, g in part["grads"].items():
            if name.startswith("stages."):
                key = name.split(".", 1)[1]
                w = np.stack([want["layers"][rank * g.shape[1] + i][key]
                              for i in range(g.shape[1])])[None]
            else:
                w = want[name]
            if not np.allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=2e-2):
                bad.append((rank, name))
    return bad


def test_pipeline_loss_and_gradients_match_jax(rank_dir, jax_side):
    parts = ranks.load(rank_dir, "grad", WORLD)
    for part in parts:
        assert abs(part["loss"] - float(jax_side["loss"])) < 1e-3
        assert len(part["grads"]) == 3 + len(jax_side["grads"]["layers"][0])
    assert _grad_failures(parts, jax_side) == []


@pytest.mark.parametrize("fault", ["no_embed_sum", "lm_head_summed"])
def test_gradient_check_fails_a_planted_fault(rank_dir, jax_side, fault):
    """Without the "pp" sum the embedding's gradient reaches stage 0 only;
    with one the LM head's is counted on every rank: each breaks the
    gradient check on its leaf, the loss unchanged."""
    parts = ranks.load(rank_dir, fault, WORLD)
    assert parts[0]["loss"] == ranks.load(rank_dir, "grad", WORLD)[0]["loss"]
    leaf = "embed" if fault == "no_embed_sum" else "lm_head"
    assert {name for _, name in _grad_failures(parts, jax_side)} == {leaf}


@pytest.mark.parametrize("build", ["axis", "dp_tp"])
def test_a_mesh_smaller_than_the_group_needs_sub(rank_dir, build):
    """Without ``sub=True`` a mesh of 2 ranks in a group of 4 raises on every
    rank; with it (the pp 2 mesh) ranks 2-3 get None."""
    for rank, got in enumerate(ranks.load(rank_dir, "sub_mesh", WORLD)):
        assert "needs 2 ranks; the process group has 4" in got["refused"][build]
        assert got["pp2_none"] == (rank >= 2)


def test_pipeline_refuses_a_batch_that_does_not_split(rank_dir):
    for got in ranks.load(rank_dir, "refusal", WORLD):
        assert got is not None and "3 microbatches" in got


def test_pipeline_equals_the_port_loss_fn_where_jax_stages_differ(rank_dir):
    """On the config JAX's stage gets wrong, the pipeline (2 microbatches)
    equals the port's ``loss_fn``: the loss within 1e-5 and each rank's
    gradients within atol 2e-5, rtol 2e-4 (both fp32, the same kernels on
    other batch splits)."""
    for rank, part in enumerate(ranks.load(rank_dir, "variant", WORLD)):
        assert abs(part["pipeline"]["loss"] - part["loss"]) < 1e-5
        for name, g in part["pipeline"]["grads"].items():
            if name.startswith("stages."):
                key = name.split(".", 1)[1]
                w = part["grads"][f"layers.{rank}.{key}"][None, None]
            else:
                w = part["grads"][name]
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=2e-4,
                                       err_msg=f"rank {rank} {name}")
