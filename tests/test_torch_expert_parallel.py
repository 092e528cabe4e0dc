"""The port's expert parallelism (``models/moe.py`` on an "ep" mesh, 4 gloo
ranks on the CPU) vs the JAX package.

One group of 4 ranks for the whole module
(``tests/torch_parallel_ranks.py::ep_ranks``) runs every case at
``tests/test_moe.py``'s config in fp32 (4 experts, one a rank), on the JAX
package's own random parameters; the JAX side runs in this process on the
virtual CPU devices, on ``shard_moe_params``'s placement. Bounds:

- ``moe_param_specs`` equal JAX's, leaf for leaf;
- ``_moe_mlp`` on the same activations on every rank: out within atol and
  rtol 1e-4 of JAX's sharded ``_moe_mlp`` and aux within rtol 1e-5
  (``tests/test_moe.py:107-147``);
- ``moe_loss_fn(mesh=ep)``: every rank's loss within 1e-5 relative of JAX's
  and each gradient (a rank's experts, the other leaves whole) within 1e-4
  of the JAX leaf's largest gradient (the rule of the port's parallel
  training test); the router's gradient left unsummed over "ep", or the aux
  loss's summed, breaks it;
- a tp or an sp mesh with MoE layers raises ``NotImplementedError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flash_attention_from_scratch_tpu.models import moe as jax_moe
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu_torch.models import moe
from flash_attention_from_scratch_tpu_torch.models.llama import params_from_jax
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.parallel.launch import spawn

import torch_parallel_ranks as ranks

SHAPE = dict(vocab_size=128, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, d_head=128,
             hidden_dim=128, n_experts=4, expert_top_k=2)
WORLD = ranks.EP_WORLD


def _named(tree, prefix=""):
    """{path: leaf}; a spec (a tuple) is a leaf."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _named(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _named(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def jax_side(cpu_mesh_devices):
    cfg = jax_moe.MoEConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    params = jax.device_put(jax_moe.init_moe_params(cfg, jax.random.PRNGKey(0)),
                            cpu_mesh_devices[0])
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 64, cfg.dim), jnp.float32)
    tokens = jax.random.randint(jax.random.PRNGKey(4), (2, 129), 0, cfg.vocab_size)
    mesh = Mesh(np.asarray(cpu_mesh_devices[:WORLD]), ("ep",))
    with mesh:
        sharded = jax_moe.shard_moe_params(params, mesh)
        rep = NamedSharding(mesh, P())
        out, aux = jax.jit(lambda l, x: jax_moe._moe_mlp(cfg, l, x))(
            sharded["layers"][0], jax.device_put(x, rep))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, t: jax_moe.moe_loss_fn(p, t, cfg, interpret=True)))(
            sharded, jax.device_put(tokens, rep))
    return {"params": params, "x": np.asarray(x), "tokens": np.asarray(tokens),
            "out": np.asarray(out), "aux": float(aux), "loss": float(loss),
            "grads": _named(jax.device_get(grads)),
            "specs": _named(jax_moe.moe_param_specs(params))}


@pytest.fixture(scope="module")
def rank_dir(tmp_path_factory, jax_side):
    setup = {"params": params_from_jax(jax.device_get(jax_side["params"]), device="cpu"),
             "cfg": {**SHAPE, "dtype": DType.FP32}, "x": torch.tensor(jax_side["x"]),
             "tokens": torch.tensor(jax_side["tokens"]).long()}
    out = tmp_path_factory.mktemp("expert_parallel")
    staged = spawn(ranks.ep_ranks, WORLD, backend="gloo", device="cpu",
                   args=(str(out), setup), timeout=300)
    assert staged == [0] * WORLD  # CPU tensors are never staged
    return str(out)


def test_moe_param_specs_equal_jax(jax_side):
    params = params_from_jax(jax.device_get(jax_side["params"]), device="cpu")
    got = _named(moe.moe_param_specs(params))
    assert got == {k: tuple(v) for k, v in jax_side["specs"].items()}
    assert got["layers.0.experts.w_gate"] == ("ep",) and got["layers.0.router"] == ()


def test_expert_parallel_moe_mlp_matches_jax(rank_dir, jax_side):
    for part in ranks.load(rank_dir, "mlp", WORLD):
        np.testing.assert_allclose(part["out"].numpy(), jax_side["out"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(part["aux"], jax_side["aux"], rtol=1e-5)


def _grad_errors(parts, jax_side):
    """Per (rank, leaf), the largest |port - JAX| on the rank's block (its
    experts, or the whole leaf) over the JAX leaf's largest |gradient|."""
    out = {}
    for rank, part in enumerate(parts):
        for name, g in part["grads"].items():
            w = np.asarray(jax_side["grads"][name])
            block = w[rank * g.shape[0]:(rank + 1) * g.shape[0]] if ".experts." in name else w
            out[rank, name] = float(np.abs(g.numpy() - block).max()) / float(np.abs(w).max())
    return out


def test_expert_parallel_gradients_match_jax(rank_dir, jax_side):
    parts = ranks.load(rank_dir, "grad", WORLD)
    for part in parts:
        assert abs(part["loss"] - jax_side["loss"]) <= 1e-5 * abs(jax_side["loss"])
        assert set(part["grads"]) == set(jax_side["grads"])
        assert part["grads"]["layers.0.experts.w_down"].shape[0] == SHAPE["n_experts"] // WORLD
    errors = _grad_errors(parts, jax_side)
    assert max(errors.values()) <= 1e-4, {k: e for k, e in errors.items() if e > 1e-4}


@pytest.mark.parametrize("fault", ["router_not_summed", "aux_summed"])
def test_gradient_check_fails_a_planted_fault(rank_dir, jax_side, fault):
    """The router's gradient from a rank's experts alone, or the aux loss's
    gradient summed over "ep" with the gates': the router's gradient breaks
    the 1e-4 rule by far; the loss is unchanged."""
    parts = ranks.load(rank_dir, fault, WORLD)
    assert parts[0]["loss"] == ranks.load(rank_dir, "grad", WORLD)[0]["loss"]
    errors = _grad_errors(parts, jax_side)
    assert max(e for (_, name), e in errors.items() if name.endswith("router")) > 1e-2


def test_moe_under_a_tp_or_sp_mesh_raises(rank_dir):
    for got in ranks.load(rank_dir, "refusals", WORLD):
        assert set(got) == {"tp_forward", "tp_shard_params", "sp_forward", "sp_shard_params"}
        for name, message in got.items():
            assert message is not None and "ROADMAP" in message, name
