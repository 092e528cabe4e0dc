"""The port's Mixture-of-Experts layer (``models/moe.py``) vs the JAX package's.

The JAX tests' tiny MoE (``tests/test_moe.py``: vocab 128, dim 256, 2
layers, 2/1 heads of 128, hidden 128, 4 experts, top 2) in fp32, the JAX
package's random parameters carried over by ``params_from_jax``, token ids
and activations from seeded numpy generators. The JAX side runs as its own
tests run it on the CPU (its attention in interpret mode).

Tolerances:

- ``_capacity``: equal, over a sweep of token counts and factors.
- ``_route``: dispatch and combine bit for bit on any fp32 gates (both
  sides compute the same 0/1 slots and the same renormalised values); the
  aux loss bit for bit on dyadic gates (multiples of 1/16: every sum and
  mean is exact in any order, and ties are frequent), and within 4e-7
  relative on softmax gates, whose two means over the tokens are fp32 sums
  in another order (one or two ulp).
- ``_moe_mlp``, ``moe_forward`` and ``moe_loss_fn``: the same fp32 products
  summed in another order: within 1e-5 of the output's largest magnitude
  (logits: of 1), the aux loss and the loss within 1e-5 relative. The
  routing itself must agree exactly (checked through ``_route`` on the
  JAX side's gates).
- gradients: within 1e-4 of each leaf's largest gradient
  (``tests/test_torch_train.py``'s rule), router and experts included, and
  both non-zero.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import moe as jax_moe
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu_torch.models import llama, moe
from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
from flash_attention_from_scratch_tpu_torch.ops.configs import DType

SHAPE = dict(vocab_size=128, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=128, n_experts=4, expert_top_k=2)


def _configs(**extra):
    fields = {**SHAPE, **extra}
    jcfg = jax_moe.MoEConfig(**fields, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    return jcfg, moe.MoEConfig(**fields, dtype=DType.FP32)


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg, _ = _configs()
    return jax_moe.init_moe_params(jcfg, jax.random.PRNGKey(0))


def _port_params():
    return llama.params_from_jax(jax.device_get(_jax_params()), device="cpu")


def _tokens(shape=(2, 129)):
    return np.random.default_rng(5).integers(0, SHAPE["vocab_size"], shape)


def _softmax_gates(t, e, seed):
    g = np.exp(np.random.default_rng(seed).standard_normal((t, e))).astype(np.float32)
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


def _dyadic_gates(t, e, seed):
    """Rows of multiples of 1/16 summing to 1: exact sums in any order, many
    ties inside a row (and ties for the top value)."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, 17, (t, e - 1)), axis=1)
    edges = np.concatenate([np.zeros((t, 1)), cuts, np.full((t, 1), 16)], axis=1)
    return (np.diff(edges, axis=1) / 16.0).astype(np.float32)


@pytest.mark.parametrize("factor", [1.0, 1.25, 2.0, 4.0])
def test_capacity_equals_jax(factor):
    jcfg, cfg = _configs(capacity_factor=factor)
    for n in list(range(0, 300)) + [1000, 4096, 4097, 8191, 32768]:
        assert moe._capacity(cfg, n) == jax_moe._capacity(jcfg, n), n


def _route_both(gates, capacity, **extra):
    jcfg, cfg = _configs(**extra)
    jd, jc, ja = jax_moe._route(jcfg, jnp.asarray(gates), capacity)
    td, tc, ta = moe._route(cfg, torch.from_numpy(np.array(gates)), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    return float(ja), float(ta)


@pytest.mark.parametrize("t,capacity", [(8, 8), (64, None), (257, None), (257, 8),
                                        (1000, 200)])
def test_route_equals_jax_on_softmax_gates(t, capacity):
    jcfg, _ = _configs()
    capacity = capacity or jax_moe._capacity(jcfg, t)
    ja, ta = _route_both(_softmax_gates(t, 4, t), capacity)
    assert abs(ta - ja) <= 4e-7 * abs(ja), (ta, ja)


@pytest.mark.parametrize("t,capacity,top_k", [(64, None, 2), (64, 8, 2), (200, 16, 2),
                                              (64, None, 4), (33, 8, 3)])
def test_route_equals_jax_exactly_on_ties(t, capacity, top_k):
    """Dyadic gates: ties everywhere (JAX's top_k puts the lower index first),
    and every sum exact, so the aux loss is bit for bit too."""
    gates = _dyadic_gates(t, 4, t + top_k)
    assert (np.sort(gates, axis=1)[:, -1] == np.sort(gates, axis=1)[:, -2]).any()
    jcfg, _ = _configs(expert_top_k=top_k)
    ja, ta = _route_both(gates, capacity or jax_moe._capacity(jcfg, t),
                         expert_top_k=top_k)
    assert ta == ja


def test_route_drops_over_capacity_as_jax():
    """tests/test_moe.py::test_route_drops_over_capacity: one expert every
    token wants, capacity 8, top 1 and top 2; ties among the other three."""
    gates = np.zeros((32, 4), np.float32)
    gates[:, 0] = 1.0
    for k in (1, 2):
        ja, ta = _route_both(gates, 8, expert_top_k=k)
        assert ta == ja
    _, cfg = _configs(expert_top_k=1)
    d, c, _ = moe._route(cfg, torch.from_numpy(gates), 8)
    assert d[:, 0].sum() == 8 and c.sum((1, 2))[8:].max() == 0


def test_moe_mlp_matches_jax():
    jcfg, cfg = _configs()
    x = np.random.default_rng(2).standard_normal((2, 64, SHAPE["dim"])).astype(np.float32)
    layer_j = _jax_params()["layers"][0]
    layer_t = _port_params()["layers"][0]
    jout, jaux = jax_moe._moe_mlp(jcfg, layer_j, jnp.asarray(x))
    tout, taux = moe._moe_mlp(cfg, layer_t, torch.from_numpy(x))
    # The routing agrees exactly: the port's route on JAX's gates is JAX's.
    gates = np.asarray(jax.nn.softmax(jnp.asarray(x).reshape(-1, SHAPE["dim"])
                                      @ layer_j["router"], axis=-1))
    _route_both(gates, moe._capacity(cfg, 128))
    jout = np.asarray(jout)
    scale = np.abs(jout).max()
    assert np.abs(tout.numpy() - jout).max() <= 1e-5 * scale
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_moe_forward_and_loss_match_jax():
    jcfg, cfg = _configs()
    tokens = _tokens()
    jlogits, jaux = jax_moe.moe_forward(_jax_params(), jnp.asarray(tokens[:, :-1]), jcfg)
    params = _port_params()
    with torch.no_grad():
        tlogits, taux = moe.moe_forward(params, torch.from_numpy(tokens[:, :-1]), cfg)
        tloss = moe.moe_loss_fn(params, torch.from_numpy(tokens), cfg)
    jloss = jax_moe.moe_loss_fn(_jax_params(), jnp.asarray(tokens), jcfg)
    assert tlogits.dtype == torch.float32 and tlogits.shape == (2, 128, SHAPE["vocab_size"])
    assert np.abs(tlogits.numpy() - np.asarray(jlogits)).max() <= 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))


def test_moe_forward_mirrors_jax_without_embed_scale_and_softcap():
    """JAX's moe_forward reads the embedding row as it is and takes no final
    softcap (the serving path applies both); the port mirrors it."""
    jcfg, cfg = _configs(embed_scale=True, final_softcap=1.0)
    tokens = _tokens((1, 129))[:, :128]
    jlogits, _ = jax_moe.moe_forward(_jax_params(), jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        tlogits, _ = moe.moe_forward(_port_params(), torch.from_numpy(tokens), cfg)
    assert np.abs(tlogits.numpy() - np.asarray(jlogits)).max() <= 1e-5
    assert np.abs(np.asarray(jlogits)).max() > 1.0  # no softcap on either side


def test_moe_grads_match_jax():
    jcfg, cfg = _configs()
    tokens = _tokens()
    jloss, jgrads = jax.value_and_grad(jax_moe.moe_loss_fn)(_jax_params(),
                                                            jnp.asarray(tokens), jcfg)
    params = _port_params()
    leaves = list(param_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss = moe.moe_loss_fn(params, torch.from_numpy(tokens), cfg)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    got = [p.grad.numpy() for p in param_leaves(params)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-12
    layer = params["layers"][0]
    assert float(layer["router"].grad.abs().max()) > 0
    assert float(layer["experts"]["w_down"].grad.abs().max()) > 0


def test_params_from_jax_carries_the_moe_tree():
    params = _port_params()
    layer = params["layers"][1]
    assert set(layer) == {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router",
                          "experts"}
    assert layer["router"].dtype == torch.float32
    jlayer = _jax_params()["layers"][1]
    for k in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(layer["experts"][k].numpy(),
                                      np.asarray(jlayer["experts"][k]))
    # bf16 experts stay bf16 and exact; the router stays fp32.
    jcfg16 = dataclasses.replace(_configs()[0], dtype=JaxDType.BF16)
    tree = jax.device_get(jax_moe.init_moe_params(jcfg16, jax.random.PRNGKey(1)))
    p16 = llama.params_from_jax(tree, device="cpu")["layers"][0]
    assert p16["experts"]["w_up"].dtype == torch.bfloat16
    assert p16["router"].dtype == torch.float32
    np.testing.assert_array_equal(p16["experts"]["w_up"].float().numpy(),
                                  np.asarray(tree["layers"][0]["experts"]["w_up"], np.float32))


def test_init_moe_params_tree_and_scale():
    _, cfg = _configs()
    params = moe.init_moe_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jtree = _jax_params()
    assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda x: 0, jtree))
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(
                lambda x: 0, {k: v for k, v in params.items()})))
    e = params["layers"][0]["experts"]
    assert e["w_gate"].shape == (4, 256, 128) and e["w_down"].shape == (4, 128, 256)
    # normal / sqrt(fan_in): the standard deviation times sqrt(fan_in) is ~1.
    assert abs(float(e["w_gate"].std()) * 256 ** 0.5 - 1) < 0.05
    assert abs(float(e["w_down"].std()) * 128 ** 0.5 - 1) < 0.05
    assert params["layers"][0]["router"].dtype == torch.float32
