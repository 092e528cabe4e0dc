"""The port's training path (plain kernels on the CPU) vs the JAX package.

A tiny Llama (tests/test_backward.py's train-step size, two layers) in fp32,
with the JAX package's random parameters handed over by ``params_from_jax``
and token ids from a seeded numpy generator. In fp32 both sides compute the
same products and differ only in summation order, so:

- the loss agrees within 1e-5 relative and every parameter gradient within
  1e-4 of that leaf's largest gradient (fp32 rounding of sums of ~10^3 terms
  is ~1e-6 relative; a wrong mask, softcap slope or sink term moves a
  gradient by 1e-2 or more of its scale);
- two AdamW steps move each parameter as two optax.adamw steps do, within
  2e-3 * lr wherever the gradient of both steps is at least 1e-1 of the
  leaf's largest (there m/sqrt(v) is well conditioned: the two sides differ
  by 6e-4 * lr at most, while beta2 = 0.999 for 0.95 moves it by 1e-2 *
  lr), and within 4 * lr everywhere: where a gradient is near 0 its sign
  is noise and a first Adam step moves the element by about +-lr either
  way.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.models import train as jax_train
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu_torch.models import llama, train
from flash_attention_from_scratch_tpu_torch.ops.configs import DType

SHAPE = dict(vocab_size=128, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=256)
LR = 1e-2
STEPS = 2


def _configs(**extra):
    jcfg = jax_llama.LlamaConfig(**SHAPE, **extra, block_q=128, block_kv=128,
                                 dtype=JaxDType.FP32)
    return jcfg, llama.LlamaConfig(**SHAPE, **extra, dtype=DType.FP32)


def _tokens():
    return np.random.default_rng(5).integers(0, SHAPE["vocab_size"], (2, 129))


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg, _ = _configs()
    return jax_llama.init_params(jcfg, jax.random.PRNGKey(0))


def _port_params():
    return llama.params_from_jax(jax.device_get(_jax_params()), device="cpu")


def _leaves(tree):
    """Leaves in the JAX package's tree order (dict keys sorted)."""
    return jax.tree_util.tree_leaves(tree)


def _grads(params, cfg, remat=False):
    for p in _leaves(params):
        p.requires_grad_(True)
    loss = llama.loss_fn(params, torch.from_numpy(_tokens()), cfg, remat=remat)
    loss.backward()
    return loss.detach(), [p.grad for p in _leaves(params)]


def test_loss_and_grads_match_jax_fp32():
    jcfg, cfg = _configs()
    want_loss, want = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jnp.asarray(_tokens(), jnp.int32), jcfg))(
            _jax_params())
    loss, grads = _grads(_port_params(), cfg)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = jax.tree_util.tree_leaves(want)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (i, err)


def test_remat_gives_the_same_grads():
    """Checkpointed layers recompute the same forward on the backward:
    the same gradients up to fp32 rounding (1e-6 of each leaf's scale)."""
    _, cfg = _configs()
    loss, grads = _grads(_port_params(), cfg)
    loss_r, grads_r = _grads(_port_params(), cfg, remat=True)
    assert float(loss) == float(loss_r)
    for g, gr in zip(grads, grads_r):
        assert float((g - gr).abs().max()) <= 1e-6 * float(g.abs().max())


def _jax_steps():
    jcfg, _ = _configs()
    opt = jax_train.make_optimizer(lr=LR)
    step = jax.jit(jax_train.make_train_step(jcfg, opt))
    params, state = _jax_params(), opt.init(_jax_params())
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, jnp.asarray(_tokens(), jnp.int32))
        losses.append(float(loss))
    return losses, [np.asarray(p) for p in jax.tree_util.tree_leaves(params)]


def test_train_steps_match_optax_adamw():
    _, cfg = _configs()
    params = _port_params()
    before = [p.clone() for p in _leaves(params)]
    opt = train.make_optimizer(params, lr=LR)
    step = train.make_train_step(cfg, opt)
    tokens = torch.from_numpy(_tokens())
    losses, grads = [], []
    for _ in range(STEPS):
        losses.append(float(step(params, tokens)))
        grads.append([p.grad.clone() for p in _leaves(params)])
    want_losses, want = _jax_steps()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for i, (p, p0, w) in enumerate(zip(_leaves(params), before, want)):
        moved = p.detach() - p0
        diff = (moved - (torch.from_numpy(np.array(w)) - p0)).abs()
        assert float(diff.max()) <= 2 * STEPS * LR, (i, float(diff.max()))
        steady = torch.ones_like(diff, dtype=torch.bool)
        for g in grads:
            steady &= g[i].abs() >= 1e-1 * float(g[i].abs().max())
        assert bool(steady.any()), i
        assert float(diff[steady].max()) <= 2e-3 * LR, (i, float(diff[steady].max()))


def test_make_optimizer_marks_leaves_and_updates_in_place():
    _, cfg = _configs()
    params = _port_params()
    leaves = _leaves(params)
    assert not any(p.requires_grad for p in leaves)
    opt = train.make_optimizer(params)
    assert all(p.requires_grad for p in leaves)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        3e-4, (0.9, 0.95), 1e-8, 0.1)
    first = leaves[0].detach().clone()
    train.make_train_step(cfg, opt)(params, torch.from_numpy(_tokens()))
    assert _leaves(params)[0] is leaves[0] and not torch.equal(leaves[0], first)
    assert opt.state[leaves[0]]["exp_avg"].dtype == leaves[0].dtype


@pytest.mark.parametrize("deterministic", [False, True])
def test_grad_path_runs_the_attention_backward(deterministic, monkeypatch):
    """With grads on, attention goes through flash_attention and its
    backward, the split kernels (K3) for the model's causal attention, by
    default and in PyTorch's deterministic mode (``fused_choice``);
    without, through flash_forward alone (the serving path)."""
    from flash_attention_from_scratch_tpu_torch.ops import autodiff
    from flash_attention_from_scratch_tpu_torch.ops.flash_backward import (
        fused_choice)

    calls = []
    real = autodiff.flash_backward

    def spy(*args, **kw):
        calls.append(fused_choice(kw.get("fused"), args[6].causal))
        return real(*args, **kw)

    monkeypatch.setattr(autodiff, "flash_backward", spy)
    _, cfg = _configs()
    params = _port_params()
    tokens = torch.from_numpy(_tokens())
    llama.loss_fn(params, tokens, cfg)  # no leaf requires grad
    for p in _leaves(params):
        p.requires_grad_(True)
    with torch.no_grad():
        llama.loss_fn(params, tokens, cfg)
    assert calls == []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        llama.loss_fn(params, tokens, cfg).backward()
    finally:
        torch.use_deterministic_algorithms(was)
    assert calls == [False] * SHAPE["n_layers"]
