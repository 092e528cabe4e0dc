"""A model trained in fp16 on the CPU: the port against the JAX package.

A tiny Llama-shaped config in fp16 (``LlamaConfig.dtype`` FP16: 2 layers,
dim 256, 2/1 heads of 128, vocab 256), its JAX parameters from a PRNG key
carried across by ``params_from_jax``, on token ids from a seeded numpy
generator (batch 2, 128 positions). The port runs its plain kernel versions
(CPU tensors; on the card the same model runs K1 and K2/K3 from their fp16
libraries, ``chip_smoke.py``'s ``train_fp16``), the JAX package
``jax.value_and_grad`` of its ``loss_fn`` over its Pallas kernels in
interpret mode.

- The loss and every parameter gradient, leaf by leaf, by the adaptive rule
  (``utils/testing.py::adaptive_tolerance_check``, fp16's eps): the port in
  fp16 against JAX in fp16, with JAX in fp32 on the same fp16 weights as the
  reference; with and without ``remat`` on the fp16 sides.
- One SGD step (``optax.sgd`` in JAX, ``torch.optim.SGD`` in the port, both
  through ``make_train_step``) moves each parameter alike: within the
  learning rate times the two gradients' gap plus two fp16 units of the
  parameter (optax rounds lr * g to fp16 before adding it, torch's SGD
  rounds once).
- The trap: the JAX package's default optimizer (``optax.adamw``, eps 1e-8,
  which is 0 in fp16) gives non-finite fp16 parameters after one step, and
  the port's ``make_optimizer`` raises ``ValueError`` on fp16 leaves.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.models import train as jax_train
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu_torch.models import llama, train
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.utils.testing import adaptive_tolerance_check

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, d_head=128,
             hidden_dim=256)
JCFG = jax_llama.LlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP16)
JCFG32 = jax_llama.LlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
CFG = llama.LlamaConfig(**SHAPE, dtype=DType.FP16)
LR = 0.1
EPS16 = float(np.finfo(np.float16).eps)


def _tokens():
    return np.random.default_rng(11).integers(0, SHAPE["vocab_size"], (2, 129))


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.device_get(jax_llama.init_params(JCFG, jax.random.PRNGKey(2)))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(dtype: str, remat: bool):
    """(loss, gradient leaves as numpy) of the JAX loss on the fp16
    parameters (cast to fp32 for ``dtype`` "fp32")."""
    cfg = {"fp16": JCFG, "fp32": JCFG32}[dtype]
    params = _jax_params()
    if dtype == "fp32":
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), params)
    loss, grads = jax.value_and_grad(lambda p: jax_llama.loss_fn(
        p, jnp.asarray(_tokens(), jnp.int32), cfg, remat=remat))(params)
    return float(loss), [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(grads)]


def _port_params():
    return llama.params_from_jax(_jax_params(), device="cpu")


def _port_loss_and_grads(remat):
    params = _port_params()
    leaves = jax.tree_util.tree_leaves(params)  # the JAX package's tree order
    for p in leaves:
        p.requires_grad_(True)
    loss = llama.loss_fn(params, torch.from_numpy(_tokens()), CFG, remat=remat)
    loss.backward()
    return float(loss.detach()), [p.grad for p in leaves]


def test_config_is_fp16():
    assert {p.dtype for p in jax.tree_util.tree_leaves(_port_params())} == {torch.float16}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_grads_match_jax_fp16(remat):
    loss16, want16 = _jax_loss_and_grads("fp16", remat)
    loss32, want32 = _jax_loss_and_grads("fp32", False)  # remat recomputes it exactly
    loss, grads = _port_loss_and_grads(remat)
    assert abs(loss - loss16) <= 2 * abs(loss16 - loss32) + 2 * EPS16 * abs(loss32), (
        loss, loss16, loss32)
    assert len(grads) == len(want16) == len(want32)
    for i, (g, w16, w32) in enumerate(zip(grads, want16, want32)):
        assert g.dtype == torch.float16 and bool(torch.isfinite(g).all()), i
        ok, kernel_err, bound = adaptive_tolerance_check(
            g.float(), torch.from_numpy(w16.copy()).half(), torch.from_numpy(w32.copy()))
        assert ok, (i, g.shape, kernel_err, bound)


@functools.lru_cache(maxsize=None)
def _jax_sgd_step():
    step = jax_train.make_train_step(JCFG, optax.sgd(LR))
    params = _jax_params()
    new, _, loss = step(params, optax.sgd(LR).init(params), jnp.asarray(_tokens(), jnp.int32))
    return float(loss), [np.asarray(p, np.float32) for p in jax.tree_util.tree_leaves(new)]


def test_sgd_step_matches_jax():
    params = _port_params()
    leaves = jax.tree_util.tree_leaves(params)
    before = [p.detach().float().clone() for p in leaves]
    for p in leaves:
        p.requires_grad_(True)
    step = train.make_train_step(CFG, torch.optim.SGD(leaves, lr=LR))
    loss = float(step(params, torch.from_numpy(_tokens())))
    want_loss, want = _jax_sgd_step()
    _, grads16 = _jax_loss_and_grads("fp16", False)
    assert abs(loss - want_loss) <= 1e-3 * abs(want_loss), (loss, want_loss)
    moved = 0
    for i, (p, p0, w, g16) in enumerate(zip(leaves, before, want, grads16)):
        got = p.detach()
        assert got.dtype == torch.float16, i
        gap = (got.float() - torch.from_numpy(w)).abs()
        top = np.maximum(np.abs(w), np.maximum(p0.abs().numpy(), got.float().abs().numpy()))
        unit = torch.from_numpy(np.spacing(top.astype(np.float16)).astype(np.float32))
        bound = LR * (p.grad.float() - torch.from_numpy(g16)).abs() + 2 * unit
        assert bool((gap <= bound).all()), (i, float((gap - bound).max()))
        moved += int((got.float() != p0).sum())
    assert moved > 0


def test_default_adamw_breaks_fp16_and_the_port_refuses_it():
    """JAX's ``make_train_step`` with its default optimizer (optax.adamw)
    on the fp16 parameters: some parameter is non-finite after one step.
    The port's ``make_optimizer`` raises on the same leaves, naming the
    trap, and leaves them untouched."""
    step = jax_train.make_train_step(JCFG)
    params = _jax_params()
    new, _, loss = step(params, jax_train.make_optimizer().init(params),
                        jnp.asarray(_tokens(), jnp.int32))
    assert np.isfinite(float(loss))
    leaves = [np.asarray(p, np.float32) for p in jax.tree_util.tree_leaves(new)]
    assert any(not np.isfinite(x).all() for x in leaves)
    port = _port_params()
    with pytest.raises(ValueError, match="fp16.*eps 1e-8.*underflow"):
        train.make_optimizer(port)
    assert not any(p.requires_grad for p in jax.tree_util.tree_leaves(port))
