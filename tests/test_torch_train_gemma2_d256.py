"""Training Gemma-2 at head width 256 on the CPU: the port against the JAX
package.

``tests/test_torch_gemma2_d256.py``'s tiny Gemma-2 (d_head 256, 2 layers: a
64-token window on layer 0, layer 1 global; softcaps 50 / 30, the sandwich
norms, the GeLU MLP, the sqrt(dim) embedding scale) in fp32, its JAX
parameters carried across by ``params_from_jax``, on tokens of length 129
(128 positions, past the window) from a seeded numpy generator. The port
runs its plain backward (CPU tensors), the JAX package ``jax.value_and_grad``
of its ``loss_fn`` over its kernels in interpret mode. In fp32 both sides
differ only in summation order, so (``tests/test_torch_train.py``'s rule)
the loss agrees within 1e-5 relative and every parameter gradient within
1e-4 of that leaf's largest. A planted fault in the port's backward (the
window or the softcap dropped from the plain backward alone) must fail the
same check.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu_torch.models import llama
from flash_attention_from_scratch_tpu_torch.ops import flash_backward as fb
from flash_attention_from_scratch_tpu_torch.ops.configs import DType

WINDOW = 64
SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, d_head=256,
             hidden_dim=256, window_pattern=(WINDOW, 0), mlp_act="gelu", post_norms=True,
             embed_scale=True, attn_softcap=50.0, final_softcap=30.0,
             attn_scale=256 ** -0.5)
JCFG = jax_llama.LlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
CFG = llama.LlamaConfig(**SHAPE, dtype=DType.FP32)


def _tokens():
    return np.random.default_rng(7).integers(0, SHAPE["vocab_size"], (1, 129))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    params = jax_llama.init_params(JCFG, jax.random.PRNGKey(3))
    loss, grads = jax.value_and_grad(
        lambda p: jax_llama.loss_fn(p, jnp.asarray(_tokens(), jnp.int32), JCFG))(params)
    return (jax.device_get(params), float(loss),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def _port_loss_and_grads():
    jparams, _, _ = _jax_loss_and_grads()
    params = llama.params_from_jax(jparams, device="cpu")
    leaves = jax.tree_util.tree_leaves(params)  # the JAX package's tree order
    for p in leaves:
        p.requires_grad_(True)
    loss = llama.loss_fn(params, torch.from_numpy(_tokens()), CFG)
    loss.backward()
    return float(loss.detach()), [p.grad for p in leaves]


def _worst_gap():
    """(loss gap relative to JAX's, worst gradient gap over its leaf's
    largest JAX gradient)."""
    _, want_loss, want = _jax_loss_and_grads()
    loss, grads = _port_loss_and_grads()
    assert len(grads) == len(want)
    gaps = [float(np.abs(g.numpy() - w).max()) / float(np.abs(w).max())
            for g, w in zip(grads, want)]
    return abs(loss - want_loss) / abs(want_loss), max(gaps)


def test_config_crosses_the_window():
    assert CFG.d_head == JCFG.d_head == 256
    assert [CFG.layer_window(i) for i in range(2)] == [WINDOW, 0]
    assert _tokens().shape[1] - 1 > WINDOW


def test_loss_and_grads_match_jax_fp32():
    loss_gap, grad_gap = _worst_gap()
    assert loss_gap <= 1e-5 and grad_gap <= 1e-4, (loss_gap, grad_gap)


def _no_window(sq, skv, cfg, device, real=fb._visible):
    return real(sq, skv, dataclasses.replace(cfg, window=0), device)


def _no_softcap(q, k, v, lse, dsum, do, cfg, scale, real=fb._plain_from_rows):
    return real(q, k, v, lse, dsum, do, dataclasses.replace(cfg, attn_softcap=0.0), scale)


@pytest.mark.parametrize("name,fault", [("_visible", _no_window),
                                        ("_plain_from_rows", _no_softcap)],
                         ids=["window dropped", "softcap dropped"])
def test_planted_backward_fault_fails_the_check(name, fault, monkeypatch):
    """The forward and the loss stay right; only the backward is wrong, and
    some gradient moves by more than 1e-4 of its leaf's scale (the random
    model's scores are small beside the cap of 50, so the softcap's slope
    moves the gradients by ~3e-3 of their scale, the window by far more)."""
    monkeypatch.setattr(fb, name, fault)
    loss_gap, grad_gap = _worst_gap()
    assert loss_gap <= 1e-5 and grad_gap > 1e-4, (loss_gap, grad_gap)
