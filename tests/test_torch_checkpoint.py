"""Checkpoints of the port (``utils/checkpoint.py``), as the JAX package's
``tests/test_checkpoint.py`` holds its own.

- Save after a training step, take another step in memory, restore, take
  that step again: the loss and every parameter equal the run without the
  round trip bit for bit (the Llama step of ``make_train_step`` and a MoE
  step on ``moe_loss_fn``, AdamW state included).
- Quantized parameters round-trip their bytes, scales, mode, recipe and
  original dtype through ``torch.load(weights_only=True)``.
- ``latest_step`` gives the JAX package's answer on the same directory
  names, a stray ``step_x`` among them.
- Restored tensors take each template leaf's device and dtype; a template
  of another structure raises ``ValueError``.
"""

import os

import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.utils import checkpoint as jax_checkpoint
from flash_attention_from_scratch_tpu_torch.models import llama, moe, train
from flash_attention_from_scratch_tpu_torch.models.train import param_leaves
from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import QuantizedWeight
from flash_attention_from_scratch_tpu_torch.utils.checkpoint import (
    latest_step, restore_checkpoint, save_checkpoint,
)

SHAPE = dict(vocab_size=128, dim=256, n_layers=1, n_heads=2, n_kv_heads=1,
             d_head=128, hidden_dim=256)


def _model(kind):
    """(params, step(params, tokens) -> loss) with its AdamW optimizer."""
    gen = torch.Generator().manual_seed(0)
    if kind == "llama":
        cfg = llama.LlamaConfig(**SHAPE)
        params = llama.init_params(cfg, gen, device="cpu")
        opt = train.make_optimizer(params, lr=1e-2)
        return params, opt, train.make_train_step(cfg, opt)
    cfg = moe.MoEConfig(**SHAPE, n_experts=4)
    params = moe.init_moe_params(cfg, gen, device="cpu")
    opt = train.make_optimizer(params, lr=1e-2)

    def step(params, tokens):
        opt.zero_grad(set_to_none=True)
        loss = moe.moe_loss_fn(params, tokens, cfg)
        loss.backward()
        opt.step()
        return loss.detach()

    return params, opt, step


@pytest.mark.parametrize("kind", ["llama", "moe"])
def test_roundtrip_and_resume(tmp_path, kind):
    params, opt, step = _model(kind)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 129)))
    step(params, tokens)
    save_checkpoint(str(tmp_path), {"params": params, "opt": opt.state_dict()}, 1)
    assert latest_step(str(tmp_path)) == 1

    # Diverge in memory, then restore and take the same step again.
    loss_a = step(params, tokens)
    p2 = [p.detach().clone() for p in param_leaves(params)]
    restored = restore_checkpoint(str(tmp_path), {"params": params, "opt": opt.state_dict()})
    with torch.no_grad():
        for p, r in zip(param_leaves(params), param_leaves(restored["params"])):
            p.copy_(r)
    opt.load_state_dict(restored["opt"])
    loss_b = step(params, tokens)
    assert float(loss_a) == float(loss_b)
    for a, b in zip(p2, param_leaves(params)):
        assert torch.equal(a, b.detach())


@pytest.mark.parametrize("mode,act", [("int8", "bf16"), ("int4", "int8")])
def test_quantized_params_roundtrip(tmp_path, mode, act):
    cfg = llama.LlamaConfig(**SHAPE)
    params = llama.quantize_params(
        llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), mode, act=act)
    save_checkpoint(str(tmp_path), params, 0)
    restored = restore_checkpoint(str(tmp_path), params)
    for key in ("wq", "w_down"):
        w0, w1 = params["layers"][0][key], restored["layers"][0][key]
        assert isinstance(w1, QuantizedWeight)
        assert (w1.mode, w1.act, w1.orig_dtype) == (mode, act, torch.bfloat16)
        assert torch.equal(w0.values, w1.values) and torch.equal(w0.scales, w1.scales)
    assert torch.equal(params["embed"], restored["embed"])


@pytest.mark.parametrize("names", [
    [], ["step_00000003", "step_00000010", "step_x", "other"],
    ["step_x", "step_", "notes"], ["step_7", "step_00000002", "step_-1"],
])
def test_latest_step_matches_jax(tmp_path, names):
    for n in names:
        os.makedirs(tmp_path / n)
    assert latest_step(str(tmp_path)) == jax_checkpoint.latest_step(str(tmp_path))
    missing = str(tmp_path / "missing")
    assert latest_step(missing) is None and jax_checkpoint.latest_step(missing) is None
    if latest_step(str(tmp_path)) is None:
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(str(tmp_path), {})


def test_restore_takes_the_templates_device_and_dtype(tmp_path):
    state = {"w": torch.randn(4, 8).to(torch.bfloat16), "n": [torch.arange(3), 2.5],
             "q": QuantizedWeight(torch.ones(8, 2, dtype=torch.int8), torch.ones(2), "int8")}
    save_checkpoint(str(tmp_path), state, 5)
    save_checkpoint(str(tmp_path), state, 5)  # saving a step again replaces it
    template = {"w": torch.empty(4, 8, dtype=torch.float32, device="meta"),
                "n": [torch.empty(3, dtype=torch.int64, device="meta"), 0.0],
                "q": QuantizedWeight(torch.empty(8, 2, dtype=torch.int8, device="meta"),
                                     torch.empty(2, device="meta"), "int8")}
    got = restore_checkpoint(str(tmp_path), template, step=5)
    assert got["w"].device.type == "meta" and got["w"].dtype == torch.float32
    assert got["n"][0].device.type == "meta" and got["n"][1] == 2.5
    assert got["q"].values.device.type == "meta"
    on_cpu = restore_checkpoint(str(tmp_path), {**template, "w": torch.empty(4, 8)})
    assert torch.equal(on_cpu["w"], state["w"].float())
    for bad in ({"w": template["w"]}, {**template, "w": torch.empty(8, 4)},
                {**template, "n": [template["n"][0]]}):
        with pytest.raises(ValueError, match="checkpoint"):
            restore_checkpoint(str(tmp_path), bad)
