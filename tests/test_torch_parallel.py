"""The port's parallel layer (4 gloo ranks on the CPU) vs the JAX package.

One group of 4 ranks for the whole module
(``tests/torch_parallel_ranks.py::parallel_ranks``) runs every case on a
(dp 2, tp 2) mesh and an sp 4 mesh of the same ranks; the JAX side runs in
this process on the virtual CPU devices, Pallas in interpret mode, at the
JAX sharding tests' sizes, on the same numpy inputs and the JAX package's
own random parameters (``params_from_jax``). Tolerances are the JAX tests':

- ``shard_mapped_attention`` on a (2, 2) mesh, with and without sinks:
  the output within atol 8e-3 / rtol 2e-2 of JAX's, the gradients (q, k,
  v and the sinks, whose gradient both sum over dp) within atol 2e-2 /
  rtol 5e-2 (``tests/test_parallel.py``);
- the model's loss on the tp mesh against JAX ``loss_fn`` on the same
  mesh, and on the sp mesh (the ring, also with a 200-token window)
  against JAX's single-device loss, within 5e-2 (JAX's context-parallel
  tests); the fused model's forward, sharded by part, against JAX's fused
  forward on the mesh within 5e-2 (JAX's fused-vs-unfused bound);
- one AdamW step on the (2, 2) mesh from JAX's ``test_sharded_train_step``
  set-up: the loss within 5e-2 of JAX's, the updated ``wq`` within 4 lr
  plus one bf16 ulp of JAX's (a near-zero gradient's sign is noise, and a
  first Adam step moves its element by about +-lr either way), the
  parameters moved, and each rank's shard shapes those of JAX's
  ``addressable_shards``;
- the same step in fp32: the gradients each rank's AdamW receives (after
  the dp sum) against ``jax.grad`` of JAX's ``loss_fn`` on the mesh, each
  rank's shard within 1e-4 of the leaf's largest gradient (the port's
  single-device training rule); with a fault planted in the step (the dp
  sum left out, copy_to's all-reduce halved) the same comparison is off by
  more than 10 % of some leaf's scale.

Also without ranks: ``llama_param_specs`` equals JAX's on plain, fused,
Qwen2-bias and sink trees; ``make_mesh`` refuses NCCL without a card a rank;
the launcher turns a hang into a failure.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.models import train as jax_train
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.ops.configs import KernelConfig as JaxKernelConfig
from flash_attention_from_scratch_tpu.parallel import mesh as jax_mesh
from flash_attention_from_scratch_tpu.parallel.sharded_attention import (
    shard_mapped_attention as jax_shard_mapped,
)
from flash_attention_from_scratch_tpu_torch.models.llama import params_from_jax
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.parallel.launch import spawn
from flash_attention_from_scratch_tpu_torch.parallel.mesh import llama_param_specs, make_mesh

import torch_parallel_ranks as ranks

LOSS_SHAPE = dict(vocab_size=128, dim=256, n_layers=1, n_heads=2, n_kv_heads=2,
                  d_head=128, hidden_dim=256)
TRAIN_SHAPE = dict(vocab_size=128, dim=512, n_layers=1, n_heads=4, n_kv_heads=4,
                   d_head=128, hidden_dim=256)
QUANT_SHAPE = dict(vocab_size=128, dim=512, n_layers=1, n_heads=4, n_kv_heads=2,
                   d_head=128, hidden_dim=256)


def _jcfg(shape, **extra):
    return jax_llama.LlamaConfig(**shape, **extra, block_q=128, block_kv=128)


def _port(tree):
    return params_from_jax(jax.device_get(tree), device="cpu")


@pytest.fixture(scope="module")
def jax_setup():
    loss_params = jax_llama.init_params(_jcfg(LOSS_SHAPE), jax.random.PRNGKey(0))
    loss_tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 513), 0, 128))
    train_params = jax_llama.init_params(_jcfg(TRAIN_SHAPE), jax.random.PRNGKey(0))
    train_tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 129), 0, 128))
    fp32_params = jax_llama.init_params(_jcfg(TRAIN_SHAPE, dtype=JaxDType.FP32),
                                        jax.random.PRNGKey(0))
    qcfg = _jcfg(QUANT_SHAPE)
    return dict(
        loss=(loss_params, loss_tokens), train=(train_params, train_tokens),
        train_fp32=fp32_params,
        int8=jax_llama.quantize_params(jax_llama.init_params(qcfg, jax.random.PRNGKey(0)),
                                       "int8"),
        int4=jax_llama.init_quantized_params(qcfg, jax.random.PRNGKey(0), "int4"))


@pytest.fixture(scope="module")
def rank_dir(tmp_path_factory, jax_setup):
    (lp, lt), (tparams, tt) = jax_setup["loss"], jax_setup["train"]
    setup = {
        "loss": {"params": _port(lp), "cfg": LOSS_SHAPE, "tokens": torch.from_numpy(lt).long()},
        "train": {"params": _port(tparams), "cfg": TRAIN_SHAPE, "tokens": torch.from_numpy(tt).long()},
        "train_fp32": {"params": _port(jax_setup["train_fp32"]),
                       "cfg": {**TRAIN_SHAPE, "dtype": DType.FP32}},
        "fused": _port(jax_llama.fuse_projections(tparams)),
        "int8": _port(jax_setup["int8"]), "int4": _port(jax_setup["int4"]),
    }
    out = tmp_path_factory.mktemp("parallel")
    staged = spawn(ranks.parallel_ranks, ranks.PAR_WORLD, backend="gloo", device="cpu",
                   args=(str(out), setup), timeout=300)
    assert staged == [0] * ranks.PAR_WORLD  # CPU tensors are never staged
    return str(out)


@pytest.fixture(scope="module")
def mesh22(cpu_mesh_devices):
    return jax_mesh.make_mesh(2, 2, devices=cpu_mesh_devices[:4])


def _np(x):
    return np.asarray(x, np.float32)


def _blocks(parts, dims=(0, 1)):
    """Reassemble rank blocks of a (dp 2, tp 2) mesh: rank = 2 * dp + tp."""
    rows = [torch.cat([parts[2 * d + t] for t in range(2)], dims[1]) for d in range(2)]
    return torch.cat(rows, dims[0])


@pytest.mark.parametrize("name", ["attn_plain", "attn_sinks"])
def test_shard_mapped_attention_matches_jax(rank_dir, mesh22, name):
    parts = ranks.load(rank_dir, name, ranks.PAR_WORLD)
    causal = name == "attn_sinks"
    cfg = JaxKernelConfig(block_q=128, block_kv=128, causal=causal)
    q, k, v, do = (jnp.asarray(x, jnp.bfloat16) for x in ranks.attn_inputs())
    z = jnp.asarray(ranks.ATTN_SINKS) if causal else None
    put = lambda x: jax.device_put(x, NamedSharding(mesh22, P("dp", "tp", None, None)))  # noqa: E731
    args = [put(q), put(k), put(v)]
    if z is not None:
        args.append(jax.device_put(z, NamedSharding(mesh22, P("tp"))))

    def loss(*xs):
        out = jax_shard_mapped(*xs[:3], cfg, mesh22, interpret=True,
                               sinks=xs[3] if len(xs) > 3 else None)
        return jnp.sum(out * put(do)), out

    (_, want), grads = jax.value_and_grad(loss, argnums=tuple(range(len(args))),
                                          has_aux=True)(*args)
    got = _blocks([p["out"] for p in parts])
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=8e-3, rtol=2e-2)
    for i, what in enumerate("qkv"):
        g = _blocks([p["grads"][i] for p in parts])
        np.testing.assert_allclose(g.float().numpy(), _np(grads[i]), atol=2e-2, rtol=5e-2,
                                   err_msg=f"d{what}")
    if z is not None:
        # Each rank holds its heads' d(sinks), summed over dp: equal on
        # both dp rows.
        dz = [p["grads"][3] for p in parts]
        assert torch.equal(dz[0], dz[2]) and torch.equal(dz[1], dz[3])
        np.testing.assert_allclose(torch.cat(dz[:2]).numpy(), _np(grads[3]),
                                   atol=2e-2, rtol=5e-2, err_msg="dsinks")


def test_loss_on_the_tp_mesh_matches_jax(rank_dir, jax_setup, mesh22):
    params, tokens = jax_setup["loss"]
    with mesh22:
        want = float(jax_llama.loss_fn(jax_mesh.shard_params(params, mesh22),
                                       jnp.asarray(tokens), _jcfg(LOSS_SHAPE),
                                       interpret=True, mesh=mesh22))
    got = ranks.load(rank_dir, "loss_tp", ranks.PAR_WORLD)
    assert len(set(got)) == 1 and abs(got[0] - want) < 5e-2, (got, want)


@pytest.mark.parametrize("name,extra", [("sp", {}), ("sp_window", dict(sliding_window=200))])
def test_loss_on_the_sp_mesh_matches_jax_single(rank_dir, jax_setup, name, extra):
    params, tokens = jax_setup["loss"]
    want = float(jax_llama.loss_fn(params, jnp.asarray(tokens), _jcfg(LOSS_SHAPE, **extra),
                                   interpret=True))
    got = ranks.load(rank_dir, f"loss_{name}", ranks.PAR_WORLD)
    assert len(set(got)) == 1 and abs(got[0] - want) < 5e-2, (got, want)


def test_fused_forward_by_part_matches_jax(rank_dir, jax_setup, mesh22):
    params, tokens = jax_setup["train"]
    fused = jax_llama.fuse_projections(params)
    with mesh22:
        want = _np(jax_llama.forward(jax_mesh.shard_params(fused, mesh22),
                                     jnp.asarray(tokens[:, :128]), _jcfg(TRAIN_SHAPE),
                                     interpret=True, mesh=mesh22))
    parts = ranks.load(rank_dir, "fused_forward", ranks.PAR_WORLD)
    # Every tp rank holds its dp row's whole logits (the vocab gathered).
    assert torch.equal(parts[0], parts[1]) and torch.equal(parts[2], parts[3])
    got = torch.cat([parts[0], parts[2]], 0).numpy()
    assert np.abs(got - want).max() < 5e-2


def test_sharded_train_step_matches_jax(rank_dir, jax_setup, mesh22):
    params, tokens = jax_setup["train"]
    cfg = _jcfg(TRAIN_SHAPE)
    sharded = jax_mesh.shard_params(params, mesh22)
    opt = jax_train.make_optimizer()
    step = jax.jit(jax_train.make_train_step(cfg, opt, interpret=True, mesh=mesh22))
    with mesh22:
        params2, _, loss = step(sharded, opt.init(sharded),
                                jax.device_put(jnp.asarray(tokens),
                                               NamedSharding(mesh22, P("dp", None))))
    parts = ranks.load(rank_dir, "train", ranks.PAR_WORLD)
    assert len({p["loss"] for p in parts}) == 1
    assert abs(parts[0]["loss"] - float(loss)) < 5e-2
    wq = torch.cat([parts[0]["wq"], parts[1]["wq"]], 1).float().numpy()
    assert torch.equal(parts[0]["wq"], parts[2]["wq"])  # the dp rows step alike
    want = _np(params2["layers"][0]["wq"])
    ulp = np.abs(want) * 2.0 ** -7
    assert (np.abs(wq - want) <= 4 * ranks.LR + ulp).all()
    assert np.abs(wq - _np(params["layers"][0]["wq"])).max() > 0
    jax_shapes = {k: {tuple(s.data.shape) for s in v.addressable_shards}
                  for k, v in [("embed", params2["embed"]), ("lm_head", params2["lm_head"]),
                               *params2["layers"][0].items()]}
    for p in parts:
        assert {k: {s} for k, s in p["shapes"].items()} == jax_shapes


@pytest.fixture(scope="module")
def jax_fp32_grads(jax_setup, mesh22):
    """``jax.grad`` of JAX's ``loss_fn`` on the (2, 2) mesh in fp32, the
    train step's tokens sharded over dp: the gradients JAX's sharded train
    step hands to optax. Each leaf by name: (its global gradient, its
    parameter's JAX spec)."""
    _, tokens = jax_setup["train"]
    cfg = _jcfg(TRAIN_SHAPE, dtype=JaxDType.FP32)
    sharded = jax_mesh.shard_params(jax_setup["train_fp32"], mesh22)
    toks = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh22, P("dp", None)))
    with mesh22:
        grads = jax.jit(jax.grad(lambda p: jax_llama.loss_fn(
            p, toks, cfg, interpret=True, mesh=mesh22)))(sharded)
    specs = jax_mesh.llama_param_specs(jax_setup["train_fp32"])
    named = {}
    for tree, prefix in ((grads, ""), (grads["layers"][0], "layers.0.")):
        named.update((prefix + k, (v, tuple(specs[k] if not prefix else specs["layers"][0][k])))
                     for k, v in tree.items() if k != "layers")
    return named


def _grad_errors(parts, want, specs):
    """Per rank and leaf, the largest |port - JAX| on the rank's shard over
    the JAX leaf's largest |gradient|. A rank's shard is the block of the
    global gradient that the leaf's JAX spec gives its (dp, tp)
    coordinate."""
    out = {}
    for rank, got in enumerate(parts):
        coord = dict(zip(("dp", "tp"), divmod(rank, 2)))
        for name, g in got["grads"].items():
            w = np.asarray(want[name])
            shard = w
            for dim, axis in enumerate(specs[name]):
                if axis is not None:
                    n = w.shape[dim] // 2
                    shard = np.take(shard, range(coord[axis] * n, (coord[axis] + 1) * n), dim)
            out[rank, name] = float(np.abs(g.numpy() - shard).max()) / float(np.abs(w).max())
    return out


def _split(named):
    return {k: g for k, (g, _) in named.items()}, {k: s for k, (_, s) in named.items()}


def test_sharded_train_step_gradients_match_jax(rank_dir, jax_fp32_grads):
    """The gradients each rank's AdamW receives in one fp32 train step on
    the (2, 2) mesh, after the dp sum, against JAX's sharded gradients:
    within 1e-4 of each leaf's largest gradient (the rule of the port's
    single-device training test; both sides compute the same fp32
    products and differ in summation order). This holds the whole sharded
    backward: copy_to's all-reduce, the vocab-parallel cross-entropy, the
    gathered embedding's slice and the dp sum."""
    parts = ranks.load(rank_dir, "train_fp32", ranks.PAR_WORLD)
    assert all(len(p["grads"]) == len(jax_fp32_grads) for p in parts)
    errors = _grad_errors(parts, *_split(jax_fp32_grads))
    assert max(errors.values()) <= 1e-4, {k: e for k, e in errors.items() if e > 1e-4}


@pytest.mark.parametrize("fault", ranks.TRAIN_FAULTS)
def test_gradient_check_fails_a_planted_fault(rank_dir, jax_fp32_grads, fault):
    """The same step with a fault planted (the dp sum left out; copy_to's
    gradient all-reduce halved) breaks the 1e-4 rule by far: some leaf of
    some rank is off by more than 10 % of its scale. The loss, taken before
    the update, is unchanged."""
    parts = ranks.load(rank_dir, fault, ranks.PAR_WORLD)
    good = ranks.load(rank_dir, "train_fp32", ranks.PAR_WORLD)
    assert parts[0]["loss"] == good[0]["loss"]
    assert max(_grad_errors(parts, *_split(jax_fp32_grads)).values()) > 0.1


def test_quantized_shards_follow_their_weight(rank_dir, jax_setup, cpu_mesh_devices):
    """int8: values shard like the dense weight, scales with N on the
    column-parallel weights and whole on the row-parallel ones, each shard
    the shape of JAX's; packed int4 on a row-parallel weight raises in both."""
    mesh = jax_mesh.make_mesh(1, 2, devices=cpu_mesh_devices[:2])
    want = jax_mesh.shard_params(jax_setup["int8"], mesh)["layers"][0]
    for got in ranks.load(rank_dir, "quantized", ranks.PAR_WORLD):
        for key in ("wq", "wo", "w_gate", "w_down"):
            w = want[key]
            assert got[key] == (tuple(w.values.addressable_shards[0].data.shape),
                                tuple(w.scales.addressable_shards[0].data.shape)), key
        assert got["int4_raises"]
    with pytest.raises(NotImplementedError):
        jax_mesh.shard_params(jax_setup["int4"], mesh)


def test_collectives_and_their_transposes(rank_dir):
    """Each collective's values and gradients on every rank of the (2, 2)
    mesh's tp lines; the cross-entropy within torch's default fp32
    tolerance of the plain one on the whole vocabulary."""
    for rank, got in enumerate(ranks.load(rank_dir, "collectives", ranks.PAR_WORLD)):
        dp, tp = divmod(rank, 2)
        src, dst = 2 * dp + (tp - 1) % 2, (tp + 1) % 2
        # ppermute by one along tp; its backward sends the cotangent back.
        assert torch.equal(got["ppermute"], torch.arange(4.0) + 10 * src)
        assert torch.equal(got["ppermute_grad"], torch.arange(1.0, 5.0) * (dst + 1))
        assert torch.equal(got["gathered"], torch.tensor([2.0 * dp] * 3 + [2.0 * dp + 1] * 3))
        assert torch.equal(got["gather_grad"], torch.arange(3.0) + 3 * tp)
        assert torch.equal(got["summed"], torch.full((2,), 4.0 * dp + 3))
        assert torch.equal(got["copy_grad"], torch.full((2,), 4.0))
        # The vocab-parallel cross-entropy: F.cross_entropy on the whole
        # logits, and this rank's columns of its gradient.
        logits, targets = ranks.ce_inputs()
        whole = logits.clone().requires_grad_(True)
        want = torch.nn.functional.cross_entropy(whole, targets, reduction="none")
        (want * torch.arange(1.0, 6.0)).sum().backward()
        torch.testing.assert_close(got["ce"], want.detach())
        torch.testing.assert_close(got["ce_grad"], whole.grad[:, tp * 6:(tp + 1) * 6])


@pytest.mark.parametrize("kind", ["plain", "fused", "qwen2_bias", "sinks"])
def test_param_specs_equal_jax(kind):
    cfg = _jcfg(LOSS_SHAPE, attn_sinks=kind == "sinks")
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(0))
    if kind == "fused":
        params = jax_llama.fuse_projections(params)
    if kind == "qwen2_bias":
        for layer in params["layers"]:
            layer.update(bq=jnp.zeros(256), bk=jnp.zeros(256), bv=jnp.zeros(256),
                         bo=jnp.zeros(256))
    want = jax_mesh.llama_param_specs(params)
    got = llama_param_specs(_port(params))
    assert {k: tuple(want[k]) for k in ("embed", "final_norm", "lm_head")} == {
        k: got[k] for k in ("embed", "final_norm", "lm_head")}
    assert [{k: tuple(s) for k, s in layer.items()} for layer in want["layers"]] == got["layers"]


def test_make_mesh_refuses_nccl_without_a_card_a_rank():
    with pytest.raises(RuntimeError, match="one card a rank"):
        make_mesh(1, 2, device="cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 2)


def test_spawn_turns_a_hang_into_a_failure():
    """Rank 0 waits at a barrier that rank 1 never reaches: the collective's
    timeout (or the launcher's) fails the call in seconds."""
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        spawn(ranks.hang, 2, backend="gloo", device="cpu", timeout=5)
    assert time.monotonic() - t0 < 60
