"""The port's tensor-parallel serving (2 gloo ranks on the CPU) vs the JAX
package.

One group of 2 ranks for the whole module
(``tests/torch_parallel_ranks.py::decode_ranks``) runs ``prefill``,
``decode_step`` and ``verify_step`` with a tp 2 mesh at
``tests/test_sharded_decode.py``'s set-up, serves with
``GenerationServer(mesh=)`` at ``tests/test_generate.py``'s tensor-parallel
set-up (dense weights, and int8 weights with an int8 cache), and hits the
JAX server's four mesh refusals. The JAX side runs in this process on the
virtual CPU devices, in interpret mode, on the JAX package's own random
parameters (``params_from_jax``). Tolerances are the JAX tests':

- the logits of each step within 6e-2 of JAX's on the same tp mesh, and
  the K pages prefill wrote within 3e-2 (each rank holds its KV heads);
- the served tokens equal on both ranks, and equal to the JAX
  single-device server's; where a token differs, its logit sits within
  0.1 of the row max of JAX's full-recompute ``forward`` on the same
  context (the JAX tensor-parallel server test's teacher forcing).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from flash_attention_from_scratch_tpu.models import decode as jax_decode
from flash_attention_from_scratch_tpu.models import llama as jax_llama
from flash_attention_from_scratch_tpu.models import lora as jax_lora
from flash_attention_from_scratch_tpu.parallel import mesh as jax_mesh
from flash_attention_from_scratch_tpu.serving.generate import GenerationServer as JaxServer
from flash_attention_from_scratch_tpu_torch.models.llama import LlamaConfig, params_from_jax
from flash_attention_from_scratch_tpu_torch.models.lora import lora_from_jax
from flash_attention_from_scratch_tpu_torch.parallel.launch import spawn

import torch_parallel_ranks as ranks

STEP_SHAPE = dict(vocab_size=128, dim=512, n_layers=1, n_heads=4, n_kv_heads=2,
                  d_head=128, hidden_dim=256)
SERVE_SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
                   d_head=128, hidden_dim=256)
PROMPTS = {1: list(range(10, 30)), 2: list(range(40, 45))}
NEW_TOKENS = 5
WORLD = 2


def _jcfg(shape):
    return jax_llama.LlamaConfig(**shape, block_q=128, block_kv=128)


def _port(tree):
    return params_from_jax(jax.device_get(tree), device="cpu")


def _shard_cache(cache, mesh):
    pool = NamedSharding(mesh, P(jax_mesh.MODEL_AXIS, None, None, None))
    sc = NamedSharding(mesh, P(jax_mesh.MODEL_AXIS, None))
    return dataclasses.replace(
        cache, k_pages=[jax.device_put(x, pool) for x in cache.k_pages],
        v_pages=[jax.device_put(x, pool) for x in cache.v_pages],
        k_scales=[jax.device_put(x, sc) for x in cache.k_scales],
        v_scales=[jax.device_put(x, sc) for x in cache.v_scales])


@pytest.fixture(scope="module")
def jax_steps(cpu_mesh_devices):
    """JAX's tp 2 prefill, decode step and 3-token verify step."""
    cfg = _jcfg(STEP_SHAPE)
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(0))
    mesh = jax_mesh.make_mesh(1, 2, devices=cpu_mesh_devices[:2])
    prompt, table = (jnp.asarray(x.numpy()) for x in ranks.decode_prompt())
    sharded = jax_mesh.shard_params(params, mesh)
    cache = _shard_cache(jax_decode.init_cache(cfg, ranks.DECODE_PAGES, ranks.DECODE_PAGE),
                         mesh)
    with mesh:
        logits0, cache = jax_decode.prefill(sharded, prompt.astype(jnp.int32), cfg, cache,
                                            table, prompt_len=20, interpret=True, mesh=mesh)
        pages0 = np.asarray(jax.device_get(cache.k_pages[0]), np.float32)
        token = int(jnp.argmax(logits0))
        logits1, cache = jax_decode.decode_step(
            sharded, jnp.asarray([token], jnp.int32), cfg, cache, jnp.asarray([21], jnp.int32),
            table[None], interpret=True, mesh=mesh)
        logits2, cache = jax_decode.verify_step(
            sharded, jnp.asarray([[token, 5, 6]], jnp.int32), cfg, cache,
            jnp.asarray([24], jnp.int32), table[None], interpret=True, mesh=mesh)
    return dict(params=params, token=token, prefill=logits0, decode=logits1, verify=logits2,
                k_pages_prefill=pages0,
                k_pages=np.asarray(jax.device_get(cache.k_pages[0]), np.float32))


@pytest.fixture(scope="module")
def jax_lora_steps(jax_steps, cpu_mesh_devices):
    """JAX's tp 2 prefill of two prompts with adapters 1 and -1 (2 adapters
    of rank 8, B non-zero), one decode step of both rows, then three more
    decode steps: what the port's 3-token verify step computes at once."""
    cfg = _jcfg(STEP_SHAPE)
    lora = jax_lora.init_lora_adapters(cfg, 2, 8, jax.random.PRNGKey(3), zero_b=False)
    mesh = jax_mesh.make_mesh(1, 2, devices=cpu_mesh_devices[:2])
    sharded = jax_mesh.shard_params(jax_steps["params"], mesh)
    prompts, tables = (jnp.asarray(x.numpy()) for x in ranks.lora_prompts())
    ids = jnp.asarray(ranks.LORA_IDS, jnp.int32)
    cache = _shard_cache(jax_decode.init_cache(cfg, ranks.DECODE_PAGES, ranks.DECODE_PAGE),
                         mesh)
    out = {"lora": lora}
    with mesh:
        for i in range(2):
            logits, cache = jax_decode.prefill(
                sharded, prompts[i:i + 1].astype(jnp.int32), cfg, cache, tables[i],
                prompt_len=20, interpret=True, mesh=mesh, lora=lora, adapter_ids=ids[i:i + 1])
            out[f"prefill{i}"] = np.asarray(logits)
        first = np.asarray([np.argmax(out["prefill0"]), np.argmax(out["prefill1"])], np.int32)
        logits, cache = jax_decode.decode_step(
            sharded, jnp.asarray(first), cfg, cache, jnp.asarray([21, 21], jnp.int32), tables,
            interpret=True, mesh=mesh, lora=lora, adapter_ids=ids)
        out["decode"] = np.asarray(logits)
        second = np.argmax(out["decode"], -1).astype(np.int32)
        verify = np.stack([second, [5, 5], [6, 6]], axis=1)
        rows = []
        for j in range(3):
            logits, cache = jax_decode.decode_step(
                sharded, jnp.asarray(verify[:, j]), cfg, cache,
                jnp.asarray([22 + j] * 2, jnp.int32), tables, interpret=True, mesh=mesh,
                lora=lora, adapter_ids=ids)
            rows.append(np.asarray(logits))
    out.update(verify=np.stack(rows, axis=1), tokens={"decode": first, "verify": verify},
               k_pages=np.asarray(jax.device_get(cache.k_pages[0]), np.float32))
    return out


@pytest.fixture(scope="module")
def jax_serving():
    cfg = _jcfg(SERVE_SHAPE)
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(1))
    out = {"params": params, "int8": jax_llama.quantize_params(params, "int8")}
    for name, p, mode in (("dense", params, "dense"), ("int8", out["int8"], "int8")):
        server = JaxServer(p, cfg, num_pages=32, page_size=64, max_batch=2, pages_per_seq=8,
                           mode=mode)
        for sid, prompt in PROMPTS.items():
            server.submit(sid, prompt, NEW_TOKENS)
        out[f"tokens_{name}"] = server.run()
    return out


@pytest.fixture(scope="module")
def rank_dir(tmp_path_factory, jax_steps, jax_lora_steps, jax_serving):
    setup = {
        "steps": {"params": _port(jax_steps["params"]), "cfg": LlamaConfig(**STEP_SHAPE),
                  "token": jax_steps["token"],
                  "lora": lora_from_jax(jax.device_get(jax_lora_steps["lora"]), device="cpu"),
                  "lora_tokens": {k: torch.tensor(v).long()
                                  for k, v in jax_lora_steps["tokens"].items()}},
        "serve": {"params": _port(jax_serving["params"]), "int8": _port(jax_serving["int8"]),
                  "cfg": LlamaConfig(**SERVE_SHAPE), "prompts": PROMPTS, "new": NEW_TOKENS},
    }
    out = tmp_path_factory.mktemp("sharded_decode")
    staged = spawn(ranks.decode_ranks, WORLD, backend="gloo", device="cpu",
                   args=(str(out), setup), timeout=300)
    assert staged == [0] * WORLD  # CPU tensors are never staged
    return str(out)


@pytest.mark.parametrize("step", ["prefill", "decode", "verify"])
def test_tp_step_logits_match_jax(rank_dir, jax_steps, step):
    parts = ranks.load(rank_dir, "steps", WORLD)
    assert torch.equal(parts[0][step], parts[1][step])  # every rank: the whole row
    err = float(np.abs(parts[0][step].numpy() - np.asarray(jax_steps[step], np.float32)).max())
    assert err < 6e-2, (step, err)


@pytest.mark.parametrize("when", ["k_pages_prefill", "k_pages"])
def test_tp_pages_match_jax(rank_dir, jax_steps, when):
    """Each rank's pool holds its KV heads; together the JAX sharded pool.
    The rows prefill wrote (pages 0-1, slots 0-19) within 3e-2, then the
    rows decode and verify added (slots 20-23 of page 0)."""
    got = torch.cat([p[when] for p in ranks.load(rank_dir, "steps", WORLD)], 0)
    got = got.float().numpy()
    want = jax_steps[when]
    assert got.shape == want.shape
    assert np.abs(got[:, :2, :20] - want[:, :2, :20]).max() < 3e-2
    if when == "k_pages":
        assert np.abs(got[:, 0, 20:24] - want[:, 0, 20:24]).max() < 3e-2


def _teacher_forced_gap(params, cfg, context, token):
    s = len(context)
    arr = np.zeros((1, s + (-s) % 128), np.int32)
    arr[0, :s] = context
    logits = jax_llama.forward(params, jnp.asarray(arr), cfg)[0, s - 1]
    return float(logits.max() - logits[token])


@pytest.mark.parametrize("mode", ["dense", "int8"])
def test_tp_server_tokens_match_jax_single_device(rank_dir, jax_serving, mode):
    parts = ranks.load(rank_dir, f"serve_{mode}", WORLD)
    assert parts[0] == parts[1]
    want = jax_serving[f"tokens_{mode}"]
    cfg = _jcfg(SERVE_SHAPE)
    params = jax_serving["params" if mode == "dense" else "int8"]
    for sid, prompt in PROMPTS.items():
        got = parts[0][sid]
        assert len(got) == NEW_TOKENS
        if got == list(want[sid]):
            continue
        j = next(i for i, (a, b) in enumerate(zip(got, want[sid])) if a != b)
        gap = _teacher_forced_gap(params, cfg, prompt + got[:j], got[j])
        assert gap <= 0.1, (mode, sid, j, gap)


def test_tp_server_refusals_match_jax(rank_dir):
    """n_kv_heads not divisible by tp, dp > 1, chunked prefill and the
    prefix cache with a mesh: ValueError, as in the JAX server."""
    for got in ranks.load(rank_dir, "refusals", WORLD):
        assert "n_kv_heads" in got["n_kv_heads"]
        assert "dp=1" in got["dp"]
        assert "single-chip" in got["prefill_chunk_tokens"]
        assert "prefix_cache" in got["prefix_cache"]


@pytest.mark.parametrize("step", ["prefill0", "prefill1", "decode", "verify"])
def test_tp_lora_step_logits_match_jax(rank_dir, jax_lora_steps, step):
    """LoRA under tp 2, adapters 1 and -1 in one batch: each prefill, the
    decode step and a 3-token verify step (held to JAX's three decode
    steps: JAX's ``verify_step`` takes no adapters) within 6e-2 of JAX's
    logits with ``mesh=`` and ``lora=``, the same on both ranks."""
    parts = ranks.load(rank_dir, "lora_steps", WORLD)
    assert torch.equal(parts[0][step], parts[1][step])
    err = float(np.abs(parts[0][step].numpy() - jax_lora_steps[step]).max())
    assert err < 6e-2, (step, err)


def test_tp_lora_pages_match_jax(rank_dir, jax_lora_steps):
    """The K pages both sequences' prefill, decode and verify wrote (slots
    0-23 of pages 0 and 2) within 3e-2 of JAX's, each rank its KV heads."""
    got = torch.cat([p["k_pages"] for p in ranks.load(rank_dir, "lora_steps", WORLD)], 0)
    got, want = got.float().numpy(), jax_lora_steps["k_pages"]
    assert got.shape == want.shape
    for page in (0, 2):
        assert np.abs(got[:, page, :24] - want[:, page, :24]).max() < 3e-2
        assert np.abs(got[:, page + 1] - want[:, page + 1]).max() < 3e-2


def test_tp_server_refuses_lora_as_jax(rank_dir):
    """``GenerationServer(mesh=, lora=)`` raises ValueError naming LoRA, as
    the JAX server does."""
    for got in ranks.load(rank_dir, "refusals", WORLD):
        assert got["lora"] is not None and "LoRA" in got["lora"]
