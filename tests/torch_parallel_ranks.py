"""The ranks' side of the port's parallel tests (not a test module).

``tests/test_torch_parallel.py``, ``test_torch_ring_attention.py`` and
``test_torch_sharded_decode.py`` each start one group of gloo ranks on the
CPU (``parallel.launch.spawn``) with one of the functions below. Every rank
runs all of its file's cases and writes its shard of each result under the
given directory (``<case>.<rank>.pt``); the test module, which holds the
JAX side, reads them back. This module imports torch and the port only: a
rank never loads JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from unittest import mock

import numpy as np
import torch

from flash_attention_from_scratch_tpu_torch.models import decode, llama, train
from flash_attention_from_scratch_tpu_torch.ops.configs import KernelConfig
from flash_attention_from_scratch_tpu_torch.parallel import collectives
from flash_attention_from_scratch_tpu_torch.parallel.mesh import (
    MODEL_AXIS, SEQ_AXIS, make_mesh, make_sp_mesh, shard_params,
)
from flash_attention_from_scratch_tpu_torch.parallel.ring_attention import ring_flash_attention
from flash_attention_from_scratch_tpu_torch.parallel.sharded_attention import (
    shard_mapped_attention,
)
from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer
from flash_attention_from_scratch_tpu_torch.utils.testing import make_qkv


def save(out_dir, case, rank, value):
    torch.save(value, os.path.join(out_dir, f"{case}.{rank}.pt"))


def load(out_dir, case, world):
    """Every rank's saved value of ``case``, in rank order."""
    return [torch.load(os.path.join(out_dir, f"{case}.{r}.pt")) for r in range(world)]


def bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------- the ring

RING_WORLD, RING_SEQ = 4, 512
# name: (heads, kv_heads, config options, sink logits or None)
RING_FORWARD = {
    "causal": (2, 2, dict(causal=True), None),
    "full": (2, 2, {}, None),
    "window100": (2, 2, dict(causal=True, window=100), None),
    "window300": (2, 2, dict(causal=True, window=300), None),
    "sinks": (2, 2, dict(causal=True), (0.5, -0.25)),
    "gqa": (4, 2, {}, None),
}
RING_BACKWARD = {
    "causal": (2, 2, dict(causal=True), None),
    "full": (2, 2, {}, None),
    "window200": (2, 2, dict(causal=True, window=200), None),
    "sinks": (2, 2, dict(causal=True), (0.4, -0.3)),
}


def ring_inputs(heads, kv_heads):
    """(q, k, v, do) float32 numpy, (1, heads, 512, 128); k/v kv_heads."""
    q, k, v = make_qkv(1, heads, RING_SEQ, kv_heads=kv_heads, seed=21)
    do = np.random.default_rng(22).standard_normal(q.shape).astype(np.float32)
    return q, k, v, do


def ring_ranks(rank, world, out_dir):
    """Every ring case on this rank's sequence shard: the forward output,
    and for the backward cases the gradients of sum(out * do)."""
    torch.set_num_threads(1)
    mesh = make_sp_mesh(world, device="cpu")
    n = RING_SEQ // world
    rows = slice(rank * n, (rank + 1) * n)
    for kind, table in (("fwd", RING_FORWARD), ("bwd", RING_BACKWARD)):
        for name, (heads, kv_heads, kw, sinks) in table.items():
            q, k, v, do = (bf16(x)[:, :, rows].clone() for x in ring_inputs(heads, kv_heads))
            z = None if sinks is None else torch.tensor(sinks, dtype=torch.float32)
            leaves = [q, k, v] + ([] if z is None else [z])
            for t in leaves:
                t.requires_grad_(kind == "bwd")
            out = ring_flash_attention(q, k, v, KernelConfig(**kw), mesh, sinks=z)
            result = {"out": out.detach()}
            if kind == "bwd":
                (out * do).sum().backward()
                result["grads"] = [t.grad for t in leaves]
            save(out_dir, f"{kind}_{name}", rank, result)
    return mesh.staged_bytes


# ------------------------------------------------ sharded attention, model

PAR_WORLD = 4
ATTN_SEQ = 256
ATTN_SINKS = np.linspace(-0.5, 0.75, 4).astype(np.float32)  # the JAX test's
LR = 3e-4


def attn_inputs():
    """(q, k, v, do): b 2, 4 heads, s 256, the JAX sharded tests' shapes."""
    q, k, v = make_qkv(2, 4, ATTN_SEQ, seed=31)
    do = np.random.default_rng(32).standard_normal(q.shape).astype(np.float32)
    return q, k, v, do


def block(x, mesh):
    """This rank's (batch/dp, heads/tp) block of a (b, h, ...) tensor."""
    b, h = x.shape[0] // mesh.size("dp"), x.shape[1] // mesh.size(MODEL_AXIS)
    return x[mesh.coord("dp") * b:][:b, mesh.coord(MODEL_AXIS) * h:][:, :h]


def _shard_attention(mesh, rank, out_dir):
    q, k, v, do = (block(bf16(x), mesh) for x in attn_inputs())
    for name, kw, sinks in (("attn_plain", {}, None),
                            ("attn_sinks", dict(causal=True), ATTN_SINKS)):
        leaves = [t.requires_grad_(True) for t in (q.clone(), k.clone(), v.clone())]
        z = None
        if sinks is not None:
            h = q.shape[1]
            z = torch.from_numpy(sinks)[mesh.coord(MODEL_AXIS) * h:][:h].clone()
            leaves.append(z.requires_grad_(True))
        out = shard_mapped_attention(*leaves[:3], KernelConfig(**kw), mesh, sinks=z)
        (out * do).sum().backward()
        save(out_dir, name, rank, {"out": out.detach(), "grads": [t.grad for t in leaves]})


def _losses(jparams, cfg_kw, tokens, meshes, rank, out_dir):
    """The loss of each named mesh on the JAX parameters (bf16)."""
    for name, (mesh, extra) in meshes.items():
        cfg = llama.LlamaConfig(**{**cfg_kw, **extra})
        with torch.no_grad():
            loss = llama.loss_fn(shard_params(jparams, mesh), tokens, cfg, mesh=mesh)
        save(out_dir, f"loss_{name}", rank, float(loss))


def named_leaves(params):
    """(name, tensor) of a one-layer tree: "embed", ..., "layers.0.wq", ..."""
    top = [(k, v) for k, v in params.items() if k != "layers"]
    return top + [(f"layers.0.{k}", v) for k, v in params["layers"][0].items()]


# Faults planted in the train step, to show that the gradient check fails
# them: the dp sum of the gradients left out, and copy_to's backward (the
# all-reduce of an activation's gradient over tp) halved.
TRAIN_FAULTS = {
    "no_dp_sum": lambda: mock.patch.object(train, "sum_data_gradients",
                                           lambda params, mesh: None),
    "half_copy_to": lambda: mock.patch.object(
        collectives._CopyTo, "backward",
        staticmethod(lambda ctx, g: (collectives._all_reduce(g, ctx.mesh, ctx.axis) / 2,
                                     None, None))),
}


def _train_step(jparams, cfg_kw, tokens, mesh, rank, out_dir, case="train"):
    """One ``make_train_step`` step on the mesh; saves the loss, each
    leaf's gradient as the optimizer receives it (after the dp sum), the
    updated ``wq`` and the shard shapes. A case named after a fault of
    ``TRAIN_FAULTS`` runs with that fault planted."""
    cfg = llama.LlamaConfig(**cfg_kw)
    params = shard_params(jparams, mesh)
    opt = train.make_optimizer(params, lr=LR)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        (k, v.grad.detach().clone()) for k, v in named_leaves(params)))
    with TRAIN_FAULTS.get(case, contextlib.nullcontext)():
        loss = train.make_train_step(cfg, opt, mesh=mesh)(params, tokens)
    shapes = {"embed": tuple(params["embed"].shape), "lm_head": tuple(params["lm_head"].shape),
              **{k: tuple(v.shape) for k, v in params["layers"][0].items()}}
    save(out_dir, case, rank, {"loss": float(loss), "shapes": shapes, "grads": grads,
                               "wq": params["layers"][0]["wq"].detach().clone()})


def _fused_forward(jparams_fused, cfg_kw, tokens, mesh, rank, out_dir):
    with torch.no_grad():
        logits = llama.forward(shard_params(jparams_fused, mesh), tokens,
                               llama.LlamaConfig(**cfg_kw), mesh=mesh)
    save(out_dir, "fused_forward", rank, logits)


def _quantized_shards(qparams, int4_params, mesh, rank, out_dir):
    sharded = shard_params(qparams, mesh)["layers"][0]
    got = {k: (tuple(sharded[k].values.shape), tuple(sharded[k].scales.shape))
           for k in ("wq", "wo", "w_gate", "w_down")}
    try:
        shard_params(int4_params, mesh)
        got["int4_raises"] = False
    except NotImplementedError:
        got["int4_raises"] = True
    save(out_dir, "quantized", rank, got)


def _collectives(mesh, rank, out_dir):
    """ppermute (shift 1), all_gather, the Megatron pair and the
    vocab-parallel cross-entropy, with gradients, on the tp axis."""
    n, me = mesh.size(MODEL_AXIS), mesh.coord(MODEL_AXIS)
    x = torch.arange(4, dtype=torch.float32).add(10 * rank).requires_grad_(True)
    y = collectives.ppermute(x, mesh, MODEL_AXIS, collectives.ring_perm(n))
    (y * torch.arange(1, 5) * (me + 1)).sum().backward()
    g = torch.full((3,), float(rank), requires_grad=True)
    gathered = collectives.all_gather(g, mesh, MODEL_AXIS, 0)
    (gathered * torch.arange(3 * n)).sum().backward()
    r = torch.full((2,), float(rank + 1), requires_grad=True)
    summed = collectives.reduce_from(collectives.copy_to(r, mesh), mesh)
    (summed * 2).sum().backward()
    logits, targets = ce_inputs()
    part = logits[:, me * 6:(me + 1) * 6].clone().requires_grad_(True)
    ce = collectives.vocab_parallel_cross_entropy(part, targets, mesh)
    (ce * torch.arange(1.0, 6.0)).sum().backward()
    save(out_dir, "collectives", rank, {
        "ppermute": y.detach(), "ppermute_grad": x.grad, "gathered": gathered.detach(),
        "gather_grad": g.grad, "summed": summed.detach(), "copy_grad": r.grad,
        "ce": ce.detach(), "ce_grad": part.grad})


def ce_inputs():
    """(5, 12) fp32 logits, split 6 a tp rank, and targets on both halves."""
    logits = torch.from_numpy(np.random.default_rng(33).standard_normal((5, 12)).astype(
        np.float32) * 3)
    return logits, torch.tensor([0, 5, 6, 11, 7])


def hang(rank, world):
    """Rank 0 waits at a barrier that rank 1 never reaches."""
    if rank == 0:
        torch.distributed.barrier()
    time.sleep(600)


def parallel_ranks(rank, world, out_dir, setup):
    """The cases of ``tests/test_torch_parallel.py`` on a (dp 2, tp 2), a
    tp 4 and an sp 4 mesh of the same four ranks. ``setup``: the JAX
    parameters (port tensors) and token ids the test module made."""
    torch.set_num_threads(1)
    dp_tp = make_mesh(2, 2, device="cpu")
    sp = make_sp_mesh(world, device="cpu")
    _shard_attention(dp_tp, rank, out_dir)
    _collectives(dp_tp, rank, out_dir)
    loss = setup["loss"]
    _losses(loss["params"], loss["cfg"], loss["tokens"],
            {"tp": (dp_tp, {}), "sp": (sp, {}),
             "sp_window": (sp, dict(sliding_window=200))}, rank, out_dir)
    step = setup["train"]
    _train_step(step["params"], step["cfg"], step["tokens"], dp_tp, rank, out_dir)
    fp32 = setup["train_fp32"]
    for case in ("train_fp32", *TRAIN_FAULTS):
        _train_step(fp32["params"], fp32["cfg"], step["tokens"], dp_tp, rank, out_dir, case)
    _fused_forward(setup["fused"], step["cfg"], step["tokens"][:, :128], dp_tp, rank,
                   out_dir)
    _quantized_shards(setup["int8"], setup["int4"], dp_tp, rank, out_dir)
    return dp_tp.staged_bytes + sp.staged_bytes


# ----------------------------------------------------------- tp serving

DECODE_PAGES, DECODE_PAGE = 8, 64


def decode_prompt():
    prompt = torch.zeros((1, 128), dtype=torch.long)
    prompt[0, :20] = torch.arange(20) % 128
    table = torch.full((4,), -1, dtype=torch.int32)
    table[:2] = torch.tensor([0, 1], dtype=torch.int32)
    return prompt, table


def _tp_steps(params, cfg, mesh, token, rank, out_dir):
    """prefill, then decode_step, then a verify step of 3 tokens."""
    prompt, table = decode_prompt()
    cache = decode.init_cache(cfg, DECODE_PAGES, DECODE_PAGE, device="cpu", mesh=mesh)
    logits0, cache = decode.prefill(params, prompt, cfg, cache, table, prompt_len=20,
                                    mesh=mesh)
    pages0 = cache.k_pages[0].clone()
    logits1, cache = decode.decode_step(params, torch.tensor([token]), cfg, cache,
                                        torch.tensor([21], dtype=torch.int32),
                                        table[None], mesh=mesh)
    logits2, cache = decode.verify_step(params, torch.tensor([[token, 5, 6]]), cfg, cache,
                                        torch.tensor([24], dtype=torch.int32),
                                        table[None], mesh=mesh)
    save(out_dir, "steps", rank, {"prefill": logits0, "decode": logits1, "verify": logits2,
                                  "k_pages_prefill": pages0, "k_pages": cache.k_pages[0]})


def _serve(params, cfg, mesh, prompts, new_tokens, **kw):
    server = GenerationServer(params, cfg, num_pages=32, page_size=64, max_batch=2,
                              pages_per_seq=8, mesh=mesh, device="cpu", **kw)
    for sid, p in prompts.items():
        server.submit(sid, p, new_tokens)
    return server.run()


def _refusals(params, cfg, mesh_tp, mesh_dp, rank, out_dir):
    """JAX's ValueErrors of a server with a mesh: n_kv_heads not divisible
    by tp, dp > 1, chunked prefill, the prefix cache, LoRA adapters."""
    from flash_attention_from_scratch_tpu_torch.models.lora import init_lora_adapters

    one_kv = dataclasses.replace(cfg, n_kv_heads=1)
    lora = init_lora_adapters(cfg, 2, 4, torch.Generator().manual_seed(0), device="cpu")
    cases = {"n_kv_heads": (one_kv, mesh_tp, {}), "dp": (cfg, mesh_dp, {}),
             "prefill_chunk_tokens": (cfg, mesh_tp, dict(prefill_chunk_tokens=128)),
             "prefix_cache": (cfg, mesh_tp, dict(prefix_cache=True)),
             "lora": (cfg, mesh_tp, dict(lora=lora))}
    got = {}
    for name, (c, mesh, kw) in cases.items():
        try:
            GenerationServer(params, c, num_pages=8, page_size=64, max_batch=2,
                             mesh=mesh, device="cpu", **kw)
            got[name] = None
        except ValueError as e:
            got[name] = str(e)
    save(out_dir, "refusals", rank, got)


LORA_IDS = (1, -1)  # the adapter of each of the LoRA steps' two sequences


def lora_prompts():
    """Two 20-token prompts padded to 128, (2, 128), and their page tables
    (2, 4): pages 0-1 and 2-3."""
    prompts = torch.zeros((2, 128), dtype=torch.long)
    prompts[0, :20] = torch.arange(20) % 128
    prompts[1, :20] = (torch.arange(20) * 7 + 3) % 128
    tables = torch.full((2, 4), -1, dtype=torch.int32)
    tables[:, :2] = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    return prompts, tables


def _tp_lora_steps(params, lora, cfg, mesh, tokens, rank, out_dir):
    """Each sequence's prefill with its adapter, then one decode step and
    one 3-token verify step of both rows (adapters 1 and -1)."""
    prompts, tables = lora_prompts()
    ids = torch.tensor(LORA_IDS)
    cache = decode.init_cache(cfg, DECODE_PAGES, DECODE_PAGE, device="cpu", mesh=mesh)
    out = {}
    for i in range(2):
        out[f"prefill{i}"], cache = decode.prefill(
            params, prompts[i:i + 1], cfg, cache, tables[i], prompt_len=20, lora=lora,
            adapter_ids=ids[i:i + 1], mesh=mesh)
    out["decode"], cache = decode.decode_step(
        params, tokens["decode"], cfg, cache, torch.tensor([21, 21], dtype=torch.int32),
        tables, lora=lora, adapter_ids=ids, mesh=mesh)
    out["verify"], cache = decode.verify_step(
        params, tokens["verify"], cfg, cache, torch.tensor([24, 24], dtype=torch.int32),
        tables, lora=lora, adapter_ids=ids, mesh=mesh)
    out["k_pages"] = cache.k_pages[0]
    save(out_dir, "lora_steps", rank, out)


def decode_ranks(rank, world, out_dir, setup):
    """The cases of ``tests/test_torch_sharded_decode.py`` on a tp 2 mesh
    (and a dp 2 mesh for the refusal of dp > 1)."""
    from flash_attention_from_scratch_tpu_torch.models.lora import shard_lora

    torch.set_num_threads(2)
    tp = make_mesh(1, world, device="cpu")
    dp = make_mesh(world, 1, device="cpu")
    steps = setup["steps"]
    _tp_steps(shard_params(steps["params"], tp), steps["cfg"], tp, steps["token"], rank,
              out_dir)
    _tp_lora_steps(shard_params(steps["params"], tp), shard_lora(steps["lora"], tp),
                   steps["cfg"], tp, steps["lora_tokens"], rank, out_dir)
    serve = setup["serve"]
    for name, params, kw in (("dense", serve["params"], {}),
                             ("int8", serve["int8"], dict(mode="int8"))):
        save(out_dir, f"serve_{name}", rank,
             _serve(params, serve["cfg"], tp, serve["prompts"], serve["new"], **kw))
    _refusals(serve["params"], serve["cfg"], tp, dp, rank, out_dir)
    return tp.staged_bytes


# ------------------------------------------------------------- on the card

def cuda_ring(rank, world):
    """On card 0 under gloo: ppermute of a CUDA tensor (staged through host
    memory), then the ring on a causal 1024-token sequence (8/2 heads)
    against single-device ``flash_attention`` on the whole of it, with this
    rank's kernel launches. Returns CPU values only."""
    from flash_attention_from_scratch_tpu_torch.ops import _build
    from flash_attention_from_scratch_tpu_torch.ops.autodiff import flash_attention

    mesh = make_sp_mesh(world, device="cuda:0", backend="gloo")
    x = torch.full((1024,), float(rank), device=mesh.device)
    moved = collectives.ppermute(x, mesh, SEQ_AXIS, collectives.ring_perm(world))
    staged = mesh.staged_bytes
    seq, cfg = 1024, KernelConfig(causal=True)
    q, k, v = (torch.from_numpy(t).to(mesh.device, torch.bfloat16).requires_grad_(True)
               for t in make_qkv(1, 8, seq, kv_heads=2, seed=5))
    do = torch.from_numpy(np.random.default_rng(6).standard_normal(q.shape).astype(
        np.float32)).to(mesh.device, torch.bfloat16)
    n = seq // world
    rows = slice(rank * n, (rank + 1) * n)
    shards = [t.detach()[:, :, rows].clone().requires_grad_(True) for t in (q, k, v)]
    _build.launch_counts.clear()
    out = ring_flash_attention(*shards, cfg, mesh)
    (out * do[:, :, rows]).sum().backward()
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    whole = flash_attention(q, k, v, cfg)
    (whole * do).sum().backward()
    diffs = [(float((a.float() - b[:, :, rows].float()).abs().max()),
              float(b[:, :, rows].float().abs().max())) for a, b in
             [(out, whole)] + [(s.grad, t.grad) for s, t in zip(shards, (q, k, v))]]
    return {"moved": moved.cpu(), "device": moved.device.type, "staged": staged,
            "launches": launches, "diffs": diffs}


# ------------------------------------------------------------ the pipeline

PIPE_WORLD = 4


def _pipe_faults(mesh):
    """Faults planted in the pipeline, to show that the gradient check
    fails them: the embedding's gradient not summed over "pp" (only stage
    0 reads it), and the LM head's summed (every rank computes it)."""
    from flash_attention_from_scratch_tpu_torch.parallel import pipeline

    def lm_head_summed(params, x, cfg):
        return llama._lm_logits({**params, "lm_head": collectives.copy_to(
            params["lm_head"], mesh, pipeline.PIPELINE_AXIS)}, x, cfg)

    return {"no_embed_sum": mock.patch.object(pipeline, "copy_to", lambda x, mesh, axis: x),
            "lm_head_summed": mock.patch.object(pipeline, "_lm_logits", lm_head_summed)}


def _grads_of(tree, prefix=""):
    """{path: gradient} of every tensor leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _grads_of(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _grads_of(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree.grad.detach().clone()}


def _leaves_train(tree):
    from flash_attention_from_scratch_tpu_torch.models.train import param_leaves

    for p in param_leaves(tree):
        p.requires_grad_(True)
    return tree


def _pipe_grads(params, tokens, cfg, mesh, n_micro):
    """pipeline_loss_fn's loss and every leaf's gradient on this rank."""
    from flash_attention_from_scratch_tpu_torch.parallel import pipeline

    staged = _leaves_train(pipeline.shard_pipeline_params(
        pipeline.stack_pipeline_params(params, mesh.size("pp")), mesh))
    loss = pipeline.pipeline_loss_fn(staged, tokens, cfg, mesh, n_micro)
    loss.backward()
    return {"loss": float(loss.detach()), "grads": _grads_of(staged)}


def pipe_ranks(rank, world, out_dir, setup):
    """The cases of ``tests/test_torch_pipeline.py``: the refusal of a mesh
    smaller than the group without ``sub``, the pp 4 and pp 2 forward (pp 2
    a sub-mesh on ranks 0-1), the pp 4 loss and gradients, the same with
    each fault of :func:`_pipe_faults` planted, the microbatch refusal, and
    the pipeline against the port's own ``loss_fn`` on a config with
    ``embed_scale``, a final softcap, RoPE scaling and a window cycle."""
    from flash_attention_from_scratch_tpu_torch.parallel import pipeline
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import make_axis_mesh

    torch.set_num_threads(1)
    params, cfg = setup["params"], llama.LlamaConfig(**setup["cfg"])
    refused = {}
    for name, build in (("axis", lambda: make_axis_mesh("pp", 2, device="cpu")),
                        ("dp_tp", lambda: make_mesh(1, 2, device="cpu"))):
        try:
            build()
            refused[name] = None
        except ValueError as e:
            refused[name] = str(e)
    meshes = {4: make_axis_mesh("pp", 4, device="cpu"),
              2: make_axis_mesh("pp", 2, device="cpu", sub=True)}
    save(out_dir, "sub_mesh", rank, {"refused": refused, "pp2_none": meshes[2] is None})
    for n, mesh in meshes.items():
        if mesh is None:
            continue
        staged = pipeline.shard_pipeline_params(pipeline.stack_pipeline_params(params, n), mesh)
        with torch.no_grad():
            save(out_dir, f"fwd_pp{n}", rank, pipeline.pipeline_forward(
                staged, setup["tokens"], cfg, mesh, n))
    mesh = meshes[4]
    save(out_dir, "grad", rank, _pipe_grads(params, setup["tokens129"], cfg, mesh, 4))
    for name, fault in _pipe_faults(mesh).items():
        with fault:
            save(out_dir, name, rank, _pipe_grads(params, setup["tokens129"], cfg, mesh, 4))
    try:
        pipeline.pipeline_forward(staged, setup["tokens"], cfg, mesh, 3)
        refused = None
    except ValueError as e:
        refused = str(e)
    save(out_dir, "refusal", rank, refused)
    variant = llama.LlamaConfig(**{**setup["cfg"], **setup["variant"]})
    got = _pipe_grads(params, setup["tokens129"], variant, mesh, 2)
    whole = _leaves_train({k: (v.clone() if k != "layers" else [
        {n: w.clone() for n, w in layer.items()} for layer in v]) for k, v in params.items()})
    loss = llama.loss_fn(whole, setup["tokens129"], variant)
    loss.backward()
    save(out_dir, "variant", rank, {"pipeline": got, "loss": float(loss.detach()),
                                    "grads": _grads_of(whole)})
    return mesh.staged_bytes


# ------------------------------------------------------ expert parallelism

EP_WORLD = 4


def _ep_faults(mesh):
    """Faults planted in expert parallelism: the experts' gradient into
    combine (so into the gates and the router) left unsummed over "ep";
    the gates' whole gradient summed, the aux loss's with it."""
    from flash_attention_from_scratch_tpu_torch.models import moe

    route = moe._route

    def gates_summed(cfg, gates, capacity):
        return route(cfg, collectives.copy_to(gates, mesh, moe.EXPERT_AXIS), capacity)

    def x_only(combine, xt, mesh):
        return combine, collectives.copy_to(xt, mesh, moe.EXPERT_AXIS)

    return {"router_not_summed": [mock.patch.object(moe, "_expert_inputs", x_only)],
            "aux_summed": [mock.patch.object(moe, "_expert_inputs", x_only),
                           mock.patch.object(moe, "_route", gates_summed)]}


def ep_ranks(rank, world, out_dir, setup):
    """The cases of ``tests/test_torch_expert_parallel.py`` on an ep 4 mesh:
    ``_moe_mlp`` on the same activations, ``moe_loss_fn``'s loss and
    gradients (and with each fault of :func:`_ep_faults`), and the
    refusals of MoE under a tp and an sp mesh."""
    from flash_attention_from_scratch_tpu_torch.models import moe
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import make_axis_mesh

    torch.set_num_threads(1)
    mesh = make_axis_mesh(moe.EXPERT_AXIS, world, device="cpu")
    cfg = moe.MoEConfig(**setup["cfg"])
    params = setup["params"]
    layer = moe.shard_moe_params(params, mesh)["layers"][0]
    with torch.no_grad():
        out, aux = moe._moe_mlp(cfg, layer, setup["x"], mesh)
    save(out_dir, "mlp", rank, {"out": out, "aux": float(aux)})
    cases = {"grad": [], **_ep_faults(mesh)}
    for name, patches in cases.items():
        with contextlib.ExitStack() as stack:
            for p in patches:
                stack.enter_context(p)
            sharded = _leaves_train(moe.shard_moe_params(params, mesh))
            loss = moe.moe_loss_fn(sharded, setup["tokens"], cfg, mesh)
            loss.backward()
        save(out_dir, name, rank, {"loss": float(loss.detach()), "grads": _grads_of(sharded)})
    refusals = {}
    for name, other in (("tp", make_mesh(1, world, device="cpu")),
                        ("sp", make_sp_mesh(world, device="cpu"))):
        for what, call in (("forward", lambda: moe.moe_forward(
                params, setup["tokens"][:, :-1], cfg, other)),
                           ("shard_params", lambda: shard_params(params, other))):
            try:
                call()
                refusals[f"{name}_{what}"] = None
            except NotImplementedError as e:
                refusals[f"{name}_{what}"] = str(e)
    save(out_dir, "refusals", rank, refusals)
    return mesh.staged_bytes


def cuda_axes(rank, world):
    """On card 0 under gloo: on a "pp" and an "ep" mesh of ``world`` ranks,
    ppermute of a CUDA tensor along the partial chain (i, i + 1) (no
    wraparound: rank 0 receives zeros), with its gradient, then reduce_from
    after copy_to with theirs. Returns CPU values only."""
    from flash_attention_from_scratch_tpu_torch.parallel.mesh import make_axis_mesh

    out = {}
    for axis in ("pp", "ep"):
        mesh = make_axis_mesh(axis, world, device="cuda:0", backend="gloo")
        x = torch.full((256,), float(rank + 1), device=mesh.device, requires_grad=True)
        y = collectives.ppermute(x, mesh, axis, [(i, i + 1) for i in range(world - 1)])
        (y * (rank + 1)).sum().backward()
        r = torch.full((2,), float(rank + 1), device=mesh.device, requires_grad=True)
        summed = collectives.reduce_from(collectives.copy_to(r, mesh, axis), mesh, axis)
        (summed * 2).sum().backward()
        out[axis] = {"moved": y.detach().cpu(), "moved_grad": x.grad.cpu(),
                     "summed": summed.detach().cpu(), "copy_grad": r.grad.cpu(),
                     "device": y.device.type, "staged": mesh.staged_bytes}
    return out


CUDA_LORA_SHAPE = dict(vocab_size=128, dim=512, n_layers=1, n_heads=4, n_kv_heads=2,
                       d_head=128, hidden_dim=256)


def _lora_step(params, lora, cfg, mesh, device):
    """Both LoRA prompts' prefill (adapters 1, -1), then one decode step."""
    prompts, tables = (t.to(device) for t in lora_prompts())
    ids = torch.tensor(LORA_IDS, device=device)
    cache = decode.init_cache(cfg, DECODE_PAGES, DECODE_PAGE, device=device, mesh=mesh)
    first = []
    with torch.no_grad():
        for i in range(2):
            logits, cache = decode.prefill(params, prompts[i:i + 1], cfg, cache, tables[i],
                                           prompt_len=20, lora=lora, adapter_ids=ids[i:i + 1],
                                           mesh=mesh)
            first.append(int(logits.argmax()))
        logits, _ = decode.decode_step(
            params, torch.tensor(first, device=device), cfg, cache,
            torch.tensor([21, 21], dtype=torch.int32, device=device), tables, lora=lora,
            adapter_ids=ids, mesh=mesh)
    return logits.float().cpu()


def cuda_tp_lora(rank, world):
    """On card 0 under gloo, tp 2: a random bf16 model's LoRA prefill and
    decode step (2 adapters of rank 8, B non-zero) on the rank's shards
    (K1, K4/K5 on the card), and on rank 0 the same steps on the whole
    model on the CPU (the plain versions). Returns CPU values only."""
    from flash_attention_from_scratch_tpu_torch.models.lora import (
        init_lora_adapters, shard_lora)
    from flash_attention_from_scratch_tpu_torch.ops import _build

    cfg = llama.LlamaConfig(**CUDA_LORA_SHAPE)
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(cfg, gen, "cpu")
    lora = init_lora_adapters(cfg, 2, 8, gen, zero_b=False, device="cpu")
    mesh = make_mesh(1, world, device="cuda:0", backend="gloo")
    _build.launch_counts.clear()
    got = _lora_step(shard_params(params, mesh), shard_lora(lora, mesh), cfg, mesh,
                     mesh.device)
    torch.cuda.synchronize()
    out = {"logits": got, "launches": dict(_build.launch_counts)}
    if rank == 0:
        out["plain"] = _lora_step(params, lora, cfg, None, "cpu")
    return out
