"""The forward of the flagship model's small config, as one callable, and
a dry run of every parallel layout.

Counterpart of the JAX package's ``__graft_entry__.entry()`` and
``dryrun_multichip``: the same 2-layer config (vocab 512, dim 1024, 8 query
and 4 KV heads of width 128, hidden 1024) and a (2, 256) token batch. The
weights are random from a ``torch.Generator`` seeded 0 and the tokens from
one seeded 1: the JAX package's distributions, not its draws.
"""

from __future__ import annotations

import dataclasses

import torch

from .models.llama import LlamaConfig, forward, init_params, loss_fn
from .utils.device import resolve_device

__all__ = ["entry", "small_config", "dryrun_multichip"]


def small_config(n_heads: int = 8, n_kv_heads: int = 4) -> LlamaConfig:
    return LlamaConfig(vocab_size=512, dim=n_heads * 128, n_layers=2, n_heads=n_heads,
                       n_kv_heads=n_kv_heads, d_head=128, hidden_dim=1024)


def entry(device="cuda"):
    """(fn, example_args): ``fn(params, tokens)`` is the model's forward,
    logits (2, 256, 512) fp32, on ``device`` (the card by default; raises
    without one; ``"cpu"`` runs the plain kernel versions)."""
    dev = resolve_device(device)
    cfg = small_config()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)


def _randint(high, shape, seed, device):
    return torch.randint(0, high, shape, device=device,
                         generator=torch.Generator(device=device).manual_seed(seed))


def _dryrun_rank(rank, world, device, backend):
    """Every part of :func:`dryrun_multichip` on this rank; returns the
    lines it prints (rank 0's are printed)."""
    from .models.decode import decode_step, init_cache, prefill
    from .models.moe import (
        EXPERT_AXIS, MoEConfig, init_moe_params, moe_loss_fn, shard_moe_params)
    from .models.train import make_optimizer, make_train_step, param_leaves
    from .ops.configs import KernelConfig
    from .parallel.collectives import reduce_from
    from .parallel.mesh import (
        MODEL_AXIS, make_axis_mesh, make_mesh, make_sp_mesh, shard_params)
    from .parallel.pipeline import (
        PIPELINE_AXIS, pipeline_loss_fn, shard_pipeline_params, stack_pipeline_params)
    from .parallel.ring_attention import ring_flash_attention

    lines, n = [], world
    kw = dict(device=device, backend=backend)
    tp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    dp = n // tp
    mesh = make_mesh(dp, tp, **kw)
    dev = mesh.device
    cfg = small_config(n_heads=2 * tp if tp > 1 else 2, n_kv_heads=tp if tp > 1 else 1)
    params = shard_params(init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev),
                          mesh)
    tokens = _randint(cfg.vocab_size, (2 * dp, 129), 1, dev)
    loss = float(make_train_step(cfg, make_optimizer(params), mesh=mesh)(params, tokens))
    assert loss == loss, "training loss is NaN"
    lines.append(f"dryrun_multichip({n}): mesh=({dp},{tp}) loss={loss:.4f}")

    # Attention sinks (each rank its heads' slice) with alternating local
    # and global windows, under the same mesh.
    sink_cfg = dataclasses.replace(cfg, n_layers=1, attn_sinks=True, window_pattern=(64, 0))
    sink_params = shard_params(
        init_params(sink_cfg, torch.Generator(device=dev).manual_seed(7), dev), mesh)
    for p in param_leaves(sink_params):
        p.requires_grad_(True)
    sink_loss = loss_fn(sink_params, tokens, sink_cfg, mesh=mesh)
    sink_loss.backward()
    sink_loss = float(sink_loss.detach())
    # The largest |gradient| of each rank's heads' sinks, summed over tp.
    nonzero = reduce_from(sink_params["layers"][0]["attn_sinks"].grad.abs().amax()[None],
                          mesh, MODEL_AXIS)
    assert sink_loss == sink_loss, "sink train loss is NaN"
    assert float(nonzero) > 0, "sink gradient is identically zero"
    lines.append(f"dryrun_multichip({n}): sink+window train step over "
                 f"(dp={dp},tp={tp}) loss={sink_loss:.4f}")

    # Tensor-parallel paged decode over a (1, tp) mesh: prefill one
    # prompt, then one decode step.
    dec_mesh = make_mesh(1, tp, sub=True, **kw) if tp > 1 else None
    if dec_mesh is not None:
        dcfg = small_config(n_heads=2 * tp, n_kv_heads=tp)
        dparams = shard_params(
            init_params(dcfg, torch.Generator(device=dev).manual_seed(5), dev), dec_mesh)
        cache = init_cache(dcfg, num_pages=8, page_size=64, device=dev, mesh=dec_mesh)
        table = torch.tensor([0, 1, 2, -1], dtype=torch.int32, device=dev)
        with torch.no_grad():
            prefill(dparams, torch.zeros((1, 128), dtype=torch.long, device=dev), dcfg,
                    cache, table, prompt_len=20, mesh=dec_mesh)
            dlogits, _ = decode_step(
                dparams, torch.zeros(1, dtype=torch.long, device=dev), dcfg, cache,
                torch.tensor([21], dtype=torch.int32, device=dev), table[None], mesh=dec_mesh)
        assert bool(torch.isfinite(dlogits).all()), "TP decode NaN"
        lines.append(f"dryrun_multichip({n}): TP prefill + paged decode over tp={tp} ok")

    # Sequence parallelism: the ring over every rank, each its shard.
    sp_mesh = make_sp_mesh(n, **kw)
    seq = 128 * n
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((1, 2, seq, 128), generator=gen, device=dev).bfloat16()
               [:, :, rank * 128:(rank + 1) * 128].contiguous() for _ in range(3))
    with torch.no_grad():
        out = ring_flash_attention(q, k, v, KernelConfig(causal=True), sp_mesh)
    assert bool(torch.isfinite(out.float()).all()), "ring attn NaN"
    lines.append(f"dryrun_multichip({n}): ring attention over sp={n} ok")

    # Expert parallelism: the MoE loss and gradients, experts over "ep".
    ep = min(4, n)
    ep_mesh = make_axis_mesh(EXPERT_AXIS, ep, sub=True, **kw)
    moe_cfg = MoEConfig(vocab_size=256, dim=256, n_layers=1, n_heads=2, n_kv_heads=1,
                        d_head=128, hidden_dim=256, n_experts=2 * ep, expert_top_k=2)
    if ep_mesh is not None:
        moe_params = shard_moe_params(
            init_moe_params(moe_cfg, torch.Generator(device=dev).manual_seed(3), dev),
            ep_mesh)
        for p in param_leaves(moe_params):
            p.requires_grad_(True)
        moe_loss = moe_loss_fn(moe_params, _randint(moe_cfg.vocab_size, (2, 129), 4, dev),
                               moe_cfg, mesh=ep_mesh)
        moe_loss.backward()
        moe_loss = float(moe_loss.detach())
        assert moe_loss == moe_loss, "MoE loss is NaN"
        lines.append(f"dryrun_multichip({n}): MoE train step over ep={ep} "
                     f"({moe_cfg.n_experts} experts) loss={moe_loss:.4f}")

    # Pipeline parallelism: GPipe over "pp", 4 microbatches, with its
    # backward through the reverse permutations.
    pp = min(4, n)
    pp_mesh = make_axis_mesh(PIPELINE_AXIS, pp, sub=True, **kw)
    pp_cfg = dataclasses.replace(small_config(n_heads=2, n_kv_heads=1), n_layers=pp)
    if pp_mesh is not None:
        staged = shard_pipeline_params(stack_pipeline_params(
            init_params(pp_cfg, torch.Generator(device=dev).manual_seed(5), dev), pp), pp_mesh)
        for p in param_leaves(staged):
            p.requires_grad_(True)
        pp_loss = pipeline_loss_fn(staged, _randint(pp_cfg.vocab_size, (4, 129), 6, dev),
                                   pp_cfg, pp_mesh, 4)
        pp_loss.backward()
        pp_loss = float(pp_loss.detach())
        assert pp_loss == pp_loss, "pipeline loss is NaN"
        lines.append(f"dryrun_multichip({n}): pipeline train step over pp={pp} "
                     f"(4 microbatches) loss={pp_loss:.4f}")
    return lines


def dryrun_multichip(n_ranks: int = 4, *, device="cuda", backend: str,
                     timeout: float = 900.0) -> list[str]:
    """Every parallel layout on ``n_ranks`` ranks of one process group (one
    ``parallel.launch.spawn``), the JAX ``dryrun_multichip``'s parts,
    configs and asserts in its order: a dp x tp train step (tp 4 where 4
    divides n_ranks, else 2 or 1), the attention-sink and (64, 0) window
    config's loss and gradients under that mesh (the sink gradient not all
    zero), tp prefill and one paged decode step over a (1, tp) mesh, the
    ring over all ranks, the MoE loss and gradients over ep = min(4,
    n_ranks) with 2 ep experts, and the pipeline's loss and gradients over
    pp = min(4, n_ranks) with 4 microbatches. The decode, ep and pp meshes
    cover the group's first ranks. Prints each part's line and returns
    them. ``device``: "cuda" (rank r on card r),
    "cuda:0" (every rank on one card, with ``backend="gloo"``) or "cpu";
    ``backend`` is required, as in ``spawn``."""
    from .ops import _build
    from .parallel.launch import spawn

    if torch.device(device).type == "cuda":
        _build.build(["flash_forward.cu", "flash_backward.cu", "paged_attention.cu"])
    lines = spawn(_dryrun_rank, n_ranks, backend=backend, device=device, timeout=timeout,
                  args=(device, backend))[0]
    for line in lines:
        print(line, flush=True)
    return lines
