"""Tensor-parallel decode scaling report: bytes and collectives a rank, and
a projection of tokens/s at each tp.

Counterpart of ``flash_attention_from_scratch_tpu/tools/scaling_report.py``,
with its CLI and row keys. Decode is bound by the weight and KV stream a
card reads, so sharding that stream over tp cards should scale tokens/s by
about tp until the replicated work and the collectives bind. For each tp
degree the tool:

1. runs one real tensor-parallel ``decode_step`` on tp ranks
   (``parallel.launch.spawn``; each rank builds the model from seed 0 and
   keeps its ``shard_params`` shard and its KV heads' cache);
2. counts rank 0's bytes exactly from its placed shards (a
   ``QuantizedWeight``'s values and scales), as JAX counts device 0's;
3. counts the collectives the step issues (``parallel.collectives.calls``;
   JAX reads them from the compiled HLO): per layer the all-reduces after
   ``wo`` and ``w_down``, and the all-gathers of the embedding rows and the
   logits (:func:`collective_plan`);
4. projects tokens/s from a measured single-card step (``--single-chip-ms``,
   from ``tools/bench_decode.py``): the HBM share of the step scales with
   the bytes a rank reads, and the activation all-reduces cross a link of
   ``--link-gbps`` a direction. The default, 450 GB/s, is NVLink 4's
   published rate a direction on an H100 SXM (a spec sheet figure, not a
   measurement); HBM is ``utils/chip.py``'s 3.35 TB/s. The ``projected_*``
   columns and ``ici_ms`` (the link time, under JAX's key) are a
   projection, not a measurement.

One spawn runs every tp degree: the mesh of tp t is (1, t) over the first t
ranks (the others hold nothing). On one card the ranks share it over gloo
(``--device cuda:0 --backend gloo``), so nothing here times a multi-card
step.

Usage:
    python -m flash_attention_from_scratch_tpu_torch.tools.scaling_report \\
        --model 8b --weights int8 --kv int8 --tps 1,2,4 \\
        --device cuda:0 --backend gloo --single-chip-ms 9.5

``--backend`` is required: "nccl" wants one card a rank.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..models.decode import decode_step, init_cache
from ..models.llama import LlamaConfig, init_params, init_quantized_params
from ..ops import _build
from ..ops.quant_matmul import QuantizedWeight
from ..parallel import collectives
from ..parallel.launch import spawn
from ..parallel.mesh import make_mesh, shard_params
from ..utils.chip import hbm_gbps

__all__ = ["tp_decode_report", "collective_plan", "main"]

# NVLink 4 on an H100 SXM: 900 GB/s a card, 450 GB/s a direction (NVIDIA's
# data sheet). Used only for the projection.
NVLINK_GBPS = 450.0

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute", "all-to-all")


def _rank_bytes(tree) -> int:
    """Bytes of every tensor this rank holds in ``tree`` (exact)."""
    if isinstance(tree, dict):
        return sum(_rank_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_rank_bytes(v) for v in tree)
    if isinstance(tree, QuantizedWeight):
        return _rank_bytes(tree.values) + _rank_bytes(tree.scales)
    return tree.numel() * tree.element_size()


def collective_plan(cfg: LlamaConfig, tp: int) -> dict:
    """The collectives of one tp ``decode_step``, by kind: an all-reduce
    after each layer's ``wo`` and ``w_down``, an all-gather of the
    embedding rows (the table is sharded by dim) and one of the logits
    (the LM head by vocabulary); none at tp 1."""
    plan = dict.fromkeys(_KINDS, 0)
    if tp > 1:
        plan.update({"all-reduce": 2 * cfg.n_layers, "all-gather": 2})
    return plan


def _report_rank(rank, world, cfg, tps, weights, kv, context, page_size, exec_batch,
                 device, backend):
    """Each tp degree's step on this rank: None where the rank is past the
    tp ranks that run it."""
    out = []
    pages_per_seq = -(-(context + 8) // page_size)
    for tp in tps:
        mesh = make_mesh(1, tp, device=device, backend=backend, sub=True)
        if mesh is None:
            out.append(None)
            continue
        gen = torch.Generator(device=mesh.device).manual_seed(0)
        if weights == "bf16":
            params = init_params(cfg, gen, mesh.device)
        else:
            params = init_quantized_params(cfg, gen, weights, act="int8", device=mesh.device)
        sharded = shard_params(params, mesh)
        del params
        cache = init_cache(cfg, exec_batch * pages_per_seq + 1, page_size, kv,
                           device=mesh.device, mesh=mesh)
        tokens = torch.zeros(exec_batch, dtype=torch.long, device=mesh.device)
        lengths = torch.full((exec_batch,), context, dtype=torch.int32, device=mesh.device)
        tables = torch.arange(exec_batch * pages_per_seq, dtype=torch.int32,
                              device=mesh.device).view(exec_batch, pages_per_seq)
        collectives.calls.clear()
        _build.launch_counts.clear()
        with torch.no_grad():
            logits, _ = decode_step(sharded, tokens, cfg, cache, lengths, tables, mesh=mesh)
        out.append({"param_bytes": _rank_bytes(sharded),
                    "collectives": {k: collectives.calls.get(k, 0) for k in _KINDS},
                    "launches": dict(_build.launch_counts),
                    "staged_bytes": mesh.staged_bytes,
                    "finite": bool(torch.isfinite(logits).all())})
        del sharded, cache
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def tp_decode_report(cfg: LlamaConfig, tps=(1, 2, 4, 8), *, batch: int = 16,
                     context: int = 1024, page_size: int = 128, weights: str = "int8",
                     kv: str = "int8", single_chip_ms: float | None = None,
                     hbm_gbps_val: float | None = None, link_gbps: float = NVLINK_GBPS,
                     exec_batch: int | None = None, device="cuda", backend: str,
                     timeout: float = 900.0) -> list[dict]:
    """One row per tp degree, each from one real step on its ranks.

    ``weights``: "int8" (W8A8, JAX's recipe: ``init_quantized_params(...,
    act="int8")``) or "bf16"; ``kv`` the cache mode. ``exec_batch``
    (default min(batch, 4)) is the batch the proving step runs; bytes and
    projections use ``batch``. ``device`` as in ``parallel.mesh.make_mesh``
    ("cuda:0" with "gloo" shares one card); ``backend`` is required, as in
    ``parallel.launch.spawn``.
    Each row: ``tp``, rank 0's ``param_bytes_per_dev``, the KV window a
    rank reads (``kv_bytes_per_dev``), their sum ``step_bytes_per_dev``,
    ``collectives`` (every rank's counts equal, checked), ``executed``
    (every rank's logits finite), ``launches`` (rank 0's kernels),
    ``staged_bytes`` (rank 0's, under gloo on a card), ``ici_ms`` (the
    projected link time of the activation all-reduces), ``byte_ratio_vs_tp1``
    and, with ``single_chip_ms``, the ``projected_*`` columns.
    """
    hbm_gbps_val = hbm_gbps() if hbm_gbps_val is None else hbm_gbps_val
    tps = sorted(tps)
    if single_chip_ms is not None and tps[0] != 1:
        raise ValueError("single_chip_ms anchors projections on a tp=1 "
                         "measurement; include 1 in tps")
    world = max(tps)
    if any(world % tp for tp in tps):
        raise ValueError(f"every tp of {tps} must divide the largest")
    exec_batch = min(batch, 4) if exec_batch is None else exec_batch
    if torch.device(device).type == "cuda":
        _build.build(["flash_forward.cu", "paged_attention.cu", "quant_matmul.cu"])
    per_rank = spawn(_report_rank, world, backend=backend, device=device, timeout=timeout,
                     args=(cfg, tps, weights, kv, context, page_size, exec_batch, device,
                           backend))
    kv_elem_bytes = {"int8": 1.0, "fp8": 1.0, "int4": 0.5}.get(kv, 2.0)
    rows = []
    for i, tp in enumerate(tps):
        got = [r[i] for r in per_rank if r[i] is not None]
        if any(g["collectives"] != got[0]["collectives"] for g in got):
            raise AssertionError(f"tp {tp}: the ranks issued different collectives: "
                                 f"{[g['collectives'] for g in got]}")
        kv_window = int(batch * context * cfg.n_kv_heads * cfg.n_layers
                        * 2 * cfg.d_head * kv_elem_bytes) // tp
        rows.append({"tp": tp, "param_bytes_per_dev": got[0]["param_bytes"],
                     "kv_bytes_per_dev": kv_window,
                     "step_bytes_per_dev": got[0]["param_bytes"] + kv_window,
                     "collectives": got[0]["collectives"],
                     "executed": all(g["finite"] for g in got),
                     "launches": got[0]["launches"], "staged_bytes": got[0]["staged_bytes"]})

    # Projections off the tp 1 row: the HBM time scales with the bytes a
    # rank reads; the link adds the 2 activation all-reduces a layer.
    base = rows[0]
    for row in rows:
        tp = row["tp"]
        byte_ratio = row["step_bytes_per_dev"] / base["step_bytes_per_dev"]
        link_s = 0.0
        if tp > 1:
            ar_bytes = 2 * cfg.n_layers * batch * cfg.dim * 2  # bf16 activations
            link_s = ar_bytes * 2 * (tp - 1) / tp / (link_gbps * 1e9)
        if single_chip_ms is not None:
            hbm_s1 = base["step_bytes_per_dev"] / (hbm_gbps_val * 1e9)
            fixed_s = max(single_chip_ms / 1e3 - hbm_s1, 0.0) / tp ** 0.5
            proj_s = hbm_s1 * byte_ratio + fixed_s + link_s
            row["projected_ms_per_step"] = round(proj_s * 1e3, 3)
            row["projected_tokens_per_s"] = round(batch / proj_s, 1)
            row["projected_scaling_vs_tp1"] = round((single_chip_ms / 1e3) / proj_s, 3)
        row["ici_ms"] = round(link_s * 1e3, 4)
        row["byte_ratio_vs_tp1"] = round(byte_ratio, 4)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="1b")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--context", type=int, default=1024)
    # int4 is not offered: a row-parallel shard of packed int4 would split
    # K's nibble pairs (shard_params raises), as in JAX.
    ap.add_argument("--weights", default="int8", choices=["int8", "bf16"])
    ap.add_argument("--kv", default="int8", choices=["dense", "int8", "int4"])
    ap.add_argument("--tps", default="1,2,4,8")
    ap.add_argument("--single-chip-ms", type=float, default=None,
                    help="measured ms/step at tp=1 from bench_decode, to anchor the projection")
    ap.add_argument("--link-gbps", type=float, default=NVLINK_GBPS,
                    help="link rate a direction for the projection (default: NVLink 4's "
                         "published 450 GB/s on an H100 SXM, a spec sheet figure)")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (rank r on card r), "cuda:0" (every rank on one card, '
                         'with --backend gloo) or "cpu"')
    ap.add_argument("--backend", required=True, choices=["nccl", "gloo"],
                    help="nccl (one card a rank) or gloo (the cpu, or ranks sharing a card)")
    args = ap.parse_args(argv)

    from .bench_decode import MODELS

    rows = tp_decode_report(MODELS[args.model], tuple(int(t) for t in args.tps.split(",")),
                            batch=args.batch, context=args.context, weights=args.weights,
                            kv=args.kv, single_chip_ms=args.single_chip_ms,
                            link_gbps=args.link_gbps, device=args.device,
                            backend=args.backend)
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
