"""A named mesh of ranks over ``torch.distributed``, and Llama's
tensor-parallel layout.

Counterpart of ``flash_attention_from_scratch_tpu/parallel/mesh.py``. The
JAX package places global arrays on a mesh of devices and GSPMD partitions
the program from the specs. Here every rank is one process that holds only
its own shard and runs the single-device kernels on it; the collectives
between ranks are explicit (``parallel/collectives.py``). So there is no
``mesh_interpret`` (a rank's kernels run where its tensors lie), and no
``spmd_safe`` or ``spmd_partition_mode`` (no partitioner to steer).

A :class:`Mesh` names its axes: ``dp`` (batch), ``tp`` (heads and hidden
columns, Megatron's layout) and ``sp`` (sequence, the ring) from
:func:`make_mesh` and :func:`make_sp_mesh`, or any one axis from
:func:`make_axis_mesh` (``pp``, the pipeline's stages; ``ep``, the
experts). Ranks lie on it in row-major order, and each axis has one process
group per line of ranks along it. A mesh covers the whole process group,
or, asked for with ``sub=True``, its first ranks (JAX's mesh over its first
devices); the ranks past it then get None. The mesh holds the rank's device
and the backend; under gloo it also counts the bytes its collectives stage
through host memory (``staged_bytes``).
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..ops.quant_matmul import QuantizedWeight
from ..utils.device import resolve_device

__all__ = ["Mesh", "make_mesh", "make_sp_mesh", "make_axis_mesh", "llama_param_specs",
           "shard_params", "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS"]

DATA_AXIS = "dp"
MODEL_AXIS = "tp"
SEQ_AXIS = "sp"


class Mesh:
    """A grid of ranks with named axes, over the default process group.

    ``shape``: {axis: size} in the given order; ``coords``: this rank's
    coordinate on each axis; ``device``: the rank's device; ``backend``:
    the process group's ("nccl" or "gloo"). Every rank must build the same
    mesh at the same point: the process groups are made collectively. The
    mesh covers the whole process group, or with ``sub`` its ranks
    [0, prod(axes)); a larger group's other ranks then take part in making
    the groups and must not use the mesh.
    """

    def __init__(self, axes: dict[str, int], device, backend: str, sub: bool = False):
        world, have = math.prod(axes.values()), dist.get_world_size()
        if have < world or (have > world and not sub):
            raise ValueError(f"a mesh of {axes} needs {world} ranks; the process group "
                             f"has {have}" + ("" if have < world else
                                              " (sub=True covers its first ranks)"))
        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        self.device = device
        self.backend = backend
        self.staged_bytes = 0
        rank = dist.get_rank()
        sizes = list(axes.values())
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        self.coords = {a: rank // s % n for a, s, n in zip(self.axis_names, strides, sizes)}
        self._groups, self._ranks = {}, {}
        for i, axis in enumerate(self.axis_names):
            if sizes[i] == 1:
                continue
            # One group per line along the axis; every rank makes every
            # group, in the same order, as new_group requires.
            for base in range(world):
                if base // strides[i] % sizes[i]:
                    continue
                ranks = [base + j * strides[i] for j in range(sizes[i])]
                group = dist.new_group(ranks)
                if rank in ranks:
                    self._groups[axis], self._ranks[axis] = group, ranks

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh lacks."""
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an axis the mesh lacks)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self._groups[axis]

    def peer(self, axis: str, coord: int) -> int:
        """The global rank at ``coord`` on ``axis``, this rank's elsewhere."""
        return self._ranks[axis][coord]


def _build(axes: dict[str, int], device, backend: str | None, sub: bool = False
           ) -> Mesh | None:
    """Join (or start, as ``torchrun`` launches) the default process group
    and build the mesh; with ``sub``, None on a rank past the mesh's ranks.
    ``backend`` defaults to "nccl" on CUDA and "gloo" on the CPU; NCCL needs
    one card a rank and raises with fewer, and a process group of another
    backend than the one asked for raises: the transport is never switched
    silently."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    world = math.prod(axes.values())
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"NCCL needs one card a rank: {world} ranks, {torch.cuda.device_count()} "
            "card(s); several ranks on one card need backend='gloo', named explicitly")
    if not dist.is_initialized():
        dist.init_process_group(backend)  # env:// rendezvous, as torchrun sets it
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, the mesh asked "
                         f"for {backend}")
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = Mesh(axes, dev, backend, sub)
    return mesh if dist.get_rank() < world else None


def make_mesh(dp: int, tp: int, *, device="cuda", backend: str | None = None,
              sub: bool = False) -> Mesh | None:
    """The (dp, tp) mesh of the JAX ``make_mesh``. ``device`` "cuda" puts
    rank r on card ``LOCAL_RANK`` (or r) modulo the cards; "cuda:0" puts
    every rank on card 0 (one card shared, with ``backend="gloo"``). The
    process group must have dp * tp ranks; with ``sub`` it may have more,
    the mesh covers its first dp * tp and the others get None (JAX's
    ``make_mesh`` over the first devices)."""
    return _build({DATA_AXIS: dp, MODEL_AXIS: tp}, device, backend, sub)


def make_axis_mesh(axis: str, n: int, *, device="cuda", backend: str | None = None,
                   sub: bool = False) -> Mesh | None:
    """A 1-D mesh of ``n`` ranks on ``axis``, the JAX tests' ``Mesh(devs,
    (axis,))``: "sp" (:func:`make_sp_mesh`), "pp" (``parallel/pipeline.py``)
    or "ep" (``models/moe.py``). ``device``, ``backend`` and ``sub`` as in
    :func:`make_mesh`."""
    return _build({axis: n}, device, backend, sub)


def make_sp_mesh(sp: int, *, device="cuda", backend: str | None = None) -> Mesh:
    """The 1-D ("sp",) mesh of the JAX ring tests: sequence shards for
    :func:`~.ring_attention.ring_flash_attention` and the model's context
    parallelism."""
    return make_axis_mesh(SEQ_AXIS, sp, device=device, backend=backend)


_COL, _ROW = (None, MODEL_AXIS), (MODEL_AXIS, None)
_LAYER_SPECS = {
    "attn_norm": (), "mlp_norm": (), "attn_post_norm": (), "mlp_post_norm": (),
    "wq": _COL, "wk": _COL, "wv": _COL, "wo": _ROW,
    # Qwen2-style biases shard with their projection's N; bo adds to the
    # summed row-parallel output.
    "bq": (MODEL_AXIS,), "bk": (MODEL_AXIS,), "bv": (MODEL_AXIS,), "bo": (),
    "attn_sinks": (MODEL_AXIS,),  # per Q head, with the head axis
    "w_gate": _COL, "w_up": _COL, "w_down": _ROW,
    "wqkv": _COL, "w_gate_up": _COL,
}
_TOP_SPECS = {"embed": (None, MODEL_AXIS), "final_norm": (), "lm_head": (None, MODEL_AXIS)}


def llama_param_specs(params) -> dict:
    """The JAX package's spec tree for the Llama parameters, a tuple per
    leaf (a ``PartitionSpec``'s entries): QKV and MLP-in column-parallel
    over tp, the output projections row-parallel, norms replicated, the
    embedding dim-sharded and the LM head vocab-sharded."""
    return {**_TOP_SPECS,
            "layers": [{k: _LAYER_SPECS[k] for k in layer} for layer in params["layers"]]}


def _shard_tensor(x, spec: tuple, mesh: Mesh, parts=None):
    """This rank's shard of ``x`` under ``spec`` (a copy, contiguous, on the
    mesh's device). ``parts``: the sizes of the fused blocks along the
    sharded dim; each block is split on its own, so the rank gets
    [block_0 shard | block_1 shard | ...] (a fused ``wqkv`` shards by part,
    like its three weights)."""
    tp, r = mesh.size(MODEL_AXIS), mesh.coord(MODEL_AXIS)
    if MODEL_AXIS not in spec or tp == 1:
        return x.to(mesh.device, copy=True)
    dim = spec.index(MODEL_AXIS)
    parts = parts or [x.shape[dim]]
    pieces, start = [], 0
    for n in parts:
        if n % tp:
            raise ValueError(f"dim {dim} block of {n} does not split over tp={tp}")
        pieces.append(x.narrow(dim, start + r * (n // tp), n // tp))
        start += n
    return torch.cat(pieces, dim).to(mesh.device).contiguous()


def _fused_parts(key: str, layer, n: int):
    """Block sizes along N of a fused weight: [q | k | v] (q's width is wo's
    input width) or [gate | up]; None for an unfused weight."""
    if key == "wqkv":
        q_dim = layer["wo"].shape[0]
        return [q_dim, (n - q_dim) // 2, (n - q_dim) // 2]
    if key == "w_gate_up":
        return [n // 2, n // 2]
    return None


def _place(x, spec: tuple, mesh: Mesh, parts=None):
    """This rank's shard of a dense or quantized leaf."""
    if not isinstance(x, QuantizedWeight):
        return _shard_tensor(x, spec, mesh, parts)
    if spec and spec[0] == MODEL_AXIS and x.mode == "int4":
        raise NotImplementedError(
            "row-parallel sharding of packed int4 weights would split the K-dim "
            "nibble pairing; use int8 for row-parallel layers or reshard before "
            "quantizing")
    scale_spec = (spec[1],) if len(spec) > 1 and spec[1] is not None else ()
    return QuantizedWeight(_shard_tensor(x.values, spec, mesh, parts),
                           _shard_tensor(x.scales, scale_spec, mesh, parts),
                           x.mode, x.orig_dtype, x.act)


def _shard_layer(layer: dict, mesh: Mesh) -> dict:
    """This rank's slice of one layer's parameters (:func:`shard_params`)."""
    if "experts" in layer:
        raise NotImplementedError(
            "MoE params under a dp/tp mesh: the JAX package has no specs for them "
            "(ROADMAP.md watch list); expert parallelism is models.moe.shard_moe_params "
            "on an \"ep\" mesh")
    return {k: _place(v, _LAYER_SPECS[k], mesh, _fused_parts(k, layer, v.shape[-1]))
            for k, v in layer.items()}


def shard_params(params, mesh: Mesh) -> dict:
    """Each rank's slice of the parameter tree, per :func:`llama_param_specs`,
    on the mesh's device. A ``QuantizedWeight`` keeps its values sharded
    like the dense weight and its per-column scales sharded with N on a
    column-parallel weight, replicated on a row-parallel one; packed int4
    on a row-parallel weight raises ``NotImplementedError`` (the shard would
    split K's nibble pairs), as in JAX. MoE layers raise
    ``NotImplementedError``, as JAX's ``llama_param_specs`` fails on them
    (experts shard over "ep": ``models.moe.shard_moe_params``)."""
    return {**{k: _place(params[k], spec, mesh) for k, spec in _TOP_SPECS.items()},
            "layers": [_shard_layer(layer, mesh) for layer in params["layers"]]}
