"""Llama-3-family transformer on the port's flash-attention kernel.

Counterpart of ``flash_attention_from_scratch_tpu/models/llama.py``:
RMSNorm, RoPE (with the Llama-3.1 frequency scaling), GQA attention through
``ops.flash_forward`` (``ops.flash_attention`` when autograd needs its
gradient), the SwiGLU (or tanh-GeLU) MLP and the next-token loss. Parameters are a
plain dict with the JAX package's tree and layout: every projection is
(in, out) and applied as ``x @ w``, so weights copy across unchanged
(:func:`params_from_jax`). A projection is either a dense tensor, applied
as a plain ``x @ w``, or a :class:`~..ops.quant_matmul.QuantizedWeight`
(:func:`quantize_params`, :func:`init_quantized_params`), applied through
the quantized matmul kernels (:func:`_mm`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.autodiff import flash_attention
from ..ops.configs import DType, KernelConfig
from ..ops.flash_forward import flash_forward
from ..ops.quant_matmul import (
    QuantizedWeight, concat_weights, quant_matmul, quantize_weight,
)
from ..parallel.collectives import (
    all_gather, copy_to, reduce_from, vocab_parallel_cross_entropy,
)
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS
from ..parallel.ring_attention import ring_flash_attention
from ..parallel.sharded_attention import shard_mapped_attention
from ..utils.device import resolve_device

__all__ = ["LlamaConfig", "LLAMA3_8B", "LLAMA31_8B", "MISTRAL_7B",
           "init_params", "params_from_jax", "forward", "loss_fn", "rms_norm",
           "rope_inv_freq", "rope_tables", "apply_rope", "quantize_params",
           "init_quantized_params", "fuse_projections", "local_heads", "local_rows"]


def _mm(x, w):
    """Dense or quantized matmul, dispatched by the weight's type.

    A :class:`QuantizedWeight` carries its recipe: ``act="int8"`` quantizes
    the activations too (W8A8 / W4A8), otherwise weight-only.
    """
    if isinstance(w, QuantizedWeight):
        return quant_matmul(x, w, act_quant=w.act == "int8")
    return x @ w


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 512
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 2
    d_head: int = 128
    hidden_dim: int = 1408
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: DType = DType.BF16
    # Sliding-window attention: each position attends only the previous
    # `sliding_window` tokens. 0 = full causal attention.
    sliding_window: int = 0
    # Per-layer window cycle: layer i uses window_pattern[i % len]
    # (0 = global). Overrides sliding_window when non-empty.
    window_pattern: tuple = ()
    # Gemma-2-family knobs (defaults = plain Llama): GeLU gate, sandwich
    # norms, sqrt(dim) embedding scale, logit softcaps, attention scale.
    mlp_act: str = "silu"
    post_norms: bool = False
    embed_scale: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    attn_scale: float = 0.0
    # One learned sink logit per Q head per layer joins the softmax
    # denominator (no value).
    attn_sinks: bool = False
    # Llama-3.1 RoPE frequency scaling for long context; 0 = none.
    rope_scale_factor: float = 0.0
    rope_low_factor: float = 1.0
    rope_high_factor: float = 4.0
    rope_orig_ctx: int = 8192

    def layer_window(self, li: int) -> int:
        """Effective sliding window of layer ``li`` (0 = full causal)."""
        if self.window_pattern:
            return self.window_pattern[li % len(self.window_pattern)]
        return self.sliding_window

    def attn_config(self, layer: int) -> KernelConfig:
        """The causal attention this model runs at ``layer``."""
        return KernelConfig(d_head=self.d_head, dtype=self.dtype, causal=True,
                            window=self.layer_window(layer),
                            attn_softcap=self.attn_softcap)


LLAMA3_8B = LlamaConfig(
    vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_head=128, hidden_dim=14336,
)

# Llama 3.1: same architecture + the published long-context RoPE scaling.
LLAMA31_8B = dataclasses.replace(
    LLAMA3_8B, rope_scale_factor=8.0, rope_low_factor=1.0,
    rope_high_factor=4.0, rope_orig_ctx=8192)

# Mistral-7B v0.1 shapes: 4096-token sliding window on every layer.
MISTRAL_7B = LlamaConfig(
    vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
    d_head=128, hidden_dim=14336, rope_theta=10000.0, sliding_window=4096)


def _dense_init(gen, shape, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w / math.sqrt(shape[0])).to(dtype)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters: normal / sqrt(fan_in) projections, unit norms.

    The tree and the (in, out) layout are the JAX package's. ``generator``
    must live on ``device``; the default device is the card, and without
    one this raises.
    """
    dev = resolve_device(device)
    dt = cfg.dtype.torch_dtype

    def dense(shape):
        return _dense_init(generator, shape, dt, dev)

    def ones(n):
        return torch.ones(n, dtype=dt, device=dev)

    q_dim = cfg.n_heads * cfg.d_head
    kv_dim = cfg.n_kv_heads * cfg.d_head
    params = {"embed": dense((cfg.vocab_size, cfg.dim)),
              "final_norm": ones(cfg.dim),
              "lm_head": dense((cfg.dim, cfg.vocab_size)),
              "layers": []}
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(cfg.dim),
            "wq": dense((cfg.dim, q_dim)),
            "wk": dense((cfg.dim, kv_dim)),
            "wv": dense((cfg.dim, kv_dim)),
            "wo": dense((q_dim, cfg.dim)),
            "mlp_norm": ones(cfg.dim),
            "w_gate": dense((cfg.dim, cfg.hidden_dim)),
            "w_up": dense((cfg.dim, cfg.hidden_dim)),
            "w_down": dense((cfg.hidden_dim, cfg.dim)),
        }
        if cfg.post_norms:
            layer["attn_post_norm"] = ones(cfg.dim)
            layer["mlp_post_norm"] = ones(cfg.dim)
        if cfg.attn_sinks:
            layer["attn_sinks"] = torch.zeros(cfg.n_heads, dtype=torch.float32,
                                              device=dev)
        params["layers"].append(layer)
    return params


_FROM_NUMPY_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                     "float16": torch.float16}


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def params_from_jax(tree, device="cuda"):
    """The JAX package's parameter tree as the port's parameters.

    Leaves may be numpy or JAX arrays; they keep their dtype. bf16 goes
    through float32 (exact both ways), because ``torch.from_numpy`` does not
    take numpy's bf16. A JAX ``QuantizedWeight`` (recognised by its fields)
    becomes the port's :class:`QuantizedWeight` with the same int8 values,
    fp32 scales, mode, original dtype and recipe.
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        if all(hasattr(x, a) for a in ("values", "scales", "mode", "act")):
            return QuantizedWeight(
                torch.from_numpy(np.array(x.values, np.int8)).to(dev),
                torch.from_numpy(np.array(x.scales, np.float32)).to(dev),
                x.mode, _FROM_NUMPY_DTYPE[np.dtype(x.orig_dtype).name], x.act)
        dt = _FROM_NUMPY_DTYPE.get(str(x.dtype))
        if dt is None:
            raise ValueError(f"unsupported parameter dtype {x.dtype}")
        return torch.from_numpy(np.array(x, np.float32)).to(dev, dt)

    return conv(tree)


def quantize_params(params, mode: str = "int8", quantize_lm_head: bool = True,
                    act: str = "bf16") -> dict:
    """Quantize every projection (and the lm_head) per output channel.

    Norms and the embedding stay dense. ``act="int8"`` selects the W8A8 /
    W4A8 recipe. Returns a new tree; the model dispatches through ``_mm``.
    """
    out = dict(params)
    if quantize_lm_head:
        out["lm_head"] = quantize_weight(params["lm_head"], mode, act)
    out["layers"] = [
        {k: (quantize_weight(v, mode, act) if k in _QUANT_KEYS else v)
         for k, v in layer.items()}
        for layer in params["layers"]]
    return out


def random_quantized_weight(shape, mode: str, act: str, generator: torch.Generator,
                            dtype=torch.bfloat16, device="cuda") -> QuantizedWeight:
    """A random (K, N) weight, already quantized: stored bytes uniform in
    [-127, 127] (int4: two nibbles per byte, so -8 occurs), and every column
    scaled by 1 / (qmax * sqrt(K)). The JAX package's recipe; the draws come
    from ``generator`` (on ``device``), so they are not the JAX package's
    numbers."""
    k, n = shape
    rows, qmax = (k // 2, 7.0) if mode == "int4" else (k, 127.0)
    vals = torch.randint(-127, 128, (rows, n), generator=generator,
                         dtype=torch.int8, device=device)
    scale = torch.full((n,), 1.0 / (qmax * math.sqrt(k)), dtype=torch.float32,
                       device=device)
    return QuantizedWeight(vals, scale, mode, dtype, act)


def init_quantized_params(cfg: LlamaConfig, generator: torch.Generator,
                          mode: str = "int8", quantize_lm_head: bool = True,
                          act: str = "bf16", device="cuda") -> dict:
    """Random already-quantized parameters, without the dense model first:
    every projection from ``random_quantized_weight``."""
    dev = resolve_device(device)
    dt = cfg.dtype.torch_dtype

    def qw(shape):
        return random_quantized_weight(shape, mode, act, generator, dt, dev)

    def ones(n):
        return torch.ones(n, dtype=dt, device=dev)

    q_dim = cfg.n_heads * cfg.d_head
    kv_dim = cfg.n_kv_heads * cfg.d_head
    params = {
        "embed": _dense_init(generator, (cfg.vocab_size, cfg.dim), dt, dev),
        "final_norm": ones(cfg.dim),
        "lm_head": (qw((cfg.dim, cfg.vocab_size)) if quantize_lm_head else
                    _dense_init(generator, (cfg.dim, cfg.vocab_size), dt, dev)),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": ones(cfg.dim),
            "wq": qw((cfg.dim, q_dim)),
            "wk": qw((cfg.dim, kv_dim)),
            "wv": qw((cfg.dim, kv_dim)),
            "wo": qw((q_dim, cfg.dim)),
            "mlp_norm": ones(cfg.dim),
            "w_gate": qw((cfg.dim, cfg.hidden_dim)),
            "w_up": qw((cfg.dim, cfg.hidden_dim)),
            "w_down": qw((cfg.hidden_dim, cfg.dim)),
        })
    return params


def rms_norm(x, weight, eps):
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (norm * weight.float()).to(x.dtype)


def rope_inv_freq(cfg: LlamaConfig, device=None):
    """Per-channel inverse frequencies (fp32), with the Llama-3.1 scaling.

    Wavelengths shorter than orig/high_factor keep their frequency, longer
    than orig/low_factor divide by scale_factor, and the band between
    interpolates.
    """
    d_head, theta = cfg.d_head, cfg.rope_theta
    inv_freq = 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                             device=device) / d_head))
    if not cfg.rope_scale_factor:
        return inv_freq
    wavelen = 2.0 * math.pi / inv_freq
    low_len = cfg.rope_orig_ctx / cfg.rope_low_factor
    high_len = cfg.rope_orig_ctx / cfg.rope_high_factor
    smooth = (cfg.rope_orig_ctx / wavelen - cfg.rope_low_factor) / (
        cfg.rope_high_factor - cfg.rope_low_factor)
    smooth = smooth.clamp(0.0, 1.0)
    scaled = inv_freq / cfg.rope_scale_factor
    blended = (1.0 - smooth) * scaled + smooth * inv_freq
    return torch.where(wavelen < high_len, inv_freq,
                       torch.where(wavelen > low_len, scaled, blended))


def rope_tables(seq_len: int, d_head: int, theta: float, cfg=None, *,
                device=None):
    """Rotary cos/sin tables, fp32, shape (seq_len, d_head // 2).

    Pass ``cfg`` to honour its RoPE scaling (its ``d_head`` and
    ``rope_theta`` then hold); the bare (d_head, theta) form is unscaled.
    """
    if cfg is not None:
        inv_freq = rope_inv_freq(cfg, device)
    else:
        inv_freq = 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                                 device=device) / d_head))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = pos[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (batch, heads, seq, d_head); rotate-half convention, fp32 math."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def fuse_projections(params) -> dict:
    """Each layer's Q/K/V and gate/up projections as one weight each.

    A layer's 7 weight matmuls become 4 (``wqkv``, ``wo``, ``w_gate_up``,
    ``w_down``): fewer, longer weight streams, and for an a8 model one
    activation quantization in place of three (and of two). Exact for dense
    weights (columns concatenated) and quantized ones (per-column scales
    concatenated, :func:`~..ops.quant_matmul.concat_weights`). The model
    uses the fused entries when present; unfused trees keep working.
    Biases on Q/K/V (Qwen2-style) raise ``NotImplementedError``, as in the
    JAX package. MoE layers (``experts``) raise ``ValueError``: they have no
    gate/up pair to fuse (the JAX function fails on them with a
    ``KeyError``).
    """
    def cat(ws):
        if isinstance(ws[0], QuantizedWeight):
            return concat_weights(ws)
        return torch.cat(ws, dim=1)

    if any("experts" in layer for layer in params["layers"]):
        raise ValueError("fuse_projections on MoE params: routed experts have no "
                         "w_gate/w_up pair to fuse; serve them unfused")
    if any("bq" in layer for layer in params["layers"]):
        raise NotImplementedError(
            "fuse_projections with QKV biases (Qwen2-style) would need a "
            "fused bias path through _qkv; keep projections unfused")
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        fused = {k: v for k, v in layer.items()
                 if k not in ("wq", "wk", "wv", "w_gate", "w_up")}
        fused["wqkv"] = cat([layer["wq"], layer["wk"], layer["wv"]])
        fused["w_gate_up"] = cat([layer["w_gate"], layer["w_up"]])
        out["layers"].append(fused)
    return out


def _qkv(layer, x, cfg: LlamaConfig):
    """x -> (q, k, v) rows, through the fused weight when present, plus the
    Qwen2-style biases when present (unfused only). The fused weight's q
    part is as wide as ``wo``'s input, which holds for a tp rank's shard
    (``[wq_r | wk_r | wv_r]``, ``parallel.mesh.shard_params``) too."""
    if "wqkv" in layer:
        qkv = _mm(x, layer["wqkv"])
        q_dim = layer["wo"].shape[0]
        kv_dim = (qkv.shape[-1] - q_dim) // 2
        return (qkv[..., :q_dim], qkv[..., q_dim:q_dim + kv_dim],
                qkv[..., q_dim + kv_dim:])
    q, k, v = _mm(x, layer["wq"]), _mm(x, layer["wk"]), _mm(x, layer["wv"])
    if "bq" in layer:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    return q, k, v


def _q_scale_ratio(cfg: LlamaConfig) -> float:
    """Factor turning the kernel's 1/sqrt(d_head) into cfg.attn_scale."""
    return (cfg.attn_scale * math.sqrt(cfg.d_head)) if cfg.attn_scale else 1.0


def local_heads(cfg: LlamaConfig, mesh=None) -> tuple[int, int]:
    """(Q heads, KV heads) of one rank: tp splits both, so each rank keeps
    whole GQA groups (``ValueError`` where tp divides either not)."""
    tp = 1 if mesh is None else mesh.size(MODEL_AXIS)
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide n_heads={cfg.n_heads} and "
                         f"n_kv_heads={cfg.n_kv_heads}")
    return cfg.n_heads // tp, cfg.n_kv_heads // tp


def _o_proj(layer, out, mesh=None, extra=None):
    """The row-parallel output projection: its partial products summed over
    tp (JAX's ``pin_residual``), then the replicated bias. ``extra`` (a
    LoRA delta of wo) adds after the bias, as in JAX; under tp it adds to
    the partial product before the sum, where a rank's delta is its head
    rows' part, so the sum counts it once."""
    y = _mm(out, layer["wo"])
    if extra is not None and mesh is not None and mesh.size(MODEL_AXIS) > 1:
        y, extra = y + extra, None
    y = reduce_from(y, mesh)
    y = y + layer["bo"] if "bo" in layer else y
    return y if extra is None else y + extra


def _mlp(layer, x, cfg: LlamaConfig):
    if "w_gate_up" in layer:
        gu = _mm(x, layer["w_gate_up"])
        h = gu.shape[-1] // 2
        g, up = gu[..., :h], gu[..., h:]
    else:
        g, up = _mm(x, layer["w_gate"]), _mm(x, layer["w_up"])
    if cfg.mlp_act == "gelu":
        gate = F.gelu(g.float(), approximate="tanh")
    else:
        gate = F.silu(g.float())
    return _mm(gate.to(x.dtype) * up, layer["w_down"])


def _attention(layer, x, cfg: LlamaConfig, cos, sin, li: int, adapt=None, mesh=None):
    """Causal attention of layer ``li`` over x (b, s, dim).

    Returns (output before wo (b, s, heads * d_head), k, v), with k and v
    (b, kv_heads, s, d_head) after RoPE: prefill writes them to pages. When
    autograd needs the gradient (grad enabled and an input requires it) the
    attention is :func:`flash_attention` (forward and backward kernels);
    otherwise the forward kernel alone. ``adapt(name, x)`` (serving with
    LoRA adapters, ``models/decode.py::lora_fn``) adds each projection's
    delta to q, k and v before RoPE. With ``mesh``: the rank's heads (tp),
    its sequence shard with the ring over ``sp`` (every row's RoPE position
    in ``cos``/``sin``), and :func:`shard_mapped_attention` for the
    gradient otherwise.
    """
    b, s, _ = x.shape
    hq, hkv = local_heads(cfg, mesh)
    q, k, v = _qkv(layer, copy_to(x, mesh), cfg)
    if adapt is not None:
        q, k, v = q + adapt("wq", x), k + adapt("wk", x), v + adapt("wv", x)
    q = q.view(b, s, hq, cfg.d_head).transpose(1, 2)
    k = k.view(b, s, hkv, cfg.d_head).transpose(1, 2)
    v = v.view(b, s, hkv, cfg.d_head).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.attn_scale:
        q = (q.float() * _q_scale_ratio(cfg)).to(q.dtype)
    sinks = layer.get("attn_sinks")
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, sinks))
    if mesh is not None and SEQ_AXIS in mesh.axis_names:
        out = ring_flash_attention(q, k, v, cfg.attn_config(li), mesh, sinks=sinks)
    elif grad and mesh is not None:
        out = shard_mapped_attention(q, k, v, cfg.attn_config(li), mesh, sinks)
    elif grad:
        out = flash_attention(q, k, v, cfg.attn_config(li), sinks)
    else:
        out = flash_forward(q, k, v, cfg.attn_config(li), sinks=sinks)
    return out.transpose(1, 2).reshape(b, s, hq * cfg.d_head), k, v


def _embed(params, tokens, cfg: LlamaConfig):
    """The embedding rows (a tp rank's slice of the model dim: its callers
    gather them, ``all_gather(..., MODEL_AXIS, -1)``)."""
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = (x.float() * math.sqrt(cfg.dim)).to(x.dtype)
    return x


def _lm_logits(params, h, cfg: LlamaConfig, mesh=None, gather: bool = True):
    """The lm_head product in the model dtype, then fp32 logits; a tp rank
    computes its vocab slice, and the slices are gathered unless
    ``gather`` is False."""
    logits = _mm(copy_to(h, mesh), params["lm_head"]).float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return all_gather(logits, mesh, MODEL_AXIS, -1) if gather else logits


def _residual_tail(cfg: LlamaConfig, layer, x, out, o_extra=None, mlp=_mlp, mesh=None):
    """Attention-output projection + MLP, with optional sandwich norms.
    ``o_extra`` adds to the output projection before the norm (the per-row
    LoRA delta of wo). ``mlp(layer, h, cfg)``: the dense MLP, or the
    serving path's, which routes a layer with experts
    (``models/decode.py::_mlp``). With a tp ``mesh`` both row-parallel
    products are summed over tp, a rank's ``o_extra`` with its wo part."""
    h = _o_proj(layer, out, mesh, o_extra)
    if cfg.post_norms:
        h = rms_norm(h, layer["attn_post_norm"], cfg.norm_eps)
    x = x + h
    h = reduce_from(mlp(layer, copy_to(rms_norm(x, layer["mlp_norm"], cfg.norm_eps), mesh),
                        cfg), mesh)
    if cfg.post_norms:
        h = rms_norm(h, layer["mlp_post_norm"], cfg.norm_eps)
    return x + h


def _layer(layer, x, cfg: LlamaConfig, cos, sin, li: int, mesh=None):
    out, _, _ = _attention(layer, rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                           cfg, cos, sin, li, mesh=mesh)
    return _residual_tail(cfg, layer, x, out, mesh=mesh)


def local_rows(x, mesh=None):
    """This rank's block of a (batch, seq, ...) tensor: the batch split over
    dp, the sequence over sp (the JAX specs ``P("dp", "sp")``)."""
    if mesh is None:
        return x
    for dim, axis in ((0, DATA_AXIS), (1, SEQ_AXIS)):
        n = x.shape[dim] // mesh.size(axis)
        if n * mesh.size(axis) != x.shape[dim]:
            raise ValueError(f"{axis}={mesh.size(axis)} must divide dim {dim} of "
                             f"{tuple(x.shape)}")
        x = x.narrow(dim, mesh.coord(axis) * n, n)
    return x


def forward(params, tokens, cfg: LlamaConfig, remat: bool = False, mesh=None,
            gather: bool = True):
    """tokens (batch, seq) int -> logits (batch, seq, vocab) fp32.

    The full-recompute oracle of the serving path and the training forward.
    ``seq`` must be a multiple of the kernel's tile (64); pad on the right,
    causality keeps the real rows exact. ``remat=True`` checkpoints each
    layer (``torch.utils.checkpoint``): the backward recomputes a layer's
    activations instead of keeping them, one more forward for
    O(seq * hidden) instead of O(layers * seq * hidden) saved memory.

    ``mesh`` (``parallel.mesh``): every rank passes the same global
    ``tokens`` and its shard of the parameters (``shard_params``), and gets
    its block of the logits, (batch / dp, seq / sp, vocab): the batch split
    over dp, the sequence over sp (the ring, each shard's RoPE positions
    its own), the heads and hidden columns over tp with the residual summed
    after ``wo`` and ``w_down`` and the vocab gathered (each rank's vocab
    slice alone with ``gather=False``).
    """
    s = tokens.shape[1]
    tokens = local_rows(tokens, mesh)
    x = all_gather(_embed(params, tokens, cfg), mesh, MODEL_AXIS, -1)
    cos, sin = rope_tables(s, cfg.d_head, cfg.rope_theta, cfg, device=x.device)
    if mesh is not None:
        n = tokens.shape[1]
        cos, sin = (t[mesh.coord(SEQ_AXIS) * n:][:n] for t in (cos, sin))
    for li, layer in enumerate(params["layers"]):
        if remat:
            x = checkpoint(_layer, layer, x, cfg, cos, sin, li, mesh,
                           use_reentrant=False)
        else:
            x = _layer(layer, x, cfg, cos, sin, li, mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x, cfg, mesh, gather)


def loss_fn(params, tokens, cfg: LlamaConfig, remat: bool = False, mesh=None):
    """Next-token cross-entropy, the mean over all positions (fp32).

    ``tokens`` (batch, seq + 1): the model reads the first ``seq`` and
    predicts the last ``seq``. Quantized parameters do not train (nor does
    the JAX package train them): they raise ``NotImplementedError``. With
    ``mesh`` every rank returns the global mean: its rows' sum of losses,
    summed over dp and sp, over the global count (the gradient of each
    rank's part passes through the sum unchanged, so each rank's gradients
    are its rows' share, which ``make_train_step`` sums). Over tp the
    logits stay split by vocabulary
    (``parallel.collectives.vocab_parallel_cross_entropy``).
    """
    if any(isinstance(w, QuantizedWeight)
           for w in [params["lm_head"]] + [v for layer in params["layers"]
                                           for v in layer.values()]):
        raise NotImplementedError(
            "training with quantized weights: neither package trains a "
            "QuantizedWeight")
    logits = forward(params, tokens[:, :-1], cfg, remat=remat, mesh=mesh, gather=False)
    targets = tokens[:, 1:]
    if mesh is None:
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
    nll = vocab_parallel_cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                       local_rows(targets, mesh).reshape(-1), mesh).sum()
    for axis in (DATA_AXIS, SEQ_AXIS):
        nll = reduce_from(nll, mesh, axis)
    return nll / targets.numel()
