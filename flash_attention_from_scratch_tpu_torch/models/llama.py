"""Llama-3-family transformer on the port's flash-attention kernel.

Counterpart of ``flash_attention_from_scratch_tpu/models/llama.py``:
RMSNorm, RoPE (with the Llama-3.1 frequency scaling), GQA attention through
``ops.flash_forward``, and the SwiGLU (or tanh-GeLU) MLP. Parameters are a
plain dict with the JAX package's tree and layout: every projection is
(in, out) and applied as ``x @ w``, so weights copy across unchanged
(:func:`params_from_jax`). The large matrix products are plain ``x @ w``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.configs import DType, KernelConfig
from ..ops.flash_forward import flash_forward
from ..utils.device import resolve_device

__all__ = ["LlamaConfig", "LLAMA3_8B", "LLAMA31_8B", "MISTRAL_7B",
           "init_params", "params_from_jax", "forward", "rms_norm",
           "rope_inv_freq", "rope_tables", "apply_rope"]


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


def params_from_jax(tree, device="cuda"):
    """The JAX package's parameter tree as the port's parameters.

    Leaves may be numpy or JAX arrays; they keep their dtype. bf16 goes
    through float32 (exact both ways), because ``torch.from_numpy`` does not
    take numpy's bf16.
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        dt = _FROM_NUMPY_DTYPE.get(str(x.dtype))
        if dt is None:
            raise ValueError(f"unsupported parameter dtype {x.dtype}")
        return torch.from_numpy(np.array(x, np.float32)).to(dev, dt)

    return conv(tree)


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


def rope_tables(seq_len: int, cfg: LlamaConfig, device=None):
    """Rotary cos/sin tables, fp32, shape (seq_len, d_head // 2)."""
    inv_freq = rope_inv_freq(cfg, device)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    angles = pos[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (batch, heads, seq, d_head); rotate-half convention, fp32 math."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _qkv(layer, x):
    """x -> (q, k, v) rows, plus the Qwen2-style biases when present."""
    q, k, v = x @ layer["wq"], x @ layer["wk"], x @ layer["wv"]
    if "bq" in layer:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    return q, k, v


def _q_scale_ratio(cfg: LlamaConfig) -> float:
    """Factor turning the kernel's 1/sqrt(d_head) into cfg.attn_scale."""
    return (cfg.attn_scale * math.sqrt(cfg.d_head)) if cfg.attn_scale else 1.0


def _o_proj(layer, out):
    y = out @ layer["wo"]
    return y + layer["bo"] if "bo" in layer else y


def _mlp(layer, x, cfg: LlamaConfig):
    g, up = x @ layer["w_gate"], x @ layer["w_up"]
    if cfg.mlp_act == "gelu":
        gate = F.gelu(g.float(), approximate="tanh")
    else:
        gate = F.silu(g.float())
    return (gate.to(x.dtype) * up) @ layer["w_down"]


def _attention(layer, x, cfg: LlamaConfig, cos, sin, li: int):
    """Causal attention of layer ``li`` over x (b, s, dim).

    Returns (output before wo (b, s, n_heads * d_head), k, v), with k and v
    (b, kv_heads, s, d_head) after RoPE: prefill writes them to pages.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(layer, x)
    q = q.view(b, s, cfg.n_heads, cfg.d_head).transpose(1, 2)
    k = k.view(b, s, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    v = v.view(b, s, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.attn_scale:
        q = (q.float() * _q_scale_ratio(cfg)).to(q.dtype)
    out = flash_forward(q, k, v, cfg.attn_config(li), sinks=layer.get("attn_sinks"))
    return out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head), k, v


def _embed(params, tokens, cfg: LlamaConfig):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = (x.float() * math.sqrt(cfg.dim)).to(x.dtype)
    return x


def _lm_logits(params, h, cfg: LlamaConfig):
    """The lm_head product in the model dtype, then fp32 logits."""
    logits = (h @ params["lm_head"]).float()
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _residual_tail(cfg: LlamaConfig, layer, x, out):
    """Attention-output projection + MLP, with optional sandwich norms."""
    h = _o_proj(layer, out)
    if cfg.post_norms:
        h = rms_norm(h, layer["attn_post_norm"], cfg.norm_eps)
    x = x + h
    h = _mlp(layer, rms_norm(x, layer["mlp_norm"], cfg.norm_eps), cfg)
    if cfg.post_norms:
        h = rms_norm(h, layer["mlp_post_norm"], cfg.norm_eps)
    return x + h


def forward(params, tokens, cfg: LlamaConfig):
    """tokens (batch, seq) int -> logits (batch, seq, vocab) fp32.

    The full-recompute oracle of the serving path. ``seq`` must be a
    multiple of the kernel's tile (64); pad on the right, causality keeps
    the real rows exact.
    """
    x = _embed(params, tokens, cfg)
    cos, sin = rope_tables(tokens.shape[1], cfg, device=x.device)
    for li, layer in enumerate(params["layers"]):
        out, _, _ = _attention(layer, rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                               cfg, cos, sin, li)
        x = _residual_tail(cfg, layer, x, out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(params, x, cfg)
