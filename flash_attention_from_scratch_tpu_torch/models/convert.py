"""HuggingFace checkpoints into the port: Llama(-compatible), Qwen2, Gemma-2.

Counterpart of ``flash_attention_from_scratch_tpu/models/convert.py``:
``from_hf_llama`` maps a ``transformers`` Llama(-compatible) model or a
state dict onto the port's parameter tree and ``LlamaConfig`` (Llama-3.1
RoPE scaling, Qwen2-style q/k/v/o biases, tied embeddings), optionally
quantizing the projections on the way in (``models.llama.quantize_params``);
``from_hf_gemma2`` does so for Gemma-2; ``load_hf_checkpoint`` reads a
checkpoint directory (``*.safetensors`` shards and ``config.json``) without
building a model.

Layout: an HF ``nn.Linear`` weight is (out, in) and the port right-multiplies,
so every projection is transposed to (in, out). HF's rotary embedding is the
rotate-half convention of ``models.llama.apply_rope`` with the same
frequencies, so no permutation is needed.

Neither ``transformers`` nor ``safetensors`` is imported: the card's machine
has neither. A model is any object with ``.state_dict()`` and ``.config``;
shards are read by :func:`read_safetensors`, a reader of the format itself.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import types

import torch

from ..ops.configs import DType
from ..utils.device import resolve_device
from .llama import LlamaConfig, quantize_params

__all__ = ["from_hf_llama", "from_hf_gemma2", "config_from_hf",
           "config_from_hf_gemma2", "load_hf_checkpoint", "read_safetensors"]

# The safetensors dtype names the reader takes.
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}


def read_safetensors(path) -> dict:
    """The tensors of one ``.safetensors`` file, on the CPU.

    The format: an 8-byte little-endian header length n, n bytes of JSON
    ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, offsets past
    the header, and an optional "__metadata__"), then the little-endian
    data. The file is read once into one buffer, which the tensors share.
    A dtype outside ``SAFETENSORS_DTYPES`` or a size that disagrees with
    the shape raises ``ValueError``.
    """
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    n = int.from_bytes(buf[:8], "little")
    header = json.loads(buf[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = SAFETENSORS_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * dt.itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} has {end - begin} bytes for "
                             f"shape {shape} of {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dt)
        else:
            out[name] = torch.frombuffer(buf, dtype=dt, count=count,
                                         offset=base + begin).reshape(shape)
    return out


def config_from_hf(hf_config, **overrides) -> LlamaConfig:
    """LlamaConfig from a transformers LlamaConfig(-like) object (any object
    with its attributes), with the Llama-3.1 RoPE scaling when
    ``rope_scaling["rope_type"]`` is "llama3"."""
    d_head = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads)
    rope_scaling = getattr(hf_config, "rope_scaling", None) or {}
    fields = dict(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        d_head=d_head,
        hidden_dim=hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        norm_eps=getattr(hf_config, "rms_norm_eps", 1e-5),
        sliding_window=getattr(hf_config, "sliding_window", None) or 0,
    )
    if rope_scaling.get("rope_type") == "llama3":
        fields.update(
            rope_scale_factor=rope_scaling["factor"],
            rope_low_factor=rope_scaling.get("low_freq_factor", 1.0),
            rope_high_factor=rope_scaling.get("high_freq_factor", 4.0),
            rope_orig_ctx=rope_scaling.get("original_max_position_embeddings", 8192),
        )
    fields.update(overrides)
    return LlamaConfig(**fields)


def config_from_hf_gemma2(hf_config, **overrides) -> LlamaConfig:
    """LlamaConfig for a transformers Gemma2Config(-like) object: the GeLU
    MLP, sandwich norms, the sqrt(dim) embedding scale, the attention and
    final logit softcaps, the query_pre_attn_scalar attention scale and the
    alternating window (even layers sliding, odd ones global)."""
    fields = dict(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        d_head=hf_config.head_dim,
        hidden_dim=hf_config.intermediate_size,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        norm_eps=hf_config.rms_norm_eps,
        mlp_act="gelu",
        post_norms=True,
        embed_scale=True,
        attn_softcap=getattr(hf_config, "attn_logit_softcapping", 0.0) or 0.0,
        final_softcap=getattr(hf_config, "final_logit_softcapping", 0.0) or 0.0,
        attn_scale=hf_config.query_pre_attn_scalar ** -0.5,
        window_pattern=(hf_config.sliding_window, 0),
    )
    fields.update(overrides)
    return LlamaConfig(**fields)


def _with_dtype(cfg: LlamaConfig, dtype) -> LlamaConfig:
    want = DType.from_torch(dtype)
    return cfg if cfg.dtype == want else dataclasses.replace(cfg, dtype=want)


def _unprefixed(sd) -> dict:
    """A state dict with transformers' "model." prefix taken off."""
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in sd.items()}


def _converter(dtype, device):
    """``w(t, transpose)``: a tensor (or array) as an owned, contiguous
    tensor of ``dtype`` on ``device``, transposed first if asked."""
    dev = resolve_device(device)

    def w(t, transpose=True):
        t = torch.as_tensor(t)
        if transpose:
            t = t.T
        return t.to(device=dev, dtype=dtype, memory_format=torch.contiguous_format,
                    copy=True)

    return w, dev


def from_hf_llama(model_or_state_dict, cfg: LlamaConfig | None = None, *,
                  dtype=torch.bfloat16, quantize: str | None = None,
                  act: str = "bf16", device="cuda"):
    """Convert a transformers Llama model (or its state dict) to params.

    Args:
      model_or_state_dict: an object with ``.state_dict()`` and ``.config``
        (``LlamaForCausalLM``; the config is read from it when ``cfg`` is
        None) or a raw mapping of names to tensors (then ``cfg`` is required:
        ``ValueError``). The "model." prefix is optional.
      dtype: the parameters' torch dtype (``cfg.dtype`` follows it).
      quantize: None, "int8" or "int4": every projection quantized on the way
        in (``quantize_params``); ``act="int8"`` picks the W8A8 / W4A8 recipe.
      device: where the parameters go (the card by default).

    A missing ``lm_head.weight`` ties the head to the embedding. Qwen2-style
    q/k/v (and o) biases become ``bq``/``bk``/``bv`` (``bo``). A weight the
    tree has no place for raises ``ValueError`` rather than being dropped.
    Returns (params, cfg).
    """
    if hasattr(model_or_state_dict, "state_dict"):
        if cfg is None:
            cfg = config_from_hf(model_or_state_dict.config)
        sd = model_or_state_dict.state_dict()
    else:
        if cfg is None:
            raise ValueError("cfg is required when passing a raw state dict")
        sd = dict(model_or_state_dict)
    cfg = _with_dtype(cfg, dtype)
    sd = _unprefixed(sd)
    conv, _ = _converter(dtype, device)

    def w(name, transpose=True):
        return conv(sd[name], transpose)

    embed = w("embed_tokens.weight", transpose=False)
    params = {
        "embed": embed,
        "final_norm": w("norm.weight", transpose=False),
        # The tied head is a copy of the embedding, as in the JAX package.
        "lm_head": w("lm_head.weight") if "lm_head.weight" in sd else embed.T.contiguous(),
        "layers": [],
    }
    consumed = {"embed_tokens.weight", "norm.weight", "lm_head.weight"}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        names = {"attn_norm": "input_layernorm.weight", "wq": "self_attn.q_proj.weight",
                 "wk": "self_attn.k_proj.weight", "wv": "self_attn.v_proj.weight",
                 "wo": "self_attn.o_proj.weight", "mlp_norm": "post_attention_layernorm.weight",
                 "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
                 "w_down": "mlp.down_proj.weight"}
        layer = {k: w(pre + n, transpose=k.startswith("w")) for k, n in names.items()}
        biases = {"bq": "self_attn.q_proj.bias", "bk": "self_attn.k_proj.bias",
                  "bv": "self_attn.v_proj.bias"}
        if pre + biases["bq"] in sd:  # Qwen2-style QKV biases
            layer.update({k: w(pre + n, transpose=False) for k, n in biases.items()})
        if pre + "self_attn.o_proj.bias" in sd:
            layer["bo"] = w(pre + "self_attn.o_proj.bias", transpose=False)
        params["layers"].append(layer)
        consumed |= {pre + n for n in names.values()} | {pre + n for n in biases.values()}
        consumed.add(pre + "self_attn.o_proj.bias")
    leftover = [k for k in sd if k not in consumed and not k.endswith("rotary_emb.inv_freq")]
    if leftover:
        # Dropping weights (an MLP bias of a "Llama-compatible" checkpoint)
        # would give a wrong model without a sign; refuse instead.
        raise ValueError(
            f"unmapped weights in checkpoint (unsupported architecture variant?): "
            f"{sorted(leftover)[:8]}" + (" ..." if len(leftover) > 8 else ""))
    if quantize:
        params = quantize_params(params, quantize, act=act)
    return params, cfg


def from_hf_gemma2(model, cfg: LlamaConfig | None = None, *, dtype=torch.float32,
                   device="cuda"):
    """Convert a transformers Gemma2ForCausalLM (any object with
    ``.state_dict()`` and ``.config``) to params; returns (params, cfg).

    Gemma's RMSNorm scales by (1 + weight): the +1 is folded into the stored
    weight (in fp32, then cast), so the port's plain RMSNorm applies. The
    head is always tied (a copy of the embedding, transposed). A weight left
    over raises ``ValueError``.
    """
    if cfg is None:
        cfg = config_from_hf_gemma2(model.config)
    cfg = _with_dtype(cfg, dtype)
    sd = _unprefixed(model.state_dict())
    conv, dev = _converter(dtype, device)

    def w(name, transpose=True):
        return conv(sd.pop(name), transpose)

    def norm(name):
        return (torch.as_tensor(sd.pop(name)).to(dev).float() + 1.0).to(dtype)

    embed = w("embed_tokens.weight", transpose=False)
    params = {"embed": embed, "final_norm": norm("norm.weight"),
              "lm_head": embed.T.contiguous(), "layers": []}
    sd.pop("lm_head.weight", None)  # tied
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        params["layers"].append({
            "attn_norm": norm(pre + "input_layernorm.weight"),
            "wq": w(pre + "self_attn.q_proj.weight"),
            "wk": w(pre + "self_attn.k_proj.weight"),
            "wv": w(pre + "self_attn.v_proj.weight"),
            "wo": w(pre + "self_attn.o_proj.weight"),
            "attn_post_norm": norm(pre + "post_attention_layernorm.weight"),
            "mlp_norm": norm(pre + "pre_feedforward_layernorm.weight"),
            "w_gate": w(pre + "mlp.gate_proj.weight"),
            "w_up": w(pre + "mlp.up_proj.weight"),
            "w_down": w(pre + "mlp.down_proj.weight"),
            "mlp_post_norm": norm(pre + "post_feedforward_layernorm.weight"),
        })
    leftover = [k for k in sd if not k.endswith("rotary_emb.inv_freq")]
    if leftover:
        raise ValueError(f"unmapped Gemma2 weights: {sorted(leftover)[:8]}")
    return params, cfg


def load_hf_checkpoint(path, cfg: LlamaConfig | None = None, **kw):
    """Load a HF Llama checkpoint directory: every ``*.safetensors`` shard
    (:func:`read_safetensors`; no model is built) and, when ``cfg`` is None,
    ``config.json``. Keyword arguments go to :func:`from_hf_llama` (dtype,
    quantize, act, device). No shard raises ``FileNotFoundError``. Unlike
    the JAX package's, which reads shards through numpy, it reads bf16
    shards."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors shards under {path!r}")
    sd = {}
    for f in files:
        sd.update(read_safetensors(f))
    if cfg is None:
        with open(os.path.join(path, "config.json")) as f:
            cfg = config_from_hf(types.SimpleNamespace(**json.load(f)))
    return from_hf_llama(sd, cfg, **kw)
