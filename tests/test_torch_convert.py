"""The port's HF converters and safetensors reader (``models/convert.py``).

Follows the JAX package's ``tests/test_convert.py``: random-init
``transformers`` Llama, Llama with Qwen2-style attention biases, and
Gemma-2 models built here (no download), converted by both packages.

- Converted tensors equal the JAX package's converted arrays exactly (fp32
  and bf16), quantized ones byte for byte with equal scales; configs equal
  field by field (Llama-3.1 RoPE scaling included).
- The port's fp32 ``forward`` matches HF's logits within the JAX tests'
  bounds (2e-2; Gemma-2 3e-2), and serving a converted model stays within
  the JAX tests' teacher-forced slack of HF's greedy logits (int8 weights
  0.6, Gemma-2 0.1).
- ``load_hf_checkpoint``: on fp32 shards (``save_pretrained``, and
  ``safetensors.torch.save_file`` in two shards) it equals the JAX
  package's; on bf16 shards it equals the port's ``from_hf_llama`` on the
  same tensors and the JAX package's (whose numpy reader gets bf16 from
  ml_dtypes, which importing jax registers); the
  reader equals ``safetensors.safe_open`` bit for bit on every dtype it
  takes.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from safetensors import safe_open  # noqa: E402

from flash_attention_from_scratch_tpu.models import convert as jax_convert  # noqa: E402
from flash_attention_from_scratch_tpu_torch.models import convert, llama  # noqa: E402
from flash_attention_from_scratch_tpu_torch.models.train import param_leaves  # noqa: E402
from flash_attention_from_scratch_tpu_torch.ops.quant_matmul import QuantizedWeight  # noqa: E402
from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer  # noqa: E402

LLAMA = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
             head_dim=128, max_position_embeddings=512, rope_theta=10000.0,
             rms_norm_eps=1e-5, tie_word_embeddings=False, mlp_bias=False)
GEMMA2 = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
              num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
              head_dim=128, max_position_embeddings=512, rope_theta=10000.0,
              rms_norm_eps=1e-6, query_pre_attn_scalar=144,
              attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
              sliding_window=64, attention_dropout=0.0)


def _llama(seed=0, **extra):
    torch.manual_seed(seed)
    cfg = transformers.LlamaConfig(**{**LLAMA, "attention_bias": False, **extra})
    return transformers.LlamaForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def hf_model():
    return _llama()


@pytest.fixture(scope="module")
def qwen_style():
    """attention_bias=True; HF inits the biases to zero, so draw them."""
    model = _llama(1, attention_bias=True)
    with torch.no_grad():
        for layer in model.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj, layer.self_attn.o_proj):
                proj.bias.normal_(std=0.5)
    return model


@pytest.fixture(scope="module")
def gemma2():
    torch.manual_seed(2)
    return transformers.Gemma2ForCausalLM(transformers.Gemma2Config(**GEMMA2)).eval()


def _assert_tree_equals_jax(params, jparams):
    """Leaves in tree order, values and dtypes equal (QuantizedWeight: its
    bytes, scales, mode and recipe)."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    got, want = leaves(params), leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, QuantizedWeight):
            assert (g.mode, g.act) == (w.mode, w.act)
            np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))
            np.testing.assert_array_equal(g.scales.numpy(), np.asarray(w.scales))
            continue
        assert g.shape == tuple(w.shape) and g.is_contiguous()
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def _config_fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


def _jax_config_fields(jcfg, port_cfg):
    want = dataclasses.asdict(jcfg)
    return {k: want[k] for k in _config_fields(port_cfg)}


@pytest.mark.parametrize("rope_scaling", [None, dict(rope_type="llama3", factor=8.0,
                                                     low_freq_factor=1.0,
                                                     high_freq_factor=4.0,
                                                     original_max_position_embeddings=8192)])
def test_config_from_hf_matches_jax(rope_scaling):
    hf = transformers.LlamaConfig(**{**LLAMA, "rope_scaling": rope_scaling,
                                     "sliding_window": 32})
    cfg = convert.config_from_hf(hf)
    assert _config_fields(cfg) == _jax_config_fields(jax_convert.config_from_hf(hf), cfg)
    assert bool(cfg.rope_scale_factor) == (rope_scaling is not None)
    # A config.json as a namespace (load_hf_checkpoint's path) gives the same.
    ns = types.SimpleNamespace(**json.loads(hf.to_json_string()))
    assert convert.config_from_hf(ns) == cfg


def test_config_from_hf_gemma2_matches_jax(gemma2):
    cfg = convert.config_from_hf_gemma2(gemma2.config)
    assert _config_fields(cfg) == _jax_config_fields(
        jax_convert.config_from_hf_gemma2(gemma2.config), cfg)
    assert cfg.window_pattern == (64, 0) and cfg.mlp_act == "gelu"
    assert cfg.post_norms and cfg.embed_scale and abs(cfg.attn_scale - 144 ** -0.5) < 1e-12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["llama", "qwen_style"])
def test_from_hf_llama_equals_jax(which, dtype, request):
    model = request.getfixturevalue("hf_model" if which == "llama" else which)
    params, cfg = convert.from_hf_llama(model, dtype=getattr(torch, dtype), device="cpu")
    jparams, jcfg = jax_convert.from_hf_llama(model, dtype=getattr(jnp, dtype))
    _assert_tree_equals_jax(params, jax.device_get(jparams))
    assert cfg.dtype.torch_dtype == getattr(torch, dtype)
    assert ("bq" in params["layers"][0]) == (which == "qwen_style")
    assert ("bo" in params["layers"][0]) == (which == "qwen_style")


@pytest.mark.parametrize("mode,act", [("int8", "bf16"), ("int4", "int8")])
def test_quantized_conversion_equals_jax(hf_model, mode, act):
    params, _ = convert.from_hf_llama(hf_model, dtype=torch.float32, quantize=mode,
                                      act=act, device="cpu")
    jparams, _ = jax_convert.from_hf_llama(hf_model, dtype=jnp.float32, quantize=mode,
                                           act=act)
    assert isinstance(params["layers"][0]["wq"], QuantizedWeight)
    _assert_tree_equals_jax(params, jax.device_get(jparams))


def _hf_logits(model, tokens):
    with torch.no_grad():
        return model(torch.tensor(tokens)).logits.float().numpy()


@pytest.mark.parametrize("which", ["llama", "qwen_style"])
def test_forward_matches_hf(which, request):
    model = request.getfixturevalue("hf_model" if which == "llama" else which)
    params, cfg = convert.from_hf_llama(model, dtype=torch.float32, device="cpu")
    tokens = (np.arange(128)[None, :] * (3 if which == "qwen_style" else 1) + 1) % 256
    ref = _hf_logits(model, tokens)
    with torch.no_grad():
        got = llama.forward(params, torch.from_numpy(tokens), cfg).numpy()
    assert np.abs(got - ref).max() < 2e-2
    assert np.abs(ref).max() > 1.0  # not vacuous
    if which == "qwen_style":
        with pytest.raises(NotImplementedError, match="fuse"):
            llama.fuse_projections(params)


def test_raw_state_dict_tied_embeddings_and_errors(hf_model):
    sd = {k: v for k, v in hf_model.state_dict().items() if k != "lm_head.weight"}
    cfg = convert.config_from_hf(hf_model.config)
    params, _ = convert.from_hf_llama(sd, cfg, dtype=torch.float32, device="cpu")
    assert params["lm_head"].shape == (cfg.dim, cfg.vocab_size)
    torch.testing.assert_close(params["lm_head"], params["embed"].T, rtol=0, atol=0)
    jparams, _ = jax_convert.from_hf_llama(sd, jax_convert.config_from_hf(hf_model.config),
                                           dtype=jnp.float32)
    _assert_tree_equals_jax(params, jax.device_get(jparams))
    with pytest.raises(ValueError, match="cfg"):
        convert.from_hf_llama(sd, device="cpu")
    unmapped = dict(sd, **{"model.layers.0.mlp.gate_proj.bias": torch.zeros(512)})
    with pytest.raises(ValueError, match="unmapped"):
        convert.from_hf_llama(unmapped, cfg, device="cpu")
    with pytest.raises(ValueError, match="unmapped"):
        jax_convert.from_hf_llama(unmapped, jax_convert.config_from_hf(hf_model.config))


def test_quantized_conversion_serves_near_hf_greedy(hf_model):
    """tests/test_convert.py::test_hf_conversion_quantized_decode: int8
    weights serve tokens within 0.6 of HF's row max (weight rounding)."""
    params, cfg = convert.from_hf_llama(hf_model, dtype=torch.float32, quantize="int8",
                                        device="cpu")
    server = GenerationServer(params, cfg, num_pages=16, page_size=64, max_batch=1,
                              pages_per_seq=8, device="cpu")
    prompt = list(range(10, 40))
    server.submit(1, prompt, 4)
    got = server.run()[1]
    assert len(got) == 4
    toks = list(prompt)
    for g in got:
        logits = _hf_logits(hf_model, [toks])[0, -1]
        assert logits.max() - logits[g] <= 0.6, (toks, g)
        toks.append(g)


def test_gemma2_conversion_equals_jax_and_matches_hf(gemma2):
    params, cfg = convert.from_hf_gemma2(gemma2, device="cpu")
    jparams, _ = jax_convert.from_hf_gemma2(gemma2)
    _assert_tree_equals_jax(params, jax.device_get(jparams))
    tokens = (np.arange(192)[None, :] * 5 + 3) % 256  # past the window of 64
    ref = _hf_logits(gemma2, tokens)
    with torch.no_grad():
        got = llama.forward(params, torch.from_numpy(tokens), cfg).numpy()
    assert np.abs(got - ref).max() < 3e-2
    assert np.abs(ref).max() > 1.0
    leftover = types.SimpleNamespace(
        config=gemma2.config,
        state_dict=lambda: {**gemma2.state_dict(), "model.extra.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="unmapped"):
        convert.from_hf_gemma2(leftover, device="cpu")


def test_gemma2_serving_matches_hf_greedy(gemma2):
    """tests/test_convert.py::test_gemma2_serving: paged decode with the
    softcaps, alternating windows and sandwich norms, within 0.1 of HF."""
    params, cfg = convert.from_hf_gemma2(gemma2, device="cpu")
    server = GenerationServer(params, cfg, num_pages=16, page_size=64, max_batch=1,
                              pages_per_seq=8, device="cpu")
    prompt = [(i * 7 + 1) % 256 for i in range(100)]
    server.submit(1, prompt, 4)
    got = server.run()[1]
    toks = list(prompt)
    for g in got:
        logits = _hf_logits(gemma2, [toks])[0, -1]
        assert logits.max() - logits[g] <= 0.1, (len(toks), g)
        toks.append(g)


def _shard_dir(tmp_path, sd, hf_config, n_shards):
    names = sorted(sd)
    for i in range(n_shards):
        part = {k: sd[k].contiguous() for k in names[i::n_shards]}
        safetensors_torch.save_file(part, str(tmp_path / f"model-{i:05d}-of-{n_shards:05d}"
                                                          ".safetensors"))
    (tmp_path / "config.json").write_text(hf_config.to_json_string())
    return str(tmp_path)


def test_load_hf_checkpoint_fp32_equals_jax(hf_model, tmp_path):
    hf_model.save_pretrained(tmp_path / "pretrained", safe_serialization=True)
    params, cfg = convert.load_hf_checkpoint(str(tmp_path / "pretrained"),
                                             dtype=torch.float32, device="cpu")
    jparams, jcfg = jax_convert.load_hf_checkpoint(str(tmp_path / "pretrained"),
                                                   dtype=jnp.float32)
    _assert_tree_equals_jax(params, jax.device_get(jparams))
    assert _config_fields(cfg) == _jax_config_fields(jcfg, cfg)
    (tmp_path / "two").mkdir()
    path = _shard_dir(tmp_path / "two", hf_model.state_dict(), hf_model.config, 2)
    params2, _ = convert.load_hf_checkpoint(path, dtype=torch.float32, device="cpu")
    jparams2, _ = jax_convert.load_hf_checkpoint(path, dtype=jnp.float32)
    _assert_tree_equals_jax(params2, jax.device_get(jparams2))
    tokens = np.arange(128)[None, :] % 256
    with torch.no_grad():
        got = llama.forward(params, torch.from_numpy(tokens), cfg).numpy()
    assert np.abs(got - _hf_logits(hf_model, tokens)).max() < 2e-2


def test_load_hf_checkpoint_reads_bf16_shards(hf_model, tmp_path):
    sd = {k: v.to(torch.bfloat16) for k, v in hf_model.state_dict().items()}
    path = _shard_dir(tmp_path, sd, hf_model.config, 3)
    params, cfg = convert.load_hf_checkpoint(path, device="cpu")
    want, _ = convert.from_hf_llama(sd, convert.config_from_hf(hf_model.config),
                                    device="cpu")
    for a, b in zip(param_leaves(params), param_leaves(want)):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cfg == convert.config_from_hf(hf_model.config)
    # The JAX package reads shards through numpy, whose bf16 comes from
    # ml_dtypes, registered once jax is imported.
    jparams, _ = jax_convert.load_hf_checkpoint(path)
    _assert_tree_equals_jax(params, jax.device_get(jparams))
    with pytest.raises(FileNotFoundError):
        convert.load_hf_checkpoint(str(tmp_path / "missing"), device="cpu")


def test_safetensors_reader_equals_safe_open(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {}
    for name, dt in convert.SAFETENSORS_DTYPES.items():
        raw = torch.randint(0, 256, (3, 5, 7), generator=gen, dtype=torch.uint8)
        if dt == torch.bool:
            tensors[name] = raw % 2 == 1
        elif dt.is_floating_point and dt.itemsize > 1:
            tensors[name] = torch.randn((3, 5, 7), generator=gen).to(dt)
        else:  # integers and fp8: every bit pattern of the raw bytes
            tensors[name] = raw.view(dt) if dt.itemsize == 1 else torch.randint(
                -1000, 1000, (3, 5, 7), generator=gen).to(dt)
    tensors["scalar"] = torch.tensor(3.5)
    tensors["empty"] = torch.zeros((0, 4), dtype=torch.bfloat16)
    path = str(tmp_path / "all.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    got = convert.read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    with safe_open(path, framework="pt") as f:
        for name in f.keys():
            want = f.get_tensor(name)
            assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
            assert torch.equal(got[name].reshape(-1).view(torch.uint8),
                               want.reshape(-1).view(torch.uint8)), name
    # A size that disagrees with the header's shape is refused.
    data = bytearray(open(path, "rb").read())
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    header["F32"]["shape"] = [3, 5, 8]
    blob = json.dumps(header).encode()
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(len(blob).to_bytes(8, "little") + blob + data[8 + n:])
    with pytest.raises(ValueError, match="F32"):
        convert.read_safetensors(str(bad))
