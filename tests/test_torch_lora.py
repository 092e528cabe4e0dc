"""Multi-LoRA serving: the port's ``models/lora.py`` and LoRA server vs the
JAX package's, on the CPU.

``lora_delta`` gets the same numpy arrays as the JAX one: in fp32 within
1e-5 of the largest delta, in bf16 within two bf16 ulps of it (the two
skinny products sum in another order), and rows of adapter -1 exactly 0.
``from_peft_state_dicts`` gives the JAX function's leaves bit for bit, on a
random-init ``peft`` model built here and on a hand-made state dict. The
servers: on the same fp32 model and adapters (the JAX tree carried over by
``params_from_jax`` and ``lora_from_jax``) a 3-request server with adapters
0, 1 and -1 serves the JAX server's tokens; in bf16 every served token,
teacher-forced through the JAX ``forward`` on its adapter's merged weights
(W + alpha A_i B_i, the oracle of tests/test_lora.py), lies within 0.1 of
the row max (that test's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_from_scratch_tpu.models.llama import (
    LlamaConfig as JaxLlamaConfig, forward as jax_forward, init_params as jax_init_params,
)
from flash_attention_from_scratch_tpu.models.lora import (
    from_peft_state_dicts as jax_from_peft, init_lora_adapters as jax_init_lora,
    lora_delta as jax_lora_delta,
)
from flash_attention_from_scratch_tpu.ops.configs import DType as JaxDType
from flash_attention_from_scratch_tpu.serving.generate import (
    GenerationServer as JaxGenerationServer,
)
from flash_attention_from_scratch_tpu_torch.models.llama import LlamaConfig, params_from_jax
from flash_attention_from_scratch_tpu_torch.models.lora import (
    LORA_KEYS, from_peft_state_dicts, init_lora_adapters, lora_delta, lora_from_jax,
    merged_params,
)
from flash_attention_from_scratch_tpu_torch.ops.configs import DType
from flash_attention_from_scratch_tpu_torch.serving.generate import GenerationServer

SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1, d_head=128,
             hidden_dim=256)
JCFG = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128)
CFG = LlamaConfig(**SHAPE)
PROMPTS = {1: (list(range(10, 30)), 0), 2: (list(range(40, 60)), 1),
           3: (list(range(70, 90)), -1)}
SERVER = dict(num_pages=32, page_size=64, max_batch=3, pages_per_seq=8)


def _jax_setup(jcfg):
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    lora = jax_init_lora(jcfg, n_adapters=2, rank=8, key=jax.random.PRNGKey(7), zero_b=False)
    # Deltas that matter without destabilizing a random model (tests/test_lora.py).
    lora["layers"] = jax.tree_util.tree_map(lambda x: x * 0.3, lora["layers"])
    return params, lora


def _port(params, lora):
    return (params_from_jax(jax.device_get(params), device="cpu"),
            lora_from_jax(jax.device_get(lora), device="cpu"))


def _serve(server, prompts=PROMPTS, n_new=4):
    for sid, (prompt, adapter) in prompts.items():
        server.submit(sid, prompt, n_new, adapter=adapter)
    return server.run()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_delta_equals_jax(dtype):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 256, 8)).astype(np.float32) / 16
    b = rng.standard_normal((3, 8, 128)).astype(np.float32) / 3
    x = rng.standard_normal((4, 5, 256)).astype(np.float32)
    ids = np.array([0, -1, 2, 1], np.int32)
    jl = {"alpha": jnp.float32(2.0), "layers": [{"wq": tuple(
        jnp.asarray(t, getattr(jnp, dtype)) for t in (a, b))}]}
    pl = {"alpha": torch.tensor(2.0), "layers": [{"wq": tuple(
        torch.from_numpy(t).to(getattr(torch, dtype)) for t in (a, b))}]}
    want = np.array(jax_lora_delta(jl, 0, "wq", jnp.asarray(x, getattr(jnp, dtype)),
                                   jnp.asarray(ids)), np.float32)
    got = lora_delta(pl, 0, "wq", torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(ids))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (4, 5, 128)
    tol = 1e-5 if dtype == "float32" else 2 * 2 ** -7
    assert float(np.abs(got.float().numpy() - want).max()) <= tol * np.abs(want).max()
    assert float(got[1].abs().max()) == 0.0 and np.abs(want[1]).max() == 0.0
    assert lora_delta(None, 0, "wq", got, ids) == 0.0
    assert lora_delta(pl, 0, "wo", got, ids) == 0.0


def _peft_state_dict():
    """A random-init HF Llama wrapped by ``peft`` (rank 8 on q and v), its
    factors drawn non-zero (peft starts B at zero): built here, no
    download."""
    transformers = pytest.importorskip("transformers")
    peft = pytest.importorskip("peft")
    torch.manual_seed(0)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, head_dim=128,
        max_position_embeddings=512, tie_word_embeddings=False)
    model = peft.get_peft_model(
        transformers.LlamaForCausalLM(hf_cfg),
        peft.LoraConfig(r=8, lora_alpha=16, target_modules=["q_proj", "v_proj"],
                        lora_dropout=0.0, bias="none"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "lora_" in name:
                p.normal_(std=0.1)
    return {k: v for k, v in model.state_dict().items() if "lora_" in k}


def test_from_peft_state_dicts_equals_jax():
    rng = np.random.default_rng(1)
    dims = {"q_proj": (256, 256), "k_proj": (256, 128), "v_proj": (256, 128),
            "o_proj": (256, 256)}
    hand = {}
    for li in range(2):
        for name, (din, dout) in dims.items():
            key = f"base_model.model.model.layers.{li}.self_attn.{name}.lora_A.weight"
            hand[key] = rng.standard_normal((8, din)).astype(np.float32)
            hand[key.replace("lora_A", "lora_B")] = rng.standard_normal((dout, 8)).astype(
                np.float32)
    sds = [_peft_state_dict(), hand]
    got = from_peft_state_dicts(CFG, sds, rank=8, alpha=16, device="cpu")
    want = jax_from_peft(JCFG, sds, rank=8, alpha=16)
    assert float(got["alpha"]) == float(want["alpha"]) == 2.0
    for li in range(2):
        for k in LORA_KEYS:
            for g, w in zip(got["layers"][li][k], want["layers"][li][k]):
                assert g.dtype == torch.bfloat16
                assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32)), (li, k)
    assert float(got["layers"][0]["wk"][0][0].abs().max()) == 0.0  # peft: no k_proj
    with pytest.raises(ValueError, match="rank"):
        from_peft_state_dicts(CFG, [hand], rank=4, alpha=8, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        jax_from_peft(JCFG, [hand], rank=4, alpha=8)


def test_lora_server_matches_jax_server():
    """fp32 model and adapters: the port's tokens equal the JAX server's
    for adapters 0, 1 and -1 in one batch."""
    jcfg = JaxLlamaConfig(**SHAPE, block_q=128, block_kv=128, dtype=JaxDType.FP32)
    jparams, jlora = _jax_setup(jcfg)
    params, lora = _port(jparams, jlora)
    want = _serve(JaxGenerationServer(jparams, jcfg, lora=jlora, **SERVER))
    got = _serve(GenerationServer(params, LlamaConfig(**SHAPE, dtype=DType.FP32), lora=lora,
                                  device="cpu", **SERVER))
    assert got == want
    assert got[1] != got[3] or got[2] != got[3]


def _merged_numpy(params, lora, adapter):
    """tests/test_lora.py's oracle: W + alpha * A_a @ B_a in fp32, cast."""
    merged = {k: v for k, v in params.items() if k != "layers"}
    merged["layers"] = []
    alpha = float(lora["alpha"])
    for li, layer in enumerate(params["layers"]):
        new = dict(layer)
        for k in LORA_KEYS:
            a, b = lora["layers"][li][k]
            delta = (np.asarray(a[adapter], np.float32)
                     @ np.asarray(b[adapter], np.float32)) * alpha
            new[k] = (np.asarray(layer[k], np.float32) + delta).astype(layer[k].dtype)
        merged["layers"].append(new)
    return merged


def test_lora_server_holds_to_merged_weight_oracle():
    """bf16: every served token within 0.1 of the row max of the JAX
    ``forward`` on its adapter's merged weights; ``merged_params`` gives
    those weights (within one bf16 ulp: fp32 products in another order);
    the adapters change what is served."""
    jparams, jlora = _jax_setup(JCFG)
    params, lora = _port(jparams, jlora)
    got = _serve(GenerationServer(params, CFG, lora=lora, device="cpu", **SERVER))
    oracles = {a: _merged_numpy(jparams, jlora, a) for a in (0, 1)}
    oracles[-1] = jparams
    for a in (0, 1):
        mine = merged_params(params, lora, a)
        for li in range(2):
            for k in LORA_KEYS:
                w = np.asarray(oracles[a]["layers"][li][k], np.float32)
                assert float(np.abs(mine["layers"][li][k].float().numpy() - w).max()) <= \
                    2 ** -7 * np.abs(w).max(), (a, li, k)
    for sid, (prompt, adapter) in PROMPTS.items():
        assert len(got[sid]) == 4
        toks = np.zeros((1, 128), np.int32)
        seq = prompt + got[sid][:-1]
        toks[0, :len(seq)] = seq
        logits = np.asarray(jax_forward(oracles[adapter], jnp.asarray(toks), JCFG)[0],
                            np.float32)
        for i, tok in enumerate(got[sid]):
            row = logits[len(prompt) - 1 + i]
            assert row.max() - row[tok] <= 0.1, (sid, adapter, i, tok, row.argmax())
    assert got[1] != got[3] or got[2] != got[3]


def test_fused_projections_take_the_deltas_once():
    """``fuse_projections`` (wqkv): the same tokens as the unfused server,
    each adapter's delta added to its own q, k or v columns."""
    from flash_attention_from_scratch_tpu_torch.models.llama import fuse_projections

    jparams, jlora = _jax_setup(JCFG)
    params, lora = _port(jparams, jlora)
    runs = [_serve(GenerationServer(p, CFG, lora=lora, device="cpu", **SERVER))
            for p in (params, fuse_projections(params))]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("option", [dict(spec_k=2), dict(prefill_chunk_tokens=128),
                                    dict(prefix_cache=True), dict(mesh=object())],
                         ids=["spec_k", "prefill_chunk_tokens", "prefix_cache", "mesh"])
def test_lora_server_refusals(option):
    """As the JAX server: LoRA with speculative decoding, chunked prefill,
    the prefix cache or a mesh raises ValueError naming LoRA; an adapter on
    a server without adapters, or past the last one, raises too."""
    params = {"embed": torch.zeros((4, 4))}
    lora = init_lora_adapters(CFG, 2, 4, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="LoRA"):
        GenerationServer(params, CFG, lora=lora, device="cpu", **SERVER, **option)


def test_submit_adapter_refusals():
    jparams, jlora = _jax_setup(JCFG)
    params, lora = _port(jparams, jlora)
    plain = GenerationServer(params, CFG, device="cpu", **SERVER)
    with pytest.raises(ValueError, match="lora"):
        plain.submit(1, [1, 2, 3], 2, adapter=0)
    with pytest.raises(ValueError, match="out of range"):
        GenerationServer(params, CFG, lora=lora, device="cpu", **SERVER).submit(
            1, [1, 2, 3], 2, adapter=2)


def test_zero_b_adapters_are_the_identity():
    """Freshly initialized adapters (B = 0) serve the base model's tokens."""
    jparams, _ = _jax_setup(JCFG)
    params = params_from_jax(jax.device_get(jparams), device="cpu")
    lora0 = init_lora_adapters(CFG, 1, 4, torch.Generator().manual_seed(3), device="cpu")
    assert float(lora0["alpha"]) == 1.0
    runs = []
    for kw, adapter in ((dict(lora=lora0), 0), ({}, -1)):
        server = GenerationServer(params, CFG, device="cpu", **SERVER, **kw)
        runs.append(_serve(server, {1: (list(range(10, 30)), adapter)}))
    assert runs[0] == runs[1]


def test_lora_chunk8_matches_stepwise():
    """``chunk=8`` (decode loops with each row's adapter) serves the
    stepwise trajectory token for token."""
    jparams, jlora = _jax_setup(JCFG)
    params, lora = _port(jparams, jlora)
    runs = [_serve(GenerationServer(params, CFG, lora=lora, device="cpu", chunk=chunk,
                                    **SERVER), n_new=10) for chunk in (1, 8)]
    assert runs[0] == runs[1] and all(len(t) == 10 for t in runs[0].values())
