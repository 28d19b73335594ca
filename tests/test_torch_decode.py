"""The port's causal LM and its decode path (``models/mla_decode.py``,
``models/generation.py``) against the JAX package's, on the CPU.

Parameters come from the JAX modules' ``init`` and go through
``load_flax_params``; quantized trees come from the JAX package's
``quantize_decoder_params`` on one side and the port's converter on the
other (bit-identical, ``tests/test_torch_quant.py``). The tiny LM has hidden
256, so that int4 keeps K7's route (the plain version here) on the 256-row
reductions and falls back to int8 on the 128-row ones.

Tolerances. fp32 parameters: 1e-5 of the largest entry, the same fp32 math
summed in another order. A quantized tree rounds each matmul's input to
bf16, so an fp32 difference of an ulp upstream may flip one such rounding:
one bf16 ulp of the largest logit there. bf16 parameters: two bf16 ulps of
the largest logit, since XLA fuses chains of bf16 elementwise ops and rounds
where eager PyTorch rounds each op. Greedy tokens must be equal: with fp32
parameters, and with bf16 ones over the default fp32 cache. (Over a bf16
cache the logits are bf16-rounded ties often enough that one ulp parts the
two runs: their tokens are not compared.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepSeekForCausalLM as JaxLM
from deepearth_tpu.models import MLAttention as JaxMLA
from deepearth_tpu.models import generate as jax_generate
from deepearth_tpu.models import generation as jgen
from deepearth_tpu.models import mla_decode as jdec
from deepearth_tpu.ops import quant as jq
from deepearth_tpu_torch import configs as tcfg
from deepearth_tpu_torch import load_flax_params
from deepearth_tpu_torch.models import (
    DeepSeekForCausalLM,
    MLAttention,
    causal_lm_decode_step,
    decode_sequence,
    generate,
    init_cache,
)
from deepearth_tpu_torch.models import generation as tgen
from deepearth_tpu_torch.models import mla_decode as tdec
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.ops import quant as tq

torch.set_num_threads(2)

REL = 1e-5
VOCAB = 512


def close_rel(out, ref, rel=REL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref,
                               atol=rel * np.abs(ref).max(), rtol=0)


def bf16_ulp(x) -> float:
    return 2.0 ** (np.floor(np.log2(float(np.abs(x).max()))) - 7)


# --------------------------------------------------------------------------- #
# MLA decode over the compressed cache
# --------------------------------------------------------------------------- #

def mla_cfg(mod, q_lora=None, yarn=False):
    scaling = (mod.RopeScalingConfig(type="yarn", factor=4.0,
                                     original_max_position_embeddings=4,
                                     mscale=1.0, mscale_all_dim=0.7)
               if yarn else mod.RopeScalingConfig())
    return mod.MLAConfig(hidden_dim=64, n_heads=4, q_lora_rank=q_lora,
                         kv_lora_rank=16, qk_rope_head_dim=8,
                         qk_nope_head_dim=16, v_head_dim=16,
                         rope_scaling=scaling)


@pytest.mark.parametrize("q_lora,yarn", [(None, False), (24, False),
                                         (24, True)],
                         ids=["no q-lora", "q-lora", "q-lora yarn"])
def test_decode_sequence_matches_jax_and_the_causal_forward(q_lora, yarn):
    x = np.random.default_rng(0).standard_normal((2, 7, 64)).astype(
        np.float32)
    jmod = JaxMLA(mla_cfg(jcfg, q_lora, yarn))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(x))[
        "params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    cfg = mla_cfg(tcfg, q_lora, yarn)
    attn = MLAttention(cfg, Init(torch.Generator().manual_seed(0), "cpu"),
                       torch.float32)
    load_flax_params(attn, params)
    ref = jdec.decode_sequence(params, mla_cfg(jcfg, q_lora, yarn),
                               jnp.asarray(x), max_len=9)
    with torch.inference_mode():
        out = decode_sequence(attn, cfg, torch.tensor(x), max_len=9)
        full = attn(torch.tensor(x), is_causal=True)
    close_rel(out, ref)
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_cache_sizes_match_jax():
    for mod_pair in ((jcfg, tcfg),):
        v3 = [m.MLAConfig(hidden_dim=7168, n_heads=128, kv_lora_rank=512,
                          qk_rope_head_dim=64, qk_nope_head_dim=128,
                          v_head_dim=128) for m in mod_pair]
        for nb in (2, 4):
            assert tdec.cache_bytes_per_token(v3[1], nb) == \
                jdec.cache_bytes_per_token(v3[0], nb)
            assert tdec.full_cache_bytes_per_token(v3[1], nb) == \
                jdec.full_cache_bytes_per_token(v3[0], nb)
    bench = tcfg.MLAConfig(hidden_dim=2048, n_heads=16, kv_lora_rank=512,
                           qk_rope_head_dim=64, qk_nope_head_dim=128,
                           v_head_dim=128)
    assert tdec.cache_bytes_per_token(bench, 2) == 1152
    assert tdec.full_cache_bytes_per_token(bench, 2) == 10240
    cache = init_cache(bench, 3, 10, torch.bfloat16, "cpu")
    assert cache.ckv.shape == (3, 10, 512) and cache.k_pe.shape == (3, 10, 64)
    assert cache.ckv.dtype == torch.bfloat16 and cache.length == 0
    assert (cache.ckv.numel() + cache.k_pe.numel()) * 2 == 3 * 10 * 1152


# --------------------------------------------------------------------------- #
# the causal LM, its decode step and generate
# --------------------------------------------------------------------------- #

def lm_cfg(mod, capacity_factor=2.0):
    return mod.DeepSeekBlockConfig(
        hidden_dim=256, n_layers=3, intermediate_size=512,
        mla=mod.MLAConfig(hidden_dim=256, n_heads=4, kv_lora_rank=128,
                          qk_rope_head_dim=32, qk_nope_head_dim=32,
                          v_head_dim=32),
        moe=mod.MoEConfig(n_routed_experts=4, num_experts_per_tok=2,
                          moe_intermediate_size=128, hidden_dim=256,
                          n_shared_experts=1,
                          capacity_factor=capacity_factor),
        first_k_dense_replace=1)


def make_lm(tie=True, bf16=False, capacity_factor=2.0):
    """(JAX params as numpy, JAX config, the port's model) of one tiny LM."""
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jc = lm_cfg(jcfg, capacity_factor)
    jm = JaxLM(jc, vocab_size=VOCAB, tie_embeddings=tie, compute_dtype=jdt,
               param_dtype=jdt)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = DeepSeekForCausalLM(lm_cfg(tcfg, capacity_factor), VOCAB,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu", tie_embeddings=tie,
                                compute_dtype=tdt, param_dtype=tdt)
    load_flax_params(model, params)
    return params, jc, jm, model


@pytest.fixture(scope="module")
def lm_fp32():
    return make_lm()


@pytest.fixture(scope="module")
def lm_bf16():
    return make_lm(bf16=True)


def ids_of(seed, b, s):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_causal_lm_logits_match_jax(tie):
    params, _, jm, model = make_lm(tie=tie)
    ids = ids_of(1, 2, 9)
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(ids),
                            jnp.asarray(mask))
    with torch.inference_mode():
        out = model(torch.tensor(ids), torch.tensor(mask))
    assert out.shape == (2, 9, VOCAB)
    close_rel(out, ref)
    assert model.tie_embeddings == tie and hasattr(model, "lm_head") != tie


def trees(params, model, bits):
    if bits is None:
        return params, model
    return (jq.quantize_decoder_params(params, min_dim=128, bits=bits),
            tq.quantize_decoder_params(model, min_dim=128, bits=bits))


def prompt_logits(jp, jc, model, ids, cache_dtypes):
    """Teacher-forced logits of every prompt position, both packages."""
    b, s = ids.shape
    jcaches = tuple(jdec.init_cache(jc.mla, b, s, cache_dtypes[0])
                    for _ in range(jc.n_layers))
    caches = [init_cache(model.cfg.mla, b, s, cache_dtypes[1], "cpu")
              for _ in range(jc.n_layers)]
    jstep = jax.jit(lambda p, c, tok: jgen.causal_lm_decode_step(
        p, jc, c, tok, s))
    ref, out = [], []
    for t in range(s):
        lj, jcaches = jstep(jp, jcaches, jnp.asarray(ids[:, t]))
        with torch.inference_mode():
            lt, caches = causal_lm_decode_step(model, caches,
                                               torch.tensor(ids[:, t]), s)
        ref.append(np.asarray(lj))
        out.append(lt.numpy())
    assert [c.length for c in caches] == [s] * jc.n_layers
    return np.stack(out, 1), np.stack(ref, 1)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["plain", "int8",
                                                    "int4"])
def test_decode_step_logits_match_jax_fp32(lm_fp32, bits):
    params, jc, _, model = lm_fp32
    jp, tm = trees(params, model, bits)
    out, ref = prompt_logits(jp, jc, tm, ids_of(2, 2, 4),
                             (jnp.float32, torch.float32))
    assert out.dtype == np.float32
    if bits is None:
        close_rel(out, ref)
    else:
        np.testing.assert_allclose(out, ref, atol=bf16_ulp(ref), rtol=0)


@pytest.mark.parametrize("bits,cache", [(None, "fp32"), (8, "fp32"),
                                        (4, "fp32"), (None, "bf16")],
                         ids=["bf16", "int8", "int4", "bf16 cache bf16"])
def test_decode_step_logits_match_jax_bf16_params(lm_bf16, bits, cache):
    params, jc, _, model = lm_bf16
    jp, tm = trees(params, model, bits)
    dts = ((jnp.float32, torch.float32) if cache == "fp32"
           else (jnp.bfloat16, torch.bfloat16))
    out, ref = prompt_logits(jp, jc, tm, ids_of(3, 2, 4), dts)
    np.testing.assert_allclose(out, ref, atol=2 * bf16_ulp(ref), rtol=0)


@pytest.mark.parametrize("which,bits", [("fp32", None), ("bf16", None),
                                        ("bf16", 8), ("bf16", 4)],
                         ids=["fp32", "bf16", "int8", "int4"])
def test_greedy_generate_gives_jax_tokens(lm_fp32, lm_bf16, which, bits):
    params, jc, _, model = lm_fp32 if which == "fp32" else lm_bf16
    jp, tm = trees(params, model, bits)
    ids = ids_of(4, 2, 6)
    ref = np.asarray(jax_generate(jp, jc, jnp.asarray(ids), 8))
    out = generate(tm, torch.tensor(ids), 8)
    assert out.dtype == torch.int32 and out.shape == (2, 8)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_right_padded_prompt_gives_the_same_tokens(lm_fp32):
    params, jc, _, model = lm_fp32
    ids = ids_of(5, 2, 5)
    padded = np.concatenate([ids, np.zeros((2, 3), np.int32)], axis=1)
    want = generate(model, torch.tensor(ids), 6, max_len=14)
    got = generate(model, torch.tensor(padded), 6, max_len=14, prompt_len=5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref = jax_generate(params, jc, jnp.asarray(padded), 6, max_len=14,
                       prompt_len=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_drop_free_decode_matches_jax():
    """capacity_factor None: the decode MoE's capacity is S K."""
    params, jc, _, model = make_lm(capacity_factor=None)
    ids = ids_of(6, 3, 4)
    ref = np.asarray(jax_generate(params, jc, jnp.asarray(ids), 4))
    np.testing.assert_array_equal(
        generate(model, torch.tensor(ids), 4).numpy(), ref)


def test_sampling_is_seeded_and_respects_top_k(lm_fp32):
    _, _, _, model = lm_fp32
    ids = torch.tensor(ids_of(7, 2, 4))

    def draw(seed, **kw):
        return generate(model, ids, 6, temperature=1.0,
                        generator=torch.Generator().manual_seed(seed), **kw)

    assert torch.equal(draw(0), draw(0))
    assert not torch.equal(draw(0), draw(1))
    assert torch.equal(draw(3, top_k=1), generate(model, ids, 6))
    logits = torch.tensor(np.random.default_rng(8).standard_normal(
        (4, VOCAB)).astype(np.float32))
    allowed = torch.topk(logits, 5, dim=-1).indices
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        tok = tgen.sample(logits, 2.0, 5, gen)
        assert tok.dtype == torch.int32
        assert bool((allowed == tok[:, None].long()).any(dim=-1).all())
    greedy = tgen.sample(logits, 0.0, None, gen)
    assert torch.equal(greedy.long(), logits.argmax(dim=-1))


def test_moe_decode_ignores_the_layers_dispatch_mode(lm_fp32):
    """Decode's MoE takes the one-hot capacity dispatch whatever the layer's
    dispatch_mode, as the JAX package's _moe_apply does."""
    _, _, _, model = lm_fp32
    ids = torch.tensor(ids_of(9, 2, 5))
    want = generate(model, ids, 4)
    moes = [m for m in model.modules() if hasattr(m, "router_weight")]
    saved = [m.cfg for m in moes]
    try:
        for m in moes:
            m.cfg = dataclasses.replace(m.cfg, dispatch_mode="scatter")
        assert torch.equal(generate(model, ids, 4), want)
    finally:
        for m, c in zip(moes, saved):
            m.cfg = c
