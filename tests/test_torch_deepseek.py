"""The port's RoPE, RMSNorm, MLA, DeepSeek stack and universal-token encoder
against the JAX package, on the CPU, in fp32.

Parameters come from each JAX module's ``init`` (jitted, once per module)
and go through ``load_flax_params``; inputs are numpy arrays from a seed,
fed to both. Module outputs agree to 1e-5 of each output's largest entry:
the same fp32 math, summed in another order. RoPE tables agree to 1e-5
absolute: an fp32 ``pow`` may round the last bit of an inverse frequency
differently, and positions up to 600 scale that ulp to ~8e-6 radians.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import deepseek as jds
from deepearth_tpu.models import encoders as jenc
from deepearth_tpu.ops import norms as jnorms
from deepearth_tpu.ops import rope as jrope
from deepearth_tpu_torch import configs as tcfg
from deepearth_tpu_torch import load_flax_params
from deepearth_tpu_torch.models import deepseek as tds
from deepearth_tpu_torch.models import encoders as tenc
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.ops import norms as tnorms
from deepearth_tpu_torch.ops import rope as trope

torch.set_num_threads(2)

REL = 1e-5
ROPE_TOL = 1e-5
B, N, D = 2, 20, 64


def port_init():
    return Init(torch.Generator().manual_seed(0), "cpu")


def close_rel(out, ref, rel=REL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref,
                               atol=rel * np.abs(ref).max(), rtol=0)


def jax_module_pair(jmod, tmod, *args, **static):
    """Init the JAX module on ``args`` (numpy) and ``static`` keywords, load
    its params into the port module, and return (jitted JAX apply taking
    params and args, params, port module)."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    init = jax.jit(lambda key, *a: jmod.init(key, *a, **static))
    params = init(jax.random.PRNGKey(0), *jargs)["params"]
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    apply = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, **static))
    return apply, params, tmod


def features(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------------------- #
# RoPE and RMSNorm
# --------------------------------------------------------------------------- #

SCALINGS = {
    "none": {},
    "linear": dict(factor=4.0),
    "dynamic": dict(factor=2.0, original_max_position_embeddings=64),
    "yarn": dict(factor=8.0, original_max_position_embeddings=64,
                 mscale=1.0, mscale_all_dim=0.5),
}


@pytest.mark.parametrize("layout", ["half", "interleaved"])
@pytest.mark.parametrize("scaling", list(SCALINGS))
@pytest.mark.parametrize("dim", [16, 64])
def test_rope_tables_match_jax(scaling, layout, dim):
    kw = SCALINGS[scaling]
    jcos, jsin = jrope.rope_cos_sin(
        600, dim, 10000.0, jcfg.RopeScalingConfig(type=scaling, **kw), layout)
    tcos, tsin = trope.rope_cos_sin(
        600, dim, 10000.0, tcfg.RopeScalingConfig(type=scaling, **kw), layout)
    assert tcos.dtype == torch.float32
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=ROPE_TOL,
                               rtol=0)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=ROPE_TOL,
                               rtol=0)
    cached = trope.rope_tables(600, dim, 10000.0,
                               tcfg.RopeScalingConfig(type=scaling, **kw),
                               layout)
    assert torch.equal(cached[0], tcos) and torch.equal(cached[1], tsin)


def test_yarn_helpers_match_jax():
    for args in [(32.0, 64, 10000.0, 4096), (1.0, 16, 500.0, 64)]:
        assert trope.yarn_find_correction_dim(*args) == \
            jrope.yarn_find_correction_dim(*args)
    assert trope.yarn_find_correction_range(32.0, 1.0, 64, 10000.0, 4096) == \
        jrope.yarn_find_correction_range(32.0, 1.0, 64, 10000.0, 4096)
    for s, m in [(1.0, 1.0), (40.0, 0.707), (8.0, 1.0)]:
        assert trope.yarn_get_mscale(s, m) == jrope.yarn_get_mscale(s, m)


@pytest.mark.parametrize("form", ["half", "interleaved", "deepseek"])
def test_rope_application_matches_jax(form):
    """Each convention on the same fp32 tables: exact fp32 products and
    sums, so 1e-6 absolute."""
    x = features(1, B, 3, N, 16)
    layout = "interleaved" if form == "interleaved" else "half"
    jcos, jsin = jrope.rope_cos_sin(N, 16, layout=layout)
    cos, sin = np.array(jcos), np.array(jsin)
    jfn = getattr(jrope, f"apply_rope_{form}")
    tfn = getattr(trope, f"apply_rope_{form}")
    ref = jfn(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    out = tfn(torch.from_numpy(x), torch.from_numpy(cos),
              torch.from_numpy(sin))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    half = np.asarray(jrope.rotate_half(jnp.asarray(x)))
    np.testing.assert_array_equal(trope.rotate_half(torch.from_numpy(x))
                                  .numpy(), half)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    """fp32 to REL; bf16 within one bf16 ulp (2^-8 relative) of the JAX
    output: both normalize in fp32 and round to bf16 before the weight."""
    x = features(2, B, N, D) * 3.0
    w = 1.0 + 0.1 * features(3, D)
    jdt = getattr(jnp, dtype)
    ref = jnorms.RMSNorm(eps=1e-6).apply({"params": {"weight": w}},
                                         jnp.asarray(x).astype(jdt))
    norm = tnorms.RMSNorm(D, 1e-6, device="cpu")
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        out = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype) and norm.weight.dtype == \
        torch.float32
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        close_rel(out, ref)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -8,
                                   atol=0)


# --------------------------------------------------------------------------- #
# MLA, the DeepSeek stack, the universal-token encoder
# --------------------------------------------------------------------------- #

def mla_cfgs(**kw):
    base = dict(hidden_dim=D, n_heads=4, kv_lora_rank=16, qk_rope_head_dim=8,
                qk_nope_head_dim=16, v_head_dim=12)
    base.update(kw)
    jscale = jcfg.RopeScalingConfig(**base.pop("rope_scaling", {}))
    tscale = tcfg.RopeScalingConfig(**dataclasses.asdict(jscale))
    return (jcfg.MLAConfig(rope_scaling=jscale, **base),
            tcfg.MLAConfig(rope_scaling=tscale, **base))


@pytest.mark.parametrize("variant", ["plain", "q_lora", "yarn_bias",
                                     "key_mask", "causal", "flash_gate_cpu",
                                     "v3_heads_flash"])
def test_mla_matches_jax(variant):
    kw = {}
    if variant == "q_lora":
        kw = dict(q_lora_rank=24)
    if variant == "yarn_bias":
        kw = dict(attention_bias=True, rope_scaling=dict(
            type="yarn", factor=4.0, original_max_position_embeddings=8,
            mscale=1.0, mscale_all_dim=1.0))
    if variant == "flash_gate_cpu":
        # N >= flash_min_seq: the CPU runs the plain path, as JAX on the CPU
        kw = dict(use_flash_attention=True, flash_min_seq=16)
    if variant == "v3_heads_flash":
        # DeepSeek-V3's head widths (q 192 = nope 128 + rope 64, v 128) with
        # flash on: no longer refused; the CPU runs the plain path
        kw = dict(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                  use_flash_attention=True, flash_min_seq=16)
    jc, tc = mla_cfgs(**kw)
    x = features(4, B, N, D)
    mask = None
    if variant == "key_mask":
        mask = np.random.default_rng(5).uniform(size=(B, N)) > 0.3
        mask[1] = False
    causal = variant == "causal"
    apply, params, mod = jax_module_pair(
        jds.MLAttention(jc, jnp.float32, jnp.float32),
        tds.MLAttention(tc, port_init(), torch.float32), x, mask,
        is_causal=causal)
    ref = apply(params, jnp.asarray(x),
                None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out = mod(torch.from_numpy(x),
                  None if mask is None else torch.from_numpy(mask), causal)
    close_rel(out, ref)


def test_swiglu_and_deepseek_transformer_match_jax():
    jc_mla, tc_mla = mla_cfgs()
    jc = jcfg.DeepSeekBlockConfig(hidden_dim=D, n_layers=2,
                                  intermediate_size=96, mla=jc_mla)
    tc = tcfg.DeepSeekBlockConfig(hidden_dim=D, n_layers=2,
                                  intermediate_size=96, mla=tc_mla)
    x = features(6, B, N, D)
    apply, params, mod = jax_module_pair(
        jds.DeepSeekTransformer(jc, jnp.float32, jnp.float32),
        tds.DeepSeekTransformer(tc, port_init(), torch.float32), x)
    ref = apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    close_rel(out, ref)
    # the block's MLP alone
    mlp = jds.SwiGLUMLP(D, 96, jnp.float32, jnp.float32)
    ref = mlp.apply({"params": params["layer_1"]["mlp"]}, jnp.asarray(x))
    with torch.no_grad():
        out = mod.layer_1.mlp(torch.from_numpy(x))
    close_rel(out, ref)


@pytest.mark.parametrize("case", ["input_2d", "input_3d", "interpolated",
                                  "pooled"])
def test_universal_token_encoder_matches_jax(case):
    """2-D input (one native row), 3-D input, a table shorter than the
    sequence (linear interpolation, via a small max_positions), and
    attention pooling (n_tokens = 1)."""
    n_tokens = 1 if case == "pooled" else 4
    jm = jcfg.ModalityConfig(name="m", input_dim=24, n_tokens=n_tokens,
                             encoder_layers=1, encoder_heads=4)
    tm = tcfg.ModalityConfig(name="m", input_dim=24, n_tokens=n_tokens,
                             encoder_layers=1, encoder_heads=4)
    S = 1 if case == "input_2d" else 30
    max_pos = 8 if case == "interpolated" else 4608
    x = features(7, B, 24) if case == "input_2d" else features(7, B, S, 24)
    apply, params, mod = jax_module_pair(
        jenc.UniversalTokenEncoder(jm, D, jnp.float32, jnp.float32,
                                   max_positions=max_pos),
        tenc.UniversalTokenEncoder(tm, D, port_init(), torch.float32,
                                   native_seq_len=S, max_positions=max_pos),
        x)
    assert params["position_embedding"].shape == \
        tuple(mod.position_embedding.shape)
    ref = apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    assert out.shape == (B, n_tokens, D)
    close_rel(out, ref)


def test_encoder_derives_the_jax_head_dims():
    for d, heads in [(512, 8), (64, 4), (2048, 16), (96, 3)]:
        jm = jcfg.ModalityConfig(name="v", encoder_heads=heads)
        tm = tcfg.ModalityConfig(name="v", encoder_heads=heads)
        ref = jenc.UniversalTokenEncoder(jm, d)._transformer_cfg()
        got = tenc.encoder_transformer_config(tm, d)
        for f in ("qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
                  "kv_lora_rank", "n_heads", "use_flash_attention"):
            assert getattr(got.mla, f) == getattr(ref.mla, f), (d, heads, f)
        assert got.intermediate_size == ref.intermediate_size
    got = tenc.encoder_transformer_config(
        tcfg.ModalityConfig(name="v", encoder_heads=8), 512).mla
    assert (got.q_head_dim, got.v_head_dim) == (48, 32)  # the vision site


@pytest.mark.parametrize("what", ["moe_layer", "moe_projection", "pipeline"])
def test_unported_deepseek_options_raise(what):
    """MoE layers, the MoE projection and pipelined stacks are ported (they
    build); a pipelined stack whose layers no prefix splits into uniform
    stages raises JAX's ValueError."""
    _, tc_mla = mla_cfgs()
    if what == "moe_projection":
        m = tcfg.ModalityConfig(name="v", input_dim=8, use_moe_projection=True)
        enc = tenc.UniversalTokenEncoder(m, D, port_init(), torch.float32)
        assert enc.moe_projection.cfg.n_routed_experts == 4
        return
    moe = tcfg.MoEConfig() if what == "moe_layer" else None
    cfg = tcfg.DeepSeekBlockConfig(hidden_dim=D, n_layers=2, mla=tc_mla,
                                   moe=moe)
    if moe is not None:
        assert hasattr(tds.DeepSeekTransformer(cfg, port_init(),
                                               torch.float32).layer_1, "moe")
    cfg.pipeline_stages = 2
    if moe is not None:
        # [dense, MoE] splits into no two uniform stages
        with pytest.raises(ValueError, match="no prefix split"):
            tds.DeepSeekTransformer(cfg, port_init(), torch.float32)
    else:
        stack = tds.DeepSeekTransformer(cfg, port_init(), torch.float32)
        assert stack.n_layers == 0 and stack.pipe.n_stages == 2


def test_deepseek_config_json_round_trips():
    jc_mla, _ = mla_cfgs(q_lora_rank=24, rope_scaling=dict(type="yarn",
                                                           factor=4.0))
    cfg = jcfg.DeepEarthConfig(hidden_dim=D, n_heads=4, n_layers=2)
    cfg.fusion.deepseek_block = jcfg.DeepSeekBlockConfig(
        hidden_dim=D, n_layers=3, mla=jc_mla,
        moe=jcfg.MoEConfig(n_routed_experts=4, hidden_dim=32))
    port = tcfg.config_from_json(jcfg.config_to_json(cfg))
    block = port.fusion.deepseek_block
    assert isinstance(block, tcfg.DeepSeekBlockConfig)
    assert isinstance(block.mla.rope_scaling, tcfg.RopeScalingConfig)
    assert block.mla.rope_scaling.type == "yarn" and block.mla.q_lora_rank == 24
    assert block.moe.n_routed_experts == 4 and block.moe.hidden_dim == D
    back = jcfg.config_from_json(tcfg.config_to_json(port))
    assert back.fusion.deepseek_block == cfg.fusion.deepseek_block


# --------------------------------------------------------------------------- #
# DeepSeekForSequenceClassification
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("inputs", ["ids", "features"])
@pytest.mark.parametrize("masked", [False, True])
def test_sequence_classifier_matches_jax(inputs, masked):
    """Token ids (the embedding) or (B, N, D) features through the stack
    with and without a key mask, the masked mean and the score head; the
    port's parameters come from JAX's init through load_flax_params and go
    back through flax_params_from_model unchanged."""
    from deepearth_tpu_torch.convert import flax_params_from_model

    jc_mla, tc_mla = mla_cfgs(q_lora_rank=24)
    jc = jcfg.DeepSeekBlockConfig(hidden_dim=D, n_layers=2,
                                  intermediate_size=96, mla=jc_mla)
    tc = tcfg.DeepSeekBlockConfig(hidden_dim=D, n_layers=2,
                                  intermediate_size=96, mla=tc_mla)
    vocab = 50 if inputs == "ids" else None
    if inputs == "ids":
        x = np.random.default_rng(8).integers(0, 50, (B, N)).astype(np.int32)
    else:
        x = features(8, B, N, D)
    mask = None
    if masked:
        mask = np.ones((B, N), bool)
        mask[1, 13:] = False
    apply, params, mod = jax_module_pair(
        jds.DeepSeekForSequenceClassification(jc, 7, vocab),
        tds.DeepSeekForSequenceClassification(
            tc, 7, vocab, generator=torch.Generator().manual_seed(0),
            device="cpu"), x, mask)
    assert sorted(params) == sorted(
        (["embed_tokens"] if vocab else []) + ["model", "score"])
    ref = apply(params, jnp.asarray(x),
                None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out = mod(torch.from_numpy(x),
                  None if mask is None else torch.from_numpy(mask))
    assert out.shape == (B, 7)
    close_rel(out, ref)
    back = flax_params_from_model(mod)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
