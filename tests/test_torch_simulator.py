"""The flagship's serving slice against the JAX package, on the CPU: the
DeepSeek stack with MoE layers, the universal-token encoder with its MoE
projection, and a tiny ``integrated_config(use_deepseek_fusion=True)``
model with its simulator.

The tiny flagship keeps every shape of the real one but its widths: universal
dim 64, 2 fusion layers and a 2-layer simulator (layer 0 dense, layer 1 MoE:
8 experts of 64, top-2 in 2 groups, one shared expert), Grid4D on 2^12-entry
tables, vision (B, 20, 1408) and language (B, 5, 7168) through MoE-projected
encoders. Fusion and the simulator see 1 CLS + 1 spacetime + 16 vision + 4
language = 22 tokens per observation, as the flagship does. Parameters come
from the JAX model's ``init`` (jitted once per module) through
``load_flax_params``; inputs are numpy arrays from a seed. Tolerances: 1e-5
of each output's largest entry for modules, 1e-4 absolute for the whole
model, in fp32 (the same math summed in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu.models import deepseek as jds
from deepearth_tpu.models import encoders as jenc
from deepearth_tpu_torch import (
    config_from_json,
    flax_params_from_model,
    kernels,
    load_flax_params,
)
from deepearth_tpu_torch import configs as tcfg
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.models import deepseek as tds
from deepearth_tpu_torch.models import encoders as tenc
from deepearth_tpu_torch.models.layers import Init

torch.set_num_threads(2)

REL, TOL = 1e-5, 1e-4
B, N, D = 2, 11, 64
S_VISION, S_LANGUAGE = 20, 5


def features(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close_rel(out, ref, rel=REL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.detach().float().numpy(), ref,
                               atol=rel * np.abs(ref).max(), rtol=0)


def port_init():
    return Init(torch.Generator().manual_seed(0), "cpu")


def pair_modules(jmod, tmod, *args):
    """Init the JAX module on ``args``, load its params into the port
    module; returns (JAX output with its intermediates, params, module)."""
    jargs = [jnp.asarray(a) for a in args]
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), *jargs)["params"]
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    out = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a,
                                           mutable=["intermediates"]))(
        params, *jargs)
    return out, params, tmod


def stack_cfgs(mode="auto", n_layers=3):
    """A DeepSeek stack of width 64: layer 0 dense, the rest MoE (8 experts,
    top-2 in 2 groups, a shared expert)."""
    kw = dict(hidden_dim=D, n_heads=4, kv_lora_rank=16, qk_rope_head_dim=8,
              qk_nope_head_dim=16, v_head_dim=12)
    moe = dict(n_routed_experts=8, num_experts_per_tok=2, n_group=2,
               topk_group=1, moe_intermediate_size=48, hidden_dim=D,
               dispatch_mode=mode)
    return tuple(c.DeepSeekBlockConfig(hidden_dim=D, n_layers=n_layers,
                                       intermediate_size=96,
                                       mla=c.MLAConfig(**kw),
                                       moe=c.MoEConfig(**moe))
                 for c in (jcfg, tcfg))


@pytest.mark.parametrize("mode", ["auto", "scatter"])
def test_deepseek_transformer_with_moe_matches_jax(mode):
    """auto takes ``dense`` on the CPU at 22 tokens; scatter the gathers."""
    jc, tc = stack_cfgs(mode)
    x = features(1, B, N, D)
    (ref, state), _, mod = pair_modules(
        jds.DeepSeekTransformer(jc, jnp.float32, jnp.float32),
        tds.DeepSeekTransformer(tc, port_init(), torch.float32), x)
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    close_rel(out, ref)
    assert not hasattr(mod.layer_0, "moe") and hasattr(mod.layer_1, "moe")
    for i in (1, 2):
        moe = getattr(mod, f"layer_{i}").moe
        sown = state["intermediates"][f"layer_{i}"]["moe"]
        close_rel(moe.aux_loss, sown["moe_aux_loss"][0])
        np.testing.assert_array_equal(moe.load.numpy(),
                                      np.asarray(sown["moe_load"][0]))
        assert moe.mode == ("dense" if mode == "auto" else mode)


def test_forced_moe_block_matches_jax():
    """force_moe overrides the layer's place in the stack (layer 0 would be
    dense)."""
    jc, tc = stack_cfgs()
    x = features(2, B, N, D)
    (ref, _), _, mod = pair_modules(
        jds.DeepSeekBlock(jc, layer_idx=0, compute_dtype=jnp.float32,
                          param_dtype=jnp.float32, force_moe=True),
        tds.DeepSeekBlock(tc, 0, port_init(), torch.float32, force_moe=True),
        x)
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    close_rel(out, ref)


def test_universal_token_encoder_with_moe_projection_matches_jax():
    jm = jcfg.ModalityConfig(name="v", input_dim=24, n_tokens=4,
                             encoder_layers=1, encoder_heads=4,
                             use_moe_projection=True)
    tm = tcfg.ModalityConfig(**dataclasses.asdict(jm))
    x = features(3, B, 30, 24)
    (ref, _), params, mod = pair_modules(
        jenc.UniversalTokenEncoder(jm, D, jnp.float32, jnp.float32),
        tenc.UniversalTokenEncoder(tm, D, port_init(), torch.float32,
                                   native_seq_len=30), x)
    assert "moe_projection" in params
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    close_rel(out, ref)
    assert mod.moe_projection.mode == "dense_all"


# --------------------------------------------------------------------------- #
# the tiny flagship
# --------------------------------------------------------------------------- #

def tiny_flagship(c, simulator_mode="auto", **overrides):
    """``integrated_config(use_deepseek_fusion=True)`` of package ``c`` at
    width 64 with 2 fusion and 2 simulator layers."""
    cfg = c.integrated_config(
        universal_dim=D, num_fusion_layers=2, use_deepseek_fusion=True,
        grid4d=c.Grid4DConfig(n_spatial_levels=4, n_temporal_levels=2,
                              hash_table_size=2 ** 12), **overrides)
    ds = cfg.fusion.deepseek_block
    cfg.fusion.deepseek_block = dataclasses.replace(
        ds, moe=dataclasses.replace(ds.moe, dispatch_mode=simulator_mode))
    return cfg


def numpy_batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "xyzt": rng.uniform(0.0, 1.0, (B, 4)).astype(np.float32),
        "modalities": {
            "vision": rng.standard_normal((B, S_VISION, 1408)).astype(
                np.float32),
            "language": rng.standard_normal((B, S_LANGUAGE, 7168)).astype(
                np.float32),
        },
    }


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


NATIVE = {"vision": S_VISION, "language": S_LANGUAGE}


def model_pair(simulator_mode, **overrides):
    jax_cfg = tiny_flagship(jcfg, simulator_mode, **overrides)
    jmodel = JaxModel(jax_cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  to_jax(numpy_batch(0)))["params"]
    model = DeepEarthModel(config_from_json(jcfg.config_to_json(jax_cfg)),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu", native_seq_lens=NATIVE).eval()
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, params, model


@pytest.fixture(scope="module", params=["auto", "ragged"])
def flagship(request):
    """The tiny flagship in fp32 and one batch through both packages; JAX's
    ragged simulator runs the megablox kernel in interpret mode."""
    jmodel, params, model = model_pair(request.param,
                                       compute_dtype=jnp.float32)
    batch = numpy_batch(1)
    ref = jax.jit(lambda p, b: jmodel.apply({"params": p}, b))(
        params, to_jax(batch))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(to_torch(batch))
    return request.param, params, model, ref, out


def close(torch_out, jax_out, tol=TOL):
    np.testing.assert_allclose(torch_out.detach().float().numpy(),
                               np.asarray(jax_out, np.float32), atol=tol,
                               rtol=0)


def test_flagship_forward_matches_jax(flagship):
    mode, _, model, ref, out = flagship
    assert out["all_tokens"].shape == (B, 22, D)
    close(out["fused_representation"], ref["fused_representation"])
    close(out["all_tokens"], ref["all_tokens"])
    assert set(out["reconstructions"]) == set(ref["reconstructions"])
    for name, value in ref["reconstructions"].items():
        close(out["reconstructions"][name], value)
    assert list(out["modality_tokens"]) == ["spacetime", "language",
                                            "vision"]
    for name, value in ref["modality_tokens"].items():
        close(out["modality_tokens"][name], value)
    # the re-sliced modality tokens are the simulator's, from index 1
    assert torch.equal(out["modality_tokens"]["vision"],
                       out["all_tokens"][:, 6:22])
    assert torch.equal(out["fused_representation"], out["all_tokens"][:, 0])
    sim = model.simulator.layer_1.moe
    assert sim.mode == ("dense" if mode == "auto" else "ragged")
    assert model.encoder_vision.moe_projection.mode == "dense_all"
    # CPU tensors take the plain versions: no kernel launched
    assert set(kernels.launch_counts.values()) == {0}


def test_flagship_extract_features_and_parameter_count(flagship):
    _, params, model, ref, _ = flagship
    feats = model.extract_features(to_torch(numpy_batch(1)))
    close(feats, ref["fused_representation"])
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_flagship_tree_round_trips_with_fp32_router_under_bf16_params():
    """bf16 parameters and compute, as the flagship runs: every leaf maps
    both ways with its JAX dtype, the routers' weight and bias stay fp32,
    and the 3-D expert weights keep their (E, D, F) layout."""
    _, params, model = model_pair("auto", param_dtype=jnp.bfloat16)
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(params)}
    ports = dict(model.named_parameters())
    for path, value in flat.items():
        name = ".".join(k.strip("[]'") for k in path.split("]["))
        name = name.replace(".kernel", ".weight").replace(
            ".scale", ".weight").replace(".embedding", ".weight")
        assert str(ports[name].dtype).split(".")[-1] == str(value.dtype), \
            path
    moe = model.simulator.layer_1.moe
    assert moe.router_weight.dtype == torch.float32
    assert moe.e_score_correction_bias.dtype == torch.float32
    assert moe.w_gate.dtype == torch.bfloat16
    assert tuple(moe.w_down.shape) == (8, D, D)
    back = flax_params_from_model(model)
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path(back)}
    assert set(got) == set(flat)
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path],
                                      np.asarray(value, np.float32))


def test_flagship_config_matches_jax():
    """integrated_config, simulator_config and their JSON agree with the
    JAX package's."""
    ref = jcfg.integrated_config(use_deepseek_fusion=True,
                                 param_dtype=jnp.bfloat16)
    got = tcfg.integrated_config(use_deepseek_fusion=True,
                                 param_dtype=torch.bfloat16)
    port = config_from_json(jcfg.config_to_json(ref))
    assert (port.fusion, port.modalities, port.param_dtype) == \
        (got.fusion, got.modalities, got.param_dtype)
    back = jcfg.config_from_json(tcfg.config_to_json(got))
    assert (back.fusion, back.modalities) == (ref.fusion, ref.modalities)
    for preset in jcfg.SIMULATOR_PRESETS:
        assert dataclasses.asdict(tcfg.simulator_config(preset)) == \
            dataclasses.asdict(jcfg.simulator_config(preset))
