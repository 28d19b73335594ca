"""The PyTorch port's DeepEarthModel against the JAX package, on the CPU.

A hidden-128, 4-head, 4-layer model (cross-attention at layers 0 and 3,
4 spatial levels on 2^10-entry tables) in fp32. Parameters come from the
JAX model's ``init`` and go through ``load_flax_params``; inputs are numpy
arrays from a seed, fed to both. Tolerance 1e-4 absolute: both sides run the
same fp32 math, summed in different orders, through 4 residual layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu.models.decoders import (
    ModalityDecoder as JaxModalityDecoder,
    SpatiotemporalDecoder as JaxSpatiotemporalDecoder,
)
from deepearth_tpu.models.fusion import CrossModalFusion as JaxFusion
from deepearth_tpu.models.grid4d import Grid4DEncoder as JaxGrid4D
from deepearth_tpu_torch import (
    DeepSeekBlockConfig,
    config_from_json,
    kernels,
    load_flax_params,
)
from deepearth_tpu_torch.models import CrossModalFusion as TorchFusion
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.models import fusion as tfusion
from deepearth_tpu_torch.models import transformer as ttransformer
from deepearth_tpu_torch.models.layers import Init, dropout

torch.set_num_threads(2)

TOL = 1e-4
B = 6
VOCAB = 232


def small_jax_config(**grid4d):
    cfg = jcfg.DeepEarthConfig(
        hidden_dim=128, n_heads=4, n_layers=4,
        grid4d=jcfg.Grid4DConfig(n_spatial_levels=4, n_temporal_levels=2,
                                 hash_table_size=2 ** 10, **grid4d),
        compute_dtype=jnp.float32,
    )
    cfg.add_modality(jcfg.ModalityConfig(
        name="species", encoding_type="learned_embedding",
        input_type="categorical", vocab_size=VOCAB))
    return cfg


def numpy_batch(seed, masks=False):
    rng = np.random.default_rng(seed)
    xyzt = rng.uniform(0.0, 1.0, (B, 4)).astype(np.float32)
    xyzt[0] = [0.0, 0.5, 1.0, 0.25]  # exact grid points
    batch = {"xyzt": xyzt,
             "modalities": {"species": rng.integers(0, VOCAB, (B,))}}
    if masks:
        batch["spatial_mask"] = rng.uniform(size=B) > 0.5
        batch["temporal_mask"] = rng.uniform(size=B) > 0.5
        batch["modality_masks"] = {"species": np.arange(B) % 2 == 0}
    return batch


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def build_pair(jax_cfg):
    """The JAX model with its params, and the port loaded with them."""
    jmodel = JaxModel(jax_cfg)
    params = jmodel.init(jax.random.PRNGKey(0), to_jax(numpy_batch(0)))["params"]
    params_np = jax.tree_util.tree_map(np.asarray, params)
    cfg = config_from_json(jcfg.config_to_json(jax_cfg))
    model = DeepEarthModel(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    load_flax_params(model, params_np)
    return jmodel, params, model


def close(torch_out, jax_out, tol=TOL):
    np.testing.assert_allclose(torch_out.detach().numpy(), np.asarray(jax_out),
                               atol=tol, rtol=0)


@pytest.fixture(scope="module")
def pair():
    return build_pair(small_jax_config())


@pytest.mark.parametrize("masks", [False, True], ids=["no_masks", "masks"])
def test_full_forward_matches_jax(pair, masks):
    jmodel, params, model = pair
    batch = numpy_batch(1, masks=masks)
    ref = jmodel.apply({"params": params}, to_jax(batch), deterministic=True)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(to_torch(batch))
    close(out["fused_representation"], ref["fused_representation"])
    close(out["all_tokens"], ref["all_tokens"])
    assert set(out["reconstructions"]) == set(ref["reconstructions"])
    for name, value in ref["reconstructions"].items():
        close(out["reconstructions"][name], value)
    for name, value in ref["input_tokens"].items():
        close(out["input_tokens"][name], value)
    # CPU tensors take the plain versions: no kernel launched
    assert set(kernels.launch_counts.values()) == {0}


def test_extract_features_matches_jax(pair):
    jmodel, params, model = pair
    batch = numpy_batch(2)
    ref = jmodel.apply({"params": params}, to_jax(batch),
                       method=JaxModel.extract_features)
    out = model.extract_features(to_torch(batch))
    assert out.is_inference()
    close(out, ref)


@pytest.mark.parametrize("masks", [False, True], ids=["no_masks", "masks"])
def test_grid4d_matches_jax(pair, masks):
    jmodel, params, model = pair
    batch = numpy_batch(3, masks=masks)
    sm, tm = batch.get("spatial_mask"), batch.get("temporal_mask")
    enc = JaxGrid4D(jmodel.config.grid4d, 128, jnp.float32, jnp.float32)
    ref = enc.apply({"params": params["grid4d"]}, jnp.asarray(batch["xyzt"]),
                    None if sm is None else jnp.asarray(sm),
                    None if tm is None else jnp.asarray(tm))
    with torch.no_grad():
        out = model.grid4d(torch.from_numpy(batch["xyzt"]),
                           None if sm is None else torch.from_numpy(sm),
                           None if tm is None else torch.from_numpy(tm))
    close(out, ref)


@pytest.mark.parametrize("mode", [dict(use_decompositions=True),
                                  dict(encoding_mode="sincos",
                                       sincos_feat_dim=16, sincos_mlp_dim=32)],
                         ids=["decompositions", "sincos"])
def test_grid4d_modes_match_jax(mode):
    jax_cfg = small_jax_config(**mode)
    jmodel, params, model = build_pair(jax_cfg)
    batch = numpy_batch(4, masks=True)
    enc = JaxGrid4D(jax_cfg.grid4d, 128, jnp.float32, jnp.float32)
    ref = enc.apply({"params": params["grid4d"]}, jnp.asarray(batch["xyzt"]),
                    jnp.asarray(batch["spatial_mask"]),
                    jnp.asarray(batch["temporal_mask"]))
    with torch.no_grad():
        out = model.grid4d(torch.from_numpy(batch["xyzt"]),
                           torch.from_numpy(batch["spatial_mask"]),
                           torch.from_numpy(batch["temporal_mask"]))
    close(out, ref)


def test_cross_modal_fusion_matches_jax(pair):
    jmodel, params, model = pair
    rng = np.random.default_rng(5)
    toks = {n: rng.standard_normal((B, 1, 128)).astype(np.float32)
            for n in ("spacetime", "species")}
    tpos = {n: rng.uniform(size=(B, 1, 1)).astype(np.float32) for n in toks}
    fusion = JaxFusion(jmodel.config.fusion, ("spacetime", "species"),
                       jnp.float32, jnp.float32)
    ref = fusion.apply({"params": params["fusion"]}, to_jax(toks), None,
                       to_jax(tpos))
    with torch.no_grad():
        out = model.fusion(to_torch(toks), None, to_torch(tpos))
    close(out["fused_representation"], ref["fused_representation"])
    close(out["all_tokens"], ref["all_tokens"])
    for name in toks:
        close(out["modality_tokens"][name], ref["modality_tokens"][name])


@pytest.mark.parametrize("variant", ["gated_mlp", "plain_mlp",
                                     "self_context", "spatial_tables"])
def test_fusion_variants_match_jax(variant):
    """Fusion options the A-stack leaves at their defaults, and a square
    4-token modality with binned spatial tables (6 tokens, token-major)."""
    D = 64
    cfg = jcfg.FusionConfig(
        universal_dim=D, num_fusion_layers=4, num_heads=4,
        use_gated_mlp=variant != "plain_mlp",
        cross_attention_context="self" if variant == "self_context"
        else "inputs")
    rng = np.random.default_rng(7)
    n_tok = {"vision": 4 if variant == "spatial_tables" else 2, "species": 1}
    toks = {n: rng.standard_normal((B, k, D)).astype(np.float32)
            for n, k in n_tok.items()}
    tpos = {n: rng.uniform(size=(B, k, 1)).astype(np.float32)
            for n, k in n_tok.items()}
    spos = None
    if variant == "spatial_tables":
        spos = {"vision": rng.uniform(size=(B, 4, 2)).astype(np.float32)}
    names = ("species", "vision")
    jfusion = JaxFusion(cfg, names, jnp.float32, jnp.float32)
    params = jfusion.init(jax.random.PRNGKey(1), to_jax(toks),
                          None if spos is None else to_jax(spos),
                          to_jax(tpos))["params"]
    ref = jfusion.apply({"params": params}, to_jax(toks),
                        None if spos is None else to_jax(spos), to_jax(tpos))
    port_cfg = config_from_json(jcfg.config_to_json(cfg))
    fusion = TorchFusion(port_cfg, names,
                         Init(torch.Generator().manual_seed(0), "cpu"),
                         torch.float32, spatial=spos is not None)
    load_flax_params(fusion, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        out = fusion(to_torch(toks), None if spos is None else to_torch(spos),
                     to_torch(tpos))
    close(out["all_tokens"], ref["all_tokens"])
    for name in toks:
        close(out["modality_tokens"][name], ref["modality_tokens"][name])


@pytest.mark.parametrize("which", ["spatial_decoder", "temporal_decoder",
                                   "decoder_species"])
def test_decoders_match_jax(pair, which):
    _, params, model = pair
    x = np.random.default_rng(6).standard_normal((B, 128)).astype(np.float32)
    if which == "decoder_species":
        dec = JaxModalityDecoder(128, VOCAB, 0.0, jnp.float32, jnp.float32)
        ref = dec.apply({"params": params[which]}, jnp.asarray(x))
    else:
        out_dim = 3 if which == "spatial_decoder" else 1
        dec = JaxSpatiotemporalDecoder(128, out_dim, which.split("_")[0],
                                       jnp.float32, jnp.float32)
        ref = dec.apply({"params": params[which]}, jnp.asarray(x))
    with torch.no_grad():
        out = getattr(model, which)(torch.from_numpy(x))
    close(out, ref)


def test_batch_major_layout_not_ported(pair):
    """More tokens than token_major_max_tokens: the batch-major layout,
    ported since, matches JAX (it no longer raises)."""
    jmodel, params, model = pair
    rng = np.random.default_rng(11)
    toks = {"spacetime": rng.standard_normal((2, 9, 128)).astype(np.float32)}
    fusion = JaxFusion(jmodel.config.fusion, ("spacetime", "species"),
                       jnp.float32, jnp.float32)
    ref = fusion.apply({"params": params["fusion"]}, to_jax(toks))
    with torch.no_grad():
        out = model.fusion(to_torch(toks))
    assert out["all_tokens"].shape == (2, 10, 128)
    close(out["all_tokens"], ref["all_tokens"])


@pytest.mark.parametrize("what", ["continuous_values", "token_sequence",
                                  "deepseek_block"])
def test_unported_branches_raise(what):
    """A pipelined simulator still raises. The other two branches are
    ported and match JAX's forward: a continuous modality with its MoE
    projection and decode_sequence (its (B, S, Din) input reconstructed
    whole by a TokenSequenceDecoder), and a token sequence ((B, S) ids, an
    embedding zeroed at MLM-hidden positions, the encoder, per-token
    logits)."""
    if what == "deepseek_block":
        cfg = config_from_json(jcfg.config_to_json(small_jax_config()))
        cfg.fusion.deepseek_block = DeepSeekBlockConfig(hidden_dim=128,
                                                        pipeline_stages=2)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DeepEarthModel(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
        return
    jc = small_jax_config()
    m = jc.modalities["species"]
    m.encoding_type, m.use_moe_projection, m.decode_sequence = what, True, True
    m.n_tokens, m.encoder_layers, m.encoder_heads = 4, 1, 4
    rng = np.random.default_rng(12)
    S = 7
    if what == "continuous_values":
        m.input_dim, m.vocab_size = 24, None
        x = rng.standard_normal((B, S, 24)).astype(np.float32)
    else:
        x = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    batch = {"xyzt": rng.uniform(0.0, 1.0, (B, 4)).astype(np.float32),
             "modalities": {"species": x},
             "modality_patch_masks": {"species": rng.uniform(size=(B, S))
                                      > 0.3}}
    jmodel = JaxModel(jc)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  to_jax(batch))["params"]
    model = DeepEarthModel(config_from_json(jcfg.config_to_json(jc)),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu", native_seq_lens={"species": S})
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    ref = jax.jit(jmodel.apply)({"params": params}, to_jax(batch))
    with torch.no_grad():
        out = model(to_torch(batch))
    width = 24 if what == "continuous_values" else VOCAB
    assert out["reconstructions"]["species"].shape == (B, S, width)
    for key in ("spatial", "temporal", "species"):
        close(out["reconstructions"][key], ref["reconstructions"][key])
    close(out["fused_representation"], ref["fused_representation"])


def test_model_without_a_device_needs_a_card(monkeypatch):
    """The model is built on the card unless the caller names a device;
    without a card that default raises instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_json(jcfg.config_to_json(small_jax_config()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepEarthModel(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Init(torch.Generator())


# --------------------------------------------------------------------------- #
# dropout: the JAX package's sites, active in training mode only
# --------------------------------------------------------------------------- #


def dropout_model(p, gated=True):
    jax_cfg = small_jax_config()
    jax_cfg.fusion.dropout = p
    jax_cfg.fusion.use_gated_mlp = gated
    return DeepEarthModel(config_from_json(jcfg.config_to_json(jax_cfg)),
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")


@pytest.mark.parametrize("gated", [True, False], ids=["gated_mlp", "mlp"])
def test_dropout_sites_match_jax(monkeypatch, gated):
    """Each attention output and the MLP: gated, one site after the down
    projection (transformer.py:141); GELU MLP, after the activation and
    after fc2 (:111, :116); attention after out_proj (fusion.py:147)."""
    calls = []

    def counting(x, p, training, generator):
        calls.append((p, training))
        return dropout(x, p, training, generator)

    monkeypatch.setattr(tfusion, "dropout", counting)
    monkeypatch.setattr(ttransformer, "dropout", counting)
    model = dropout_model(0.25, gated).train()
    model(to_torch(numpy_batch(8)), generator=torch.Generator())
    # 4 layers of self-attention, cross-attention at layers 0 and 3
    mlp_sites = 1 if gated else 2
    assert len(calls) == 4 + 2 + 4 * mlp_sites
    assert set(calls) == {(0.25, True)}


def test_dropout_zero_is_bit_identical_to_eval():
    model = dropout_model(0.0)
    batch = to_torch(numpy_batch(9, masks=True))
    with torch.no_grad():
        ref = model.eval()(batch)["fused_representation"]
        out = model.train()(batch)["fused_representation"]
    assert torch.equal(out, ref)


def test_dropout_active_only_in_training_and_reproducible():
    model = dropout_model(0.5)
    batch = to_torch(numpy_batch(10))
    with torch.no_grad():
        ref = model.eval()(batch)["fused_representation"]
        model.train()
        a = model(batch, generator=torch.Generator().manual_seed(3))
        b = model(batch, generator=torch.Generator().manual_seed(3))
        c = model(batch, generator=torch.Generator().manual_seed(4))
        with pytest.raises(ValueError, match="Generator"):
            model(batch)
    a, b, c = (x["fused_representation"] for x in (a, b, c))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, ref)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_dropout_keep_fraction_and_scaling(p):
    """flax's statistics (its bits differ): each element kept with
    probability 1 - p and scaled by 1 / (1 - p)."""
    x = torch.full((200, 500), 2.0)
    y = dropout(x, p, True, torch.Generator().manual_seed(0))
    kept = y != 0
    # binomial standard error at n=1e5 is <= 0.0016: allow 4 of them
    assert abs(kept.float().mean().item() - (1 - p)) < 0.0064
    torch.testing.assert_close(y[kept], torch.full_like(y[kept],
                                                        2.0 / (1 - p)))
    assert dropout(x, p, False, None) is x


def test_extract_features_runs_in_eval_mode_and_restores_the_mode():
    """JAX's extract_features always runs deterministic: with dropout > 0
    the port's gives the same features after model.train() as after
    model.eval(), needs no generator, and leaves the caller's mode."""
    model = dropout_model(0.5)
    batch = to_torch(numpy_batch(11))
    ref = model.eval().extract_features(batch)
    assert not model.training
    out = model.train().extract_features(batch)
    assert model.training
    assert torch.equal(out, ref)
