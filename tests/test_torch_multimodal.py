"""The port's multimodal forward against the JAX package, on the CPU.

A tiny multimodal model in fp32: universal dim 64, 4 heads, 2 fusion layers,
Grid4D on 2^12-entry tables; species (learned embedding), vision (B, 260,
32) patches through a universal-token encoder to 16 tokens, and language
(B, 24) through one to 4 tokens. The fusion stack sees 1 CLS + 1 spacetime
+ 1 species + 16 vision + 4 language = 23 tokens, more than
``token_major_max_tokens``, so it runs batch-major. Parameters come from the
JAX model's ``init`` (jitted once for the module) through
``load_flax_params``; inputs and masks are numpy arrays from a seed, passed
in the batch to both. Tolerance 1e-4 absolute, as for the A-stack forward:
the same fp32 math, summed in other orders, through encoders and fusion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu_torch import (
    config_from_json,
    flax_params_from_model,
    kernels,
    load_flax_params,
)
from deepearth_tpu_torch.models import DeepEarthModel

torch.set_num_threads(2)

TOL = 1e-4
B, S_VISION, VOCAB = 2, 260, 232


def tiny_config():
    cfg = jcfg.DeepEarthConfig(
        hidden_dim=64, n_heads=4, n_layers=2,
        grid4d=jcfg.Grid4DConfig(n_spatial_levels=4, n_temporal_levels=2,
                                 hash_table_size=2 ** 12),
        compute_dtype=jnp.float32)
    cfg.add_modality(jcfg.ModalityConfig(
        name="species", encoding_type="learned_embedding",
        input_type="categorical", vocab_size=VOCAB))
    cfg.add_modality(jcfg.ModalityConfig(
        name="vision", input_dim=32, n_tokens=16, encoder_layers=1,
        encoder_heads=4))
    cfg.add_modality(jcfg.ModalityConfig(
        name="language", input_dim=24, n_tokens=4, encoder_layers=1,
        encoder_heads=4))
    return cfg


def numpy_batch(seed, masks=False):
    rng = np.random.default_rng(seed)
    batch = {
        "xyzt": rng.uniform(0.0, 1.0, (B, 4)).astype(np.float32),
        "modalities": {
            "species": rng.integers(0, VOCAB, (B,)),
            "vision": rng.standard_normal((B, S_VISION, 32)).astype(
                np.float32),
            "language": rng.standard_normal((B, 24)).astype(np.float32),
        },
    }
    if masks:
        batch["spatial_mask"] = np.array([True, False])
        batch["temporal_mask"] = np.array([False, True])
        batch["modality_masks"] = {"species": np.array([True, False]),
                                   "vision": np.array([False, True]),
                                   "language": np.array([True, False])}
        batch["modality_patch_masks"] = {
            "vision": rng.uniform(size=(B, S_VISION)) > 0.75}
    return batch


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


@pytest.fixture(scope="module")
def pair():
    jax_cfg = tiny_config()
    jmodel = JaxModel(jax_cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  to_jax(numpy_batch(0)))["params"]
    apply = jax.jit(lambda p, b: jmodel.apply({"params": p}, b))
    model = DeepEarthModel(config_from_json(jcfg.config_to_json(jax_cfg)),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu",
                           native_seq_lens={"vision": S_VISION}).eval()
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    return apply, params, model


def close(torch_out, jax_out, tol=TOL):
    np.testing.assert_allclose(torch_out.detach().numpy(),
                               np.asarray(jax_out), atol=tol, rtol=0)


@pytest.mark.parametrize("masks", [False, True], ids=["no_masks", "masks"])
def test_multimodal_forward_matches_jax(pair, masks):
    apply, params, model = pair
    batch = numpy_batch(1, masks=masks)
    ref = apply(params, to_jax(batch))
    kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(to_torch(batch))
    assert out["all_tokens"].shape == (B, 23, 64)  # batch-major fusion
    close(out["fused_representation"], ref["fused_representation"])
    close(out["all_tokens"], ref["all_tokens"])
    assert set(out["reconstructions"]) == set(ref["reconstructions"])
    for name, value in ref["reconstructions"].items():
        close(out["reconstructions"][name], value)
    for name, value in ref["input_tokens"].items():
        close(out["input_tokens"][name], value)
    for name, value in ref["modality_tokens"].items():
        close(out["modality_tokens"][name], value)
    assert out["reconstructions"]["vision"].shape == (B, 32)
    # CPU tensors take the plain versions: no kernel launched
    assert set(kernels.launch_counts.values()) == {0}


def test_extract_features_matches_jax(pair):
    apply, params, model = pair
    batch = numpy_batch(2)
    ref = apply(params, to_jax(batch))["fused_representation"]
    out = model.extract_features(to_torch(batch))
    assert out.is_inference()
    close(out, ref)


def test_explicit_positions_match_jax(pair):
    """Positions in the batch win over the default grid and times."""
    apply, params, model = pair
    batch = numpy_batch(3)
    rng = np.random.default_rng(4)
    batch["spatial_positions"] = {
        "vision": rng.uniform(size=(B, 16, 2)).astype(np.float32)}
    batch["temporal_positions"] = {
        "language": rng.uniform(size=(B, 4, 1)).astype(np.float32)}
    ref = apply(params, to_jax(batch))
    with torch.inference_mode():
        out = model(to_torch(batch))
    close(out["all_tokens"], ref["all_tokens"])


def test_converted_tree_round_trips(pair):
    """Every leaf of the multimodal tree (RMSNorm weights, positions, query
    tokens, spatial tables, MLA projections) maps both ways."""
    _, params, model = pair
    back = flax_params_from_model(model)
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, flat)) == set(
        map(jax.tree_util.keystr, got))
    for path, value in flat.items():
        np.testing.assert_array_equal(got[path], np.asarray(value))
    enc = params["encoder_vision"]
    assert enc["position_embedding"].shape == (S_VISION, 64)
    assert "pool_query" in params["encoder_language"] or \
        "query_tokens" in params["encoder_language"]
    assert "spatial_embed_x" in params["fusion"]["st_embedding"]
