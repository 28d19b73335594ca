"""The C-stack's modules against the JAX package, on the CPU: the shared
latent space (``LatentPool``, ``MultimodalSharedSpace``), the bidirectional
reconstructor with its ``VisionSequenceDecoder`` (pooled and full-grid
output), the multimodal autoencoder, and the MLP U-Nets (``MLPUNet``,
``MultimodalUNet``, ``BimodalMLPUNet`` with a learned and a frozen species
table) with ``species_topk``.

Small widths, parameters from the JAX module's ``init`` through
``load_flax_params``, numpy inputs from a seed, fp32, eval mode, held within
1e-5 of each output's largest entry (tests/test_torch_model_zoo.py's
helpers). ``input_feature_mask`` and the U-Nets' training masks draw from a
``torch.Generator`` where JAX takes a key: they are held on shape, rate and
repeatability.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu.models import bidirectional as jbi
from deepearth_tpu.models import mlp_unet as junet
from deepearth_tpu.models import shared_space as jshared
from deepearth_tpu_torch.models import (
    BidirectionalReconstructor,
    BimodalMLPUNet,
    LatentPool,
    MLPUNet,
    MultimodalAutoencoder,
    MultimodalSharedSpace,
    MultimodalUNet,
    VisionSequenceDecoder,
    input_feature_mask,
    species_topk,
)
from test_torch_model_zoo import B, close, features, init, paired

torch.set_num_threads(2)


def test_input_feature_mask():
    g = torch.Generator().manual_seed(3)
    m = input_feature_mask(g, (32, 50), 0.3)
    assert m.shape == (32, 50) and m.dtype == torch.bool
    assert 0.6 < m.float().mean().item() < 0.8
    assert input_feature_mask(g, (4, 5), 0.0).all()
    assert torch.equal(
        input_feature_mask(torch.Generator().manual_seed(1), (6, 7), 0.5),
        input_feature_mask(torch.Generator().manual_seed(1), (6, 7), 0.5))


def test_latent_pool_and_shared_space_match_jax():
    tokens = features(12, B, 7, 32)
    out, ref, _ = paired(
        jshared.LatentPool(n_latents=4, dim=32, n_heads=4),
        LatentPool(4, 32, 4, init=init()), tokens)
    close(out, ref)
    dims = {"vision": 24, "language": 40}
    feats = {"vision": features(13, B, 6, 24),
             "language": features(14, B, 40)}
    out, ref, params = paired(
        jshared.MultimodalSharedSpace(dims, dim=32, n_latents=4, n_heads=4),
        MultimodalSharedSpace(dims, 32, 4, 4, init=init()), feats)
    close(out, ref)
    assert out["latents"].shape == (B, 4, 32)


def test_vision_sequence_decoder_matches_jax():
    out, ref, _ = paired(
        jbi.VisionSequenceDecoder(grid=(2, 2, 3), channels=24,
                                  hidden_dim=16, n_heads=4),
        VisionSequenceDecoder(40, (2, 2, 3), 24, 16, 4, init=init()),
        features(15, B, 40))
    close(out, ref)
    assert out.shape == (B, 2, 2, 3, 24)


@pytest.mark.parametrize("full", [False, True])
def test_bidirectional_reconstructor_matches_jax(full):
    kw = dict(vision_dim=24, language_dim=40, hidden_dim=16,
              vision_grid=(2, 2, 3), full_vision_output=full)
    vision, language = features(16, B, 12, 24), features(17, B, 40)
    out, ref, _ = paired(jbi.BidirectionalReconstructor(**kw),
                         BidirectionalReconstructor(**kw, init=init()),
                         vision, language)
    close(out, ref)
    want = (B, 2, 2, 3, 24) if full else (B, 24)
    assert out["vision_from_language"].shape == want
    # pooled (B, Dv) vision in
    out, ref, _ = paired(jbi.BidirectionalReconstructor(**kw),
                         BidirectionalReconstructor(**kw, init=init()),
                         vision.mean(axis=1), language)
    close(out, ref)


def test_multimodal_autoencoder_matches_jax():
    kw = dict(vision_dim=24, language_dim=40, bottleneck_dim=8, n_species=5,
              hidden_dim=16)
    out, ref, _ = paired(jbi.MultimodalAutoencoder(**kw),
                         MultimodalAutoencoder(**kw, init=init()),
                         features(18, B, 12, 24), features(19, B, 40))
    close(out, ref)


def test_mlp_unet_matches_jax():
    """base 64, depth 3: widths 64, 32, then the floor of 32."""
    out, ref, params = paired(
        junet.MLPUNet(input_dim=20, output_dim=12, base_width=64, depth=3),
        MLPUNet(20, 12, 64, 3, init=init()), features(20, B, 20))
    close(out, ref)
    assert params["down2"]["kernel"].shape == (32, 32)


def test_multimodal_unet_matches_jax_and_masks_in_training():
    kw = dict(vision_dim=20, language_dim=12, base_width=32, depth=2)
    vision, language = features(21, B, 3, 20), features(22, B, 12)
    out, ref, _ = paired(junet.MultimodalUNet(**kw),
                         MultimodalUNet(**kw, init=init()), vision, language)
    close(out, ref)
    mod = MultimodalUNet(**kw, language_mask_prob=0.5, init=init()).train()
    v, lang = torch.from_numpy(vision), torch.from_numpy(language)
    with torch.no_grad():
        a = mod(v, lang, torch.Generator().manual_seed(2))
        b = mod(v, lang, torch.Generator().manual_seed(2))
        c = mod(v, lang, torch.Generator().manual_seed(3))
    assert torch.equal(a["language_recon"], b["language_recon"])
    assert not torch.equal(a["language_recon"], c["language_recon"])
    with pytest.raises(ValueError):
        mod(v, lang)


@pytest.mark.parametrize("frozen", [False, True])
def test_bimodal_mlp_unet_matches_jax(frozen):
    table = features(23, 6, 24) if frozen else None
    kw = dict(n_species=6, embedding_dim=24, hidden_dim=32)
    jmod = junet.BimodalMLPUNet(
        **kw, species_table=None if table is None else jnp.asarray(table))
    tmod = BimodalMLPUNet(**kw, species_table=None if table is None
                          else torch.from_numpy(table), init=init())
    emb = features(24, B, 24)
    out, ref, params = paired(jmod, tmod, emb)
    close({k: out[k] for k in ("recon", "target", "species_table")},
          {k: ref[k] for k in ("recon", "target", "species_table")})
    assert out["mask"].all() and np.asarray(ref["mask"]).all()
    assert ("species_embeddings" in params) == (not frozen)
    assert ("species_embeddings" in dict(tmod.named_parameters())) == \
        (not frozen)
    ids = np.array([0, 5, 2])
    jparams = params
    ref = jmod.apply({"params": jparams}, species_ids=jnp.asarray(ids))
    with torch.no_grad():
        out = tmod(species_ids=torch.from_numpy(ids))
    close(out["recon"], ref["recon"])
    with pytest.raises(ValueError):
        tmod(embedding=torch.from_numpy(emb),
             species_ids=torch.from_numpy(ids))
    tmod.train()
    g = torch.Generator().manual_seed(4)
    masked = tmod(embedding=torch.from_numpy(emb), generator=g)
    assert 0.3 < masked["mask"].float().mean().item() < 0.7


def test_species_topk_matches_jax():
    recon, table = features(25, 5, 16), features(26, 9, 16)
    ref = junet.species_topk(jnp.asarray(recon), jnp.asarray(table), k=3)
    out = species_topk(torch.from_numpy(recon), torch.from_numpy(table), 3)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
