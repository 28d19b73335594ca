"""The port's token-sequence paths of DeepEarthModel against the JAX package,
on the CPU: a ``token_sequence`` modality (ids -> an embedding zeroed at
MLM-hidden positions -> the universal-token encoder -> per-token logits by a
TokenSequenceDecoder) and a ``decode_sequence`` vision modality (its
(B, S, Din) patches reconstructed whole by a TokenSequenceDecoder, MAE).

A tiny model (universal dim 64, 4 heads, 2 fusion layers; species, vision
(B, 40, 32) to 16 tokens, text (B, 12) ids of a 50-word vocabulary to 4
tokens) in fp32 with ``LossWeights(contrastive=0.1)``; the MLM and MAE
masks are numpy arrays in the batch and both steps take
``apply_masking=False``. Tolerances as tests/test_torch_training.py states
them: the forward's outputs 1e-4 absolute; loss terms 1e-5 relative, grad
norm 1e-4; every gradient leaf at step 1 within 1e-4 of its largest
magnitude (plus 1e-7); after 3 steps the parameters within 2 * sum(lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu.training import losses as jlosses
from deepearth_tpu.training import trainer as jtrainer
from deepearth_tpu_torch import config_from_json, kernels, load_flax_params
from deepearth_tpu_torch.convert import _leaves, _torch_name
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.models.deepearth import TokenSequenceDecoder
from deepearth_tpu_torch.training import (
    LossWeights,
    TrainState,
    create_optimizer,
    deepearth_loss,
    make_train_step,
)

torch.set_num_threads(2)

B, S_VISION, S_TEXT, TEXT_VOCAB, PEAK_LR = 4, 40, 12, 50, 1e-3
WEIGHTS = dict(contrastive=0.1)


def jax_config():
    cfg = jcfg.DeepEarthConfig(
        hidden_dim=64, n_heads=4, n_layers=2,
        grid4d=jcfg.Grid4DConfig(n_spatial_levels=4, n_temporal_levels=2,
                                 hash_table_size=2 ** 12),
        compute_dtype=jnp.float32)
    cfg.add_modality(jcfg.ModalityConfig(
        name="species", encoding_type="learned_embedding",
        input_type="categorical", vocab_size=232))
    cfg.add_modality(jcfg.ModalityConfig(
        name="vision", input_dim=32, n_tokens=16, encoder_layers=1,
        encoder_heads=4, decode_sequence=True))
    cfg.add_modality(jcfg.ModalityConfig(
        name="text", encoding_type="token_sequence", input_type="text",
        vocab_size=TEXT_VOCAB, n_tokens=4, encoder_layers=1,
        encoder_heads=4))
    cfg.optimizer = jcfg.OptimizerConfig(learning_rate=PEAK_LR,
                                         warmup_steps=2, total_steps=10)
    return cfg


def numpy_batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "xyzt": rng.uniform(0.0, 1.0, (B, 4)).astype(np.float32),
        "modalities": {
            "species": rng.integers(0, 232, (B,)),
            "vision": rng.standard_normal((B, S_VISION, 32)).astype(
                np.float32),
            "text": rng.integers(0, TEXT_VOCAB, (B, S_TEXT)).astype(
                np.int32),
        },
        "spatial_mask": rng.uniform(size=B) > 0.5,
        "temporal_mask": rng.uniform(size=B) > 0.5,
        "modality_masks": {name: rng.uniform(size=B) > 0.3
                           for name in ("species", "vision", "text")},
        "modality_patch_masks": {  # MAE 75% hidden, MLM 15% hidden
            "vision": rng.uniform(size=(B, S_VISION)) > 0.75,
            "text": rng.uniform(size=(B, S_TEXT)) > 0.15},
    }


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def torch_named(tree):
    return {_torch_name(path): (v.T if path[-1] == "kernel" else v)
            for path, v in _leaves(jax.tree_util.tree_map(np.asarray, tree))}


def rel_close(a, b, rtol):
    a, b = float(a), float(b)
    assert abs(a - b) <= rtol * max(abs(b), 1e-12), (a, b)


@pytest.fixture(scope="module")
def setup():
    cfg = jax_config()
    jmodel = JaxModel(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  to_jax(numpy_batch(0)))["params"]
    weights = jlosses.LossWeights(**WEIGHTS)

    def loss_fn(p, batch):
        out = jmodel.apply({"params": p}, batch, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.deepearth_loss(out, batch, cfg, weights)

    return dict(
        cfg=cfg, jmodel=jmodel, params=params,
        apply=jax.jit(jmodel.apply),
        step=jax.jit(jtrainer.make_train_step(jmodel, cfg, weights,
                                              apply_masking=False)),
        grads=jax.jit(jax.value_and_grad(loss_fn, has_aux=True)),
        port_cfg=config_from_json(jcfg.config_to_json(cfg)))


def port_model(s):
    model = DeepEarthModel(s["port_cfg"],
                           generator=torch.Generator().manual_seed(0),
                           device="cpu",
                           native_seq_lens={"vision": S_VISION,
                                            "text": S_TEXT})
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, s["params"]))
    return model


def test_forward_matches_jax(setup):
    """Per-token logits and the whole-sequence reconstruction, the fused
    tokens, in eval mode."""
    batch = numpy_batch(5)
    ref = setup["apply"]({"params": setup["params"]}, to_jax(batch))
    model = port_model(setup)
    assert isinstance(model.decoder_text, TokenSequenceDecoder)
    assert isinstance(model.decoder_vision, TokenSequenceDecoder)
    model.eval()
    with torch.no_grad():
        out = model(to_torch(batch))
    recon = out["reconstructions"]
    assert recon["text"].shape == (B, S_TEXT, TEXT_VOCAB)
    assert recon["vision"].shape == (B, S_VISION, 32)
    for key in ("spatial", "temporal", "species", "vision", "text"):
        np.testing.assert_allclose(recon[key].numpy(),
                                   np.asarray(ref["reconstructions"][key]),
                                   rtol=0, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(out["all_tokens"].numpy(),
                               np.asarray(ref["all_tokens"]), rtol=0,
                               atol=1e-4)


def test_step_one_loss_terms_and_gradients_match_jax(setup):
    batch = numpy_batch(1)
    (loss, metrics), grads = setup["grads"](setup["params"], to_jax(batch))
    model = port_model(setup)
    model.train()
    kernels.reset_launch_counts()
    out = model(to_torch(batch))
    t_loss, t_metrics = deepearth_loss(out, to_torch(batch),
                                       setup["port_cfg"],
                                       LossWeights(**WEIGHTS))
    t_loss.backward()
    assert set(kernels.launch_counts.values()) == {0}  # CPU: plain versions
    rel_close(t_loss.detach(), loss, 1e-5)
    assert set(t_metrics) == set(metrics)
    for key in ("loss/vision", "loss/text", "acc/text"):
        assert key in t_metrics
    for k, v in metrics.items():
        rel_close(t_metrics[k].detach(), v, 1e-5)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    ref = torch_named(grads)
    assert set(got) == set(ref)
    for name, g in ref.items():
        np.testing.assert_allclose(got[name], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-7,
                                   err_msg=name)


def test_three_steps_match_jax(setup):
    batches = [numpy_batch(10 + i) for i in range(3)]
    tx = jtrainer.create_optimizer(setup["cfg"].optimizer)
    jstate = jtrainer.TrainState.create(apply_fn=setup["jmodel"].apply,
                                        params=setup["params"], tx=tx)
    model = port_model(setup)
    state = TrainState(model, create_optimizer(model.parameters(),
                                               setup["port_cfg"].optimizer))
    step = make_train_step(model, setup["port_cfg"], LossWeights(**WEIGHTS),
                           apply_masking=False)
    for batch in batches:
        jstate, m = setup["step"](jstate, to_jax(batch),
                                  jax.random.PRNGKey(0))
        state, tm = step(state, to_torch(batch), torch.Generator())
        rel_close(tm["loss/total"], m["loss/total"], 1e-5)
        rel_close(tm["grad_norm"], m["grad_norm"], 1e-4)
    lrs = [state.optimizer.learning_rate(i) for i in range(3)]
    ref = torch_named(jstate.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0,
                                   atol=2 * sum(lrs) + 1e-6, err_msg=name)


def test_token_sequence_needs_its_length():
    cfg = config_from_json(jcfg.config_to_json(jax_config()))
    with pytest.raises(ValueError, match="native_seq_lens"):
        DeepEarthModel(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu", native_seq_lens={"vision": S_VISION})
