"""The port's multimodal train step against the JAX package, on the CPU.

The tiny multimodal model of tests/test_torch_multimodal.py (universal dim
64, 4 heads, 2 fusion layers; species, vision (B, 260, 32) through a
universal-token encoder with MLA to 16 tokens, language (B, 24) to 4) in
fp32, dropout 0, with ``LossWeights(contrastive=0.1)`` (the objective of
tools/bench_multimodal.py): the MAE patch masks, the pooled MSE targets of
vision and language and the contrastive term over pooled modality tokens all
run. Masks are numpy arrays in the batch and both steps take
``apply_masking=False``. The vision encoder's attention runs K3's plain
versions here (260 keys), forward and backward.

Tolerances, as tests/test_torch_training.py states them: loss terms 1e-5
relative, grad norm 1e-4; every gradient leaf at step 1 within 1e-4 of its
largest magnitude (plus 1e-7); after 3 steps the parameters within
2 * sum(lr) and the optimizer's moments within 1e-3 of their leaf's largest
magnitude.

Also MLA at N >= flash_min_seq (set low): on the CPU both packages keep
``dot_product_attention`` (the flash kernels run only on their devices);
forward 1e-5 of its largest entry, gradients 1e-4 of each leaf's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu.models import deepseek as jds
from deepearth_tpu.training import losses as jlosses
from deepearth_tpu.training import trainer as jtrainer
from deepearth_tpu_torch import (
    config_from_json,
    kernels,
    load_flax_opt_state,
    load_flax_params,
)
from deepearth_tpu_torch import configs as tcfg
from deepearth_tpu_torch.convert import _leaves, _torch_name
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.models import deepseek as tds
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.training import (
    FusedAdamW,
    LossWeights,
    TrainState,
    create_optimizer,
    deepearth_loss,
    make_train_step,
)

torch.set_num_threads(2)

B, S_VISION, VOCAB, PEAK_LR = 4, 260, 232, 1e-3
WEIGHTS = dict(contrastive=0.1)


def jax_config():
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
    # warmup over 2 steps: lr 0, peak/2, then peak at the third update
    cfg.optimizer = jcfg.OptimizerConfig(learning_rate=PEAK_LR,
                                         warmup_steps=2, total_steps=10)
    return cfg


def numpy_batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "xyzt": rng.uniform(0.0, 1.0, (B, 4)).astype(np.float32),
        "modalities": {
            "species": rng.integers(0, VOCAB, (B,)),
            "vision": rng.standard_normal((B, S_VISION, 32)).astype(
                np.float32),
            "language": rng.standard_normal((B, 24)).astype(np.float32),
        },
        "spatial_mask": rng.uniform(size=B) > 0.5,
        "temporal_mask": rng.uniform(size=B) > 0.5,
        "modality_masks": {name: rng.uniform(size=B) > 0.3
                           for name in ("species", "vision", "language")},
        "modality_patch_masks": {
            "vision": rng.uniform(size=(B, S_VISION)) > 0.75},
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
    """A flax-named tree as {port parameter name: numpy array in the port's
    layout}."""
    return {_torch_name(path): (v.T if path[-1] == "kernel" else v)
            for path, v in _leaves(jax.tree_util.tree_map(np.asarray, tree))}


def rel_close(a, b, rtol):
    a, b = float(a), float(b)
    assert abs(a - b) <= rtol * max(abs(b), 1e-12), (a, b)


def assert_leaves_close(got, ref, rel=1e-4):
    assert set(got) == set(ref)
    for name, g in ref.items():
        np.testing.assert_allclose(got[name], g, rtol=0,
                                   atol=rel * np.abs(g).max() + 1e-7,
                                   err_msg=name)


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
        step=jax.jit(jtrainer.make_train_step(jmodel, cfg, weights,
                                              apply_masking=False)),
        grads=jax.jit(jax.value_and_grad(loss_fn, has_aux=True)),
        port_cfg=config_from_json(jcfg.config_to_json(cfg)))


def port_model(s):
    model = DeepEarthModel(s["port_cfg"],
                           generator=torch.Generator().manual_seed(0),
                           device="cpu", native_seq_lens={"vision": S_VISION})
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, s["params"]))
    return model


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
    for key in ("loss/vision", "loss/language", "loss/contrastive"):
        assert key in t_metrics
    for k, v in metrics.items():
        rel_close(t_metrics[k].detach(), v, 1e-5)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert_leaves_close(got, torch_named(grads))


def test_three_steps_match_jax(setup):
    """loss and grad norm per step, then params and optimizer moments."""
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
    assert lrs == pytest.approx([0.0, PEAK_LR / 2, PEAK_LR])
    ref = torch_named(jstate.params)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0,
                                   atol=2 * sum(lrs) + 1e-6, err_msg=name)
    want = FusedAdamW(list(model.parameters()), 0.0)
    load_flax_opt_state(want, model, jstate.opt_state)
    assert want.count == state.optimizer.count == 3
    for p in model.parameters():
        for key, w in want.state[p].items():
            torch.testing.assert_close(
                state.optimizer.state[p][key], w, rtol=0,
                atol=1e-3 * w.abs().max().item() + 1e-12)


@pytest.mark.parametrize("masked", [False, True], ids=["plain",
                                                       "key_mask_causal"])
def test_mla_over_flash_min_seq_matches_jax_on_the_cpu(masked):
    kw = dict(hidden_dim=64, n_heads=4, kv_lora_rank=16, qk_rope_head_dim=8,
              qk_nope_head_dim=16, v_head_dim=12, use_flash_attention=True,
              flash_min_seq=16)
    n = 40
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, n, 64)).astype(np.float32)
    do = rng.standard_normal((2, n, 64)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(2, n)) > 0.3
        mask[:, 0] = True
    jmod = jds.MLAttention(jcfg.MLAConfig(**kw), jnp.float32, jnp.float32)
    jmask = None if mask is None else jnp.asarray(mask)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jmask,
                       is_causal=masked)["params"]
    ref, vjp = jax.vjp(lambda p, x_: jmod.apply({"params": p}, x_, jmask,
                                                is_causal=masked),
                       params, jnp.asarray(x))
    ref_params, ref_x = vjp(jnp.asarray(do))

    mod = tds.MLAttention(tcfg.MLAConfig(**kw),
                          Init(torch.Generator().manual_seed(0), "cpu"),
                          torch.float32)
    load_flax_params(mod, jax.tree_util.tree_map(np.asarray, params))
    tx = torch.from_numpy(x).requires_grad_()
    kernels.reset_launch_counts()
    out = mod(tx, None if mask is None else torch.from_numpy(mask), masked)
    out.backward(torch.from_numpy(do))
    assert set(kernels.launch_counts.values()) == {0}
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert_leaves_close({"x": tx.grad.numpy()}, {"x": np.asarray(ref_x)})
    assert_leaves_close({n_: p.grad.numpy()
                         for n_, p in mod.named_parameters()},
                        torch_named(ref_params))
