"""The flagship's train step against the JAX package, on the CPU.

The tiny flagship of tests/test_torch_simulator.py
(``integrated_config(use_deepseek_fusion=True)`` at universal dim 64: 2
fusion layers, a 2-layer MLA + MoE simulator, vision (B, 20, 1408) and
language (B, 5, 7168) through MoE-projected encoders; 3 MoE layers in all)
in fp32, dropout 0, trained with ``LossWeights(moe_aux=0.1)`` and the
flagship's optimizer settings (bf16 first moment, factored second moment:
the simulator's kv_b_proj kernels are factored at this width). Masks are
numpy arrays in the batch and both steps take ``apply_masking=False``. The
learning rate is the cosine schedule from the configured peak (1e-4, the
default the flagship trains with) without warmup, so the first update
already moves the parameters.

Under ``auto`` the simulator's MoE layer takes capacity dispatch, under
``ragged`` the grouped matmul: the port through ``gmm_plain`` and
``gmm_bwd_plain`` (K5's plain versions), JAX through megablox ``gmm`` and
its VJP (``tgmm``) in interpret mode.

Tolerances, as tests/test_torch_multimodal_training.py states them: loss
terms 1e-5 relative (every term at step 1; the total and ``loss/moe_aux`` at
every step), grad norm 1e-4; every gradient leaf at step 1 within 1e-4 of
its largest magnitude (plus 1e-7); after 3 steps the parameters within
2 * sum(lr); the factored second moment's fp32 factors within 1e-3 of
their leaf's largest magnitude, the bf16 first moment within one bf16 ulp
of its leaf's largest magnitude (2^-7 of it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu.training import losses as jlosses
from deepearth_tpu.training import trainer as jtrainer
from deepearth_tpu_torch import (
    config_from_json,
    flax_params_from_model,
    kernels,
    load_flax_opt_state,
)
from deepearth_tpu_torch.convert import _leaves, _torch_name
from deepearth_tpu_torch.models import DeepEarthModel, MoELayer
from deepearth_tpu_torch.training import (
    FusedAdamW,
    LossWeights,
    TrainState,
    create_optimizer,
    make_train_step,
)

torch.set_num_threads(2)

B, D, S_VISION, S_LANGUAGE, PEAK_LR, STEPS = 2, 64, 20, 5, 1e-4, 3
NATIVE = {"vision": S_VISION, "language": S_LANGUAGE}
MOE_AUX = 0.1


def jax_config(simulator_mode):
    cfg = jcfg.integrated_config(
        universal_dim=D, num_fusion_layers=2, use_deepseek_fusion=True,
        grid4d=jcfg.Grid4DConfig(n_spatial_levels=4, n_temporal_levels=2,
                                 hash_table_size=2 ** 12),
        compute_dtype=jnp.float32)
    ds = cfg.fusion.deepseek_block
    cfg.fusion.deepseek_block = dataclasses.replace(
        ds, moe=dataclasses.replace(ds.moe, dispatch_mode=simulator_mode))
    assert cfg.fusion.dropout == 0.0
    # the flagship train plan's optimizer (tools/bench_flagship.py:132-134)
    # on the cosine schedule without warmup: lr(0) is the peak
    cfg.optimizer = jcfg.OptimizerConfig(
        learning_rate=PEAK_LR, warmup_steps=0, total_steps=4,
        moment_dtype="bfloat16", second_moment="factored")
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
        "spatial_mask": np.array([True, False]),
        "temporal_mask": np.array([False, True]),
        "modality_masks": {"vision": np.array([True, False]),
                           "language": np.array([False, True])},
        "modality_patch_masks": {
            "vision": rng.uniform(size=(B, S_VISION)) > 0.75,
            "language": rng.uniform(size=(B, S_LANGUAGE)) > 0.5},
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


def keep_gradients() -> optax.GradientTransformation:
    """Passes the gradients on unchanged and keeps them as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module", params=["auto", "ragged"])
def run(request):
    """3 train steps of both packages (JAX's make_train_step, jitted once)
    from one set of parameters (the port's random init, handed to JAX as a
    flax tree: a JAX init would cost another compile): per-step metrics,
    both packages' gradients at step 1, and both final states."""
    cfg = jax_config(request.param)
    jmodel = JaxModel(cfg)
    weights = jlosses.LossWeights(moe_aux=MOE_AUX)
    jstep = jax.jit(jtrainer.make_train_step(jmodel, cfg, weights,
                                             apply_masking=False))
    port_cfg = config_from_json(jcfg.config_to_json(cfg))
    model = DeepEarthModel(port_cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", native_seq_lens=NATIVE)
    params = jax.tree_util.tree_map(jnp.asarray, flax_params_from_model(model))
    state = TrainState(model, create_optimizer(model.parameters(),
                                               port_cfg.optimizer))
    step = make_train_step(model, port_cfg, LossWeights(moe_aux=MOE_AUX),
                           apply_masking=False)
    # the configured optimizer behind a transformation that keeps the
    # gradients it was handed in its state: one compile gives both
    jstate = jtrainer.TrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=optax.chain(keep_gradients(),
                       jtrainer.create_optimizer(cfg.optimizer)))
    jax_metrics, port_metrics = [], []
    kernels.reset_launch_counts()
    for i in range(STEPS):
        batch = numpy_batch(10 + i)
        jstate, m = jstep(jstate, to_jax(batch), jax.random.PRNGKey(0))
        state, tm = step(state, to_torch(batch), torch.Generator())
        if i == 0:
            jgrads = jstate.opt_state[0]
            # the score-correction biases move the choice only: no
            # gradient in the port, zeros in JAX
            grads = {n: (np.zeros(p.shape, np.float32) if p.grad is None
                         else p.grad.numpy().copy())
                     for n, p in model.named_parameters()}
            modes = {n: mod.mode for n, mod in model.named_modules()
                     if isinstance(mod, MoELayer)}
        jax_metrics.append({k: float(v) for k, v in m.items()})
        port_metrics.append({k: float(v) for k, v in tm.items()})
    return dict(mode=request.param, cfg=cfg, jax=jax_metrics,
                port=port_metrics, grads=grads, jgrads=torch_named(jgrads),
                modes=modes, model=model, state=state,
                jparams=jstate.params, jopt=jstate.opt_state[1],
                launches=dict(kernels.launch_counts))


def test_dispatch_modes_and_no_kernel_on_the_cpu(run):
    sim = "dense" if run["mode"] == "auto" else "ragged"
    assert run["modes"] == {
        "encoder_vision.moe_projection": "dense_all",
        "encoder_language.moe_projection": "dense_all",
        "simulator.layer_1.moe": sim}
    assert set(run["launches"].values()) == {0}


def test_loss_terms_and_grad_norm_match_jax_every_step(run):
    """Every term at step 1, from one set of parameters; then the total, the
    aux term and the grad norm at every step (Adam's first update moves an
    element whose gradient is at rounding-noise level by +-lr, whichever
    sign the noise took, so a small term may drift apart more than the
    total)."""
    first, port_first = run["jax"][0], run["port"][0]
    assert set(port_first) == set(first) and "loss/moe_aux" in port_first
    for key, v in first.items():
        rel_close(port_first[key], v, 1e-4 if key == "grad_norm" else 1e-5)
    for m, tm in zip(run["jax"], run["port"]):
        assert set(tm) == set(m)
        for key in ("loss/total", "loss/moe_aux"):
            rel_close(tm[key], m[key], 1e-5)
        rel_close(tm["grad_norm"], m["grad_norm"], 1e-4)
    # three MoE calls, each a load-balance loss of about E sum f P >= 1
    assert all(tm["loss/moe_aux"] > 0.5 for tm in run["port"])


def test_step_one_gradients_match_jax(run):
    """Every leaf, the routers' weights among them: the aux term's gradient
    reaches them through the gate's scores."""
    ref = run["jgrads"]
    assert set(run["grads"]) == set(ref)
    for name, g in ref.items():
        np.testing.assert_allclose(run["grads"][name], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-7,
                                   err_msg=name)


def test_params_and_moments_after_three_steps_match_jax(run):
    state, model = run["state"], run["model"]
    lrs = [state.optimizer.learning_rate(i) for i in range(STEPS)]
    sched = optax.warmup_cosine_decay_schedule(0.0, PEAK_LR, 0, 4)
    assert lrs == pytest.approx([float(sched(i)) for i in range(STEPS)])
    assert lrs[0] == pytest.approx(PEAK_LR)
    ref = torch_named(run["jparams"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0,
                                   atol=2 * sum(lrs) + 1e-6, err_msg=name)
    want = FusedAdamW(list(model.parameters()), 0.0,
                      mu_dtype=torch.bfloat16, second_moment="factored")
    load_flax_opt_state(want, model, run["jopt"])
    assert want.count == state.optimizer.count == STEPS
    factored = [p for p in model.parameters()
                if "nu_row" in state.optimizer.state[p]]
    assert factored  # the simulator's kv_b_proj kernels
    for p in model.parameters():
        assert state.optimizer.state[p]["mu"].dtype == torch.bfloat16
        for key, w in want.state[p].items():
            # the bf16 first moment: an entry that lands near a rounding
            # boundary at one step rounds to either neighbour, and that ulp
            # carries on into the later steps
            top = w.float().abs().max().item()
            torch.testing.assert_close(
                state.optimizer.state[p][key].float(), w.float(), rtol=0,
                atol=(2 ** -7 if key == "mu" else 1e-3) * top + 1e-12)


def test_loss_moves_with_moe_aux(run):
    """The same step with moe_aux 0 reports no aux term, and its total is
    the reported total less moe_aux times the aux term."""
    cfg = config_from_json(jcfg.config_to_json(run["cfg"]))
    model = DeepEarthModel(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", native_seq_lens=NATIVE)
    batch = to_torch(numpy_batch(30))
    totals = {}
    for w in (0.0, MOE_AUX):
        model.load_state_dict(run["model"].state_dict())
        st = TrainState(model, create_optimizer(model.parameters(),
                                                cfg.optimizer))
        _, m = make_train_step(model, cfg, LossWeights(moe_aux=w),
                               apply_masking=False)(st, batch,
                                                    torch.Generator())
        assert ("loss/moe_aux" in m) == (w > 0)
        totals[w] = m
    with_aux = totals[MOE_AUX]
    rel_close(with_aux["loss/total"] - MOE_AUX * with_aux["loss/moe_aux"],
              totals[0.0]["loss/total"], 1e-6)
