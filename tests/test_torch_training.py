"""The PyTorch port's training layer against the JAX package, on the CPU.

Inputs are numpy arrays from a seed, fed to both packages. The model is
hidden 128, 4 heads, 2 fusion layers (cross-attention at layer 0), 4
spatial levels on 2^10-entry tables, fp32 compute, B=8; parameters come from
the JAX model's ``init`` through ``load_flax_params``.

Tolerances, with their reasons:
- losses and metrics 1e-5 relative: the same fp32 math summed in another
  order;
- gradients at step 1: 1e-4 of each leaf's largest magnitude (plus 1e-7),
  the forward's 1e-4 parity (tests/test_torch_model.py) carried backward;
- the optimizer on identical gradients: 1e-6 relative; only the bias
  correction's scalar is rounded differently;
- parameters after 3 steps: 2 * sum(lr) absolute. Adam moves every
  parameter by about lr per step whatever its gradient's size, and a
  gradient at rounding-noise level can flip its sign (2 * lr apart); the
  optimizer's moments agree to 1e-3 of their leaf's largest magnitude.
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
from deepearth_tpu.training import metrics as jmetrics
from deepearth_tpu.training import optimizers as jopt
from deepearth_tpu.training import trainer as jtrainer
from deepearth_tpu_torch import (
    config_from_json,
    flax_params_from_model,
    load_flax_opt_state,
    load_flax_params,
)
from deepearth_tpu_torch.configs import MaskingConfig
from deepearth_tpu_torch.convert import _leaves, _torch_name
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.training import (
    FusedAdamW,
    LossWeights,
    MetricAccumulator,
    MultiSteps,
    Trainer,
    TrainState,
    coordinate_error_meters,
    create_optimizer,
    deepearth_loss,
    format_epoch_line,
    mae_patch_mask,
    make_eval_step,
    make_train_step,
    mlm_token_mask,
    optimizer_state_bytes,
    partial_load_params,
    sample_masks,
    time_error_hours,
)
from deepearth_tpu_torch.training import losses as tlosses
from deepearth_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(2)

B = 8
VOCAB = 232
PEAK_LR = 1e-3
WEIGHTS = dict(contrastive=0.1, species_contrastive=0.1)


def jax_config():
    cfg = jcfg.DeepEarthConfig(
        hidden_dim=128, n_heads=4, n_layers=2,
        grid4d=jcfg.Grid4DConfig(n_spatial_levels=4, n_temporal_levels=2,
                                 hash_table_size=2 ** 10),
        compute_dtype=jnp.float32)
    cfg.add_modality(jcfg.ModalityConfig(
        name="species", encoding_type="learned_embedding",
        input_type="categorical", vocab_size=VOCAB))
    # warmup over 2 steps: lr 0, peak/2, then peak at the third update
    cfg.optimizer = jcfg.OptimizerConfig(learning_rate=PEAK_LR,
                                         warmup_steps=2, total_steps=10)
    return cfg


def numpy_batch(seed, masks=True, n=B):
    rng = np.random.default_rng(seed)
    batch = {"xyzt": rng.uniform(0.0, 1.0, (n, 4)).astype(np.float32),
             "modalities": {"species": rng.integers(0, 8, (n,))}}
    if masks:
        batch["spatial_mask"] = rng.uniform(size=n) > 0.5
        batch["temporal_mask"] = rng.uniform(size=n) > 0.5
        batch["modality_masks"] = {"species": np.arange(n) % 2 == 0}
    return batch


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
    if isinstance(a, torch.Tensor):
        a = a.detach()
    a, b = float(a), float(b)
    assert abs(a - b) <= rtol * max(abs(b), 1e-12), (a, b)


@pytest.fixture(scope="module")
def setup():
    """The JAX model, its initial params and jitted steps, and the port's
    config."""
    cfg = jax_config()
    jmodel = JaxModel(cfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         to_jax(numpy_batch(0)))["params"]
    weights = jlosses.LossWeights(**WEIGHTS)
    step = jax.jit(jtrainer.make_train_step(jmodel, cfg, weights,
                                            apply_masking=False))

    def loss_fn(p, batch):
        out = jmodel.apply({"params": p}, batch, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jlosses.deepearth_loss(out, batch, cfg, weights)

    grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return dict(cfg=cfg, jmodel=jmodel, params=params, step=step,
                grads=grads, port_cfg=config_from_json(
                    jcfg.config_to_json(cfg)))


def port_model(s, params=None):
    model = DeepEarthModel(s["port_cfg"],
                           generator=torch.Generator().manual_seed(0))
    load_flax_params(model, jax.tree_util.tree_map(
        np.asarray, s["params"] if params is None else params))
    return model


# --------------------------------------------------------------------------- #
# the train step against JAX
# --------------------------------------------------------------------------- #


def test_train_step_gradients_match_jax(setup):
    batch = numpy_batch(1)
    (loss, metrics), grads = setup["grads"](setup["params"], to_jax(batch))
    model = port_model(setup)
    model.train()
    out = model(to_torch(batch))
    t_loss, t_metrics = deepearth_loss(out, to_torch(batch), setup["port_cfg"],
                                       LossWeights(**WEIGHTS))
    t_loss.backward()
    rel_close(t_loss, loss, 1e-5)
    assert set(t_metrics) == set(metrics)
    for k, v in metrics.items():
        rel_close(t_metrics[k], v, 1e-5)
    ref = torch_named(grads)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(ref)
    for name, g in ref.items():
        tol = 1e-4 * np.abs(g).max() + 1e-7
        np.testing.assert_allclose(got[name], g, rtol=0, atol=tol,
                                   err_msg=name)


def _jax_run(setup, batches, n):
    tx = jtrainer.create_optimizer(setup["cfg"].optimizer)
    state = jtrainer.TrainState.create(apply_fn=setup["jmodel"].apply,
                                       params=setup["params"], tx=tx)
    states, metrics = [], []
    for batch in batches[:n]:
        state, m = setup["step"](state, to_jax(batch), jax.random.PRNGKey(0))
        states.append(state)
        metrics.append(m)
    return states, metrics


def _assert_params_close(model, jax_params, lrs):
    ref = torch_named(jax_params)
    tol = 2 * sum(lrs) + 1e-6
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0,
                                   atol=tol, err_msg=name)


def _assert_moments_close(opt, model, jax_opt_state):
    ref = FusedAdamW(list(model.parameters()), 0.0)
    load_flax_opt_state(ref, model, jax_opt_state)
    assert ref.count == opt.count
    for p in model.parameters():
        for key, want in ref.state[p].items():
            got = opt.state[p][key]
            tol = 1e-3 * want.abs().max().item() + 1e-12
            torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_three_steps_match_jax(setup):
    """loss and grad_norm per step, then params and optimizer state."""
    batches = [numpy_batch(10 + i) for i in range(3)]
    states, jmetrics_ = _jax_run(setup, batches, 3)
    model = port_model(setup)
    state = TrainState(model, create_optimizer(model.parameters(),
                                               setup["port_cfg"].optimizer))
    step = make_train_step(model, setup["port_cfg"], LossWeights(**WEIGHTS),
                           apply_masking=False)
    for batch, m in zip(batches, jmetrics_):
        state, tm = step(state, to_torch(batch), torch.Generator())
        rel_close(tm["loss/total"], m["loss/total"], 1e-5)
        rel_close(tm["grad_norm"], m["grad_norm"], 1e-4)
    assert state.step == 3 and state.optimizer.count == 3
    lrs = [state.optimizer.learning_rate(i) for i in range(3)]
    assert lrs == pytest.approx([0.0, PEAK_LR / 2, PEAK_LR])
    _assert_params_close(model, states[-1].params, lrs)
    _assert_moments_close(state.optimizer, model, states[-1].opt_state)


def test_jax_run_resumes_in_the_port(setup):
    """Params and FusedAdamWState after 2 JAX steps, loaded into the port,
    take the third step as JAX does."""
    batches = [numpy_batch(20 + i) for i in range(3)]
    states, _ = _jax_run(setup, batches, 3)
    model = port_model(setup, states[1].params)
    opt = create_optimizer(model.parameters(), setup["port_cfg"].optimizer)
    load_flax_opt_state(opt, model, states[1].opt_state)
    state = TrainState(model, opt, step=2)
    step = make_train_step(model, setup["port_cfg"], LossWeights(**WEIGHTS),
                           apply_masking=False)
    step(state, to_torch(batches[2]), torch.Generator())
    _assert_params_close(model, states[2].params, [PEAK_LR])
    _assert_moments_close(opt, model, states[2].opt_state)


def test_flax_params_from_model_inverts_the_load(setup):
    model = port_model(setup)
    got = dict(_leaves(flax_params_from_model(model)))
    ref = dict(_leaves(jax.tree_util.tree_map(np.asarray, setup["params"])))
    assert set(got) == set(ref)
    for path, value in ref.items():
        np.testing.assert_array_equal(got[path], value,
                                      err_msg="/".join(path))


def test_microbatches_equal_the_full_batch(setup):
    """k=2 microbatches give the full batch's update when every row counts
    (no masks) and no term couples rows (no contrastive losses)."""
    batch = to_torch(numpy_batch(30, masks=False))
    weights = LossWeights(contrastive=0.0)
    params = {}
    for k in (1, 2):
        model = port_model(setup)
        cfg = dataclasses.replace(setup["port_cfg"])
        cfg.optimizer = dataclasses.replace(cfg.optimizer, schedule="constant")
        state = TrainState(model, create_optimizer(model.parameters(),
                                                   cfg.optimizer))
        step = make_train_step(model, cfg, weights, apply_masking=False,
                               microbatch_steps=k)
        state, m = step(state, batch, torch.Generator())
        # the step leaves the gradient it applied in .grad
        # (mask_token gets none: no row is masked)
        params[k] = (m, {n: (p.detach().clone(), p.grad)
                         for n, p in model.named_parameters()
                         if p.grad is not None})
    (m1, p1), (m2, p2) = params[1], params[2]
    rel_close(m2["loss/total"], m1["loss/total"], 1e-5)
    rel_close(m2["grad_norm"], m1["grad_norm"], 1e-4)
    assert set(p1) == set(p2)
    for name, (w1, g1) in p1.items():
        w2, g2 = p2[name]
        torch.testing.assert_close(g2, g1, rtol=0,
                                   atol=1e-5 * g1.abs().max().item() + 1e-9)
        torch.testing.assert_close(w2, w1, rtol=0, atol=2 * PEAK_LR)
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(model, cfg, weights, microbatch_steps=3)(
            state, batch, torch.Generator())


def test_train_step_masks_with_the_generator(setup):
    """apply_masking draws the masks from the step's generator: the same
    seed gives the same step."""
    batch = to_torch(numpy_batch(31, masks=False))
    out = []
    for _ in range(2):
        model = port_model(setup)
        state = TrainState(model, create_optimizer(
            model.parameters(), setup["port_cfg"].optimizer))
        step = make_train_step(model, setup["port_cfg"])
        _, m = step(state, batch, torch.Generator().manual_seed(5))
        out.append(m)
    assert out[0]["loss/total"] == out[1]["loss/total"]
    assert np.isfinite(float(out[0]["loss/total"]))


def test_eval_step_matches_jax(setup):
    batch = numpy_batch(40)
    ref = jax.jit(jtrainer.make_eval_step(
        setup["jmodel"], setup["cfg"], jlosses.LossWeights(**WEIGHTS)))(
        jtrainer.TrainState.create(apply_fn=None, params=setup["params"],
                                   tx=optax.identity()), to_jax(batch))
    model = port_model(setup)
    state = TrainState(model, create_optimizer(model.parameters(),
                                               setup["port_cfg"].optimizer))
    step = make_eval_step(model, setup["port_cfg"], LossWeights(**WEIGHTS))
    got = step(state, to_torch(batch))
    assert set(got) == set(ref)
    for k in ref:
        rel_close(got[k], ref[k], 1e-5)


def test_eval_masks_are_deterministic_per_batch_index(setup):
    batch = to_torch(numpy_batch(41, masks=False, n=64))
    model = port_model(setup)
    state = TrainState(model, None)
    step = make_eval_step(model, setup["port_cfg"])
    a, b, c = step(state, batch, 3), step(state, batch, 3), step(state, batch, 4)
    assert a == b
    assert a["loss/total"] != c["loss/total"]
    assert not model.training


# --------------------------------------------------------------------------- #
# the optimizer against JAX's fused_adamw on identical gradients
# --------------------------------------------------------------------------- #

SHAPES = {"w": (128, 160), "e": (200, 128), "t": (3, 64, 2), "b": (160,),
          "s": (1, 1, 16)}


def _params_and_grads(seed, steps):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 0))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("variant", [
    dict(),
    dict(mu_dtype="bfloat16"),
    dict(second_moment="factored"),
    dict(second_moment="bfloat16"),
    dict(clip_norm=0.05),
], ids=["float32", "bf16_mu", "factored", "bf16_nu", "clip_active"])
def test_fused_adamw_matches_jax(variant):
    steps = 4
    params, grads = _params_and_grads(0, steps)
    mu = variant.get("mu_dtype")
    kw = dict(b1=0.9, b2=0.999, weight_decay=0.01,
              clip_norm=variant.get("clip_norm", 1e6),
              second_moment=variant.get("second_moment", "float32"))
    sched = optax.linear_schedule(1e-3, 5e-4, 10)
    tx = jopt.fused_adamw(sched, mu_dtype=jnp.bfloat16 if mu else None, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)

    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    opt = FusedAdamW(list(tp.values()), ttrainer.linear_schedule(1e-3, 5e-4,
                                                                 10),
                     mu_dtype=torch.bfloat16 if mu else None, **kw)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    assert opt.count == int(st.count) == steps
    for i, (k, p) in enumerate(tp.items()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        state = opt.state[p]
        assert state["mu"].dtype == (torch.bfloat16 if mu else torch.float32)
        np.testing.assert_allclose(state["mu"].float().numpy(),
                                   np.asarray(st.mu[k], np.float32),
                                   rtol=1e-5 if not mu else 1e-2, atol=1e-9)
        nu = st.nu[k]
        if isinstance(nu, jopt._FactoredNu):
            for ours, theirs in ((state["nu_row"], nu.row),
                                 (state["nu_col"], nu.col)):
                np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                           rtol=1e-5, atol=1e-12)
        else:
            np.testing.assert_allclose(state["nu"].float().numpy(),
                                       np.asarray(nu, np.float32),
                                       rtol=1e-5 if kw["second_moment"] ==
                                       "float32" else 1e-2, atol=1e-12)
    if kw["second_moment"] == "factored":
        assert "nu_row" in opt.state[tp["w"]] and "nu" in opt.state[tp["t"]]


def test_optimizer_state_bytes_matches_jax():
    params, _ = _params_and_grads(1, 0)
    tparams = [torch.from_numpy(v) for v in params.values()]
    for sm in ("float32", "bfloat16", "factored"):
        for mu in (None, "bfloat16"):
            ref = jopt.optimizer_state_bytes(
                {k: jnp.asarray(v) for k, v in params.items()}, sm,
                jnp.bfloat16 if mu else None)
            got = optimizer_state_bytes(tparams, sm,
                                        torch.bfloat16 if mu else None)
            assert got == ref


def test_multisteps_matches_optax():
    params, grads = _params_and_grads(2, 6)
    tx = optax.MultiSteps(jopt.fused_adamw(1e-3, weight_decay=0.01,
                                           clip_norm=1.0), every_k_schedule=3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    opt = MultiSteps(FusedAdamW(list(tp.values()), 1e-3, weight_decay=0.01,
                                clip_norm=1.0), 3)
    for i, g in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        assert opt.inner.count == (i + 1) // 3
    sd = opt.state_dict()
    again = MultiSteps(FusedAdamW(list(tp.values()), 1e-3), 3)
    again.load_state_dict(sd)
    assert again.gradient_step == 2 and again.inner.count == 2


@pytest.mark.parametrize("cfg", [
    dict(schedule="cosine"),
    dict(schedule="cosine", warmup_steps=0, total_steps=50),
    dict(schedule="onecycle", total_steps=1000),
    dict(schedule="constant"),
], ids=["cosine", "cosine_no_warmup", "onecycle", "constant"])
def test_schedules_match_optax(cfg):
    jc = jcfg.OptimizerConfig(learning_rate=3e-4, **cfg)
    if jc.schedule == "cosine":
        ref = optax.warmup_cosine_decay_schedule(
            0.0, jc.learning_rate, jc.warmup_steps,
            max(jc.total_steps, jc.warmup_steps + 1))
    elif jc.schedule == "onecycle":
        ref = optax.cosine_onecycle_schedule(jc.total_steps, jc.learning_rate)
    else:
        ref = lambda count: jc.learning_rate  # noqa: E731
    ours = ttrainer.create_schedule(config_from_json(jcfg.config_to_json(
        jcfg.DeepEarthConfig(optimizer=jc))).optimizer)
    for count in (0, 1, 7, 50, 99, 100, 101, 299, 300, 301, 999, 1000,
                  5000, 10000, 20000):
        want = float(ref(count))
        got = ours(count) if callable(ours) else ours
        # optax evaluates the schedule in float32
        assert got == pytest.approx(want, rel=1e-5, abs=1e-12), count


def test_create_optimizer_reads_the_config():
    p = [torch.nn.Parameter(torch.zeros(4, 4))]
    cfg = config_from_json(jcfg.config_to_json(jcfg.DeepEarthConfig(
        optimizer=jcfg.OptimizerConfig(grad_accum_steps=4,
                                       moment_dtype="bfloat16",
                                       second_moment="bfloat16"))))
    opt = create_optimizer(p, cfg.optimizer)
    assert isinstance(opt, MultiSteps) and opt.every_k == 4
    assert opt.inner.clip_norm == 1.0
    assert opt.inner.state[p[0]]["mu"].dtype == torch.bfloat16
    assert opt.inner.state[p[0]]["nu"].dtype == torch.bfloat16
    assert opt.inner.param_groups[0]["weight_decay"] == 0.01


# --------------------------------------------------------------------------- #
# masking, losses, metrics
# --------------------------------------------------------------------------- #


def test_mask_rates_and_shapes():
    g = torch.Generator().manual_seed(0)
    cfg = MaskingConfig(spatial_mask_prob=0.5, temporal_mask_prob=0.1,
                        modality_mask_prob=0.25)
    m = sample_masks(g, 20000, ("a", "b", "c"), cfg, {"a": 0.9, "b": 0.0})
    assert m["spatial_mask"].shape == (20000,)
    assert m["spatial_mask"].dtype == torch.bool
    hidden = {k: 1 - m[k].float().mean().item()
              for k in ("spatial_mask", "temporal_mask")}
    hidden.update({k: 1 - v.float().mean().item()
                   for k, v in m["modality_masks"].items()})
    # binomial standard error at n=20000 is <= 0.0036: allow 4 of them
    want = {"spatial_mask": 0.5, "temporal_mask": 0.1, "a": 0.9, "b": 0.0,
            "c": 0.25}
    for k, p in want.items():
        assert abs(hidden[k] - p) < 0.015, (k, hidden[k])
    mae = mae_patch_mask(g, 40, 500, 0.75)
    mlm = mlm_token_mask(g, 40, 500, 0.15)
    assert mae.shape == mlm.shape == (40, 500)
    assert abs(1 - mae.float().mean().item() - 0.75) < 0.015
    assert abs(1 - mlm.float().mean().item() - 0.15) < 0.015
    again = sample_masks(torch.Generator().manual_seed(0), 20000,
                         ("a", "b", "c"), cfg, {"a": 0.9, "b": 0.0})
    assert torch.equal(again["spatial_mask"], m["spatial_mask"])


def _loss_config():
    cfg = jcfg.DeepEarthConfig(hidden_dim=16, n_heads=2, n_layers=1)
    for m in (
        jcfg.ModalityConfig(name="species", encoding_type="learned_embedding",
                            input_type="categorical", vocab_size=11),
        jcfg.ModalityConfig(name="language", encoding_type="token_sequence",
                            vocab_size=13, loss_weight=0.5),
        jcfg.ModalityConfig(name="vision", input_dim=6, decode_sequence=True),
        jcfg.ModalityConfig(name="weather", input_dim=5),
        jcfg.ModalityConfig(name="ndvi", input_dim=4, n_tokens=2),
    ):
        cfg.add_modality(m)
    return cfg


def _loss_inputs(seed, n=12):
    """Synthetic outputs and a batch exercising every branch of the loss."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    outputs = {
        "reconstructions": {
            "spatial": rng.uniform(size=(n, 3)).astype(np.float32),
            "temporal": rng.uniform(size=(n, 1)).astype(np.float32),
            "species": f(n, 11), "language": f(n, 7, 13),
            "vision": f(n, 5, 6), "weather": f(n, 5), "ndvi": f(n, 4)},
        "modality_tokens": {k: f(n, t, 16) for k, t in (
            ("spacetime", 1), ("species", 1), ("language", 3), ("vision", 2),
            ("weather", 1), ("ndvi", 2))},
        "fused_representation": f(n, 16),
    }
    batch = {
        "xyzt": rng.uniform(size=(n, 4)).astype(np.float32),
        "modalities": {"species": rng.integers(0, 4, (n,)),
                       "language": rng.integers(0, 13, (n, 7)),
                       "vision": f(n, 5, 6), "weather": f(n, 5),
                       "ndvi": f(n, 3, 4)},
        "spatial_mask": rng.uniform(size=n) > 0.5,
        "temporal_mask": rng.uniform(size=n) > 0.5,
        "modality_masks": {k: rng.uniform(size=n) > 0.5 for k in (
            "species", "language", "vision", "weather", "ndvi")},
        "modality_patch_masks": {"language": rng.uniform(size=(n, 7)) > 0.3,
                                 "vision": rng.uniform(size=(n, 5)) > 0.5},
        "spatial_span_m": np.array([1000.0, 2000.0, 50.0], np.float32),
        "temporal_span_h": np.float32(24.0),
    }
    return outputs, batch


@pytest.mark.parametrize("weights", [
    dict(),
    dict(contrastive=0.0, species_contrastive=0.5, spatial=2.0),
    dict(contrastive=0.3, modality=0.7, temporal=0.0),
], ids=["default", "species_contrastive", "reweighted"])
@pytest.mark.parametrize("masked", [True, False], ids=["masks", "no_masks"])
def test_every_loss_branch_matches_jax(weights, masked):
    cfg = _loss_config()
    outputs, batch = _loss_inputs(len(weights) + masked)
    if not masked:
        for k in ("spatial_mask", "temporal_mask", "modality_masks",
                  "modality_patch_masks"):
            del batch[k]
    ref_total, ref = jlosses.deepearth_loss(
        to_jax(outputs), to_jax(batch), cfg, jlosses.LossWeights(**weights))
    total, got = deepearth_loss(to_torch(outputs), to_torch(batch),
                                config_from_json(jcfg.config_to_json(cfg)),
                                LossWeights(**weights))
    assert set(got) == set(ref)
    for key in ("loss/language", "acc/language", "loss/vision",
                "loss/weather", "loss/ndvi", "acc/species", "err/xyz_m",
                "err/t_h"):
        assert key in got
    for k in ref:
        rel_close(got[k], ref[k], 1e-5)
    rel_close(total, ref_total, 1e-5)


def test_contrastive_losses_match_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((10, 12)).astype(np.float32) for _ in "ab")
    labels = rng.integers(0, 3, (10,))
    labels[9] = 7  # an anchor without a positive
    rel_close(tlosses.clip_contrastive_loss(torch.from_numpy(a),
                                            torch.from_numpy(b), 0.07),
              jlosses.clip_contrastive_loss(jnp.asarray(a), jnp.asarray(b),
                                            0.07), 1e-5)
    rel_close(tlosses.species_contrastive_loss(torch.from_numpy(a),
                                               torch.from_numpy(labels), 0.07),
              jlosses.species_contrastive_loss(jnp.asarray(a),
                                               jnp.asarray(labels), 0.07),
              1e-5)


def test_moe_aux_with_intermediates_is_not_ported():
    cfg = _loss_config()
    outputs, batch = _loss_inputs(0)
    with pytest.raises(NotImplementedError, match="item 12"):
        deepearth_loss(to_torch(outputs), to_torch(batch),
                       config_from_json(jcfg.config_to_json(cfg)),
                       LossWeights(moe_aux=0.1),
                       intermediates={"moe_aux_loss": torch.ones(())})


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    p, t = (rng.uniform(size=(9, 3)).astype(np.float32) for _ in "pt")
    span = [1000.0, 500.0, 20.0]
    rel_close(coordinate_error_meters(torch.from_numpy(p), torch.from_numpy(t),
                                      span),
              jmetrics.coordinate_error_meters(jnp.asarray(p), jnp.asarray(t),
                                               span), 1e-6)
    rel_close(time_error_hours(torch.from_numpy(p[:, :1]),
                               torch.from_numpy(t[:, :1]), 24.0),
              jmetrics.time_error_hours(jnp.asarray(p[:, :1]),
                                        jnp.asarray(t[:, :1]), 24.0), 1e-6)
    acc, jacc = MetricAccumulator(), jmetrics.MetricAccumulator()
    for v in (1.0, 2.0, 4.5):
        m = {"loss/total": v, "loss/species": v / 2, "loss/spatial": v * 3}
        acc.update({k: torch.tensor(x) for k, x in m.items()})
        jacc.update({k: jnp.asarray(x) for k, x in m.items()})
    assert acc.result() == pytest.approx(jacc.result())
    line = format_epoch_line(7, acc.result(), {"obs/s": 1234.5})
    assert line == jmetrics.format_epoch_line(7, jacc.result(),
                                              {"obs/s": 1234.5})
    acc.reset()
    assert acc.result() == {}


# --------------------------------------------------------------------------- #
# the Trainer
# --------------------------------------------------------------------------- #


def _batches(n_batches, seed=50):
    return [to_torch(numpy_batch(seed + i, masks=False))
            for i in range(n_batches)]


def test_trainer_checkpoints_keep_three_and_the_best(setup, tmp_path):
    model = port_model(setup)
    trainer = Trainer(model, setup["port_cfg"], checkpoint_dir=str(tmp_path))
    state = trainer.init_state()
    state, _ = trainer.fit(state, iter(_batches(2)), num_steps=2, log_every=0)
    trainer.save(state, 2, metrics={"val_loss": 1.0})
    state, last = trainer.fit(state, iter(_batches(4)), num_steps=4,
                              log_every=2, save_every=1)
    assert "loss/total" in last
    # steps 1..4 of the second fit: 1 and 2 exist already (2 is the best)
    assert trainer.saved_steps() == [2, 3, 4]
    assert trainer.best_step() == 2
    trainer.save(state, 5)
    trainer.save(state, 6)
    assert trainer.saved_steps() == [2, 4, 5, 6]
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    count = state.optimizer.count

    fresh = port_model(setup)
    restorer = Trainer(fresh, setup["port_cfg"], checkpoint_dir=str(tmp_path))
    restored = restorer.restore(restorer.init_state())
    assert restored.step == 6 and restored.optimizer.count == count
    for n, p in fresh.named_parameters():
        assert torch.equal(p, saved[n]), n
    back = config_from_json(str(tmp_path / "config.json"))
    assert back.optimizer == setup["port_cfg"].optimizer


def test_trainer_fit_evaluate_and_sink(setup):
    class Sink:
        def __init__(self):
            self.logged = []

        def log(self, metrics, step):
            self.logged.append((step, metrics))

    model = port_model(setup)
    trainer = Trainer(model, setup["port_cfg"], seed=1)
    sink = Sink()
    state, _ = trainer.fit(trainer.init_state(), iter(_batches(4)), 4,
                           eval_batches=lambda: _batches(2, seed=90),
                           eval_every=2, log_every=2, metric_sink=sink)
    assert [s for s, _ in sink.logged] == [2, 4]
    assert "obs_per_s" in sink.logged[0][1]
    assert trainer.best_val < float("inf")
    val = trainer.evaluate(state, _batches(2, seed=90))
    assert np.isfinite(val["loss/total"])
    with pytest.raises(NotImplementedError, match="item 16"):
        trainer.fit(state, iter(_batches(1)), 1, echo_factor=2)


def test_partial_load_params():
    init = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    loaded = {"a": torch.ones(2), "b": torch.ones(4), "d": torch.ones(1)}
    merged, n_loaded, n_skipped = partial_load_params(init, loaded)
    assert (n_loaded, n_skipped) == (1, 1)
    assert torch.equal(merged["a"], torch.ones(2))
    assert torch.equal(merged["b"], torch.zeros(3))
    assert set(merged) == {"a", "b", "c"}
