"""The port's examples against the JAX package's ``examples/``, on the CPU.

The first steps of quick_test and density_field are held against the JAX
examples' from the same parameters (the JAX model's ``init`` through
``convert.load_flax_params``) and the same batches (the numpy synthetic
generator, its masks passed in the batch, dropout off; numpy-made xyzt for
the density field): each step's loss within 1e-4 relative (the same fp32
arithmetic summed in another order); the parameters after the steps within
1e-4 of each leaf's largest entry but for at most one entry or 0.1% of a
leaf's entries, each within 2 lr a step (:func:`assert_params_close`: Adam
carries an entry whose gradient cancels to rounding noise by about lr
either way); both examples' first moments, which hold the gradients,
within 1e-4 of each leaf's largest entry, every entry
(:func:`assert_first_moments_close`).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax import linen as nn

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu.models import Grid4DEncoder as JaxGrid4DEncoder
from deepearth_tpu.training import losses as jlosses
from deepearth_tpu.training import trainer as jtrainer
from deepearth_tpu_torch.configs import config_to_json
from deepearth_tpu_torch.convert import (_leaves, _torch_name,
                                         load_flax_opt_state,
                                         load_flax_params)
from deepearth_tpu_torch.data import (SyntheticConfig,
                                      SyntheticEarthDataGenerator)
from deepearth_tpu_torch.examples import density_field, quick_test
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.training import (FusedAdamW, TrainState,
                                          create_optimizer, make_train_step)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def torch_named(tree):
    """A flax-named tree as {port parameter name: numpy array in the port's
    layout}."""
    return {_torch_name(path): (v.T if path[-1] == "kernel" else v)
            for path, v in _leaves(jax.tree_util.tree_map(np.asarray, tree))}


def assert_params_close(model, jax_params, lr_sum):
    """Each leaf within 1e-4 of its largest entry, but for at most one entry
    or 0.1% of its entries, each within 2 * lr_sum: Adam moves an entry by
    about lr a step whatever its gradient's size, so an entry whose
    gradient is a sum that cancels to near rounding noise moves by an
    amount the summation order decides (up to 2 lr apart when its sign
    flips)."""
    ref = torch_named(jax_params)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert got.keys() == ref.keys()
    for name, want in ref.items():
        diff = np.abs(got[name] - want)
        off = diff > 1e-4 * np.abs(want).max() + 1e-12
        assert off.sum() <= max(1, 1e-3 * off.size), (name, int(off.sum()))
        assert diff.max() <= 2 * lr_sum, (name, float(diff.max()))


def assert_first_moments_close(names, got, want):
    """Each first moment (``got`` in ``names``' order) within 1e-4 of its
    leaf's largest entry in ``want`` ({port parameter name: array}), every
    entry: the moments hold each step's gradients, so a fault in a few
    rows' gradients shows here even where Adam's step hides it."""
    assert len(names) == len(got) and set(names) == want.keys()
    for name, m in zip(names, got):
        np.testing.assert_allclose(m.float().numpy(), want[name], rtol=0,
                                   atol=1e-4 * np.abs(want[name]).max(),
                                   err_msg=name)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def quick_batches(n):
    """The example's synthetic batches at B=16 with numpy masks."""
    rng = np.random.default_rng(5)
    gen = SyntheticEarthDataGenerator(SyntheticConfig())
    out = []
    for batch in gen.batch_iterator(16, modalities=("species", "weather"),
                                    steps=n):
        batch["spatial_mask"] = rng.uniform(size=16) > 0.3
        batch["temporal_mask"] = rng.uniform(size=16) > 0.3
        batch["modality_masks"] = {m: rng.uniform(size=16) > 0.4
                                   for m in ("species", "weather")}
        out.append(batch)
    return out


def test_quick_test_first_steps_match_jax():
    """examples/quick_test.py's model, optimizer and loss weights, 3 train
    steps from the JAX model's parameters in fp32."""
    cfg = jcfg.tiny_config(compute_dtype=jnp.float32)
    cfg.add_modality(jcfg.ModalityConfig(name="weather", input_dim=5,
                                         n_tokens=1, encoder_layers=1,
                                         encoder_heads=2))
    cfg.optimizer.learning_rate = 3e-3
    cfg.optimizer.warmup_steps = 5
    cfg.optimizer.total_steps = 60
    port_cfg = quick_test.example_config()
    port_cfg.compute_dtype = torch.float32
    assert config_to_json(port_cfg) == jcfg.config_to_json(cfg)
    batches = quick_batches(3)
    jmodel = JaxModel(cfg)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batches[0])
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)["params"]
    step = jax.jit(jtrainer.make_train_step(
        jmodel, cfg, jlosses.LossWeights(contrastive=0.01),
        apply_masking=False))
    state = jtrainer.TrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=jtrainer.create_optimizer(cfg.optimizer))
    model = DeepEarthModel(port_cfg,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    tstep = make_train_step(model, port_cfg, quick_test.LOSS_WEIGHTS,
                            apply_masking=False)
    tstate = TrainState(model, create_optimizer(model.parameters(),
                                                port_cfg.optimizer))
    gen = torch.Generator().manual_seed(0)
    for batch in batches:
        state, m = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                        jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, to_torch(batch), gen)
        want, got = float(m["loss/total"]), float(tm["loss/total"])
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    # lr 0, 0.6e-3, 1.2e-3 over the warmup
    assert_params_close(model, state.params, 1.8e-3)
    ref = FusedAdamW(list(model.parameters()), 0.0)
    load_flax_opt_state(ref, model, state.opt_state)
    assert ref.count == tstate.optimizer.count == 3
    names = [n for n, _ in model.named_parameters()]
    assert_first_moments_close(
        names, [tstate.optimizer.state[p]["mu"] for p in model.parameters()],
        {n: ref.state[p]["mu"].float().numpy()
         for n, p in model.named_parameters()})


class JaxDensityField(nn.Module):
    """examples/density_field.py's DensityField (defined there inside
    main)."""

    @nn.compact
    def __call__(self, xyzt):
        h = JaxGrid4DEncoder(
            jcfg.Grid4DConfig(n_spatial_levels=12, n_temporal_levels=6,
                              hash_table_size=2 ** 16),
            hidden_dim=64, name="grid4d")(xyzt)
        h = nn.gelu(nn.Dense(64)(h))
        return nn.softplus(nn.Dense(1)(h))


def jax_density_example():
    spec = importlib.util.spec_from_file_location(
        "jax_density_field", os.path.join(REPO, "examples",
                                          "density_field.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_density_field_first_steps_match_jax():
    """5 Adam steps at B=4096 on numpy-made points from the JAX example's
    initial parameters, its loss and optax.adam(3e-3)."""
    true_density = jax_density_example().true_density
    model = JaxDensityField()
    rng = np.random.default_rng(11)
    xyzts = [rng.uniform(0, 1, (density_field.BATCH, 4)).astype(np.float32)
             for _ in range(5)]
    params = model.init(jax.random.PRNGKey(1),
                        jax.random.uniform(jax.random.PRNGKey(0), (1024, 4)))
    tx = optax.adam(density_field.LR)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, xyzt):
        def loss_fn(p):
            return jnp.mean((model.apply(p, xyzt) - true_density(xyzt)) ** 2)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    field = density_field.DensityField(torch.Generator(), device="cpu")
    load_flax_params(field, jax.tree_util.tree_map(np.asarray,
                                                   params["params"]))
    ttx = density_field.Adam(density_field.LR)
    tstate = ttx.init(tuple(field.parameters()))
    for xyzt in xyzts:
        params, opt_state, loss = step(params, opt_state, jnp.asarray(xyzt))
        tloss, tstate = density_field.train_step(field, ttx, tstate,
                                                 torch.from_numpy(xyzt))
        assert abs(float(tloss) - float(loss)) <= 1e-4 * float(loss), (
            float(tloss), float(loss))
    assert_params_close(field, params["params"], 5 * density_field.LR)
    assert_first_moments_close([n for n, _ in field.named_parameters()],
                               tstate.mu,
                               torch_named(opt_state[0].mu["params"]))
