"""The training recipes against the JAX package's, on the CPU: 3 steps of
``make_bidirectional_step``, ``make_autoencoder_step`` and of a clipped
``create_vision_decoder_finetune_state``, each against optax through the
JAX recipe from one set of parameters (JAX's ``init``, loaded into the
port), on numpy batches from a seed, fp32. The parameters after each step
within 1e-5; the reported losses within 1e-5 relative. The finetune state
clips at a norm the gradients pass, so the clip scale is the trainable
leaves' norm alone (``optax.multi_transform``'s ``set_to_zero`` leaves are
out of it), and its frozen leaves stay exactly as they were.

``full_vision_output`` trains only in the port: JAX's recipe compares the
(B, T, H, W, C) grid with the unreshaped (B, S, C) patches, which does not
broadcast (pinned below). The port lays the patches out as the grid; its
3 steps are held against ``jax.value_and_grad`` of that loss with JAX's
optimizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import bidirectional as jbi
from deepearth_tpu.training import recipes as jrecipes
from deepearth_tpu.training import trainer as jtrainer
from deepearth_tpu_torch import configs as tcfg
from deepearth_tpu_torch import load_flax_params
from deepearth_tpu_torch.convert import _leaves, _torch_name
from deepearth_tpu_torch.models import (
    BidirectionalReconstructor,
    MultimodalAutoencoder,
)
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.training import (
    TrainState,
    create_optimizer,
    create_vision_decoder_finetune_state,
    frozen_optimizer,
    make_autoencoder_step,
    make_bidirectional_step,
)

torch.set_num_threads(2)

B, STEPS, TOL = 8, 3, 1e-5
DIMS = dict(vision_dim=24, language_dim=40, hidden_dim=16)
GRID = (2, 2, 3)


def opt_cfgs(**kw):
    """The same optimizer in both packages: the cosine schedule without
    warmup from 1e-3 (every step moves the parameters), weight decay."""
    kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10,
              weight_decay=0.01, **kw)
    return jcfg.OptimizerConfig(**kw), tcfg.OptimizerConfig(**kw)


def batch(seed, patches=12):
    rng = np.random.default_rng(seed)
    return {"vision": rng.standard_normal((B, patches, 24)).astype(np.float32),
            "language": rng.standard_normal((B, 40)).astype(np.float32),
            "species": np.array([0, 1, 1, 2, 3, 3, 3, 4], np.int32)}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def port_of(jmod, tmod, sample):
    params = jmod.init(jax.random.PRNGKey(0), **{
        k: jnp.asarray(v) for k, v in sample.items()})["params"]
    load_flax_params(tmod, jax.tree_util.tree_map(np.asarray, params))
    return params


def assert_params(model, jparams, what):
    got = dict(model.named_parameters())
    for path, v in _leaves(jax.tree_util.tree_map(np.asarray, jparams)):
        ref = v.T if path[-1] == "kernel" else v
        np.testing.assert_allclose(got[_torch_name(path)].detach().numpy(),
                                   ref, rtol=0, atol=TOL,
                                   err_msg=f"{what}: {'/'.join(path)}")


def assert_metrics(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = float(v)
        assert abs(got[k].item() - v) <= TOL * max(abs(v), 1e-6), (k, got[k],
                                                                    v)


def run_both(jmod, tmod, jstep, tstep, jstate, tstate, patches=12):
    for i in range(STEPS):
        b = batch(20 + i, patches)
        jstate, jm = jstep(jstate, to_jax(b), jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, to_torch(b), torch.Generator())
        assert_metrics(tm, jm)
        assert_params(tmod, jstate.params, f"step {i + 1}")
    assert tstate.step == STEPS
    return jstate, tstate


def test_bidirectional_step_matches_jax():
    jmod = jbi.BidirectionalReconstructor(**DIMS, vision_grid=GRID)
    tmod = BidirectionalReconstructor(**DIMS, vision_grid=GRID,
                                      init=Init(torch.Generator(), "cpu"))
    params = port_of(jmod, tmod, {k: batch(0)[k]
                                  for k in ("vision", "language")})
    jc, tc = opt_cfgs()
    jstate = jtrainer.TrainState.create(
        apply_fn=jmod.apply, params=params,
        tx=jtrainer.create_optimizer(jc))
    run_both(jmod, tmod, jax.jit(jrecipes.make_bidirectional_step(jmod)),
             make_bidirectional_step(tmod), jstate,
             TrainState(tmod, create_optimizer(tmod.parameters(), tc)))


def test_autoencoder_step_matches_jax():
    kw = dict(vision_dim=24, language_dim=40, bottleneck_dim=8, n_species=5,
              hidden_dim=16)
    jmod = jbi.MultimodalAutoencoder(**kw)
    tmod = MultimodalAutoencoder(**kw, init=Init(torch.Generator(), "cpu"))
    params = port_of(jmod, tmod, {k: batch(0)[k]
                                  for k in ("vision", "language")})
    jc, tc = opt_cfgs()
    jstate = jtrainer.TrainState.create(
        apply_fn=jmod.apply, params=params,
        tx=jtrainer.create_optimizer(jc))
    _, tstate = run_both(
        jmod, tmod, jax.jit(jrecipes.make_autoencoder_step(jmod)),
        make_autoencoder_step(tmod), jstate,
        TrainState(tmod, create_optimizer(tmod.parameters(), tc)))


def test_clipped_vision_decoder_finetune_matches_jax():
    """grad_clip_norm 1e-3: every step clips. The frozen leaves stay
    exactly equal; the trainable ones follow optax."""
    jmod = jbi.BidirectionalReconstructor(**DIMS, vision_grid=GRID)
    tmod = BidirectionalReconstructor(**DIMS, vision_grid=GRID,
                                      init=Init(torch.Generator(), "cpu"))
    params = port_of(jmod, tmod, {k: batch(0)[k]
                                  for k in ("vision", "language")})
    jc, tc = opt_cfgs(grad_clip_norm=1e-3)
    start = {n: p.detach().clone() for n, p in tmod.named_parameters()}
    tstate = create_vision_decoder_finetune_state(tmod, tc)
    trained = {id(p) for p in tstate.optimizer.params}
    names = {n for n, p in tmod.named_parameters() if id(p) in trained}
    assert names and all(n.startswith("language_to_vision.") for n in names)
    assert len(names) < len(start)
    jstate = jrecipes.create_vision_decoder_finetune_state(jmod, params, jc)
    tstep = make_bidirectional_step(tmod)
    jstep = jax.jit(jrecipes.make_bidirectional_step(jmod))
    for i in range(STEPS):
        b = batch(30 + i)
        # the clip must bite: the trainable leaves' gradient norm
        g = jax.grad(lambda p: jnp.mean((jmod.apply(
            {"params": p}, language=jnp.asarray(b["language"]))[
                "vision_from_language"] - b["vision"].mean(1)) ** 2))(
            jstate.params)
        assert float(optax.global_norm(g["language_to_vision"])) > 1e-2
        jstate, jm = jstep(jstate, to_jax(b), jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, to_torch(b), torch.Generator())
        assert_metrics(tm, jm)
        assert_params(tmod, jstate.params, f"step {i + 1}")
    for n, p in tmod.named_parameters():
        if n not in names:
            assert torch.equal(p, start[n]), n
        else:
            assert not torch.equal(p, start[n]), n


def test_frozen_optimizer_reads_flax_paths():
    tmod = BidirectionalReconstructor(**DIMS, vision_grid=GRID,
                                      full_vision_output=True,
                                      init=Init(torch.Generator(), "cpu"))
    seen = []
    frozen_optimizer(tcfg.OptimizerConfig(), tmod,
                     lambda path: seen.append(path) or True)
    assert "language_to_vision_full/cond_proj/kernel" in seen
    assert "vision_to_language/ln0/scale" in seen
    assert "language_to_vision_full/patch_queries" in seen
    with pytest.raises(ValueError):
        frozen_optimizer(tcfg.OptimizerConfig(), tmod, lambda path: False)


def test_full_grid_step_trains_where_jax_cannot():
    jmod = jbi.BidirectionalReconstructor(**DIMS, vision_grid=GRID,
                                          full_vision_output=True)
    tmod = BidirectionalReconstructor(**DIMS, vision_grid=GRID,
                                      full_vision_output=True,
                                      init=Init(torch.Generator(), "cpu"))
    params = port_of(jmod, tmod, {k: batch(0)[k]
                                  for k in ("vision", "language")})
    jc, tc = opt_cfgs()
    tx = jtrainer.create_optimizer(jc)
    jstate = jtrainer.TrainState.create(apply_fn=jmod.apply, params=params,
                                        tx=tx)
    with pytest.raises(ValueError, match="broadcast"):
        jrecipes.make_bidirectional_step(jmod)(
            jstate, to_jax(batch(1)), jax.random.PRNGKey(0))

    @jax.jit
    def jstep(state, b, rng):
        def loss_fn(p):
            out = jmod.apply({"params": p}, vision=b["vision"],
                             language=b["language"])
            recon = out["vision_from_language"]
            l_v = jnp.mean((recon - b["vision"].reshape(recon.shape)) ** 2)
            l_l = jnp.mean((out["language_from_vision"] - b["language"]) ** 2)
            total = l_v + l_l
            return total, {"loss/vision_from_language": l_v,
                           "loss/language_from_vision": l_l,
                           "loss/total": total}
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return state.apply_gradients(grads=grads), metrics

    run_both(jmod, tmod, jstep, make_bidirectional_step(tmod), jstate,
             TrainState(tmod, create_optimizer(tmod.parameters(), tc)))
