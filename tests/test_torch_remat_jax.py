"""Activation checkpointing in the port against JAX's ``nn.remat``, on the
CPU: the tiny flagship of tests/test_torch_remat.py (universal dim 64, 2
fusion layers, a 2-layer MLA + MoE simulator, MoE-projected vision and
language encoders) with ``fusion.remat`` and both modalities'
``encoder_remat`` under each policy, one forward and backward from one set
of parameters (the port's, handed to JAX as a flax tree), dropout 0, fp32.
Tolerances as tests/test_torch_flagship_training.py states them: the loss
and the aux term within 1e-5 relative, each gradient leaf within 1e-4 of
its largest magnitude plus 1e-7. One JAX compile a policy (~12-17 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import DeepEarthModel as JaxModel
from deepearth_tpu.training import losses as jlosses
from deepearth_tpu_torch import config_from_json, flax_params_from_model
from deepearth_tpu_torch.convert import _leaves, _torch_name
from test_torch_remat import (
    MOE_AUX,
    POLICIES,
    flagship_config,
    numpy_batch,
    port_loss,
    port_model,
    to_torch,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_remat(policy):
    """One forward and backward of the tiny flagship with remat on every
    stack, against JAX's ``nn.remat`` under the same policy."""
    jc = flagship_config(jcfg, True, policy)
    model = port_model(config_from_json(jcfg.config_to_json(jc)))
    assert model.fusion.remat and model.simulator.remat
    assert model.encoder_vision.transformer.remat_policy == policy
    params = jax.tree_util.tree_map(jnp.asarray, flax_params_from_model(model))
    batch = numpy_batch(1)
    jmodel = JaxModel(jc)

    def loss_fn(p, b):
        out, mut = jmodel.apply({"params": p}, b, deterministic=False,
                                rngs={"dropout": jax.random.PRNGKey(0)},
                                mutable=["intermediates"])
        return jlosses.deepearth_loss(
            out, b, jc, jlosses.LossWeights(moe_aux=MOE_AUX),
            mut.get("intermediates"))

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jax.tree_util.tree_map(jnp.asarray,
                                                              batch))
    model.train()
    loss, metrics = port_loss(model, model.config, to_torch(batch),
                              torch.Generator())
    loss.backward()
    for key in ("loss/total", "loss/moe_aux"):
        ref = float(jmetrics[key])
        assert abs(metrics[key].item() - ref) <= 1e-5 * abs(ref), key
    grads = dict(model.named_parameters())
    seen = set()
    for path, g in _leaves(jax.tree_util.tree_map(np.asarray, jgrads)):
        name = _torch_name(path)
        p = grads[name]
        got = (np.zeros(p.shape, np.float32) if p.grad is None
               else p.grad.numpy())
        ref = g.T if path[-1] == "kernel" else g
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-7,
                                   err_msg=name)
        seen.add(name)
    assert seen == set(grads)
