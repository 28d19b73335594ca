"""The port's DistributedTrainer over 2 and 4 gloo ranks against the JAX
package's single-device train step, on the CPU.

One launch of 4 gloo ranks (``tests/torch_dist_worker.py``, scenario
``trainer``, legs in ``tests/torch_dist_legs.py``; rendezvous through a
``file://`` store under ``tmp_path``) trains the tiny flagship-shaped model
of ``dryrun_multichip`` (fp32, ``LossWeights(contrastive=0.01)``, masks in
the batch, ``apply_masking=False``) for 2 steps in each leg:

* dp over 4 ranks and over 2;
* dp x expert x model as (2, 2, 1) and (1, 2, 2), and over 2 ranks as
  expert 2 and as model 2, from a ``ragged`` dispatch config that the
  expert axis demotes to ``auto``;
* FSDP with ``fsdp_axes=('data', 'expert')`` on (2, 2, 1), and with
  ``('data',)`` over 2 ranks;
* FSDP plus ``microbatch_steps=2``, held against JAX's step with
  ``microbatch_steps=2``;
* pp over ('data' 2, 'pipe' 2) and over 'pipe' 2, the simulator
  pipelined in 2 stages;
* sp over ('data' 2, 'sequence' 2) and over 'sequence' 2, the vision
  encoder's MLA as ring attention;
* dp over 4 fed by each process's share (``step(local_of=8)``).

The 2-rank legs run two at once, one on each half of the world (the halves
of a (replica, ...) mesh), so each pair costs one leg's time.

Meanwhile the parent runs JAX's single-device step (``make_train_step``,
what JAX's DistributedTrainer runs on a 1-device mesh, with masking off)
from the same parameters, converted from the port's. The bars are JAX's
own (tests/test_distributed.py): the step-1 loss within 1e-5 relative, the
step-2 loss (after one update) within 1e-4. Also: each rank's stored
element count per leaf equal to the size of JAX's shard
(``NamedSharding.shard_shape``), sharded checkpoint save -> a trainer over
another model -> restore -> the next step equal to the uninterrupted one on
every rank, the learning-rate scaling, and device_prefetch(sharding=...).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_legs as L  # noqa: E402
from test_torch_ring_pipeline import collect, launch  # noqa: E402
from deepearth_tpu import configs as jcfg  # noqa: E402
from deepearth_tpu.models import DeepEarthModel as JaxModel  # noqa: E402
from deepearth_tpu.parallel import create_mesh as jax_mesh  # noqa: E402
from deepearth_tpu.parallel import param_spec as jax_param_spec  # noqa: E402
from deepearth_tpu.training import losses as jlosses  # noqa: E402
from deepearth_tpu.training import trainer as jtrainer  # noqa: E402
from deepearth_tpu_torch import config_to_json, flax_params_from_model  # noqa: E402
from deepearth_tpu_torch.convert import load_flax_opt_state  # noqa: E402
from deepearth_tpu_torch.parallel.mesh import module_leaf_layouts  # noqa: E402
from deepearth_tpu_torch.training.optimizers import FusedAdamW  # noqa: E402

torch.set_num_threads(2)


# the JAX reference of each leg: (pipelined, microbatch_steps)
REFS = ((False, 1), (False, 2), (True, 1))


def ref_of(leg):
    return (leg.startswith("pp"), 2 if leg == "fsdp_mb" else 1)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("trainer")
    procs = launch("trainer", 4, workdir)
    # JAX's side while the ranks train, its compiles side by side
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(REFS)) as pool:
        refs = dict(zip(REFS, pool.map(lambda r: jax_run(*r), REFS)))
    return collect(procs, workdir, timeout=300), refs


def jax_run(pipelined, microbatch_steps):
    """JAX's single-device steps from the port model's parameters (the
    pipelined simulator's, for the pp legs): each step's loss and gradient
    norm, and Adam's first moments after step 1 as {port name: array}."""
    cfg = L.make_cfg(pipeline_stages=2 if pipelined else 0)
    model = L.pipelined_model(cfg) if pipelined else L.make_model(cfg)
    jc = jcfg.config_from_json(config_to_json(cfg))
    jmodel = JaxModel(jc)
    step = jax.jit(jtrainer.make_train_step(
        jmodel, jc, jlosses.LossWeights(**L.LOSS_WEIGHTS),
        apply_masking=False, microbatch_steps=microbatch_steps))
    params = jax.tree_util.tree_map(jnp.asarray, flax_params_from_model(model))
    state = jtrainer.TrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=jtrainer.create_optimizer(jc.optimizer))
    batch = jax.tree_util.tree_map(jnp.asarray, L.numpy_batch())
    out = {"loss": [], "grad_norm": []}
    for _ in range(L.STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        out["loss"].append(float(m["loss/total"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if "mu" not in out:
            ref = FusedAdamW(list(model.parameters()), 0.0)
            load_flax_opt_state(ref, model, state.opt_state)
            out["mu"] = {n: ref.state[p]["mu"].numpy()
                         for n, p in model.named_parameters()}
    return out


def rel_close(a, b, rtol):
    assert abs(a - b) <= rtol * abs(b), (a, b, abs(a - b) / abs(b))


LEG_NAMES = list(L.LEGS) + ["dp4_local"] + list(L.LEGS_2)


def ranks_of(ranks, leg):
    """The ranks that ran ``leg``: all four, or the pair's half."""
    got = [r for r in ranks if leg in r]
    assert len(got) == (2 if leg in L.LEGS_2 else 4), leg
    return got


@pytest.mark.parametrize("leg", LEG_NAMES)
def test_leg_losses_match_jax(results, leg):
    ranks, refs = results
    ref = refs[ref_of(leg)]
    ran = ranks_of(ranks, leg)
    for r in ran:
        metrics = r[leg]["metrics"]
        rel_close(metrics[0]["loss/total"], ref["loss"][0], 1e-5)
        rel_close(metrics[1]["loss/total"], ref["loss"][1], 1e-4)
        # AdamW's first step is ~sign(g) whatever g's scale: the norm
        # catches a gradient summed or scaled wrong over the ranks
        rel_close(metrics[0]["grad_norm"], ref["grad_norm"][0], 1e-5)
        assert np.isfinite(metrics[1]["grad_norm"])
    # every rank reports the global metrics
    assert len({r[leg]["metrics"][1]["loss/total"] for r in ran}) == 1


@pytest.mark.parametrize("leg", LEG_NAMES)
def test_leg_first_moments_match_jax(results, leg):
    """Every rank's Adam first moments after step 1 (0.1 the clipped
    gradient, gathered whole) against JAX's, leaf by leaf, within 1e-4 of
    the leaf's largest entry (tests/test_torch_examples_jax.py's bar)."""
    ranks, refs = results
    want = refs[ref_of(leg)]["mu"]
    for r in ranks_of(ranks, leg):
        got = r[leg]["mu"]
        assert got.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)


def test_ragged_demoted_under_expert_axis(results):
    """Under an expert axis > 1 the ragged dispatch becomes 'auto' in the
    model's MoE layers; without one (model 2 alone) it stays, as JAX's
    trainer keeps it."""
    ranks, _ = results
    for leg, want in (("dp_ep", "auto"), ("ep_tp", "auto"), ("ep2", "auto"),
                      ("tp2", "ragged")):
        assert set(ranks_of(ranks, leg)[0][leg]["mode"].values()) == {want}


@pytest.mark.parametrize("leg,shape,axes,fsdp", [
    ("fsdp", (2, 2, 1), ("data", "expert", "model"), ("data", "expert")),
    ("ep_tp", (1, 2, 2), ("data", "expert", "model"), ()),
    ("pp", (2, 2), ("data", "pipe"), ()),
    ("fsdp2", (2,), ("data",), ("data",)),
    ("pp2", (2,), ("pipe",), ()),
])
def test_local_numels_match_jax_shards(results, leg, shape, axes, fsdp):
    """Each rank stores, per parameter and per Adam moment, the element
    count of JAX's shard of that leaf under the same mesh and rules."""
    ranks = ranks_of(results[0], leg)
    pp = leg.startswith("pp")
    cfg = L.make_cfg(pipeline_stages=2 if pp else 0)
    model = L.pipelined_model(cfg) if pp else L.make_model(cfg)
    mesh = jax_mesh(jax.devices()[:int(np.prod(shape))], mesh_shape=shape,
                    axis_names=axes)
    sharded = 0
    for name, (path, fshape, _) in module_leaf_layouts(model).items():
        spec = jax_param_spec(path, fshape, mesh, fsdp)
        want = int(np.prod(jax.sharding.NamedSharding(mesh, spec)
                           .shard_shape(fshape)))
        sharded += want < int(np.prod(fshape))
        for r in ranks:
            assert r[leg]["numels"][f"params/{name}"] == want, (name, spec)
            assert r[leg]["numels"][f"opt/{name}/mu"] == want, name
    assert sharded > 0


def test_sharded_checkpoint_resume(results):
    ranks, _ = results
    for r in ranks:
        c = r["checkpoint"]
        assert c["restored_step"] == 1 and c["saved"] == [1]
        assert c["params_equal"]  # every parameter back, bit for bit
        assert c["resumed"] == c["straight"]
    assert len({r["checkpoint"]["resumed"] for r in ranks}) == 1


def test_lr_scaling(results):
    ranks, _ = results
    lr = ranks[0]["lr"]
    assert lr["scaled"] == lr["base"] * 4 == lr["again"]
    assert lr["caller"] == lr["base"]


def test_device_prefetch_places_each_ranks_rows(results):
    ranks, _ = results
    for r in ranks:
        got = r["prefetch"]
        d = got["data"]
        for s in range(3):
            want = L.numpy_batch(s)
            np.testing.assert_array_equal(got["xyzt"][s],
                                          want["xyzt"][d * 4:(d + 1) * 4])
            np.testing.assert_array_equal(
                got["vision"][s], want["modalities"]["vision"][d * 4:
                                                               (d + 1) * 4])
