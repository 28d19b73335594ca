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
* dp over 4 fed by each process's share (``step(local_of=8)``);
* FSDP with the fusion layers and the simulator's blocks checkpointed
  (remat 'dots'), held against JAX's step without remat;
* the capacity routes under the expert split on (2, 2, 1):
  ``dispatch_mode='scatter'`` with ``fsdp_axes=('data', 'expert')`` at
  capacity_factor 2 (no drops: held against JAX's drop-free step) and 0.5
  (drops), and ``'dense'`` (one-hot) at 0.5, both held against JAX's
  scatter step at 0.5 (its slots and drops are JAX's dense step's too).

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

The split of the step (each unit's blocks gathered only while it runs, the
gradients back to the blocks, the experts over 'expert'): in every leg
that gathers, a rank never holds more whole bytes than twice its largest
unit's, and less than the whole model's; the tensors made from them alone
(casts, concatenations) at most one unit's bytes at once; and autograd
keeps, of what does not depend on the batch, less than the smallest unit's
bytes (measured apart from the counters, over two forwards). Each
parameter's gradient has its block's shape; under 'expert' 2 each MoE
layer runs its 2 of 4 experts, and all 3 of 3 (their weights split over
'expert' on another dim by FSDP); the 'expert' ranks' gradients of a leaf
they hold alike are equal, and the whole gradients are JAX's (none summed
twice over 'expert'). The model runs only inside the trainer's step. A leg
with fp32 parameters computed in bf16 is held against the port's own
single-process step.
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


# the JAX reference of each leg: (pipelined, microbatch_steps, the MoE's
# dispatch mode, capacity factor and expert count). JAX's 'dense' and
# 'scatter' keep the same slots and drop the same assignments, so the
# port's capacity legs with drops are held to JAX's scatter step; at
# capacity_factor 2 no assignment is dropped (C = 40 slots, 40 tokens), and
# that leg is held to JAX's drop-free step
REFS = ((False, 1, "auto", 2.0, 4), (False, 2, "auto", 2.0, 4),
        (True, 1, "auto", 2.0, 4), (False, 1, "scatter", 0.5, 4),
        (False, 1, "auto", 2.0, 3))


def ref_of(leg):
    cfg = {**L.LEGS, **L.LEGS_2}.get(leg, (None,) * 4)[3] or {}
    if cfg.get("capacity_factor", 2.0) < 2.0:
        return (False, 1, "scatter", cfg["capacity_factor"], 4)
    return (leg.startswith("pp"), 2 if leg == "fsdp_mb" else 1, "auto", 2.0,
            cfg.get("n_experts", 4))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("trainer")
    procs = launch("trainer", 4, workdir)
    # JAX's side while the ranks train, its compiles side by side
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(REFS)) as pool:
        refs = dict(zip(REFS, pool.map(lambda r: jax_run(*r), REFS)))
    refs.update({leg: port_run(leg) for leg in L.PORT_REF_LEGS})
    return collect(procs, workdir, timeout=300), refs


def port_run(leg):
    """The port's single-process step on ``leg``'s config (make_train_step
    over the whole batch): each step's loss and gradient norm."""
    from deepearth_tpu_torch.data.batches import map_leaves
    from deepearth_tpu_torch.training import LossWeights
    from deepearth_tpu_torch.training.trainer import (
        TrainState, create_optimizer, make_train_step)

    cfg = L.make_cfg(**L.LEGS[leg][3])
    model = L.make_model(cfg)
    step = make_train_step(model, cfg, LossWeights(**L.LOSS_WEIGHTS),
                           apply_masking=False)
    state = TrainState(model, create_optimizer(model.parameters(),
                                               cfg.optimizer))
    batch = map_leaves(lambda x: torch.as_tensor(np.asarray(x)),
                       L.numpy_batch())
    gen = torch.Generator().manual_seed(0)
    out = {"loss": [], "grad_norm": []}
    for _ in range(L.STEPS):
        state, m = step(state, batch, gen)
        out["loss"].append(float(m["loss/total"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    return out


def jax_run(pipelined, microbatch_steps, dispatch_mode, capacity_factor,
            n_experts):
    """JAX's single-device steps from the port model's parameters (the
    pipelined simulator's, for the pp legs): each step's loss and gradient
    norm, Adam's first moments after step 1 as {port name: array}, and the
    step-1 gradients they hold (as ``grads``: mu / (1 - b1) / the clip
    scale)."""
    cfg = L.make_cfg(pipeline_stages=2 if pipelined else 0,
                     dispatch_mode=dispatch_mode,
                     capacity_factor=capacity_factor, n_experts=n_experts)
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
            clip = cfg.optimizer.grad_clip_norm
            scale = (1.0 if clip is None
                     else min(1.0, clip / out["grad_norm"][0]))
            out["grads"] = {n: mu / ((1.0 - cfg.optimizer.b1) * scale)
                            for n, mu in out["mu"].items()}
    return out


def rel_close(a, b, rtol):
    assert abs(a - b) <= rtol * abs(b), (a, b, abs(a - b) / abs(b))


LEG_NAMES = ([n for n in L.LEGS if n not in L.PORT_REF_LEGS] + ["dp4_local"]
             + list(L.LEGS_2))


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


@pytest.mark.parametrize("leg", L.PORT_REF_LEGS)
def test_leg_matches_single_process_step(results, leg):
    """fp32 parameters computed in bf16, split: every rank's losses and
    gradient norms against the port's single-process step on the same
    config, within the bf16 train step's bars of chip_smoke.py's TRAIN_TOL
    (2e-3 on the loss, 2e-2 on the norm): each rank rounds its rows' bf16
    gradients before they are summed, the single process the whole
    batch's (bf16 against fp32 moves this step's norm by 1.2%)."""
    ranks, refs = results
    ref = refs[leg]
    for r in ranks_of(ranks, leg):
        for i, m in enumerate(r[leg]["metrics"]):
            rel_close(m["loss/total"], ref["loss"][i], 2e-3)
            rel_close(m["grad_norm"], ref["grad_norm"][i], 2e-2)


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


# -- the split of the step ---------------------------------------------------- #

# the legs whose ranks gather some parameter for its unit
GATHERING = ["fsdp", "fsdp_mb", "ep_tp", "pp", "scatter", "scatter_drop",
             "fsdp_remat", "fsdp_bf16", "fsdp_e3", "fsdp2", "tp2", "pp2"]
# the legs with an 'expert' axis of 2 (E = 4 in the tiny config)
EXPERT_LEGS = ["dp_ep", "ep_tp", "fsdp", "fsdp_mb", "scatter", "scatter_drop",
               "dense", "fsdp_remat", "ep2"]


@pytest.mark.parametrize("leg", GATHERING)
def test_whole_bytes_held_at_once(results, leg):
    """The gather's counters: in each step a rank holds at most twice its
    largest unit's whole bytes at once and, where more than one unit
    gathers, less than the whole of what it gathers (all its units
    together: what a step that gathered the whole model held; a pp leg
    gathers its pipelined stack alone); of tensors made from them alone
    (casts, concatenations), at most its largest unit's bytes. Apart from
    the counters: of the tensors autograd keeps from a forward, those that
    do not depend on the batch (the parameters' own storage aside) come to
    less than the smallest unit's bytes, so no unit's whole weights, nor a
    cast or a concatenation of them, stay for the backward."""
    for r in ranks_of(results[0], leg):
        units = r[leg]["unit_bytes"]
        largest, whole = max(units.values()), sum(units.values())
        for peak, made in zip(r[leg]["gathered_peak"], r[leg]["made_peak"]):
            assert 0 < peak <= 2 * largest, (peak, largest, units)
            assert made <= largest, (made, largest)
            if len(units) > 1:
                assert peak < whole, (peak, whole)
        kept = r[leg]["kept"]
        assert kept["batch_free"] < min(units.values()), kept


@pytest.mark.parametrize("leg", ["fsdp", "pp", "fsdp_e3", "fsdp2"])
def test_model_runs_only_inside_the_step(results, leg):
    """After init_state the model's parameters are the rank's blocks: a
    forward outside the trainer's step raises, a second init_state raises,
    and full_params() gives every parameter at its whole shape."""
    for r in ranks_of(results[0], leg):
        assert r[leg]["guards"] == {"forward": True, "init_state": True,
                                    "full_params": True}


def test_experts_whole_where_the_axis_does_not_divide(results):
    """3 experts over 'expert' 2: every rank's MoE layers run all 3, and
    their weights are stored split over 'expert' on another dim (FSDP),
    gathered whole for the layer."""
    cfg = L.make_cfg(n_experts=3)
    whole = {n: tuple(p.shape)
             for n, p in L.make_model(cfg).named_parameters()}
    for r in ranks_of(results[0], "fsdp_e3"):
        got = r["fsdp_e3"]
        assert set(got["experts"].values()) == {(0, 3)}
        split = [n for n, s in got["block_shapes"].items()
                 if n.endswith((".w_gate", ".w_up", ".w_down"))
                 and s[0] == 3 and s != whole[n]]
        assert len(split) == 3 * len(got["experts"]), split


@pytest.mark.parametrize("leg", GATHERING + ["dp_ep"])
def test_gradients_have_block_shapes(results, leg):
    """After the backward each parameter's gradient is its block's shape:
    the stored element count, below the whole leaf's where it is split."""
    cfg = L.make_cfg(**{**L.LEGS, **L.LEGS_2}[leg][3])
    model = (L.pipelined_model(cfg) if leg.startswith("pp")
             else L.make_model(cfg))
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    split = 0
    for r in ranks_of(results[0], leg):
        got = r[leg]
        assert got["grad_shapes"].keys() <= whole.keys()
        for name, shape in got["grad_shapes"].items():
            assert shape == got["block_shapes"][name], name
            assert int(np.prod(shape)) == got["numels"][f"params/{name}"]
            split += shape != whole[name]
    assert split > 0


@pytest.mark.parametrize("leg", EXPERT_LEGS)
def test_experts_split_over_expert(results, leg):
    """Under 'expert' 2 every MoE layer runs its rank's 2 of the 4 experts:
    experts [2 c, 2 c + 2) on the rank at 'expert' coordinate c."""
    for r in ranks_of(results[0], leg):
        c = r[leg]["coords"]["expert"]
        assert r[leg]["experts"], leg
        for name, experts in r[leg]["experts"].items():
            assert tuple(experts) == (2 * c, 2), (name, experts)


@pytest.mark.parametrize("leg", EXPERT_LEGS)
def test_expert_ranks_gradients_equal_not_doubled(results, leg):
    """The 'expert' ranks compute the same rows: a leaf they hold alike
    gets the same gradient on both (bit for bit), and every leaf's whole
    gradient (gathered from the blocks) is JAX's, within 1e-4 of its
    largest entry, so no rank summed the axis's equal gradients."""
    ranks, refs = results
    ran = ranks_of(ranks, leg)
    want = refs[ref_of(leg)]["grads"]
    by_place = {}
    for r in ran:
        coords = r[leg]["coords"]
        place = tuple(v for k, v in sorted(coords.items()) if k != "expert")
        by_place.setdefault(place, []).append(r[leg])
        for name, g in r[leg]["full_grads"].items():
            w = want[name]
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
    alike = 0
    for group in by_place.values():
        assert len(group) == 2
        a, b = group
        for name, g in a["grads"].items():
            if a["block_shapes"][name] == tuple(a["full_grads"][name].shape):
                np.testing.assert_array_equal(g, b["grads"][name],
                                              err_msg=name)
                alike += 1
    assert alike > 0
