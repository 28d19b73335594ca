"""Ring attention, the GPipe pipeline and the pipelined DeepSeek stack of
the port against the JAX package, on the CPU.

Multi-rank legs: one launch of 4 gloo ranks (``tests/torch_dist_worker.py``,
scenario ``ring_pipeline``, rendezvous through a ``file://`` store under
``tmp_path``) runs ``ring_attention`` over a 4-rank and a 2-rank
'sequence' ring (the 2-rank one as two replicas of a (replica, sequence)
mesh) and over (data 2, sequence 2) with ``batch_axis='data'``,
``pipeline_apply`` over 4 and 2 'pipe' ranks at six microbatch counts (1,
2 and 6 need padding at 4 stages), and the pipelined 4-layer DeepSeek stack
over ('data', 'pipe'). While they run, the parent computes JAX's side on
conftest's virtual CPU devices.

Tolerances are JAX's own tests' (tests/test_parallel_pp_sp.py): ring
outputs 2e-5 and gradients 5e-5 absolute; pipeline outputs 1e-5 and
gradients 1e-4; the stack 1e-5 forward and 1e-4 on every gradient.

In one process: the pipelined stack against JAX's (forward and every
gradient, the first_k_dense prefix, key masks, the load-balance terms with
the bubble ticks, the impossible pattern), ring attention without a group
(one process's loop), MLA's ``sequence_axis`` knob, and the converter
carrying a pipelined flax tree both ways bit for bit.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_dist_worker as W  # noqa: E402
from deepearth_tpu import configs as jcfg  # noqa: E402
from deepearth_tpu.models.deepseek import DeepSeekTransformer as JaxStack  # noqa: E402
from deepearth_tpu.models.deepseek import MLAttention as JaxMLA  # noqa: E402
from deepearth_tpu.parallel import create_mesh as jax_mesh  # noqa: E402
from deepearth_tpu.parallel import pipeline_apply as jax_pipeline  # noqa: E402
from deepearth_tpu.parallel import ring_attention as jax_ring  # noqa: E402
from deepearth_tpu_torch.configs import MLAConfig  # noqa: E402
from deepearth_tpu_torch.convert import (  # noqa: E402
    flax_params_from_model,
    load_flax_params,
)
from deepearth_tpu_torch.models.deepseek import (  # noqa: E402
    DeepSeekTransformer,
    MLAttention,
    collect_moe_aux_losses,
    pipeline_split,
    stack_sequential_state,
)
from deepearth_tpu_torch.models.layers import Init  # noqa: E402
from deepearth_tpu_torch.ops.sharding import use_mesh  # noqa: E402
from deepearth_tpu_torch.parallel import Mesh, ring_attention  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(scenario, world, workdir):
    """Start ``world`` gloo ranks of the worker; each writes its output to
    ``<workdir>/log<rank>`` (a file, not a pipe: a rank blocked on a full
    pipe would stall the others in their next collective)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env["PYTHONPATH"] = ROOT
    procs = []
    for r in range(world):
        with open(os.path.join(workdir, f"log{r}"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable,
                 os.path.join(ROOT, "tests", "torch_dist_worker.py"),
                 scenario, str(r), str(world), str(workdir)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
    return procs


def collect(procs, workdir, timeout=240):
    def logs():
        return "\n".join(
            f"rank {r}: " + open(os.path.join(workdir, f"log{r}")).read()[
                -3000:] for r in range(len(procs)))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise AssertionError(f"ranks still running after {timeout} s\n"
                             + logs())
    assert all(p.returncode == 0 for p in procs), logs()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("ring_pipeline")
    procs = launch("ring_pipeline", 4, workdir)
    yield lambda: collect(procs, workdir)


@pytest.fixture(scope="module")
def results(ranks):
    return ranks()


# -- JAX's side --------------------------------------------------------------- #


def jax_ring_case(name, n_shards, batch_axis=None):
    q, k, v, mask, scale, causal = W.ring_case_inputs(name)
    devices = jax.devices()
    if batch_axis:
        mesh = jax_mesh(devices[:4], mesh_shape=(2, 2),
                        axis_names=("data", "sequence"))
    else:
        mesh = jax_mesh(devices[:n_shards], axis_names=("sequence",))
    km = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jax_ring(q, k, v, scale=scale, mesh=mesh,
                        axis_name="sequence", key_mask=km, is_causal=causal,
                        batch_axis=batch_axis)
    def loss(*a):
        o = f(*a)
        return (o * jnp.cos(o)).sum(), o
    grads, out = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    return dict(out=np.asarray(out), dq=np.asarray(grads[0]),
                dk=np.asarray(grads[1]), dv=np.asarray(grads[2]))


def check_ring(port, ref):
    np.testing.assert_allclose(port["out"], ref["out"], atol=2e-5)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(port[g], ref[g], atol=5e-5, err_msg=g)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("name", list(W.RING_CASES))
def test_ring_attention_matches_jax(results, name, n_shards):
    ref = jax_ring_case(name, n_shards)
    for r in results:
        check_ring(r[f"ring{n_shards}"][name], ref)
    if name == "masked_row":
        assert (results[0][f"ring{n_shards}"][name]["out"][0] == 0).all()


@pytest.mark.parametrize("name", ["plain", "grad_causal_mask"])
def test_ring_attention_batch_axis_matches_jax(results, name):
    ref = jax_ring_case(name, 2, batch_axis="data")
    for r in results:
        check_ring(r["ring_batch"][name], ref)


def jax_mlp_stage(params, x):
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return x + h @ params["w2"]


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_apply_matches_jax(results, n_stages):
    mesh = jax_mesh(jax.devices()[:n_stages], axis_names=("pipe",))
    stacked = {k: jnp.asarray(v) for k, v in W.stage_params(n_stages).items()}
    x = jnp.asarray(W.pipe_x(2, 24))
    for m in W.PIPE_MICROBATCHES:
        ref = np.asarray(jax.jit(lambda p, x, m=m: jax_pipeline(
            jax_mlp_stage, p, x, mesh=mesh, n_microbatches=m))(stacked, x))
        for r in results:
            np.testing.assert_allclose(r[f"pipe{n_stages}"][f"mb{m}"], ref,
                                       atol=1e-5, err_msg=f"mb {m}")
    xg = jnp.asarray(W.pipe_x(3, 16))
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(jax_pipeline(
        jax_mlp_stage, p, x, mesh=mesh, n_microbatches=4) ** 2),
        argnums=(0, 1)))(stacked, xg)
    for rank, r in enumerate(results):
        # stage p's gradient lands on pipe rank p (rank r is pipe r % P)
        got, p = r[f"pipe{n_stages}"]["grad"], rank % n_stages
        for k in stacked:
            want = np.zeros_like(got[k])
            want[p] = np.asarray(gp[k])[p]
            np.testing.assert_allclose(got[k], want, atol=1e-4)
        np.testing.assert_allclose(got["x"], np.asarray(gx), atol=1e-4)


# -- the pipelined stack ------------------------------------------------------ #


def jax_block_cfg(**kw):
    base = jcfg.DeepSeekBlockConfig(
        hidden_dim=64, n_layers=4, intermediate_size=128,
        mla=jcfg.MLAConfig(hidden_dim=64, n_heads=4, kv_lora_rank=32,
                           qk_rope_head_dim=8, qk_nope_head_dim=16,
                           v_head_dim=16),
        moe=jcfg.MoEConfig(n_routed_experts=4, num_experts_per_tok=2,
                           hidden_dim=64, moe_intermediate_size=64),
        first_k_dense_replace=1, moe_layer_freq=1)
    import dataclasses
    return dataclasses.replace(base, **kw)


def port_stack(cfg, seed=3):
    return DeepSeekTransformer(
        cfg, Init(torch.Generator().manual_seed(seed), "cpu", torch.float32),
        torch.float32)


def jax_params(model):
    return jax.tree_util.tree_map(jnp.asarray, flax_params_from_model(model))


def port_named(tree):
    """A flax-named gradient tree as {port name: array in the port's
    layout}, through load_flax_params on a scratch stack."""
    from deepearth_tpu_torch.convert import _leaves, _to_port, _torch_name

    return {_torch_name(p): _to_port(np.asarray(v), p, p[-1] == "kernel")
            for p, v in _leaves(jax.tree_util.tree_map(np.asarray, tree))}


def jax_stack_run(cfg, params, x, mask=None):
    """JAX's output, gradients of sum(y^2) + sum(aux terms) and the aux
    terms (each sown leaf's mean, as the loss reads them)."""
    model = JaxStack(cfg)

    def loss(p, x):
        y, mut = model.apply({"params": p}, x, mask,
                             mutable=["intermediates"])
        aux = [v.mean() for path, v in
               jax.tree_util.tree_flatten_with_path(mut)[0]
               if "moe_aux_loss" in jax.tree_util.keystr(path)]
        return (y ** 2).sum() + sum(aux), (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    return np.asarray(y), port_named(gp), np.asarray(gx), \
        sorted(float(a) for a in aux)


def port_stack_run(model, x, mask=None, with_aux=True):
    xt = torch.from_numpy(x).requires_grad_()
    with collect_moe_aux_losses(model) as aux:
        y = model(xt, None if mask is None else torch.from_numpy(mask))
        loss = (y ** 2).sum() + (sum(aux) if with_aux else 0.0)
    loss.backward()
    return (y.detach().numpy(), {n: p.grad.numpy() for n, p in
                                 model.named_parameters()
                                 if p.grad is not None},
            xt.grad.numpy(), sorted(float(a.detach()) for a in aux))


def check_stack(port, ref):
    y, g, gx, aux = port
    ry, rg, rgx, raux = ref
    np.testing.assert_allclose(y, ry, atol=1e-5)
    np.testing.assert_allclose(gx, rgx, atol=1e-4)
    np.testing.assert_allclose(aux, raux, rtol=1e-5)
    assert set(g) <= set(rg)
    for n, v in g.items():
        np.testing.assert_allclose(v, rg[n], atol=1e-4, err_msg=n)


@pytest.mark.parametrize("first_k,masked", [(0, False), (1, False),
                                            (1, True)])
def test_pipelined_stack_matches_jax(first_k, masked):
    """P = 2, M = 4; the port's pipelined stack from a random init, its
    weights handed to JAX: forward, the input's and every parameter's
    gradient of sum(y^2) plus the load-balance terms (JAX sows them over
    (tick, stage), bubble ticks included: one term per stage layer)."""
    cfg = W.pipelined_stack_cfg(2)
    cfg.first_k_dense_replace = first_k
    jc = jax_block_cfg(first_k_dense_replace=first_k, pipeline_stages=2,
                       pipeline_microbatches=4)
    model = port_stack(cfg)
    x, mask = W.stack_inputs()
    mask = mask if masked else None
    ref = jax_stack_run(jc, jax_params(model), jnp.asarray(x),
                        None if mask is None else jnp.asarray(mask))
    port = port_stack_run(model, x, mask)
    check_stack(port, ref)
    # one term per MoE layer: the prefix's layer_1 (first_k 1), and
    # pipe/stages/layer_0 (the stage-layers of first_k 0: layer_0, layer_1)
    assert len(port[3]) == (2 if first_k else 2)


def test_pipelined_stack_equals_sequential():
    """stack_sequential_state: the sequential stack's weights stacked into
    the pipelined one give its output and (stacked) gradients of sum(y^2)
    (the load-balance terms differ by design: the pipeline's count the
    bubble ticks)."""
    seq = port_stack(W.pipelined_stack_cfg(0))
    pipe = port_stack(W.pipelined_stack_cfg(2), seed=9)
    pipe.load_state_dict(stack_sequential_state(seq.state_dict(),
                                                W.pipelined_stack_cfg(2)))
    x, mask = W.stack_inputs()
    ys, gs, gxs, _ = port_stack_run(seq, x, mask, with_aux=False)
    yp, gp, gxp, _ = port_stack_run(pipe, x, mask, with_aux=False)
    np.testing.assert_allclose(yp, ys, atol=1e-5)
    np.testing.assert_allclose(gxp, gxs, atol=1e-4)
    stacked = stack_sequential_state(
        {n: torch.from_numpy(v) for n, v in gs.items()},
        W.pipelined_stack_cfg(2))
    for n, v in gp.items():
        np.testing.assert_allclose(v, stacked[n].numpy(), atol=1e-4,
                                   err_msg=n)


def check_stack_ranks(results, leg, dispatch="auto"):
    """Every rank's output, input gradient and aux terms of the worker's
    ``leg``, and its parameter gradients (a stage's on its 'pipe' rank,
    summed over 'pipe'), against JAX's stack with ``dispatch``."""
    import dataclasses

    model = port_stack(W.pipelined_stack_cfg(2))
    x, mask = W.stack_inputs()
    jc = jax_block_cfg(pipeline_stages=2, pipeline_microbatches=4)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, dispatch_mode=dispatch))
    ry, rg, rgx, raux = jax_stack_run(jc, jax_params(model), jnp.asarray(x),
                                      jnp.asarray(mask))
    for r in results:
        got = r[leg]
        np.testing.assert_allclose(got["out"], ry, atol=1e-5)
        np.testing.assert_allclose(got["dx"], rgx, atol=1e-4)
        np.testing.assert_allclose(sorted(got["aux"]), raux, rtol=1e-5)
    for n, g in results[0][leg]["grads"].items():
        if ".stages." in n:
            # pipe rank p holds stage p's gradient; the others zeros there
            g = sum(r[leg]["grads"][n] for r in results[:2])
        np.testing.assert_allclose(g, rg[n], atol=1e-4, err_msg=n)


def test_pipelined_stack_over_pipe_ranks_matches_jax(results):
    """The same stack over ('data' 2, 'pipe' 2) gloo ranks, each 'pipe'
    rank running one stage, every rank on the whole batch, against
    JAX's."""
    check_stack_ranks(results, "stack")


@pytest.mark.parametrize("dispatch", ["auto", "scatter"])
def test_pipelined_stack_rows_over_data_matches_jax(results, dispatch):
    """As above, each 'data' rank on its own rows: each runs its share of
    every microbatch; the MoE layers sum their load statistics over 'data'
    on the capacity-free route 'auto' takes here, and gather the tokens on
    'scatter'. The output and input gradient gathered over 'data', the
    parameter gradients summed over it."""
    check_stack_ranks(results, f"stack_rows_{dispatch}", dispatch)


def test_pipeline_split_and_impossible_pattern():
    cfg = W.pipelined_stack_cfg(2)
    assert pipeline_split(cfg, 2) == (2, (True,))
    from deepearth_tpu.models.deepseek import _pipeline_split
    for fk, freq, n, p in [(1, 1, 24, 4), (0, 1, 4, 2), (1, 2, 8, 2),
                           (3, 1, 12, 3)]:
        c = W.pipelined_stack_cfg(0)
        c.first_k_dense_replace, c.moe_layer_freq, c.n_layers = fk, freq, n
        jc = jax_block_cfg(first_k_dense_replace=fk, moe_layer_freq=freq,
                           n_layers=n)
        assert pipeline_split(c, p) == _pipeline_split(jc, p)
    bad = W.pipelined_stack_cfg(4)
    bad.first_k_dense_replace, bad.moe_layer_freq = 0, 2
    with pytest.raises(ValueError, match="no prefix split"):
        port_stack(bad)
    with pytest.raises(ValueError, match="no prefix split"):
        JaxStack(jax_block_cfg(first_k_dense_replace=0, moe_layer_freq=2,
                               pipeline_stages=4)).init(
            jax.random.PRNGKey(0), jnp.zeros((4, 6, 64)))


def test_pipelined_tree_round_trip_bitwise():
    """A flax tree of JAX's pipelined stack (its own init) loads into the
    port and comes back leaf for leaf, bit for bit, the stage axis in
    front."""
    jc = jax_block_cfg(pipeline_stages=2, pipeline_microbatches=4)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(JaxStack(jc).init)(
        jax.random.PRNGKey(5), jnp.zeros((4, 6, 64)))["params"])
    model = port_stack(W.pipelined_stack_cfg(2))
    load_flax_params(model, tree)
    back = flax_params_from_model(model)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    assert any("stages" in jax.tree_util.keystr(k) for k in flat)
    for k, v in flat.items():
        assert flat_back[k].dtype == v.dtype and np.array_equal(
            flat_back[k], v), jax.tree_util.keystr(k)


# -- one process -------------------------------------------------------------- #


def test_ring_without_group_matches_jax():
    """An abstract mesh (no ranks): the ring is one process's loop over the
    blocks, held to JAX's 4-device ring."""
    mesh = Mesh(("sequence",), (4,))
    for name in ("key_mask", "grad_causal_mask"):
        q, k, v, mask, scale, causal = W.ring_case_inputs(name)
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = ring_attention(qt, kt, vt, scale=scale, mesh=mesh,
                           key_mask=torch.from_numpy(mask), is_causal=causal)
        (o * torch.cos(o)).sum().backward()
        check_ring(dict(out=o.detach().numpy(), dq=qt.grad.numpy(),
                        dk=kt.grad.numpy(), dv=vt.grad.numpy()),
                   jax_ring_case(name, 4))


def test_mla_sequence_axis_knob():
    """MLAConfig.sequence_axis runs ring attention under an ambient mesh
    with that axis (JAX's (data 2, sequence 4) mesh against the port's
    abstract one), and is inert without a mesh, as in JAX."""
    kw = dict(hidden_dim=64, n_heads=4, kv_lora_rank=32,
              qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16)
    port = MLAttention(MLAConfig(sequence_axis="sequence", ring_min_seq=8,
                                 **kw),
                       Init(torch.Generator().manual_seed(0), "cpu",
                            torch.float32), torch.float32)
    x = np.random.default_rng(1).standard_normal((4, 16, 64)).astype(
        np.float32)
    jm = JaxMLA(jcfg.MLAConfig(sequence_axis="sequence", ring_min_seq=8,
                               **kw))
    params = jax.tree_util.tree_map(jnp.asarray, flax_params_from_model(port))
    mesh = jax_mesh(jax.devices(), mesh_shape=(2, 4),
                    axis_names=("data", "sequence"))
    with jax.set_mesh(mesh):
        ref = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
            params, jnp.asarray(x)))
    plain = port(torch.from_numpy(x)).detach().numpy()
    with use_mesh(Mesh(("data", "sequence"), (2, 4))):
        ringed = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(ringed, ref, atol=2e-5)
    np.testing.assert_allclose(plain, ref, atol=2e-5)
    assert port._ring_mesh(16) is None  # no mesh, no ring
    with use_mesh(Mesh(("data", "sequence"), (2, 4))):
        assert port._ring_mesh(16) is not None
        assert port._ring_mesh(4) is None  # below ring_min_seq
        assert port._ring_mesh(10) is None  # 4 does not divide 10
