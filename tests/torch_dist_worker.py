"""One gloo rank of the port's multi-process tests (not collected by pytest;
spawned by tests/test_torch_ring_pipeline.py and
tests/test_torch_distributed.py). Imports no JAX.

Usage: python torch_dist_worker.py <scenario> <rank> <world> <dir>

Joins the process group through a ``file://`` store in <dir> (no port to
race for), runs the scenario and writes ``<dir>/rank<rank>.pt``: a dict of
numpy arrays and numbers. The inputs come from numpy seeds that the tests
repeat on the JAX side. gloo on the CPU; with ``DIST_TEST_DEVICE=cuda``,
NCCL with rank r on card r (``chip_smoke.py --multi-card`` holds that run
against the gloo one).
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deepearth_tpu_torch.parallel import (  # noqa: E402
    create_mesh,
    pipeline_apply,
    ring_attention,
)

torch.set_num_threads(1)
DEVICE = torch.device(os.environ.get("DIST_TEST_DEVICE", "cpu"))


def np_(t):
    return t.detach().float().cpu().numpy().copy()


def dev(a):
    """A numpy array as a tensor on DEVICE."""
    return torch.from_numpy(a).to(DEVICE)


# -- inputs, repeated by the tests on the JAX side --------------------------- #


def ring_inputs(seed, b=2, h=4, n=32, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for _ in range(3)]


def ring_mask(seed, b, n, full_row=None):
    mask = np.random.default_rng(seed).uniform(size=(b, n)) < 0.7
    mask[:, 0] = True
    if full_row is not None:
        mask[full_row] = False
    return mask


RING_CASES = {
    # name: (seed, n, scale, causal, mask kind)
    "plain": (0, 32, 0.25, False, None),
    "causal": (1, 64, 0.25, True, None),
    "key_mask": (2, 32, 0.3, False, "random"),
    "masked_row": (7, 32, 0.3, False, "row0"),
    "grad": (4, 16, 0.5, False, None),
    "grad_causal_mask": (5, 16, 0.5, True, "random"),
}


def ring_case_inputs(name):
    seed, n, scale, causal, kind = RING_CASES[name]
    q, k, v = ring_inputs(seed, n=n)
    mask = None
    if kind == "random":
        mask = ring_mask(seed + 100, q.shape[0], n)
    elif kind == "row0":
        mask = ring_mask(seed + 100, q.shape[0], n, full_row=0)
    return q, k, v, mask, scale, causal


def mlp_stage(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return x + h @ params["w2"]


def stage_params(n_stages, d=8, hidden=16, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.standard_normal((n_stages, d, hidden)) * 0.1).astype(
            np.float32),
        "b1": (rng.standard_normal((n_stages, hidden)) * 0.1).astype(
            np.float32),
        "w2": (rng.standard_normal((n_stages, hidden, d)) * 0.1).astype(
            np.float32),
    }


def pipe_x(seed, n, d=8):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


PIPE_MICROBATCHES = (1, 2, 4, 6, 12, 24)


def pipelined_stack_cfg(pipeline_stages=0, dispatch_mode="auto"):
    from deepearth_tpu_torch.configs import (DeepSeekBlockConfig, MLAConfig,
                                             MoEConfig)

    return DeepSeekBlockConfig(
        hidden_dim=64, n_layers=4, intermediate_size=128,
        mla=MLAConfig(hidden_dim=64, n_heads=4, kv_lora_rank=32,
                      qk_rope_head_dim=8, qk_nope_head_dim=16,
                      v_head_dim=16),
        moe=MoEConfig(n_routed_experts=4, num_experts_per_tok=2,
                      hidden_dim=64, moe_intermediate_size=64,
                      dispatch_mode=dispatch_mode),
        first_k_dense_replace=1, moe_layer_freq=1,
        pipeline_stages=pipeline_stages,
        pipeline_microbatches=4 if pipeline_stages else 0)


def stack_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 6, 64)).astype(np.float32)
    mask = rng.uniform(size=(8, 6)) < 0.7
    mask[:, 0] = True
    return x, mask


# -- scenarios ---------------------------------------------------------------- #


def _ring_on(mesh, batch_axis=None, cases=RING_CASES):
    out = {}
    for name in cases:
        q, k, v, mask, scale, causal = ring_case_inputs(name)
        qt, kt, vt = (dev(a).requires_grad_() for a in (q, k, v))
        o = ring_attention(
            qt, kt, vt, scale=scale, mesh=mesh, axis_name="sequence",
            key_mask=None if mask is None else dev(mask),
            is_causal=causal, batch_axis=batch_axis)
        (o * torch.cos(o)).sum().backward()
        out[name] = dict(out=np_(o), dq=np_(qt.grad), dk=np_(kt.grad),
                         dv=np_(vt.grad))
    return out


def _pipe_on(mesh, n_stages):
    out = {}
    stacked = {k: dev(v) for k, v in stage_params(n_stages)
               .items()}
    x = dev(pipe_x(2, 24))
    for m in PIPE_MICROBATCHES:
        y = pipeline_apply(mlp_stage, stacked, x, mesh=mesh,
                           n_microbatches=m)
        out[f"mb{m}"] = np_(y)
    params = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    xg = dev(pipe_x(3, 16)).requires_grad_()
    y = pipeline_apply(mlp_stage, params, xg, mesh=mesh, n_microbatches=4)
    (y ** 2).sum().backward()
    out["grad"] = {k: np_(v.grad) for k, v in params.items()}
    out["grad"]["x"] = np_(xg.grad)
    return out


def _stack_on(mesh, rows_local=False, dispatch_mode="auto"):
    """The pipelined 4-layer stack (prefix 2, 2 stages of 1 MoE layer) run
    over the mesh's 'pipe' group, with key masks, on the whole batch, or
    (``rows_local``) each 'data' rank on its own rows, its objective its
    rows' part plus 1/size of the aux terms: output and input gradient
    (gathered over 'data'), every parameter's gradient (summed over
    'data') and the aux terms (weights from
    tests/test_torch_ring_pipeline.py's seed)."""
    from deepearth_tpu_torch.models.deepseek import (
        DeepSeekTransformer, collect_moe_aux_losses)
    from deepearth_tpu_torch.models.layers import Init
    from deepearth_tpu_torch.ops.sharding import use_mesh
    from deepearth_tpu_torch.parallel import comm

    model = DeepSeekTransformer(
        pipelined_stack_cfg(2, dispatch_mode),
        Init(torch.Generator().manual_seed(3), "cpu", torch.float32),
        torch.float32).to(DEVICE)
    xn, mask = stack_inputs()
    data = mesh.group("data") if rows_local else None
    n = comm.group_size(data)
    rows = len(xn) // n
    mine = slice(comm.group_rank(data) * rows, (comm.group_rank(data) + 1)
                 * rows)
    x = dev(xn[mine]).requires_grad_()
    with use_mesh(mesh, rows_local=rows_local), \
            collect_moe_aux_losses(model) as aux:
        y = model(x, dev(mask[mine]))
        loss = (y ** 2).sum() + sum(aux) / n
    loss.backward()
    grads = {n_: p.grad for n_, p in model.named_parameters()
             if p.grad is not None}
    comm.all_reduce_(list(grads.values()), data)
    return dict(out=np_(comm.gather_rows(y.detach(), data)),
                dx=np_(comm.gather_rows(x.grad, data)),
                grads={n_: np_(g) for n_, g in grads.items()},
                aux=[float(a) for a in aux])


def scenario_ring_pipeline():
    out = {}
    m4 = create_mesh(mesh_shape=(4,), axis_names=("sequence",))
    out["ring4"] = _ring_on(m4)
    m22 = create_mesh(mesh_shape=(2, 2), axis_names=("replica", "sequence"))
    out["ring2"] = _ring_on(m22.submesh("sequence"))
    mds = create_mesh(mesh_shape=(2, 2), axis_names=("data", "sequence"))
    out["ring_batch"] = _ring_on(mds, batch_axis="data",
                                 cases=("plain", "grad_causal_mask"))
    p4 = create_mesh(mesh_shape=(4,), axis_names=("pipe",))
    out["pipe4"] = _pipe_on(p4, 4)
    p22 = create_mesh(mesh_shape=(2, 2), axis_names=("replica", "pipe"))
    out["pipe2"] = _pipe_on(p22.submesh("pipe"), 2)
    dp = create_mesh(mesh_shape=(2, 2), axis_names=("data", "pipe"))
    out["stack"] = _stack_on(dp)
    for mode in ("auto", "scatter"):
        out[f"stack_rows_{mode}"] = _stack_on(dp, rows_local=True,
                                              dispatch_mode=mode)
    return out


SCENARIOS = {"ring_pipeline": scenario_ring_pipeline}


def main():
    scenario, rank, world, workdir = (sys.argv[1], int(sys.argv[2]),
                                      int(sys.argv[3]), sys.argv[4])
    os.environ["DIST_TEST_DIR"] = workdir
    if scenario not in SCENARIOS:
        import torch_dist_legs  # the trainer legs

        SCENARIOS.update(torch_dist_legs.SCENARIOS)
    backend = "gloo"
    if DEVICE.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world)
    result = SCENARIOS[scenario]()
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
