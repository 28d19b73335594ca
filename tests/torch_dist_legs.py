"""The DistributedTrainer legs that tests/test_torch_distributed.py runs on
4 gloo ranks through tests/torch_dist_worker.py (scenario ``trainer``).
Imports no JAX.

The model is the tiny flagship-shaped config of the JAX package's
multi-chip dry run (``__graft_entry__.py`` ``dryrun_multichip``'s
``make_cfg``: an MoE simulator of 3 layers, the first dense, one fusion
layer, vision (B, 16, 32)), in fp32, built from one torch seed on every
rank; the batch and its masks come from one numpy seed. Each leg trains 2
steps from that model and records every rank's metrics, and its Adam first
moments after the first step; and, for the split of the step: the most
whole bytes its units held at once in each step beside each unit's whole
bytes, every parameter's block and gradient shape, the experts each MoE
layer ran and, under an 'expert' axis, every gradient after the first
step (the block, and gathered whole).
"""

import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from deepearth_tpu_torch.configs import (
    DeepSeekBlockConfig,
    MLAConfig,
    ModalityConfig,
    MoEConfig,
    OptimizerConfig,
    tiny_config,
)
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.models.deepseek import stack_sequential_state
from deepearth_tpu_torch.parallel import AXES, create_mesh
from deepearth_tpu_torch.training import LossWeights
from deepearth_tpu_torch.training.distributed import DistributedTrainer

B, SEQ, STEPS = 8, 16, 2
# where the ranks run (tests/torch_dist_worker.py)
DEVICE = torch.device(os.environ.get("DIST_TEST_DEVICE", "cpu"))
# the load-balance term too: its statistics span the global batch
LOSS_WEIGHTS = dict(contrastive=0.01, moe_aux=0.01)


def make_cfg(pipeline_stages=0, seq_axis=None, dispatch_mode="auto",
             capacity_factor=2.0, remat=None, compute_dtype=torch.float32,
             n_experts=4):
    c = tiny_config()
    c.hidden_dim = 64
    c.n_heads = 4
    c.compute_dtype = compute_dtype
    c.fusion.universal_dim = 64
    c.fusion.num_fusion_layers = 1
    c.fusion.num_heads = 4
    c.fusion.deepseek_block = DeepSeekBlockConfig(
        hidden_dim=64, n_layers=3, intermediate_size=128,
        mla=MLAConfig(hidden_dim=64, n_heads=4, kv_lora_rank=16,
                      qk_rope_head_dim=8, qk_nope_head_dim=16,
                      v_head_dim=16),
        moe=MoEConfig(n_routed_experts=n_experts, num_experts_per_tok=2,
                      moe_intermediate_size=128, hidden_dim=64,
                      n_shared_experts=1, dispatch_mode=dispatch_mode,
                      capacity_factor=capacity_factor),
        first_k_dense_replace=1,
        pipeline_stages=pipeline_stages,
        pipeline_microbatches=(4 if pipeline_stages else 0))
    c.add_modality(ModalityConfig(
        name="vision", input_dim=32, n_tokens=2, encoder_layers=1,
        encoder_heads=4, encoder_sequence_axis=seq_axis,
        encoder_ring_min_seq=8))
    if remat is not None:  # the fusion layers and the simulator's blocks
        c.fusion.remat, c.fusion.remat_policy = True, remat
    # the first update moves the parameters (no warmup)
    c.optimizer = OptimizerConfig(learning_rate=1e-3, warmup_steps=0,
                                  total_steps=4)
    return c


def numpy_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "xyzt": rng.uniform(0.0, 1.0, (B, 4)).astype(np.float32),
        "modalities": {
            "species": rng.integers(0, 232, (B,)).astype(np.int64),
            "vision": rng.standard_normal((B, SEQ, 32)).astype(np.float32),
        },
        "spatial_mask": rng.uniform(size=B) > 0.5,
        "temporal_mask": rng.uniform(size=B) > 0.5,
        "modality_masks": {"species": rng.uniform(size=B) > 0.3,
                           "vision": rng.uniform(size=B) > 0.3},
    }


def make_model(cfg, seed=0):
    """Built on the CPU from ``seed``, then moved to DEVICE: the same
    numbers wherever the ranks run."""
    return DeepEarthModel(cfg, generator=torch.Generator().manual_seed(seed),
                          device="cpu", native_seq_lens={"vision": SEQ}
                          ).to(DEVICE)


def pipelined_model(cfg_pp, seed=0):
    """The pipelined model holding the sequential model's numbers."""
    seq = make_model(make_cfg(), seed)
    model = make_model(cfg_pp, seed + 1)
    state = seq.state_dict()
    sim = {n[len("simulator."):]: v for n, v in state.items()
           if n.startswith("simulator.")}
    stacked = stack_sequential_state(sim, cfg_pp.fusion.deepseek_block)
    state = {n: v for n, v in state.items() if not n.startswith("simulator.")}
    state.update({f"simulator.{n}": v for n, v in stacked.items()})
    model.load_state_dict(state)
    return model


# 4-rank legs: name -> (mesh shape, axis names, trainer kwargs, cfg kwargs)
LEGS = {
    "dp4": ((4,), ("data",), {}, {}),
    "dp_ep": ((2, 2, 1), AXES, {}, dict(dispatch_mode="ragged")),
    "ep_tp": ((1, 2, 2), AXES, {}, dict(dispatch_mode="ragged")),
    "fsdp": ((2, 2, 1), AXES, dict(fsdp_axes=("data", "expert")), {}),
    "fsdp_mb": ((2, 2, 1), AXES,
                dict(fsdp_axes=("data", "expert"), microbatch_steps=2), {}),
    "pp": ((2, 2), ("data", "pipe"), {}, dict(pipeline_stages=2)),
    "sp": ((2, 2), ("data", "sequence"), {}, dict(seq_axis="sequence")),
    # the capacity route under the expert split, its slots the global
    # batch's: without drops at capacity_factor 2 (C = 40 slots for 40
    # tokens), with them at 0.5 (C = 10 slots, 20 assignments an expert)
    "scatter": ((2, 2, 1), AXES, dict(fsdp_axes=("data", "expert")),
                dict(dispatch_mode="scatter", capacity_factor=2.0)),
    "scatter_drop": ((2, 2, 1), AXES, dict(fsdp_axes=("data", "expert")),
                     dict(dispatch_mode="scatter", capacity_factor=0.5)),
    # the one-hot capacity route under the expert split, with drops
    "dense": ((2, 2, 1), AXES, {},
              dict(dispatch_mode="dense", capacity_factor=0.5)),
    # checkpointed blocks: the recompute gathers its blocks anew
    "fsdp_remat": ((2, 2, 1), AXES, dict(fsdp_axes=("data", "expert")),
                   dict(remat="dots")),
    # fp32 parameters computed in bf16 (the configs' default): each layer
    # casts its whole weights, and the casts are made again in the backward
    "fsdp_bf16": ((2, 2, 1), AXES, dict(fsdp_axes=("data", "expert")),
                  dict(compute_dtype=torch.bfloat16)),
    # 3 experts over 'expert' 2: the rules leave them whole on every rank,
    # and FSDP splits the expert weights over 'expert' on another dim
    "fsdp_e3": ((2, 2, 1), AXES, dict(fsdp_axes=("data", "expert")),
                dict(n_experts=3)),
}
# the legs held against the port's own single-process step (JAX's bf16
# arithmetic rounds in other places)
PORT_REF_LEGS = ("fsdp_bf16",)
# 2-rank legs, two at once: the first on ranks 0-1, the second on ranks
# 2-3 (each its half of a (replica, ...) mesh)
PAIRS = [
    ("dp2", ((2,), ("data",), {}, {})),
    ("fsdp2", ((2,), ("data",), dict(fsdp_axes=("data",)), {})),
    ("ep2", ((1, 2, 1), AXES, {}, dict(dispatch_mode="ragged"))),
    ("tp2", ((1, 1, 2), AXES, {}, dict(dispatch_mode="ragged"))),
    ("pp2", ((2,), ("pipe",), {}, dict(pipeline_stages=2))),
    ("sp2", ((2,), ("sequence",), {}, dict(seq_axis="sequence"))),
]
LEGS_2 = dict(PAIRS)


def run_leg(name, mesh, local=False):
    print(f"leg {name}{' local' if local else ''} at {time.time():.1f}",
          flush=True)
    _, _, kwargs, cfg_kwargs = {**LEGS, **LEGS_2}[name]
    cfg = make_cfg(**cfg_kwargs)
    model = (pipelined_model(cfg) if cfg_kwargs.get("pipeline_stages")
             else make_model(cfg))
    trainer = DistributedTrainer(
        model, cfg, LossWeights(**LOSS_WEIGHTS), mesh=mesh,
        lr_scale_by_data_parallel=False, apply_masking=False, **kwargs)
    state = trainer.init_state()
    moe = {n: m for n, m in model.named_modules()
           if type(m).__name__ == "MoELayer"}
    out = {"numels": trainer.local_numels(), "metrics": [],
           "mode": {n: m.cfg.dispatch_mode for n, m in moe.items()},
           "coords": {ax: mesh.coordinate(ax) for ax in mesh.axis_names},
           "unit_bytes": trainer.unit_bytes(), "gathered_peak": [],
           "made_peak": []}
    batch = numpy_batch()
    for _ in range(STEPS):
        if local:
            from deepearth_tpu_torch.parallel import \
                process_local_batch_indices
            idx = process_local_batch_indices(B)
            part = _take(batch, idx)
            state, m = trainer.step(state, part, local_of=B)
        else:
            state, m = trainer.step(state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["gathered_peak"].append(trainer.gathered_peak)
        out["made_peak"].append(trainer.made_peak)
        if "kept" not in out and trainer._units:
            out["kept"] = kept_bytes(trainer, model)
            out["guards"] = guards(trainer, model)
        if "mu" not in out:
            params = dict(model.named_parameters())
            out["block_shapes"] = {n: tuple(p.shape)
                                   for n, p in params.items()}
            out["grad_shapes"] = {n: tuple(p.grad.shape)
                                  for n, p in params.items()
                                  if p.grad is not None}
            out["experts"] = {n: m.experts for n, m in moe.items()}
            if mesh.shape.get("expert", 1) > 1:
                out["grads"] = {n: p.grad.cpu().numpy().copy()
                                for n, p in params.items()
                                if p.grad is not None}
                out["full_grads"] = {n: g.cpu().numpy() for n, g in
                                     trainer.full_grads().items()}
            # Adam's first moments after step 1: 0.1 the clipped gradient
            out["mu"] = {n[:-3]: v.cpu().numpy() for n, v in
                         trainer.full_state("opt/").items()
                         if n.endswith("/mu")}
    return out


def _forward_keeping(trainer, model, seed):
    """One forward under the split over the batch of ``seed`` (no
    backward): every tensor autograd keeps as it is (the saved-tensor
    hooks' pack returned it unchanged), by storage, as (storage bytes,
    [(shape, dtype, sum, sum of squares)])."""
    from deepearth_tpu_torch.ops.sharding import use_mesh
    from deepearth_tpu_torch.parallel import comm

    pack, kept = comm._pack, {}

    def recording(t):
        out = pack(t)
        if out is t:
            d = t.detach().double()
            kept.setdefault(t.untyped_storage().data_ptr(), (
                t.untyped_storage().nbytes(), []))[1].append(
                (tuple(t.shape), t.dtype, float(d.sum()),
                 float(d.square().sum())))
        return out

    comm._pack = recording
    try:
        batch = trainer.shard_batch(numpy_batch(100 + seed))
        gen = torch.Generator(device=DEVICE).manual_seed(100 + seed)
        with use_mesh(trainer.mesh, rows_local=True), trainer._split():
            out = model(batch, generator=gen)
            del out
    finally:
        comm._pack = pack
    return kept


def kept_bytes(trainer, model):
    """What autograd keeps from a forward under the split: all the bytes it
    keeps, and those whose values do not depend on the batch (found in two
    forwards over two batches with the same shape, dtype and sums), apart
    from the parameters' own storage."""
    a, b = (_forward_keeping(trainer, model, s) for s in (0, 1))
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    seen = {f for _, fs in b.values() for f in fs}
    free = sum(n for key, (n, fs) in a.items()
               if key not in params and any(f in seen for f in fs))
    return {"all": sum(n for n, _ in a.values()), "batch_free": free,
            "batch_free_shapes": sorted(
                {f[0] for key, (n, fs) in a.items() if key not in params
                 for f in fs if f in seen})}


def guards(trainer, model):
    """Whether a forward outside the trainer's step and a second
    init_state each raise, and whether full_params() gives every parameter
    whole."""
    raised = {}
    for what, call in (
            ("forward", lambda: model(trainer.shard_batch(numpy_batch()))),
            ("init_state", trainer.init_state)):
        try:
            call()
            raised[what] = False
        except RuntimeError:
            raised[what] = True
    full = {n: tuple(p.shape) for n, p in trainer.full_params().items()}
    raised["full_params"] = full == {
        n: tuple(p.shape)
        for n, p in make_model(trainer.config).named_parameters()}
    return raised


def run_pairs():
    """Each pair's legs at once, on the two halves of the world: every
    rank builds both halves' meshes (a collective), then runs its half's
    leg."""
    out = {}
    half = dist.get_rank() // 2
    for i in range(0, len(PAIRS), 2):
        meshes = []
        for name, (shape, axes, _, _) in PAIRS[i:i + 2]:
            m = create_mesh(mesh_shape=(2,) + shape,
                            axis_names=("replica",) + axes)
            meshes.append((name, m.submesh(*axes)))
        name, mesh = meshes[half]
        out[name] = run_leg(name, mesh)
    return out


def _take(tree, idx):
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    return tree[idx]


def checkpoint_leg():
    """Save after one step, restore into a trainer over a model of another
    seed, take the second step: its loss against the uninterrupted run's."""
    mesh = create_mesh(mesh_shape=(2, 2, 1), axis_names=AXES)
    cfg = make_cfg()
    ckpt = None
    if dist.get_rank() == 0:
        ckpt = tempfile.mkdtemp(prefix="dist_ckpt_",
                                dir=os.environ.get("DIST_TEST_DIR"))
    holder = [ckpt]
    dist.broadcast_object_list(holder, 0)
    ckpt = holder[0]
    kw = dict(mesh=mesh, lr_scale_by_data_parallel=False,
              apply_masking=False, fsdp_axes=("data", "expert"),
              checkpoint_dir=ckpt)
    batch = numpy_batch()
    t1 = DistributedTrainer(make_model(cfg), cfg,
                            LossWeights(**LOSS_WEIGHTS), **kw)
    s1 = t1.init_state()
    s1, _ = t1.step(s1, batch)
    t1.save(s1, 1)
    saved_params = t1.full_params()
    s1, m_straight = t1.step(s1, batch)
    t2 = DistributedTrainer(make_model(cfg, seed=123), cfg,
                            LossWeights(**LOSS_WEIGHTS), **kw)
    s2 = t2.init_state()
    s2 = t2.restore(s2)
    restored = t2.full_params()
    same = all(torch.equal(restored[n], v) for n, v in saved_params.items())
    restored_step = s2.step
    s2, m_resumed = t2.step(s2, batch)
    return dict(straight=float(m_straight["loss/total"]),
                resumed=float(m_resumed["loss/total"]),
                restored_step=restored_step, params_equal=same,
                saved=t2.saved_steps())


def lr_leg():
    mesh = create_mesh(mesh_shape=(4,), axis_names=("data",))
    cfg = make_cfg()
    base = cfg.optimizer.learning_rate
    t = DistributedTrainer(make_model(cfg), cfg, mesh=mesh)
    t2 = DistributedTrainer(make_model(cfg), cfg, mesh=mesh)
    return dict(base=base, scaled=t.config.optimizer.learning_rate,
                again=t2.config.optimizer.learning_rate,
                caller=cfg.optimizer.learning_rate)


def prefetch_leg():
    """device_prefetch(sharding=batch_sharding(mesh)): each rank's rows."""
    from deepearth_tpu_torch.data.batches import device_prefetch
    from deepearth_tpu_torch.parallel import batch_sharding

    mesh = create_mesh(mesh_shape=(2, 2), axis_names=("data", "model"))
    batches = [numpy_batch(s) for s in range(3)]
    out = list(device_prefetch(iter(batches), size=2, device=DEVICE,
                               sharding=batch_sharding(mesh)))
    return dict(xyzt=[o["xyzt"].cpu().numpy() for o in out],
                vision=[o["modalities"]["vision"].cpu().numpy()
                        for o in out],
                data=mesh.coordinate("data"))


def scenario_trainer():
    out = {}
    for name, (shape, axes, _, _) in LEGS.items():
        out[name] = run_leg(name, create_mesh(mesh_shape=shape,
                                              axis_names=axes))
    out["dp4_local"] = run_leg("dp4", create_mesh(
        mesh_shape=(4,), axis_names=("data",)), local=True)
    out.update(run_pairs())
    out["checkpoint"] = checkpoint_leg()
    out["lr"] = lr_leg()
    out["prefetch"] = prefetch_leg()
    return out


SCENARIOS = {"trainer": scenario_trainer}
