"""Activation checkpointing (``remat`` with its three policies) in the port,
on the CPU.

The tiny flagship of tests/test_torch_flagship_training.py
(``integrated_config(use_deepseek_fusion=True)`` at universal dim 64: 2
fusion layers, a 2-layer MLA + MoE simulator, vision (B, 20, 1408) and
language (B, 5, 7168) through MoE-projected encoders) with ``fusion.remat``
(the fusion layers and the simulator's blocks) and both modalities'
``encoder_remat`` under each policy:

against the port without remat, bit for bit, over 3 train steps with
dropout 0.1 in the fusion layers and the MLA, from one generator seed:
metrics, parameters and the generator's state after the steps (against JAX's
``nn.remat``: tests/test_torch_remat_jax.py).

Then what each policy keeps: under ``dots`` no ``aten.mm`` / ``addmm`` runs
again in the backward, under ``dots_saveable`` no ``bmm`` either, and under
both a kernel's forward (K1 and K5 here, through their plain versions on
the CPU) runs again with every op inside it. The MoE layer routes each
token the same way in the recompute, its aux loss keeps its gradient, and
``collect_moe_aux_losses`` gets one value a call with the backward run
inside it. An unknown policy raises JAX's ``ValueError``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import deepseek as jds
from deepearth_tpu_torch import configs as tcfg
from deepearth_tpu_torch.models import DeepEarthModel, MoELayer
from deepearth_tpu_torch.models import deepseek as tds
from deepearth_tpu_torch.models import fusion as tfusion
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.ops import moe
from deepearth_tpu_torch.ops import remat as remat_sites
from deepearth_tpu_torch.training import (
    LossWeights,
    TrainState,
    create_optimizer,
    deepearth_loss,
    make_train_step,
)

torch.set_num_threads(2)

B, D, S_VISION, S_LANGUAGE = 2, 64, 20, 5
NATIVE = {"vision": S_VISION, "language": S_LANGUAGE}
MOE_AUX = 0.1
POLICIES = ["full", "dots", "dots_saveable"]
aten = torch.ops.aten


def flagship_config(pkg, remat=False, policy="full", dropout=0.0):
    """The tiny flagship in the JAX package's (``pkg`` = its configs) or the
    port's terms, with remat on every stack that has it."""
    cfg = pkg.integrated_config(
        universal_dim=D, num_fusion_layers=2, use_deepseek_fusion=True,
        grid4d=pkg.Grid4DConfig(n_spatial_levels=4, n_temporal_levels=2,
                                hash_table_size=2 ** 12),
        compute_dtype=jnp.float32 if pkg is jcfg else torch.float32)
    cfg.fusion.remat, cfg.fusion.remat_policy = remat, policy
    cfg.fusion.dropout = dropout
    ds = cfg.fusion.deepseek_block
    cfg.fusion.deepseek_block = dataclasses.replace(
        ds, mla=dataclasses.replace(ds.mla, attention_dropout=dropout))
    for m in cfg.modalities.values():
        m.encoder_remat, m.encoder_remat_policy = remat, policy
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


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def port_model(cfg, seed=0):
    return DeepEarthModel(cfg, generator=torch.Generator().manual_seed(seed),
                          device="cpu", native_seq_lens=NATIVE)


def port_loss(model, cfg, batch, generator=None):
    with tds.collect_moe_aux_losses(model) as aux:
        out = model(batch, generator=generator)
    return deepearth_loss(out, batch, cfg, LossWeights(moe_aux=MOE_AUX),
                          {"moe_aux_loss": aux})


def train_run(remat, policy, steps=3):
    """3 train steps with dropout 0.1 in the fusion layers and the MLA,
    masking on, from seed 0's parameters and a generator seeded 3: the
    metrics, the parameters and the generator's state after."""
    cfg = flagship_config(tcfg, remat, policy, dropout=0.1)
    model = port_model(cfg)
    state = TrainState(model, create_optimizer(model.parameters(),
                                               cfg.optimizer))
    step = make_train_step(model, cfg, LossWeights(moe_aux=MOE_AUX))
    g = torch.Generator().manual_seed(3)
    metrics = []
    for i in range(steps):
        state, m = step(state, to_torch(numpy_batch(10 + i)), g)
        metrics.append({k: v.item() for k, v in m.items()})
    return (metrics, {n: p.detach().clone()
                      for n, p in model.named_parameters()}, g.get_state())


@pytest.fixture(scope="module")
def no_remat_run():
    return train_run(False, "full")


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_no_remat_bit_for_bit_with_dropout(policy,
                                                         no_remat_run):
    """The recompute draws its dropout masks from a copy of the generator
    set to its state at the block's entry: the forward's masks, and the
    caller's generator ends where it ends without remat."""
    metrics, params, gen_state = train_run(True, policy)
    ref_metrics, ref_params, ref_state = no_remat_run
    assert metrics == ref_metrics
    assert metrics[0]["loss/moe_aux"] > 0
    for name, p in ref_params.items():
        assert torch.equal(params[name], p), name
    assert torch.equal(gen_state, ref_state)


def test_dropout_is_live_in_the_bit_for_bit_run(no_remat_run):
    """Another generator seed gives another loss: the masks the remat run
    replays are real draws."""
    cfg = flagship_config(tcfg, False, dropout=0.1)
    model = port_model(cfg).train()
    batch = to_torch(numpy_batch(10))
    losses = []
    for seed in (3, 4):
        torch.manual_seed(0)
        losses.append(port_loss(model, cfg, batch,
                                torch.Generator().manual_seed(seed))[0].item())
    assert losses[0] != losses[1]


def stack(mode="ragged", remat=False, policy="full", n_layers=3):
    """A DeepSeek stack of width 64 (layer 0 dense, the rest MoE: 8 experts,
    top-2), the MoE dispatch forced to ``mode``."""
    cfg = tcfg.DeepSeekBlockConfig(
        hidden_dim=D, n_layers=n_layers, intermediate_size=96,
        mla=tcfg.MLAConfig(hidden_dim=D, n_heads=4, kv_lora_rank=16,
                           qk_rope_head_dim=8, qk_nope_head_dim=16,
                           v_head_dim=12),
        moe=tcfg.MoEConfig(n_routed_experts=8, num_experts_per_tok=2,
                           moe_intermediate_size=48, hidden_dim=D,
                           dispatch_mode=mode))
    return tds.DeepSeekTransformer(
        cfg, Init(torch.Generator().manual_seed(0), "cpu"), torch.float32,
        remat=remat, remat_policy=policy)


class OpCounter(TorchDispatchMode):
    """Counts the aten ops that run, and apart those that run inside a
    kernel site."""

    def __init__(self):
        super().__init__()
        self.ops, self.in_kernel = {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        table = self.in_kernel if remat_sites.in_kernel_site() else self.ops
        table[func] = table.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def backward_ops(module, x, **kwargs):
    """The ops the backward of sum(module(x)) runs, and those its forward
    ran inside kernel sites."""
    x = x.clone().requires_grad_(True)
    with OpCounter() as fwd:
        out = module(x, **kwargs)
    with OpCounter() as bwd:
        out.float().square().sum().backward()
    return bwd, fwd


def count(table, *ops):
    return sum(table.get(op, 0) for op in ops)


def test_dots_recompute_no_unbatched_matmul():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 11, D)).astype(np.float32))
    runs = {pol: backward_ops(stack(remat=pol is not None,
                                    policy=pol or "full"), x)
            for pol in (None, "full", "dots", "dots_saveable")}
    mm = (aten.mm.default, aten.addmm.default)
    bmm = (aten.bmm.default, aten.baddbmm.default)
    base = runs[None][0]
    # full remat runs the forward's matmuls again; dots keeps them
    assert count(runs["full"][0].ops, *mm) > count(base.ops, *mm)
    assert count(runs["dots"][0].ops, *mm) == count(base.ops, *mm)
    assert count(runs["dots_saveable"][0].ops, *mm) == count(base.ops, *mm)
    # the attention's batched products: recomputed under dots, kept under
    # dots_saveable
    assert count(runs["dots"][0].ops, *bmm) > count(base.ops, *bmm)
    assert count(runs["dots_saveable"][0].ops, *bmm) == count(base.ops, *bmm)


@pytest.mark.parametrize("policy", ["dots", "dots_saveable"])
def test_dots_policies_recompute_kernels(policy):
    """K5 (the ragged MoE's grouped matmul) and K1 (a token-major fusion
    stack's attention) run their forwards again in the backward, every op
    inside them too: a kernel's output is never saved."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, 11, D)).astype(np.float32))
    bwd, fwd = backward_ops(stack(remat=True, policy=policy), x)
    assert fwd.in_kernel and bwd.in_kernel == fwd.in_kernel
    plain_bwd, _ = backward_ops(stack(), x)
    assert not plain_bwd.in_kernel

    fcfg = tcfg.FusionConfig(universal_dim=D, num_fusion_layers=2,
                             num_heads=4)
    init = Init(torch.Generator().manual_seed(1), "cpu")
    layer = tfusion.FusionLayer(fcfg, 0, init, torch.float32)
    wrapped = tds.remat_wrap(layer, policy)
    tm = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (3, B, D)).astype(np.float32))  # token-major (N, B, D)
    bwd, fwd = backward_ops(
        lambda h: wrapped(h, h, token_major=True), tm)
    # K1 at the self- and cross-attention sites
    assert fwd.in_kernel and bwd.in_kernel == fwd.in_kernel


@pytest.mark.parametrize("policy", POLICIES)
def test_routing_repeats_in_the_recompute(policy, monkeypatch):
    """Each MoE gate call of the recompute chooses the experts the forward
    chose (a flip would change no shape: the checkpoint's own check cannot
    see it)."""
    calls = []
    real = moe.moe_gate

    def gate(*args, **kwargs):
        g = real(*args, **kwargs)
        calls.append((remat_sites.is_recomputing(), g.topk_idx.clone()))
        return g
    monkeypatch.setattr(moe, "moe_gate", gate)
    model = stack(remat=True, policy=policy)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, 11, D)).astype(np.float32)).requires_grad_(True)
    model(x).square().sum().backward()
    forward = [idx for again, idx in calls if not again]
    # the backward recomputes the last block first
    recompute = [idx for again, idx in calls if again][::-1]
    assert len(forward) == len(recompute) == 2
    for a, b in zip(forward, recompute):
        assert torch.equal(a, b)


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("policy", POLICIES)
def test_aux_loss_gradient_and_hook_under_remat(policy, early_stop):
    """The aux loss leaves each block by the module and the hook: with a
    backward run inside ``collect_moe_aux_losses`` the hook gives one value
    per MoE call, and the aux loss's gradient equals the one without
    remat. Without the checkpoint's early stop the recompute runs each
    MoE layer's forward to its end, hook and all."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, 11, D)).astype(np.float32))
    grads = {}
    for remat in (False, True):
        model = stack("scatter", remat, policy)
        with tds.collect_moe_aux_losses(model) as aux, \
                torch_checkpoint.set_checkpoint_early_stop(early_stop):
            out = model(x)
            loss = out.square().mean() + sum(aux)
            loss.backward()
            assert len(aux) == 2
        # the layers keep the forward's values, not the recompute's
        assert model.layer_1.moe.aux_loss is aux[0]
        assert model.layer_2.moe.aux_loss is aux[1]
        routers = [m.router_weight.grad for m in model.modules()
                   if isinstance(m, MoELayer)]
        assert all(g is not None and g.abs().sum() > 0 for g in routers)
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
        layer = model.layer_1.moe
        assert layer.mode == "scatter" and layer.aux_loss.requires_grad
    assert grads[False].keys() == grads[True].keys()
    for name, g in grads[False].items():
        assert torch.equal(grads[True][name], g), name


def test_unknown_policy_raises_jax_error():
    with pytest.raises(ValueError) as jax_err:
        jds.remat_wrap(jds.DeepSeekBlock, (2, 3), policy="offload")
    with pytest.raises(ValueError) as port_err:
        stack(remat=True, policy="offload")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as wrap_err:
        tds.remat_wrap(torch.nn.Identity(), "offload")
    assert str(wrap_err.value) == str(jax_err.value)
    for empty in (None, ""):
        assert tds.remat_context_fn(empty) is None


def test_no_checkpoint_without_grad():
    """In eval under no_grad the wrapped stack runs as the plain one."""
    model = stack("scatter", True, "dots").eval()
    plain = stack("scatter").eval()
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (B, 11, D)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(model(x), plain(x))
