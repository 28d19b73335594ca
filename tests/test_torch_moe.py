"""The port's MoE routing, dispatch and grouped matmul against the JAX
package, on the CPU.

``gmm_plain`` (K5's plain version) is held against the megablox ``gmm``
kernel itself, run in interpret mode as ``ragged_expert_ffn`` runs it off the
TPU. Every other function of ``ops/moe.py`` and ``MoELayer`` in each
dispatch mode are held against their JAX counterparts, with parameters from
the JAX module's ``init`` through ``load_flax_params``. Inputs are numpy
arrays from a seed, fed to both.

Tolerances: fp32 outputs to 1e-5 of each output's largest entry (the same
fp32 math summed in another order); bf16 within one bf16 ulp of the largest
entry; routing (top-k indices, dispatch and combine tensors, queue
positions, loads) exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.megablox import gmm as jax_gmm

from deepearth_tpu import configs as jcfg
from deepearth_tpu.models import deepseek as jds
from deepearth_tpu.ops import moe as jmoe
from deepearth_tpu_torch import configs as tcfg
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch import load_flax_params
from deepearth_tpu_torch.convert import _leaves, _torch_name
from deepearth_tpu_torch.models import deepseek as tds
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.ops import grouped_matmul as tgmm
from deepearth_tpu_torch.ops import moe as tmoe

torch.set_num_threads(2)

REL = 1e-5
S, D, F, E, K = 40, 32, 48, 8, 2


def close_rel(out, ref, rel=REL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref,
                               atol=rel * np.abs(ref).max(), rtol=0)


def bf16_ulp(ref) -> float:
    """One bf16 ulp of the largest entry."""
    return 2.0 ** (np.floor(np.log2(np.abs(np.asarray(ref, np.float32))
                                    .max())) - 7)


def features(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def routing(seed, n=S, e=E, k=K):
    """Top-k choices and weights from the JAX gate on random logits."""
    g = jmoe.moe_gate(jnp.asarray(features(seed, n, e)), jnp.zeros((e,)),
                      top_k=k, n_group=1, topk_group=1, norm_topk_prob=True,
                      routed_scaling_factor=1.0)
    return np.array(g.topk_idx), np.array(g.topk_weight)


# --------------------------------------------------------------------------- #
# K5's plain version against the megablox kernel
# --------------------------------------------------------------------------- #

GMM_CASES = {
    # group sizes (sum = M) and what they exercise
    "empty_group": [60, 0, 80, 116],  # M = 256, one group empty
    "ragged_m": [37, 50, 0, 113],  # M = 200: JAX pads to 256
    "straddle": [100, 60, 90, 6],  # groups cross the 128-row tiles
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_plain_matches_megablox(case, dtype):
    sizes = np.array(GMM_CASES[case], np.int32)
    m = int(sizes.sum())
    lhs, rhs = features(1, m, D), features(2, len(sizes), D, F)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # megablox wants the rows 128-aligned: pad rows on the JAX side into the
    # last group, as ragged_expert_ffn does, and slice them away
    pad = (-m) % 128
    jsizes = sizes.copy()
    jsizes[-1] += pad
    ref = jax_gmm(jnp.asarray(np.pad(lhs, ((0, pad), (0, 0))), jdt),
                  jnp.asarray(rhs, jdt), jnp.asarray(jsizes),
                  preferred_element_type=jnp.float32, tiling=(128, D, F),
                  interpret=True)
    ref = np.asarray(ref)[:m]
    out = tgmm.gmm_plain(t(lhs).to(tdt), t(rhs).to(tdt), t(sizes))
    assert out.dtype == torch.float32 and out.shape == (m, F)
    tol = REL if dtype == "float32" else bf16_ulp(ref) / np.abs(ref).max()
    close_rel(out.numpy(), ref, tol)
    assert tgmm.supported(t(lhs).to(tdt), t(rhs).to(tdt), t(sizes))


def test_gmm_cpu_backward_is_the_plain_backward():
    """On the CPU the autograd Function's backward is gmm_bwd_plain: the
    gradients of the per-group products, an empty group's weight gradient
    0."""
    sizes = t(np.array([5, 0, 9, 2], np.int32))
    lhs = t(features(3, 16, D)).requires_grad_()
    rhs = t(features(4, 4, D, F)).requires_grad_()
    dout = t(features(5, 16, F))
    tgmm.gmm(lhs, rhs, sizes).backward(dout)
    lhs2, rhs2 = (x.detach().clone().requires_grad_() for x in (lhs, rhs))
    rows = [(0, 0, 5), (2, 5, 14), (3, 14, 16)]
    ref = torch.cat([lhs2[s:e] @ rhs2[g] for g, s, e in rows])
    ref.backward(dout)
    close_rel(lhs.grad.numpy(), lhs2.grad.numpy())
    close_rel(rhs.grad.numpy(), rhs2.grad.numpy())
    assert bool((rhs.grad[1] == 0).all())


def megablox_vjp(lhs, rhs, sizes, dout, jdt):
    """jax.vjp of the megablox gmm in interpret mode, as ragged_expert_ffn
    calls it: rows padded to 128 into the last group on JAX's side (their
    cotangent 0, their dlhs sliced away), tiling clamped to the shape."""
    m, k = lhs.shape
    n = rhs.shape[2]
    pad = (-m) % 128
    jsizes = sizes.copy()
    jsizes[-1] += pad

    def f(l, r):
        return jax_gmm(l, r, jnp.asarray(jsizes),
                       preferred_element_type=jnp.float32,
                       tiling=(128, k, n), interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(np.pad(lhs, ((0, pad), (0, 0))), jdt),
                     jnp.asarray(rhs, jdt))
    dlhs, drhs = vjp(jnp.asarray(np.pad(dout, ((0, pad), (0, 0)))))
    return (np.asarray(dlhs.astype(jnp.float32))[:m],
            np.asarray(drhs.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_bwd_plain_matches_megablox_vjp(case, dtype):
    """K5-bwd's plain version against megablox's VJP (gmm with transpose_rhs
    for dlhs, tgmm for drhs) on an fp32 dout with genuine low bits: in bf16
    within one bf16 ulp of each output's largest entry (both sum in fp32 and
    round once), an empty group's drhs exactly 0."""
    sizes = np.array(GMM_CASES[case], np.int32)
    m = int(sizes.sum())
    lhs, rhs = features(6, m, D), features(7, len(sizes), D, F)
    dout = features(8, m, F)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_dlhs, ref_drhs = megablox_vjp(lhs, rhs, sizes, dout, jdt)
    dlhs, drhs = tgmm.gmm_bwd_plain(t(lhs).to(tdt), t(rhs).to(tdt), t(sizes),
                                    t(dout))
    assert dlhs.dtype == drhs.dtype == tdt
    assert dlhs.shape == (m, D) and drhs.shape == (len(sizes), D, F)
    for out, ref in ((dlhs, ref_dlhs), (drhs, ref_drhs)):
        tol = REL if dtype == "float32" else (bf16_ulp(ref)
                                              / np.abs(ref).max())
        close_rel(out.float().numpy(), ref, tol)
    for g in np.flatnonzero(sizes == 0):
        assert bool((drhs[g] == 0).all()) and not ref_drhs[g].any()


def bf16_rn(x):
    """fp32 to bf16 (as fp32 values), rounded to nearest even, by bits."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_split_dout_plain_is_the_kernels_split(scale):
    """split_dout_plain gives the split K5-bwd's kernels use (split2):
    hi = bf16_rn(x), lo = bf16_rn(x - hi), bit for bit, and hi + lo keeps x
    to 2^-16 of |x|; an x exact in bf16 has lo = 0."""
    x = features(12, 64, 40, scale=scale)
    x[0, :8] = bf16_rn(x[0, :8])
    hi, lo = tgmm.split_dout_plain(t(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert hi.shape == lo.shape == x.shape
    want_hi = bf16_rn(x)
    want_lo = bf16_rn(x - want_hi)
    np.testing.assert_array_equal(hi.float().numpy().view(np.uint32),
                                  want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.float().numpy().view(np.uint32),
                                  want_lo.view(np.uint32))
    kept = hi.double() + lo.double()
    assert bool(((kept - t(x).double()).abs()
                 <= 2.0 ** -16 * t(x).double().abs()).all())
    assert bool((lo[0, :8] == 0).all())


@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_bwd_from_split_parts_matches_megablox_vjp(case):
    """The arithmetic of K5-bwd's TMA route on bf16 lhs/rhs: dout split by
    split_dout_plain, dlhs = hi . rhs^T + lo . rhs^T and drhs = lhs^T . hi
    + lhs^T . lo, each product exact in fp32, the fp32 sums rounded once to
    bf16, against megablox's VJP at the tolerance of
    test_gmm_bwd_plain_matches_megablox_vjp (one bf16 ulp of each output's
    largest entry); an empty group's drhs exactly 0."""
    sizes = np.array(GMM_CASES[case], np.int32)
    m = int(sizes.sum())
    lhs, rhs = features(6, m, D), features(7, len(sizes), D, F)
    dout = features(8, m, F)
    ref_dlhs, ref_drhs = megablox_vjp(lhs, rhs, sizes, dout, jnp.bfloat16)
    lhs32, rhs32 = (t(x).to(torch.bfloat16).float() for x in (lhs, rhs))
    by_part = [tgmm.gmm_bwd_plain(lhs32, rhs32, t(sizes), part.float())
               for part in tgmm.split_dout_plain(t(dout))]
    dlhs, drhs = ((a + b).to(torch.bfloat16) for a, b in zip(*by_part))
    for out, ref in ((dlhs, ref_dlhs), (drhs, ref_drhs)):
        close_rel(out.float().numpy(), ref, bf16_ulp(ref) / np.abs(ref).max())
    for g in np.flatnonzero(sizes == 0):
        assert bool((drhs[g] == 0).all())


@pytest.mark.parametrize("dtype,m,k,n,tma", [
    ("bfloat16", 2816, 2048, 2048, True),  # the flagship's experts
    ("bfloat16", 1, 8, 8, True),
    ("bfloat16", 256, 96, 200, True),
    ("bfloat16", 257, 100, 130, False),  # K off the 8-element grid
    ("bfloat16", 64, 33, 31, False),
    ("bfloat16", 0, 64, 64, False),  # no rows to map
    ("float32", 64, 64, 64, False)])
def test_gmm_bwd_tma_route_is_a_rule_on_shapes(dtype, m, k, n, tma):
    """K5-bwd's TMA route: bf16, M >= 1, K and N multiples of 8 (TMA's
    16-byte row strides); the rule reads nothing but the shapes and type."""
    assert kernels.gmm_bwd_tma_route(getattr(torch, dtype), m, k, n) is tma


def test_gmm_backward_honours_needs_input_grad():
    sizes = t(np.array([5, 0, 9, 2], np.int32))
    lhs = t(features(3, 16, D)).requires_grad_()
    rhs = t(features(4, 4, D, F))
    tgmm.gmm(lhs, rhs, sizes).sum().backward()
    assert lhs.grad is not None and rhs.grad is None


# --------------------------------------------------------------------------- #
# gate, dispatch and expert functions
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n_group,topk_group,norm,scale", [
    (1, 1, True, 1.0), (2, 1, True, 2.5), (4, 2, False, 1.0),
    (2, 1, False, 0.5)])
def test_moe_gate_matches_jax(n_group, topk_group, norm, scale):
    logits = features(10, S, E, scale=2.0)
    bias = features(11, E, scale=0.1)
    kw = dict(top_k=K, n_group=n_group, topk_group=topk_group,
              norm_topk_prob=norm, routed_scaling_factor=scale)
    ref = jmoe.moe_gate(jnp.asarray(logits), jnp.asarray(bias), **kw)
    out = tmoe.moe_gate(t(logits), t(bias), **kw)
    assert out.topk_idx.dtype == torch.int32
    np.testing.assert_array_equal(out.topk_idx.numpy(),
                                  np.asarray(ref.topk_idx))
    close_rel(out.topk_weight.numpy(), ref.topk_weight)
    close_rel(out.scores.numpy(), ref.scores)


def test_top_k_breaks_ties_to_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0]], np.float32)
    values, idx = jax.lax.top_k(jnp.asarray(x), 3)
    got_v, got_i = tmoe.topk_stable(t(x), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(values))


@pytest.mark.parametrize("capacity", [3, 10, 80])
def test_dispatch_combine_and_positions_match_jax(capacity):
    """capacity 3 and 10 drop tokens (40 tokens x 2 over 8 experts); the
    priority is k-major, and both functions agree exactly with JAX."""
    idx, w = routing(12)
    ref = jmoe.make_dispatch_combine(jnp.asarray(idx), jnp.asarray(w),
                                     n_experts=E, capacity=capacity)
    out = tmoe.make_dispatch_combine(t(idx), t(w), n_experts=E,
                                     capacity=capacity)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = jmoe.position_in_expert(jnp.asarray(idx), E)
    out = tmoe.position_in_expert(t(idx), E)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if capacity < 80:
        assert float(out[1].max()) >= capacity  # some assignments drop


def expert_weights(seed, e=E):
    return (features(seed, e, D, F, scale=0.2),
            features(seed + 1, e, D, F, scale=0.2),
            features(seed + 2, e, F, D, scale=0.2))


@pytest.mark.parametrize("capacity", [4, 12])
def test_scatter_dispatch_ffn_matches_jax(capacity):
    idx, w = routing(13)
    xf = features(14, S, D)
    ws = expert_weights(15)
    ref_y, ref_load = jmoe.scatter_dispatch_ffn(
        jnp.asarray(xf), jnp.asarray(idx), jnp.asarray(w),
        *map(jnp.asarray, ws), capacity)
    y, load = tmoe.scatter_dispatch_ffn(t(xf), t(idx), t(w), *map(t, ws),
                                        capacity)
    close_rel(y.numpy(), ref_y)
    np.testing.assert_array_equal(load.numpy(), np.asarray(ref_load))


def test_dense_all_and_expert_ffn_match_jax():
    idx, w = routing(16)
    xf = features(17, S, D)
    ws = expert_weights(18)
    ref_y, ref_load = jmoe.dense_all_expert_ffn(
        jnp.asarray(xf), jnp.asarray(idx), jnp.asarray(w),
        *map(jnp.asarray, ws))
    y, load = tmoe.dense_all_expert_ffn(t(xf), t(idx), t(w), *map(t, ws))
    close_rel(y.numpy(), ref_y)
    np.testing.assert_array_equal(load.numpy(), np.asarray(ref_load))
    expert_in = features(19, E, 6, D)
    ref = jmoe.expert_ffn(jnp.asarray(expert_in), *map(jnp.asarray, ws))
    close_rel(tmoe.expert_ffn(t(expert_in), *map(t, ws)).numpy(), ref)


def test_load_balance_aux_loss_matches_jax():
    idx, _ = routing(20)
    scores = 1.0 / (1.0 + np.exp(-features(21, S, E)))
    ref = jmoe.load_balance_aux_loss(jnp.asarray(scores), jnp.asarray(idx), E)
    out = tmoe.load_balance_aux_loss(t(scores), t(idx), E)
    close_rel(out.numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_expert_ffn_matches_jax(dtype):
    """The drop-free sorted path: the port through gmm_plain, JAX through
    the megablox kernel in interpret mode. An expert no token chose is an
    empty group."""
    idx, w = routing(22)
    idx[idx == 3] = 4  # expert 3 gets nothing
    xf = features(23, S, D)
    ws = expert_weights(24)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jmoe.ragged_expert_ffn(
        jnp.asarray(xf, jdt), jnp.asarray(idx), jnp.asarray(w),
        *(jnp.asarray(x, jdt) for x in ws))
    out = tmoe.ragged_expert_ffn(t(xf).to(tdt), t(idx), t(w),
                                 *(t(x).to(tdt) for x in ws))
    assert out.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        close_rel(out.numpy(), ref)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref,
                                   atol=bf16_ulp(ref), rtol=0)


def test_ragged_expert_ffn_gradients_match_jax_vjp():
    """All five differentiable inputs (tokens, gate weights, the three
    expert weights) in fp32, through gmm_bwd_plain on the port's side and
    megablox's VJP in interpret mode on JAX's: within 1e-4 of each
    gradient's largest entry. An expert no token chose gets 0."""
    idx, w = routing(25)
    idx[idx == 5] = 6  # expert 5 gets nothing
    xf = features(26, S, D)
    ws = expert_weights(27)
    dy = features(28, S, D)
    args = (xf, w, *ws)

    def jf(x_, w_, g_, u_, d_):
        return jmoe.ragged_expert_ffn(x_, jnp.asarray(idx), w_, g_, u_, d_)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in args))
    refs = [np.asarray(r) for r in vjp(jnp.asarray(dy))]
    leaves = [t(a).requires_grad_() for a in args]
    out = tmoe.ragged_expert_ffn(leaves[0], t(idx), leaves[1], *leaves[2:])
    out.backward(t(dy))
    for name, leaf, ref in zip(("xf", "topk_weight", "w_gate", "w_up",
                                "w_down"), leaves, refs):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
    for w_ in leaves[2:]:
        assert bool((w_.grad[5] == 0).all())


# --------------------------------------------------------------------------- #
# MoELayer and its dispatch rule
# --------------------------------------------------------------------------- #

def moe_cfgs(**kw):
    base = dict(n_routed_experts=E, num_experts_per_tok=K, n_group=2,
                topk_group=1, moe_intermediate_size=F, hidden_dim=D,
                capacity_factor=1.0, n_shared_experts=1,
                routed_scaling_factor=1.5)
    base.update(kw)
    return jcfg.MoEConfig(**base), tcfg.MoEConfig(**base)


@pytest.fixture(scope="module")
def layer_inputs():
    return features(30, 2, S // 2, D)


@pytest.mark.parametrize("mode", ["dense_all", "dense", "scatter", "ragged"])
def test_moe_layer_matches_jax(mode, layer_inputs):
    """Each mode with converted params, a shared expert and capacity factor
    1.0 (dense and scatter drop tokens): output, aux loss and load."""
    jc, tc = moe_cfgs(dispatch_mode=mode)
    x = layer_inputs
    jmod = jds.MoELayer(jc, jnp.float32, jnp.float32)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = params["params"]
    ref, state = jmod.apply({"params": params}, jnp.asarray(x),
                            mutable=["intermediates"])
    mod = tds.MoELayer(tc, Init(torch.Generator().manual_seed(0), "cpu"),
                       torch.float32)
    load_flax_params(mod, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        out = mod(t(x))
    close_rel(out.numpy(), ref)
    inter = state["intermediates"]
    close_rel(mod.aux_loss.numpy(), inter["moe_aux_loss"][0])
    np.testing.assert_array_equal(mod.load.numpy(),
                                  np.asarray(inter["moe_load"][0]))
    assert mod.mode == mode


@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_moe_layer_gradients_with_aux_loss_match_jax(mode, layer_inputs):
    """The layer's output dotted with a cotangent plus 0.1 times its aux
    loss (the sown moe_aux_loss), differentiated against JAX's: every
    parameter and the input within 1e-4 of its largest entry. The aux term
    reaches the router through the gate's scores."""
    jc, tc = moe_cfgs(dispatch_mode=mode)
    x = layer_inputs
    dy = features(32, *x.shape)
    jmod = jds.MoELayer(jc, jnp.float32, jnp.float32)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    params = params["params"]

    def jloss(p, x_):
        y, state = jmod.apply({"params": p}, x_, mutable=["intermediates"])
        aux = state["intermediates"]["moe_aux_loss"][0]
        return jnp.sum(y * jnp.asarray(dy)) + 0.1 * aux

    ref_params, ref_x = jax.grad(jloss, argnums=(0, 1))(params,
                                                         jnp.asarray(x))
    mod = tds.MoELayer(tc, Init(torch.Generator().manual_seed(0), "cpu"),
                       torch.float32)
    load_flax_params(mod, jax.tree_util.tree_map(np.asarray, params))
    tx = t(x).requires_grad_()
    with tds.collect_moe_aux_losses(mod) as aux:
        y = mod(tx)
    assert len(aux) == 1 and aux[0] is mod.aux_loss
    ((y * t(dy)).sum() + 0.1 * aux[0]).backward()
    assert mod.mode == mode
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_x), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(ref_x)).max())
    ref = {_torch_name(path): (v.T if path[-1] == "kernel" else v)
           for path, v in _leaves(jax.tree_util.tree_map(np.asarray,
                                                          ref_params))}
    grads = {n: p.grad for n, p in mod.named_parameters()}
    assert set(grads) == set(ref)
    # the score-correction bias moves the choice only: JAX's gradient is 0
    assert grads.pop("e_score_correction_bias") is None
    assert not ref.pop("e_score_correction_bias").any()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=0,
                                   atol=1e-4 * np.abs(ref[name]).max(),
                                   err_msg=name)


def test_moe_layer_router_stays_fp32_under_bf16_params():
    _, tc = moe_cfgs()
    mod = tds.MoELayer(tc, Init(torch.Generator().manual_seed(0), "cpu",
                                torch.bfloat16), torch.bfloat16)
    assert mod.router_weight.dtype == torch.float32
    assert mod.e_score_correction_bias.dtype == torch.float32
    assert mod.w_gate.dtype == torch.bfloat16
    out = mod(t(features(31, 3, D)).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and mod.mode == "dense"


def flagship_moe(jax_side: bool):
    """The flagship's two MoE sites: the simulator's and the encoders'
    input projection."""
    c = jcfg if jax_side else tcfg
    sim = c.integrated_config(use_deepseek_fusion=True).fusion \
        .deepseek_block.moe
    proj = c.MoEConfig(n_routed_experts=4, num_experts_per_tok=2,
                       moe_intermediate_size=2048, hidden_dim=2048,
                       n_shared_experts=None)
    return {
        "simulator": sim, "projection": proj,
        "exact": dataclasses.replace(sim, capacity_factor=None),
        "ultra": c.simulator_config("ultra").moe,
        "budget_set": dataclasses.replace(proj, dense_all_max_bytes=2 ** 40),
        "no_ragged": dataclasses.replace(sim, allow_ragged=False),
    }


# (site, tokens): the flagship simulator at B = 1, 16, 47, 64 (22 tokens per
# observation), the vision projection at B = 16 and 64 (4608 patches)
DISPATCH_TABLE = [("simulator", 22), ("simulator", 352), ("simulator", 1034),
                  ("simulator", 1408), ("projection", 1024),
                  ("projection", 73728), ("projection", 294912),
                  ("exact", 64), ("ultra", 73728), ("budget_set", 294912),
                  ("no_ragged", 1408)]


def test_select_dispatch_mode_matches_jax():
    """On the CPU the port decides as the JAX package does on its CPU
    backend (6 GiB budget, no ragged)."""
    jsites, tsites = flagship_moe(True), flagship_moe(False)
    for site, n in DISPATCH_TABLE:
        assert tds.select_dispatch_mode(tsites[site], n, "cpu") == \
            jds.select_dispatch_mode(jsites[site], n), (site, n)
    assert tds.dense_all_activation_bytes(tsites["projection"], 294912) == \
        jds.dense_all_activation_bytes(jsites["projection"], 294912)


H100_MEMORY = 85_024_112_640  # an H100 80GB's total_memory, in bytes


@pytest.mark.parametrize("site,n,memory,want", [
    ("simulator", 22, H100_MEMORY, "dense"),
    ("simulator", 352, H100_MEMORY, "dense"),
    ("simulator", 1034, H100_MEMORY, "ragged"),
    ("simulator", 1408, H100_MEMORY, "ragged"),
    ("no_ragged", 1408, H100_MEMORY, "scatter"),
    ("projection", 294912, H100_MEMORY, "dense_all"),
    ("projection", 294912, 16 * 2 ** 30, "ragged"),
    ("ultra", 73728, H100_MEMORY, "ragged"),
])
def test_select_dispatch_mode_on_a_card(site, n, memory, want):
    """The card's branch, decided from the device type and the card's total
    memory (passed here: no card on this machine): 37.5% of it is the
    dense_all budget, and the ragged path stands where JAX's TPU rule puts
    it."""
    cfg = flagship_moe(False)[site]
    assert tds.select_dispatch_mode(cfg, n, "cuda", memory) == want
    if cfg.dense_all_max_bytes is None:
        assert tds.dense_all_budget_bytes(cfg, "cuda", memory) == \
            int(0.375 * memory)
    assert tds.dense_all_budget_bytes(cfg, "cpu") == 6 * 2 ** 30
