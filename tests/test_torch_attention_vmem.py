"""The port's mid-length attention (K3's plain versions) and
``dot_product_attention`` against the JAX package, on the CPU.

JAX's ``vmem_attention`` runs its Pallas kernels in interpret mode here, as
the JAX package's own tests run them; its gradients come from ``jax.vjp``,
which runs the backward kernel ``_bwd_kernel``. Inputs are numpy arrays from
a seed in fp32. Forward tolerance 2e-5 absolute: the same fp32 softmax,
summed in another order. Backward: 2e-5 of each gradient's largest entry in
fp32; in bf16 one bf16 ulp of it (both sides round p, ds and the results at
the same places, but their fp32 sums differ in order, so a rounded value may
land on the other neighbour). A row whose keys are all masked must give
exactly 0 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu.ops import attention as jattn
from deepearth_tpu.ops import attention_vmem as jvmem
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.ops import attention as tattn
from deepearth_tpu_torch.ops import attention_vmem as tvmem

torch.set_num_threads(2)

TOL = 2e-5


def inputs(seed, b, h, nq, nk, dqk, dv, mask=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, dqk)).astype(np.float32)
    k = rng.standard_normal((b, h, nk, dqk)).astype(np.float32)
    v = rng.standard_normal((b, h, nk, dv)).astype(np.float32)
    key_mask = None
    if mask:
        key_mask = rng.uniform(size=(b, nk)) > 0.3
        key_mask[0] = False  # a row that sees no key at all
    return q, k, v, key_mask


def both(arrays):
    """The same arrays as JAX arrays and as torch tensors."""
    jx = [None if a is None else jnp.asarray(a) for a in arrays]
    tx = [None if a is None else torch.from_numpy(a) for a in arrays]
    return jx, tx


@pytest.mark.parametrize("shape,mask", [
    ((2, 2, 300, 300, 48, 32), False),  # MLA self-attention, Dqk != Dv
    ((2, 2, 16, 276, 64, 64), False),  # query-token cross-attention
    ((2, 2, 100, 260, 48, 80), True),  # everything ragged, masked keys
    ((2, 1, 33, 1024, 16, 8), True),  # the longest key row
], ids=["mla", "cross", "ragged_masked", "nk1024"])
def test_plain_matches_jax_kernel(shape, mask):
    b, h, nq, nk, dqk, dv = shape
    (jq, jk, jv, jm), (tq, tk, tv, tm) = both(
        inputs(nq + nk, b, h, nq, nk, dqk, dv, mask))
    scale = dqk ** -0.5
    ref = np.asarray(jvmem.vmem_attention(jq, jk, jv, scale=scale,
                                          key_mask=jm, interpret=True))
    kernels.reset_launch_counts()
    plain = tvmem.vmem_attention_plain(tq, tk, tv, scale=scale, key_mask=tm)
    wrapped = tvmem.vmem_attention(tq, tk, tv, scale=scale, key_mask=tm)
    assert kernels.launch_counts["vmem_attention_fwd"] == 0  # CPU: plain
    for out in (plain, wrapped):
        assert out.shape == (b, h, nq, dv) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
    if mask:
        assert not ref[0].any() and not plain[0].any()
        assert np.abs(ref[1:]).max() > 0


@pytest.mark.parametrize("case", ["plain", "key_mask", "bias", "causal",
                                  "causal_cross", "short", "dqk_ne_dv"])
def test_dot_product_attention_matches_jax(case):
    b, h, nq, nk, dqk, dv = 2, 3, 20, 20, 16, 16
    if case == "causal_cross":
        nq, nk = 7, 20
    if case == "short":
        nq, nk = 23, 23  # the batch-major fusion stack's length
    if case == "dqk_ne_dv":
        nq, nk, dqk, dv = 9, 300, 48, 32  # K3's shape gate, on the CPU
    q, k, v, mask = inputs(11, b, h, nq, nk, dqk, dv, mask=case == "key_mask")
    bias = None
    if case == "bias":
        bias = np.random.default_rng(3).standard_normal(
            (1, h, nq, nk)).astype(np.float32)
    (jq, jk, jv, jm, jb), (tq, tk, tv, tm, tb) = both([q, k, v, mask, bias])
    kw = dict(scale=dqk ** -0.5, is_causal=case.startswith("causal"))
    ref = np.asarray(jattn.dot_product_attention(jq, jk, jv, key_mask=jm,
                                                 attn_bias=jb, **kw))
    out = tattn.dot_product_attention(tq, tk, tv, key_mask=tm, attn_bias=tb,
                                      **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
    if case == "key_mask":
        assert not out[0].any() and not ref[0].any()


def test_cpu_gradients_match_jax_kernel():
    """On the CPU the autograd.Function differentiates its plain version;
    JAX differentiates through its backward kernel in interpret mode.
    Tolerance 5e-5 absolute, 5e-4 relative, as the JAX package holds its
    backward kernel against its einsum path."""
    q, k, v, mask = inputs(5, 1, 2, 40, 288, 32, 24, mask=True)
    mask[0, :] = True
    mask[0, :7] = False
    (jq, jk, jv, jm), (tq, tk, tv, tm) = both([q, k, v, mask])
    scale = 32 ** -0.5

    def jloss(q, k, v):
        o = jvmem.vmem_attention(q, k, v, scale=scale, key_mask=jm,
                                 interpret=True)
        return jnp.sum(o * jnp.cos(o))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    o = tvmem.vmem_attention(*leaves, scale=scale, key_mask=tm)
    (o * torch.cos(o)).sum().backward()
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   atol=5e-5, rtol=5e-4)


@pytest.mark.parametrize("args", [
    (576, 576, 128, 128, False, False), (16, 576, 128, 128, False, False),
    (576, 576, 48, 32, False, False), (1024, 1024, 128, 128, False, False),
    (1, 256, 8, 8, False, False), (576, 576, 128, 128, True, False),
    (576, 576, 128, 128, False, True), (16, 128, 128, 128, False, False),
    (16, 255, 64, 64, False, False), (2048, 2048, 128, 128, False, False),
    (16, 1025, 64, 64, False, False), (1025, 576, 64, 64, False, False),
    (576, 576, 256, 128, False, False), (576, 576, 128, 129, False, False),
    (23, 23, 64, 64, False, False), (4, 1, 64, 64, False, False),
])
def test_supported_truth_table_matches_jax(args):
    assert tvmem.supported(*args) == jvmem.supported(*args)


def test_routes_to_the_kernel_only_on_the_card():
    """A CPU tensor at a K3 shape takes the plain path: no launch."""
    _, (tq, tk, tv, _) = both(inputs(1, 1, 1, 16, 300, 32, 32))
    kernels.reset_launch_counts()
    out = tattn.dot_product_attention(tq, tk, tv, scale=0.2)
    assert out.shape == (1, 1, 16, 32)
    assert set(kernels.launch_counts.values()) == {0}


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(float(np.abs(x).max()))) - 7)


def _jax_bwd(arrays, do, scale, dtype):
    """JAX's outputs and gradients through its kernels in interpret mode."""
    jq, jk, jv, jm = (None if a is None else jnp.asarray(a) for a in arrays)
    jq, jk, jv = (x.astype(dtype) for x in (jq, jk, jv))
    out, vjp = jax.vjp(lambda q, k, v: jvmem.vmem_attention(
        q, k, v, scale=scale, key_mask=jm, interpret=True), jq, jk, jv)
    grads = vjp(jnp.asarray(do).astype(dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


BWD_CASES = {  # name: ((B, H, Nq, Nk, Dqk, Dv), key mask, dtype)
    "mla_fp32": ((2, 2, 300, 300, 48, 32), False, "fp32"),
    "masked_fp32": ((2, 2, 100, 260, 48, 80), True, "fp32"),
    "mla_bf16": ((2, 2, 300, 300, 48, 32), False, "bf16"),
    "cross_masked_bf16": ((2, 2, 16, 276, 64, 64), True, "bf16"),
}


@pytest.mark.parametrize("name", list(BWD_CASES))
def test_bwd_plain_matches_jax_kernel(name):
    """vmem_attention_bwd_plain against jax.vjp through _bwd_kernel; with a
    key mask, batch row 0 sees no key: its dq is 0, and masked keys get no
    dk or dv."""
    (b, h, nq, nk, dqk, dv), mask, dtype = BWD_CASES[name]
    q, k, v, key_mask = inputs(nq + dqk, b, h, nq, nk, dqk, dv, mask)
    do = np.random.default_rng(nk).standard_normal((b, h, nq, dv)).astype(
        np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    scale = dqk ** -0.5
    ref = _jax_bwd([q, k, v, key_mask], do, scale, jdt)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    tm = None if key_mask is None else torch.from_numpy(key_mask)
    got = tvmem.vmem_attention_bwd_plain(tq, tk, tv, tdo, scale=scale,
                                         key_mask=tm)
    for g, r, label in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == tdt
        tol = (2e-5 * np.abs(r).max() if dtype == "fp32" else _bf16_ulp(r))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0, atol=tol,
                                   err_msg=label)
    if mask:
        assert not got[0][0].any() and not ref[0][0].any()
        hidden = ~key_mask[:, None, :, None]
        for g in got[1:]:
            assert not g.float().numpy()[np.broadcast_to(hidden,
                                                         g.shape)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cpu_backward_is_the_plain_bwd(dtype):
    """The autograd.Function's CPU backward is vmem_attention_bwd_plain,
    bit for bit."""
    q, k, v, key_mask = inputs(21, 2, 2, 64, 280, 48, 32, mask=True)
    do = np.random.default_rng(22).standard_normal((2, 2, 64, 32)).astype(
        np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    tm = torch.from_numpy(key_mask)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    tvmem.vmem_attention(*leaves, scale=0.15, key_mask=tm).backward(tdo)
    want = tvmem.vmem_attention_bwd_plain(tq, tk, tv, tdo, scale=0.15,
                                          key_mask=tm)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


def test_bf16_backward_rounds_where_the_jax_kernel_rounds():
    """The repair: differentiating the plain forward with autograd (the
    CPU backward before) rounds dp = dout . v^T to bf16 on its way back
    through p's cast and never rounds ds, so in bf16 about half of its dq
    and dk entries differ from JAX's _bwd_kernel; vmem_attention_bwd_plain
    rounds where the kernel does, and under 1% differ (by one ulp, where
    the two fp32 sums round to different neighbours)."""
    q, k, v, _ = inputs(31, 2, 2, 300, 300, 48, 32)
    do = np.random.default_rng(32).standard_normal((2, 2, 300, 32)).astype(
        np.float32)
    scale = 48 ** -0.5
    ref = _jax_bwd([q, k, v, None], do, scale, jnp.bfloat16)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tvmem.vmem_attention_plain(*leaves, scale=scale)
    autograd = torch.autograd.grad(out, leaves, tdo)
    plain = tvmem.vmem_attention_bwd_plain(tq, tk, tv, tdo, scale=scale)
    for a, p, r, label in zip(autograd, plain, ref, ("dq", "dk", "dv")):
        assert np.abs(p.float().numpy() - r).max() <= _bf16_ulp(r), label
        assert (p.float().numpy() != r).mean() < 0.01, label
        if label != "dv":  # dq and dk go through ds
            assert (a.float().numpy() != r).mean() > 0.1, label
