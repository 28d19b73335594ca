"""The PyTorch port's token-major pairwise attention and RoPE against the JAX
package, on the CPU, forward and backward (jax.vjp against the port's
autograd.Function). The K1 CUDA kernels are held against their plain
versions in tests/test_torch_kernels_cuda.py.

CPU tolerance: 5e-6 absolute in fp32, as the JAX package's own tests of the
same function use (sums in another order over Dh <= 64 terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepearth_tpu.ops import attention_smallseq as jattn
from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.ops import attention_smallseq as tattn

torch.set_num_threads(2)

TOL = 5e-6


def qkv_np(seed, nq, nk, b, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((nq, b, d), (nk, b, d), (nk, b, d)))


def run_both(q, k, v, heads, key_mask=None, use_kernel=False, scale=None):
    scale = (q.shape[-1] // heads) ** -0.5 if scale is None else scale
    ref = jattn.pairwise_token_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_heads=heads,
        scale=scale, use_kernel=use_kernel,
        key_mask=None if key_mask is None else jnp.asarray(key_mask))
    out = tattn.pairwise_token_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        n_heads=heads, scale=scale,
        key_mask=None if key_mask is None else torch.from_numpy(key_mask))
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("nq,nk", [(3, 3), (2, 4)])
def test_plain_matches_pallas_kernel_interpret(nq, nk):
    """JAX's Pallas core in interpret mode (B % 256 == 0, D % 128 == 0)."""
    q, k, v = qkv_np(nq * 10 + nk, nq, nk, 256, 256)
    out, ref = run_both(q, k, v, heads=4, use_kernel=True)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("nq,nk", [(3, 3), (2, 5), (5, 2)])
@pytest.mark.parametrize("mask", ["none", "random", "some_rows_dead"])
def test_plain_matches_jax_with_key_masks(nq, nk, mask):
    b, heads = 8, 12
    q, k, v = qkv_np(nq + nk, nq, nk, b, 768)
    key_mask = None
    if mask != "none":
        rng = np.random.default_rng(nk)
        key_mask = rng.uniform(size=(b, nk)) > 0.4
        if mask == "some_rows_dead":
            key_mask[::2] = False
    out, ref = run_both(q, k, v, heads, key_mask=key_mask)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    if mask == "some_rows_dead":
        assert (out[:, ::2] == 0.0).all()


def test_all_keys_masked_gives_zeros():
    q, k, v = qkv_np(1, 3, 3, 4, 96)
    out, ref = run_both(q, k, v, 6, key_mask=np.zeros((4, 3), bool))
    assert (out == 0.0).all() and (ref == 0.0).all()


def test_output_keeps_query_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in qkv_np(2, 3, 3, 4, 64))
    out = tattn.pairwise_token_attention(q, k, v, n_heads=2, scale=0.125)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("n,heads,d", [(3, 12, 768), (5, 4, 64), (1, 2, 32)])
def test_rope_token_major_matches_jax(n, heads, d):
    x = np.random.default_rng(n).standard_normal((n, 7, d)).astype(np.float32)
    ref = jattn.rope_token_major(jnp.asarray(x), heads)
    out = tattn.rope_token_major(torch.from_numpy(x), heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    kernels.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in qkv_np(3, 3, 3, 4, 64))
    out = tattn.pairwise_token_attention(q, k, v, n_heads=2, scale=0.125)
    ref = tattn.pairwise_token_attention_plain(q, k, v, n_heads=2, scale=0.125)
    assert torch.equal(out, ref)
    assert kernels.launch_counts["pairwise_attention_fwd"] == 0


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((3, 4, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tattn.pairwise_token_attention(q, q, q, n_heads=2, scale=0.125)


# --------------------------------------------------------------------------- #
# backward (K1-bwd's plain version and the autograd.Function around K1)
# --------------------------------------------------------------------------- #


def grads_both(q, k, v, do, heads, key_mask=None, use_kernel=False):
    """(dq, dk, dv) from jax.vjp of the JAX function and from the port's
    autograd.Function, as numpy."""
    scale = (q.shape[-1] // heads) ** -0.5
    jm = None if key_mask is None else jnp.asarray(key_mask)
    _, vjp = jax.vjp(lambda a, b, c: jattn.pairwise_token_attention(
        a, b, c, n_heads=heads, scale=scale, key_mask=jm,
        use_kernel=use_kernel), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tattn.pairwise_token_attention(
        tq, tk, tv, n_heads=heads, scale=scale,
        key_mask=None if key_mask is None else torch.from_numpy(key_mask))
    out.backward(torch.from_numpy(do))
    return [t.grad.numpy() for t in (tq, tk, tv)], [np.asarray(r) for r in ref]


def test_bwd_matches_pallas_bwd_kernel_interpret():
    """JAX's _pw_bwd_kernel in interpret mode (unmasked; B % 256 == 0,
    D % 128 == 0)."""
    q, k, v = qkv_np(11, 3, 3, 256, 128)
    do = np.random.default_rng(12).standard_normal((3, 256, 128)).astype(
        np.float32)
    got, ref = grads_both(q, k, v, do, heads=2, use_kernel=True)
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("nq,nk", [(3, 3), (2, 5)])
@pytest.mark.parametrize("mask", ["none", "random", "some_rows_dead"])
def test_bwd_matches_jax_xla_path(nq, nk, mask):
    """jax.vjp through the XLA path, with key masks; rows with no visible
    key get zero gradients, as the jnp.where in the JAX function gives."""
    b = 8
    q, k, v = qkv_np(nq * nk, nq, nk, b, 96)
    do = np.random.default_rng(nk).standard_normal((nq, b, 96)).astype(
        np.float32)
    key_mask = None
    if mask != "none":
        key_mask = np.random.default_rng(nq).uniform(size=(b, nk)) > 0.4
        if mask == "some_rows_dead":
            key_mask[::2] = False
    got, ref = grads_both(q, k, v, do, heads=6, key_mask=key_mask)
    for name, a, r in zip("qkv", got, ref):
        np.testing.assert_allclose(a, r, atol=TOL, rtol=0, err_msg=f"d{name}")
        if mask == "some_rows_dead":
            assert (a[:, ::2] == 0.0).all()


@pytest.mark.parametrize("mask", [False, True])
def test_function_matches_autograd_of_the_plain_forward(mask):
    q, k, v = (torch.from_numpy(x).double().float()
               for x in qkv_np(21, 3, 4, 5, 64))
    do = torch.randn((3, 5, 64), generator=torch.Generator().manual_seed(0))
    key_mask = None
    if mask:
        key_mask = torch.tensor([[1, 0, 1, 0], [0, 0, 0, 0], [1, 1, 1, 1],
                                 [0, 0, 0, 1], [1, 0, 0, 0]], dtype=torch.bool)
    grads = []
    for fn in (tattn.pairwise_token_attention,
               tattn.pairwise_token_attention_plain):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves, n_heads=4, scale=0.25, key_mask=key_mask).backward(do)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_bwd_plain_keeps_dtype_and_takes_strided_views():
    """q, k, v as the fused qkv projection leaves them, in bf16."""
    qkv = torch.randn((3, 4, 3 * 64), generator=torch.Generator().manual_seed(1))
    q, k, v = qkv.to(torch.bfloat16).chunk(3, dim=-1)
    do = torch.randn((3, 4, 64)).to(torch.bfloat16)
    dq, dk, dv = tattn.pairwise_token_attention_bwd_plain(
        q, k, v, do, n_heads=2, scale=0.125)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    ref = tattn.pairwise_token_attention_bwd_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), do, n_heads=2,
        scale=0.125)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)


def test_cpu_backward_launches_no_kernel():
    kernels.reset_launch_counts()
    q = torch.randn((3, 4, 64), requires_grad=True)
    tattn.pairwise_token_attention(q, q, q, n_heads=2, scale=0.125).sum() \
        .backward()
    assert q.grad is not None
    assert set(kernels.launch_counts.values()) == {0}
