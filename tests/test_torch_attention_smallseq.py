"""The PyTorch port's token-major pairwise attention and RoPE against the JAX
package, on the CPU. The K1 CUDA kernel is held against its plain version in
tests/test_torch_kernels_cuda.py.

CPU tolerance: 5e-6 absolute in fp32, as the JAX package's own tests of the
same function use (sums in another order over Dh <= 64 terms).
"""

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
