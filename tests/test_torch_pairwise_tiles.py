"""The arithmetic order of K1's streaming routes, forward and backward, on
the CPU.

No CUDA kernel runs here, so ``kernels/csrc/pairwise_attention_fwd_tma.cu``
and ``pairwise_attention_bwd_tma.cu`` (whose loads, dots, butterfly and
softmax are ``pairwise_stream.cuh``'s) are written out in plain PyTorch as
the kernels run them, per (batch row, head) and for all of them at once,
and held against the JAX package's ``_pw_fwd_kernel`` and ``_pw_bwd_kernel``
(its Pallas kernels in interpret mode, through
``pairwise_token_attention(use_kernel=True)`` and its ``jax.vjp``), against
the JAX function's XLA path with key masks, and against
``pairwise_token_attention_plain`` and ``pairwise_token_attention_bwd_plain``:

- 8 lanes a (row, head), lane l holding the head's 16-byte vectors l,
  l + 8, ... (loaded into registers):
  each lane's partial dot over its elements in order, then a butterfly
  over the 8 lanes (xor 4, 2, 1);
- the scores scaled, a masked key at -1e30, p = exp(s - max) / sum with
  the max and the sum taken in key order, 0 for a row with no visible key
  (one function in both directions, so the forward's p is the backward's
  bit for bit);
- forward: o_i = sum_j p_ij v_j in key order from 0, then one cast;
- backward: delta_i = sum_j p_ij dp_ij in key order, ds_ij = p_ij (dp_ij -
  delta_i) scale; dq_i = sum_j ds_ij k_j in key order, dk_j = sum_i ds_ij
  q_i and dv_j = sum_i p_ij do_i in query order, each from 0, then one cast.

Limits: in fp32 (bf16-valued inputs, the written-out order's fp32 result)
5e-6 absolute, as ``tests/test_torch_attention_smallseq.py`` holds the port
against JAX (sums in another order over Dh <= 64 terms); in bf16 the card's
K1-bwd limit (chip_smoke.ATTN_BWD_TOL): |got - ref| <= 2^-7 |ref| + 1e-4
elementwise, one rounding apart. A row with no visible key is exactly 0.
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
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
LANES = 8


def lane_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Nq, Nk, B, H) dots of a (Nq, B, H, Dh) and b (Nk, B, H, Dh) as the
    kernel sums them: each lane's elements in order, then the butterfly."""
    nvec = a.shape[-1] // 8
    parts = []
    for lane in range(LANES):
        acc = torch.zeros((a.shape[0], b.shape[0]) + a.shape[1:3])
        for vec in range(lane, nvec, LANES):
            for e in range(8):
                col = 8 * vec + e
                acc = acc + a[:, None, :, :, col] * b[None, :, :, :, col]
        parts.append(acc)
    for offset in (4, 2, 1):
        parts = [parts[lane] + parts[lane ^ offset] for lane in range(LANES)]
    return parts[0]


def stream_probs(qf, kf, scale, key_mask=None):
    """p (Nq, Nk, B, H) from fp32 (N, B, H, Dh) q and k as
    ``pairwise_stream.cuh``'s softmax takes it from the lane dots."""
    nk = kf.shape[0]
    b, n_heads = qf.shape[1:3]
    s = lane_dots(qf, kf) * scale
    visible = torch.ones((b, n_heads), dtype=torch.bool)
    if key_mask is not None:
        s = torch.where(key_mask.T[None, :, :, None], s,
                        torch.full_like(s, -1e30))
        visible = key_mask.any(dim=1)[:, None].expand(b, n_heads)
    mx = s[:, 0]
    for j in range(1, nk):
        mx = torch.maximum(mx, s[:, j])
    e = torch.exp(s - mx[:, None])
    den = e[:, 0]
    for j in range(1, nk):
        den = den + e[:, j]
    return torch.where(visible, e / den[:, None], torch.zeros_like(e))


def _heads(x, b, n_heads):
    return x.float().reshape(x.shape[0], b, n_heads, -1)


def k1_fwd_tiles(q, k, v, n_heads, scale, key_mask=None):
    """K1-fwd's streaming route in plain PyTorch. Returns the fp32 output,
    before the one cast to the inputs' type, and p."""
    nq, b, d = q.shape
    qf, kf, vf = (_heads(x, b, n_heads) for x in (q, k, v))
    p = stream_probs(qf, kf, scale, key_mask)
    out = torch.zeros_like(qf)
    for i in range(nq):
        for j in range(k.shape[0]):
            out[i] = out[i] + p[i, j][..., None] * vf[j]
    if key_mask is not None:  # exactly 0, whatever v holds
        out = torch.where(key_mask.any(dim=1)[None, :, None, None], out,
                          torch.zeros_like(out))
    return out.reshape(nq, b, d), p


def k1_bwd_tiles(q, k, v, do, n_heads, scale, key_mask=None,
                 return_p=False):
    """K1-bwd's streaming route in plain PyTorch. Returns fp32 (dq, dk, dv),
    before the one cast to the inputs' type (and p with ``return_p``)."""
    nq, b, d = q.shape
    nk = k.shape[0]
    qf, kf, vf, dof = (_heads(x, b, n_heads) for x in (q, k, v, do))
    p = stream_probs(qf, kf, scale, key_mask)
    dp = lane_dots(dof, vf)
    delta = torch.zeros_like(p[:, 0])
    for j in range(nk):
        delta = delta + p[:, j] * dp[:, j]
    ds = p * (dp - delta[:, None]) * scale
    dq = torch.zeros_like(qf)
    for i in range(nq):
        for j in range(nk):
            dq[i] = dq[i] + ds[i, j][..., None] * kf[j]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for j in range(nk):
        for i in range(nq):
            dk[j] = dk[j] + ds[i, j][..., None] * qf[i]
            dv[j] = dv[j] + p[i, j][..., None] * dof[i]
    grads = (dq.reshape(nq, b, d), dk.reshape(nk, b, d), dv.reshape(nk, b, d))
    return (*grads, p) if return_p else grads


def inputs(seed, nq, nk, b, d, fused=False, dtype=torch.bfloat16):
    """q, k, v (strided views of one fused projection with ``fused``) and
    do, bf16-valued, in ``dtype``."""
    r = np.random.default_rng(seed)
    if fused:
        qkv = torch.from_numpy(r.standard_normal((nq, b, 3 * d)).astype(
            np.float32)).to(torch.bfloat16).to(dtype)
        q, k, v = qkv.chunk(3, dim=-1)
    else:
        q, k, v = (torch.from_numpy(r.standard_normal((n, b, d)).astype(
            np.float32)).to(torch.bfloat16).to(dtype) for n in (nq, nk, nk))
    do = torch.from_numpy(r.standard_normal((nq, b, d)).astype(
        np.float32)).to(torch.bfloat16).to(dtype)
    return q, k, v, do


def mask_for(seed, b, nk, kind):
    if kind == "none":
        return None
    m = torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(b, nk)) > 0.4)
    if kind == "some_rows_dead":
        m[::3] = False
    return m


def assert_bf16_close(got, ref):
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= BF16_RTOL * ref.float().abs() + BF16_ATOL).all()), \
        diff.max().item()


@pytest.mark.parametrize("nq,nk", [(3, 3), (2, 3)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_order_matches_the_interpreted_pallas_bwd_kernel(nq, nk, dtype):
    """JAX's _pw_bwd_kernel in interpret mode (unmasked; B % 256 == 0,
    D % 128 == 0), on the same bf16-valued inputs."""
    heads, scale = 2, 0.125
    q, k, v, do = inputs(nq * 10 + nk, nq, nk, 256, 128)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b, c: jattn.pairwise_token_attention(
        a, b, c, n_heads=heads, scale=scale, use_kernel=True),
        *(jnp.asarray(x.float().numpy()).astype(jdt) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do.float().numpy()).astype(jdt))
    got = k1_bwd_tiles(q, k, v, do, heads, scale)
    for g, r in zip(got, ref):
        r = torch.from_numpy(np.array(r.astype(jnp.float32)))
        if dtype == "fp32":
            torch.testing.assert_close(g, r, atol=TOL, rtol=0)
        else:
            assert_bf16_close(g.to(torch.bfloat16), r)


CASES = {  # (Nq, Nk, B, D, H, fused qkv views)
    "A-stack heads (3, 3, Dh 64)": (3, 3, 10, 768, 12, False),
    "fused qkv views": (3, 3, 9, 768, 12, True),
    "Nq 2 Nk 3": (2, 3, 7, 256, 4, False),
    "Nq 3 Nk 1": (3, 1, 5, 128, 2, False),
    "Dh 160 (lanes of 3 and 2 vectors)": (3, 3, 6, 640, 4, False),
    "Dh 8 (one vector a head)": (1, 2, 6, 96, 12, False),
    "Dh 256 (4 vectors a lane)": (3, 3, 4, 512, 2, False),
}


@pytest.mark.parametrize("mask", ["none", "random", "some_rows_dead"])
@pytest.mark.parametrize("name", list(CASES))
def test_order_matches_plain_and_jax_with_key_masks(name, mask):
    """The plain version and jax.vjp of the JAX function's XLA path; rows
    with no visible key get exactly 0."""
    nq, nk, b, d, heads, fused = CASES[name]
    q, k, v, do = inputs(b * nk, nq, nk, b, d, fused)
    key_mask = mask_for(nq, b, nk, mask)
    scale = (d // heads) ** -0.5
    strides = [s for x in (q, k, v) for s in kernels._pairwise_strides(x)]
    assert kernels.pairwise_bwd_tma_route(torch.bfloat16, nq, nk,
                                          d // heads, strides)
    got = k1_bwd_tiles(q, k, v, do, heads, scale, key_mask)
    plain = tattn.pairwise_token_attention_bwd_plain(
        q.float(), k.float(), v.float(), do.float(), n_heads=heads,
        scale=scale, key_mask=key_mask)
    jm = None if key_mask is None else jnp.asarray(key_mask.numpy())
    _, vjp = jax.vjp(lambda a, bb, c: jattn.pairwise_token_attention(
        a, bb, c, n_heads=heads, scale=scale, key_mask=jm),
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))
    ref = vjp(jnp.asarray(do.float().numpy()))
    bf = tattn.pairwise_token_attention_bwd_plain(
        q, k, v, do, n_heads=heads, scale=scale, key_mask=key_mask)
    for g, p, r, pb in zip(got, plain, ref, bf):
        torch.testing.assert_close(g, p, atol=TOL, rtol=0)
        torch.testing.assert_close(
            g, torch.from_numpy(np.array(r)), atol=TOL, rtol=0)
        assert_bf16_close(g.to(torch.bfloat16), pb)
        if mask == "some_rows_dead":
            assert bool((g.to(torch.bfloat16)[:, ::3] == 0).all())


def test_lane_dots_sum_every_element_once():
    """The lanes' vectors cover the head exactly once at every head dim the
    route takes (lanes past the head's vectors add nothing)."""
    for head_dim in range(8, 257, 8):
        a = torch.zeros((1, 1, 1, head_dim))
        a[..., :] = 1.0
        assert lane_dots(a, a).item() == head_dim


@pytest.mark.parametrize("nq,nk", [(3, 3), (2, 3)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fwd_order_matches_the_interpreted_pallas_fwd_kernel(nq, nk, dtype):
    """JAX's _pw_fwd_kernel in interpret mode (unmasked; B % 256 == 0,
    D % 128 == 0), on the same bf16-valued inputs, at the A-stack's head
    dim (64)."""
    heads, scale = 4, 0.125
    q, k, v, _ = inputs(nq * 10 + nk + 1, nq, nk, 256, 256)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    ref = jattn.pairwise_token_attention(
        *(jnp.asarray(x.float().numpy()).astype(jdt) for x in (q, k, v)),
        n_heads=heads, scale=scale, use_kernel=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    got, _ = k1_fwd_tiles(q, k, v, heads, scale)
    if dtype == "fp32":
        torch.testing.assert_close(got, ref, atol=TOL, rtol=0)
    else:
        assert_bf16_close(got.to(torch.bfloat16), ref)


@pytest.mark.parametrize("mask", ["none", "random", "some_rows_dead"])
@pytest.mark.parametrize("name", list(CASES))
def test_fwd_order_matches_plain_and_jax_with_key_masks(name, mask):
    """The plain version and the JAX function's XLA path, in fp32, and the
    plain version in bf16; rows with no visible key get exactly 0. Every
    case is on the forward's streaming route."""
    nq, nk, b, d, heads, fused = CASES[name]
    q, k, v, _ = inputs(b * nk + 1, nq, nk, b, d, fused)
    key_mask = mask_for(nq + 1, b, nk, mask)
    scale = (d // heads) ** -0.5
    strides = [s for x in (q, k, v) for s in kernels._pairwise_strides(x)]
    assert kernels.pairwise_fwd_tma_route(torch.bfloat16, nq, nk,
                                          d // heads, strides)
    got, _ = k1_fwd_tiles(q, k, v, heads, scale, key_mask)
    plain = tattn.pairwise_token_attention_plain(
        q.float(), k.float(), v.float(), n_heads=heads, scale=scale,
        key_mask=key_mask)
    jm = None if key_mask is None else jnp.asarray(key_mask.numpy())
    ref = jattn.pairwise_token_attention(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)), n_heads=heads,
        scale=scale, key_mask=jm)
    torch.testing.assert_close(got, plain, atol=TOL, rtol=0)
    torch.testing.assert_close(got, torch.from_numpy(np.array(ref)),
                               atol=TOL, rtol=0)
    assert_bf16_close(got.to(torch.bfloat16),
                      tattn.pairwise_token_attention_plain(
                          q, k, v, n_heads=heads, scale=scale,
                          key_mask=key_mask))
    if mask == "some_rows_dead":
        assert bool((got.to(torch.bfloat16)[:, ::3] == 0).all())


@pytest.mark.parametrize("mask", ["none", "some_rows_dead"])
@pytest.mark.parametrize("name", list(CASES))
def test_fwd_and_bwd_orders_share_p_bit_for_bit(name, mask):
    """The written-out forward's p is the written-out backward's, bit for
    bit, as the two kernels share pairwise_stream.cuh's softmax."""
    nq, nk, b, d, heads, fused = CASES[name]
    q, k, v, do = inputs(b + nq, nq, nk, b, d, fused)
    key_mask = mask_for(nk, b, nk, mask)
    scale = (d // heads) ** -0.5
    _, p_fwd = k1_fwd_tiles(q, k, v, heads, scale, key_mask)
    *_, p_bwd = k1_bwd_tiles(q, k, v, do, heads, scale, key_mask,
                             return_p=True)
    assert torch.equal(p_fwd, p_bwd)
    if mask == "some_rows_dead":
        assert bool((p_fwd[:, :, ::3] == 0).all())
