"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and nvcc, is marked ``cuda``, and skips
without a card. The file imports neither JAX nor the JAX package, because
the card's machine may have neither; ``tests/conftest.py`` does import JAX,
so there run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K2-fwd does the plain version's fp32 operations in the same
order, so it must be bit-identical. K1-fwd sums in another order: 1e-5 in
fp32; in bf16 one ulp at |x| < 4 (2^-6), since an fp32 value near a
rounding boundary may round either way. K1-bwd: the same reasons,
elementwise (ATTN_BWD_TOL). K2-bwd adds with atomics in an order that
changes from run to run: 1e-5 of the sum of |terms| of each row.
"""

import os
import sys

import numpy as np
import pytest
import torch

from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.ops import attention_smallseq as tattn
from deepearth_tpu_torch.ops import hash_encoding as the
from deepearth_tpu_torch.training import Trainer

pytestmark = pytest.mark.cuda

ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ATTN_BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -7, 1e-4)}
HASH_BWD_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc to build the kernels")
    return torch.device("cuda")


def coords(seed, n, d, device):
    """Uniform coordinates plus exact grid points of every level and 1.0."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    c[: n // 4] = rng.integers(0, 17, (n // 4, d)) / 16.0
    c[0], c[1] = 0.0, 1.0
    return torch.from_numpy(c).to(device)


@pytest.mark.parametrize("interpolation", ["linear", "nearest"])
@pytest.mark.parametrize("d,levels,table,f,table_size", [
    (3, 16, 2 ** 19, 2, None),  # A-stack spatial
    (1, 8, 2 ** 17, 2, None),  # A-stack temporal
    (3, 4, 3001, 2, None),  # T not a power of two
    (2, 3, 1024, 3, None),  # general F
    (4, 2, 1024, 1, 1000),  # hashed into part of the table
])
def test_hash_encode_matches_plain(cuda, interpolation, d, levels, table, f,
                                   table_size):
    x = coords(d, 4096, d, cuda)
    rng = np.random.default_rng(levels)
    tables = torch.from_numpy(rng.uniform(-1e-4, 1e-4, (levels, table, f))
                              .astype(np.float32)).to(cuda)
    res = torch.tensor([2.0 ** (4 + i) for i in range(levels)], device=cuda)
    kw = dict(interpolation=interpolation, table_size=table_size)
    kernels.reset_launch_counts()
    out = the.hash_encode(x, tables, res, **kw)
    ref = the.hash_encode_plain(x, tables, res, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hash_encode_fwd"] == 1
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("nq,nk,b,d,heads,mask", [
    (3, 3, 4096, 768, 12, False),  # the A-stack site
    (3, 3, 4096, 768, 12, True),
    (3, 3, 1000, 768, 12, False),  # odd B
    (2, 5, 999, 768, 12, True),  # Nq != Nk
    (3, 3, 100, 640, 4, False),  # Dh = 160: lanes loop over the head
])
def test_pairwise_attention_matches_plain(cuda, dtype, nq, nk, b, d, heads,
                                          mask):
    g = torch.Generator(device=cuda).manual_seed(b)
    q = torch.randn((nq, b, d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((nk, b, d), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    key_mask = None
    if mask:
        key_mask = torch.rand((b, nk), generator=g, device=cuda) > 0.4
        key_mask[:17] = False  # rows that see no key
    kw = dict(n_heads=heads, scale=(d // heads) ** -0.5, key_mask=key_mask)
    kernels.reset_launch_counts()
    out = tattn.pairwise_token_attention(q, k, v, **kw)
    ref = tattn.pairwise_token_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["pairwise_attention_fwd"] == 1
    assert out.dtype == dtype and out.shape == (nq, b, d)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=ATTN_TOL[dtype])
    if mask:
        assert bool((out[:, :17] == 0).all())


def test_pairwise_attention_takes_strided_views(cuda):
    """q, k, v as the fused qkv projection leaves them: views, row stride 3D."""
    qkv = torch.randn((3, 512, 3 * 768), device=cuda)
    q, k, v = qkv.chunk(3, dim=-1)
    out = tattn.pairwise_token_attention(q, k, v, n_heads=12, scale=0.125)
    ref = tattn.pairwise_token_attention_plain(q, k, v, n_heads=12,
                                               scale=0.125)
    torch.testing.assert_close(out, ref, rtol=0, atol=ATTN_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("nq,nk,b,d,heads,mask,fused", [
    (3, 3, 4096, 768, 12, False, True),  # the A-stack site, qkv views
    (3, 3, 4096, 768, 12, True, False),
    (3, 3, 1000, 768, 12, False, False),  # odd B
    (2, 5, 999, 768, 12, True, False),  # Nq != Nk
    (3, 3, 100, 640, 4, False, False),  # Dh = 160
])
def test_pairwise_attention_bwd_matches_plain(cuda, dtype, nq, nk, b, d,
                                              heads, mask, fused):
    g = torch.Generator(device=cuda).manual_seed(b + nk)
    if fused:
        q, k, v = torch.randn((nq, b, 3 * d), generator=g, device=cuda).to(
            dtype).chunk(3, dim=-1)
    else:
        q = torch.randn((nq, b, d), generator=g, device=cuda).to(dtype)
        k, v = (torch.randn((nk, b, d), generator=g, device=cuda).to(dtype)
                for _ in range(2))
    do = torch.randn((nq, b, d), generator=g, device=cuda).to(dtype)
    key_mask = None
    if mask:
        key_mask = torch.rand((b, nk), generator=g, device=cuda) > 0.4
        key_mask[:17] = False
    scale = (d // heads) ** -0.5
    kernels.reset_launch_counts()
    got = kernels.pairwise_attention_bwd(q, k, v, do, heads, scale, key_mask)
    ref = tattn.pairwise_token_attention_bwd_plain(
        q, k, v, do, n_heads=heads, scale=scale, key_mask=key_mask)
    torch.cuda.synchronize()
    assert kernels.launch_counts["pairwise_attention_bwd"] == 1
    rtol, atol = ATTN_BWD_TOL[dtype]
    for a, r in zip(got, ref):
        assert a.dtype == dtype and a.shape == r.shape and a.is_contiguous()
        diff = (a.float() - r.float()).abs()
        assert bool((diff <= rtol * r.float().abs() + atol).all()), \
            diff.max().item()
        if mask:
            assert bool((a[:, :17] == 0).all())


def test_autograd_goes_through_both_kernels(cuda):
    """Gradients through the autograd.Functions on the card equal autograd
    through the plain forwards."""
    q, k, v = torch.randn((3, 4 * 3, 256), device=cuda).chunk(3, dim=1)
    leaves = [x.contiguous().requires_grad_() for x in (q, k, v)]
    tables = torch.rand((2, 512, 2), device=cuda).requires_grad_()
    coords = torch.rand((64, 3), device=cuda)
    res = torch.tensor([16.0, 32.0], device=cuda)
    grads = {}
    for name, attn, enc in (
            ("kernel", tattn.pairwise_token_attention, the.hash_encode),
            ("plain", tattn.pairwise_token_attention_plain,
             the.hash_encode_plain)):
        kernels.reset_launch_counts()
        out = attn(*leaves, n_heads=4, scale=0.125)
        (out.square().sum() + enc(coords, tables, res).sum()).backward()
        grads[name] = [x.grad.clone() for x in (*leaves, tables)]
        for x in (*leaves, tables):
            x.grad = None
        torch.cuda.synchronize()
        assert set(kernels.launch_counts.values()) == (
            {1} if name == "kernel" else {0})
    for a, b in zip(grads["kernel"], grads["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("interpolation", ["linear", "nearest"])
@pytest.mark.parametrize("d,levels,table,f,table_size", [
    (3, 16, 2 ** 19, 2, None),  # A-stack spatial
    (1, 8, 2 ** 17, 2, None),  # A-stack temporal
    (3, 4, 3001, 2, None),
    (2, 3, 1024, 3, None),
    (4, 2, 1024, 1, 1000),
])
def test_hash_encode_bwd_matches_plain(cuda, interpolation, d, levels, table,
                                       f, table_size):
    x = coords(d + 5, 4096, d, cuda)
    g = torch.Generator(device=cuda).manual_seed(levels)
    grad_out = torch.randn((4096, levels * f), generator=g, device=cuda)
    res = torch.tensor([2.0 ** (4 + i) for i in range(levels)], device=cuda)
    shape = (levels, table, f)
    kw = dict(interpolation=interpolation, table_size=table_size)
    kernels.reset_launch_counts()
    got = kernels.hash_encode_bwd(x, grad_out, res, shape, table_size or table,
                                  interpolation == "linear")
    ref = the.hash_encode_bwd_plain(x, grad_out, res, shape, **kw)
    abs_sum = the.hash_encode_bwd_plain(x, grad_out.abs(), res, shape, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hash_encode_bwd"] == 1
    assert got.shape == shape
    assert bool(((got - ref).abs() <= HASH_BWD_TOL * abs_sum).all())
    if table_size:
        assert bool((got[:, table_size:] == 0).all())


def test_hash_encode_refuses_coords_gradient(cuda):
    with pytest.raises(NotImplementedError, match="coords"):
        the.hash_encode(torch.rand((4, 3), device=cuda, requires_grad=True),
                        torch.zeros((2, 256, 2), device=cuda),
                        torch.tensor([16.0, 32.0], device=cuda))


def test_astack_train_step_launches_every_kernel(cuda):
    """One train step of the A-stack model at B=4096 with masking: K2-fwd 2,
    K2-bwd 2, K1-fwd 16, K1-bwd 16 launches, and a finite loss."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import astack_config, make_batch

    gen = torch.Generator(device=cuda).manual_seed(0)
    cfg = astack_config()
    model = DeepEarthModel(cfg, generator=gen, device=cuda)
    trainer = Trainer(model, cfg)
    state = trainer.init_state()
    batch = make_batch(gen, 4096)
    kernels.reset_launch_counts()
    state, metrics = trainer.train_step(state, batch, gen)
    torch.cuda.synchronize()
    assert kernels.launch_counts == {
        "hash_encode_fwd": 2, "hash_encode_bwd": 2,
        "pairwise_attention_fwd": 16, "pairwise_attention_bwd": 16}
    assert np.isfinite(metrics["loss/total"].item())
    assert np.isfinite(metrics["grad_norm"].item())


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn((3, 4, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tattn.pairwise_token_attention(q.half(), q.half(), q.half(),
                                       n_heads=2, scale=0.125)
    with pytest.raises(ValueError, match="Nq\\*Nk"):
        big = torch.randn((9, 4, 64), device=cuda)
        tattn.pairwise_token_attention(big, big, big, n_heads=2, scale=0.125)
    with pytest.raises(ValueError, match="coords_dim"):
        the.hash_encode(torch.rand((4, 5), device=cuda),
                        torch.zeros((2, 256, 2), device=cuda),
                        torch.tensor([16.0, 32.0], device=cuda))
