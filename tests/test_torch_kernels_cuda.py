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
changes from run to run: 1e-5 of the sum of |terms| of each row. K3-fwd
sums in another order than its plain version: 1e-5 in fp32, one bf16 ulp at
|x| < 4 in bf16 (VMEM_TOL); a row whose keys are all masked is exactly 0.
K4-fwd rounds the unnormalised p of each key tile (the library's online
softmax) where its plain version rounds the normalised p of the full row;
it is held by chip_smoke.check_flash_out: 1e-5 in fp32, two bf16 ulps of
the output's largest entry in bf16, and the mean error within 2^-8 of the
mean |plain|; its log-sum-exp within 1e-4. K3-bwd and K4-bwd are
held by chip_smoke.check_grads: each gradient within BWD_TOL of its largest
entry (1e-5 in fp32, two bf16 ulps of it in bf16) plus 1e-6; dq exactly 0
where no key is visible, dk and dv exactly 0 for a masked key.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.configs import MLAConfig
from deepearth_tpu_torch.models.deepseek import MLAttention
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.ops import attention as tdpa
from deepearth_tpu_torch.ops import attention_smallseq as tattn
from deepearth_tpu_torch.ops import attention_vmem as tvmem
from deepearth_tpu_torch.ops import flash_attention as tflash
from deepearth_tpu_torch.ops import hash_encoding as the
from deepearth_tpu_torch.training import Trainer

pytestmark = pytest.mark.cuda

ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ATTN_BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -7, 1e-4)}
HASH_BWD_TOL = 1e-5
VMEM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
NO_K3_K4 = {"vmem_attention_fwd": 0, "vmem_attention_bwd": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0}


def _smoke():
    """chip_smoke.py, at the repository's root, as a module."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


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
        assert {kernels.launch_counts[k] for k in (
            "pairwise_attention_fwd", "pairwise_attention_bwd",
            "hash_encode_fwd", "hash_encode_bwd")} == (
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
    smoke = _smoke()
    gen = torch.Generator(device=cuda).manual_seed(0)
    cfg = smoke.astack_config()
    model = DeepEarthModel(cfg, generator=gen, device=cuda)
    trainer = Trainer(model, cfg)
    state = trainer.init_state()
    batch = smoke.make_batch(gen, 4096)
    kernels.reset_launch_counts()
    state, metrics = trainer.train_step(state, batch, gen)
    torch.cuda.synchronize()
    assert kernels.launch_counts == {
        "hash_encode_fwd": 2, "hash_encode_bwd": 2,
        "pairwise_attention_fwd": 16, "pairwise_attention_bwd": 16,
        **NO_K3_K4}
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,nq,nk,dqk,dv,mask,strided", [
    (16, 8, 576, 576, 48, 32, False, True),  # the MLA site, v a view
    (16, 8, 16, 576, 64, 64, False, False),  # the cross site
    (3, 2, 100, 260, 48, 80, True, False),  # ragged, masked
    (2, 2, 33, 1024, 128, 128, True, False),  # the longest row, widest head
    (1, 1, 1, 1, 8, 8, False, False),  # one key
])
def test_vmem_attention_matches_plain(cuda, dtype, b, h, nq, nk, dqk, dv,
                                      mask, strided):
    g = torch.Generator(device=cuda).manual_seed(nq + nk)
    q = torch.randn((b, h, nq, dqk), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, h, nk, dqk), generator=g, device=cuda).to(dtype)
    if strided:  # (B, N, H, 2 Dv) sliced and transposed, as MLA leaves v
        v = torch.randn((b, nk, h, 2 * dv), generator=g, device=cuda).to(
            dtype)[..., dv:].transpose(1, 2)
    else:
        v = torch.randn((b, h, nk, dv), generator=g, device=cuda).to(dtype)
    key_mask = None
    if mask:
        key_mask = torch.rand((b, nk), generator=g, device=cuda) > 0.3
        key_mask[0] = False
    kw = dict(scale=dqk ** -0.5, key_mask=key_mask)
    kernels.reset_launch_counts()
    out = tvmem.vmem_attention(q, k, v, **kw)
    ref = tvmem.vmem_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["vmem_attention_fwd"] == 1
    assert out.dtype == dtype and out.shape == (b, h, nq, dv)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=VMEM_TOL[dtype])
    if mask:
        assert bool((out[0] == 0).all())


def test_dot_product_attention_routes_k3_shapes_to_the_kernel(cuda):
    q = torch.randn((2, 2, 16, 32), device=cuda)
    k = torch.randn((2, 2, 300, 32), device=cuda)
    kernels.reset_launch_counts()
    out = tdpa.dot_product_attention(q, k, k, scale=0.2)
    ref = tvmem.vmem_attention_plain(q, k, k, scale=0.2)
    torch.cuda.synchronize()
    assert kernels.launch_counts["vmem_attention_fwd"] == 1
    torch.testing.assert_close(out, ref, rtol=0, atol=VMEM_TOL[torch.float32])
    short = torch.randn((2, 2, 23, 32), device=cuda)
    tdpa.dot_product_attention(short, short, short, scale=0.2)
    assert kernels.launch_counts["vmem_attention_fwd"] == 1  # plain at 23


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,nq,nk,dqk,dv,mask,strided", [
    (16, 8, 576, 576, 48, 32, False, True),  # the MLA site, v a view
    (16, 8, 16, 576, 64, 64, False, False),  # the cross site
    (3, 2, 100, 260, 48, 80, True, False),  # ragged, masked
    (2, 2, 33, 1024, 128, 128, True, False),  # the longest row, widest head
    (1, 1, 1, 1, 8, 8, False, False),  # one key
])
def test_vmem_attention_bwd_matches_plain(cuda, dtype, b, h, nq, nk, dqk, dv,
                                          mask, strided):
    smoke = _smoke()
    g = torch.Generator(device=cuda).manual_seed(nq + nk + 1)
    q, k, v, dout, key_mask = smoke.attention_case(g, b, h, nq, nk, dqk, dv,
                                                   dtype, mask, strided)
    kernels.reset_launch_counts()
    got = kernels.vmem_attention_bwd(q, k, v, dout, dqk ** -0.5, key_mask)
    ref = tvmem.vmem_attention_bwd_plain(q, k, v, dout, scale=dqk ** -0.5,
                                         key_mask=key_mask)
    torch.cuda.synchronize()
    assert kernels.launch_counts["vmem_attention_bwd"] == 1
    smoke.check_grads("K3-bwd", got, ref, dtype, key_mask)


def test_vmem_attention_autograd_runs_k3_bwd(cuda):
    """Autograd through K3 on the card launches K3-fwd and K3-bwd once each
    and gives the plain backward's gradients."""
    smoke = _smoke()
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, dout, _ = smoke.attention_case(g, 4, 8, 576, 576, 48, 32,
                                            torch.bfloat16, strided=True)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    kernels.reset_launch_counts()
    out = tvmem.vmem_attention(*leaves, scale=48 ** -0.5)
    out.backward(dout)
    torch.cuda.synchronize()
    assert kernels.launch_counts["vmem_attention_fwd"] == 1
    assert kernels.launch_counts["vmem_attention_bwd"] == 1
    ref = tvmem.vmem_attention_bwd_plain(q, k, v, dout, scale=48 ** -0.5)
    # .grad keeps each leaf's strides (v is a strided view)
    smoke.check_grads("K3 autograd", [x.grad.contiguous() for x in leaves],
                      ref, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,n,dqk,dv,mask,causal,strided", [
    (2, 8, 4608, 48, 32, False, False, True),  # the 4608-patch MLA site
    (2, 4, 2048, 64, 64, False, True, False),  # causal
    (3, 2, 1000, 48, 32, True, False, False),  # ragged N, masked keys
    (2, 2, 1500, 128, 128, True, True, False),  # widest heads, both masks
    (2, 2, 1, 8, 8, False, True, False),  # one token
])
def test_flash_attention_matches_plain(cuda, dtype, b, h, n, dqk, dv, mask,
                                       causal, strided):
    smoke = _smoke()
    g = torch.Generator(device=cuda).manual_seed(n + dqk)
    q, k, v, dout, key_mask = smoke.attention_case(g, b, h, n, n, dqk, dv,
                                                   dtype, mask, strided)
    kw = dict(scale=dqk ** -0.5, key_mask=key_mask, causal=causal)
    kernels.reset_launch_counts()
    out, lse = kernels.flash_attention_fwd(q, k, v, kw["scale"], key_mask,
                                           causal)
    ref, ref_lse = tflash.flash_attention_plain(q, k, v, return_lse=True,
                                                **kw)
    got = kernels.flash_attention_bwd(q, k, v, out, lse, dout, kw["scale"],
                                      key_mask, causal)
    ref_grads = tflash.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                 **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["flash_attention_fwd"] == 1
    assert kernels.launch_counts["flash_attention_bwd"] == 1
    assert out.dtype == dtype and out.shape == (b, h, n, dv)
    smoke.check_flash_out("K4-fwd", out, ref, dtype)
    assert torch.equal(lse.isinf(), ref_lse.isinf())
    finite = ref_lse.isfinite()
    torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=0,
                               atol=1e-4)
    if mask:
        assert bool((out[0] == 0).all())  # the library would give mean(v)
    smoke.check_grads("K4-bwd", got, ref_grads, dtype, key_mask)


def test_mla_flash_gate_runs_k4_on_the_card(cuda):
    """At N >= flash_min_seq the MLA runs K4-fwd and, under autograd,
    K4-bwd, and agrees with the same module on the plain path; below it,
    neither kernel runs."""
    cfg = MLAConfig(hidden_dim=64, n_heads=4, kv_lora_rank=16,
                    qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
                    use_flash_attention=True, flash_min_seq=1024)
    mla = MLAttention(cfg, Init(torch.Generator(device=cuda).manual_seed(0),
                                cuda), torch.bfloat16)
    kernels.reset_launch_counts()
    with torch.no_grad():
        assert mla(torch.randn((1, 1023, 64), device=cuda)).shape == (
            1, 1023, 64)
    assert kernels.launch_counts["flash_attention_fwd"] == 0
    x = torch.randn((2, 1100, 64), device=cuda)
    grads = {}
    for label in ("kernel", "plain"):
        mla.zero_grad()
        kernels.reset_launch_counts()
        with (_smoke().plain_versions() if label == "plain"
              else contextlib.nullcontext()):
            out = mla(x)
            out.float().square().mean().backward()
        torch.cuda.synchronize()
        want = 1 if label == "kernel" else 0
        assert kernels.launch_counts["flash_attention_fwd"] == want
        assert kernels.launch_counts["flash_attention_bwd"] == want
        grads[label] = (out.detach(),
                        [p.grad.clone() for p in mla.parameters()])
    (out_k, g_k), (out_p, g_p) = grads["kernel"], grads["plain"]
    assert (out_k.float() - out_p.float()).abs().max().item() < 2e-2
    for a, r in zip(g_k, g_p):
        err = (a - r).abs().max().item()
        assert err <= 2e-2 * r.abs().max().item() + 1e-6, err


def test_flash_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn((1, 2, 40, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        wide = torch.randn((1, 2, 40, 192), device=cuda, dtype=torch.bfloat16)
        kernels.flash_attention_fwd(wide, wide, q, 0.1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.flash_attention_fwd(q.half(), q.half(), q.half(), 0.1)
    with pytest.raises(ValueError, match="key_mask"):
        kernels.flash_attention_fwd(q, q, q, 0.1,
                                    torch.ones((1, 39), dtype=torch.bool,
                                               device=cuda))
    with pytest.raises(ValueError, match="unit stride"):
        kernels.flash_attention_fwd(q, q, q.transpose(2, 3).contiguous()
                                    .transpose(2, 3), 0.1)
    out, lse = kernels.flash_attention_fwd(q, q, q, 0.1)
    with pytest.raises(ValueError, match="lse"):
        kernels.flash_attention_bwd(q, q, q, out, lse[:, :1], out, 0.1)
    cfg = MLAConfig(hidden_dim=64, n_heads=2, kv_lora_rank=16,
                    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
                    use_flash_attention=True, flash_min_seq=16)
    mla = MLAttention(cfg, Init(torch.Generator(device=cuda), cuda),
                      torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="item 13"):
        mla(torch.randn((1, 32, 64), device=cuda))


def test_multimodal_train_steps_launch_k3_and_k4(cuda):
    """One train step of the multimodal model at universal dim 64 with
    vision at 576 patches (K3-fwd 2, K3-bwd 2, K2 2/2) and at 4608 patches
    (K4-fwd 1, K4-bwd 1, K2 2/2), masking on, no plain version reached."""
    smoke = _smoke()
    gen = torch.Generator(device=cuda).manual_seed(0)
    cfg = smoke.multimodal_config(hidden_dim=64)
    for patches, want in (
            (576, {"vmem_attention_fwd": 2, "vmem_attention_bwd": 2}),
            (4608, {"flash_attention_fwd": 1, "flash_attention_bwd": 1})):
        model = DeepEarthModel(cfg, generator=gen, device=cuda,
                               native_seq_lens={"vision": patches})
        trainer = Trainer(model, cfg, smoke.MM_LOSS_WEIGHTS)
        state = trainer.init_state()
        batch = smoke.make_mm_batch(gen, 4, patches)
        kernels.reset_launch_counts()
        with smoke.plain_versions_refused():
            state, metrics = trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
        assert kernels.launch_counts == {
            "hash_encode_fwd": 2, "hash_encode_bwd": 2,
            "pairwise_attention_fwd": 0, "pairwise_attention_bwd": 0,
            **NO_K3_K4, **want}
        assert np.isfinite(metrics["loss/total"].item())
        assert np.isfinite(metrics["grad_norm"].item())


def test_multimodal_forward_launches_k3_twice(cuda):
    """The multimodal model at full width, one small request: K3-fwd 2,
    K2-fwd 2, K1-fwd 0 launches, finite features, no plain version."""
    smoke = _smoke()
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = DeepEarthModel(smoke.multimodal_config(), generator=gen,
                           device=cuda,
                           native_seq_lens={"vision": 576}).eval()
    batch = smoke.make_mm_batch(gen, 3)
    kernels.reset_launch_counts()
    with smoke.plain_versions_refused():
        feats = model.extract_features(batch)
    torch.cuda.synchronize()
    assert kernels.launch_counts == {
        "hash_encode_fwd": 2, "hash_encode_bwd": 0,
        "pairwise_attention_fwd": 0, "pairwise_attention_bwd": 0,
        **NO_K3_K4, "vmem_attention_fwd": 2}
    assert feats.shape == (3, 512) and bool(feats.isfinite().all())


def test_vmem_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn((1, 1, 8, 32), device=cuda)
    k = torch.randn((1, 1, 300, 32), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.vmem_attention_fwd(q.half(), k.half(), k.half(), 0.2)
    with pytest.raises(ValueError, match="at most 1024"):
        long = torch.randn((1, 1, 1025, 32), device=cuda)
        kernels.vmem_attention_fwd(q, long, long, 0.2)
    with pytest.raises(ValueError, match="head dims"):
        wide = torch.randn((1, 1, 300, 129), device=cuda)
        kernels.vmem_attention_fwd(q, k, wide, 0.2)
    with pytest.raises(ValueError, match="unit stride"):
        kernels.vmem_attention_fwd(q, k, k.transpose(2, 3).contiguous()
                                   .transpose(2, 3), 0.2)
    with pytest.raises(ValueError, match="key_mask"):
        kernels.vmem_attention_fwd(q, k, k, 0.2,
                                   torch.ones((1, 299), dtype=torch.bool,
                                              device=cuda))
