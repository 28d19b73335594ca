"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and nvcc, is marked ``cuda``, and skips
without a card. The file imports neither JAX nor the JAX package, because
the card's machine may have neither; ``tests/conftest.py`` does import JAX,
so there run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: K2-fwd (the Grid4D encode and the per-table kernel) does the
plain version's fp32 operations in the same order, masks by an fp32
multiply and casts once, so it must be bit-identical. K1-fwd sums in
another order: 1e-5 in fp32; in bf16 one ulp at |x| < 4 (2^-6), since an
fp32 value near a rounding boundary may round either way. K1-bwd: the same
reasons, elementwise (ATTN_BWD_TOL). K1-fwd and K1-bwd on both their routes
(the streaming kernel, the one-warp-per-(row, head) kernel), two runs
bitwise equal. K2-bwd adds with atomics in an order that changes from run
to run, on both its routes (the dense gradient written whole, scalar
atomics into a zeroed gradient): 1e-5 of the sum of |terms| of each row.
K3-fwd sums in another order than its plain version, on each route: 1e-5 in
fp32, one bf16 ulp at |x| < 4 in bf16 (VMEM_TOL); a row whose keys are all
masked is exactly 0; two runs are bitwise equal. K4-fwd rounds the
unnormalised p of each key tile (the library's online softmax) where its
plain version rounds the normalised p of the full row; it is held by
chip_smoke.check_flash_out: 1e-5 in fp32, two bf16 ulps of the output's
largest entry in bf16, and the mean error within 2^-8 of the mean |plain|;
its log-sum-exp within 1e-4. K3-bwd and K4-bwd are held by
chip_smoke.check_grads: each gradient within BWD_TOL of its largest entry
(1e-5 in fp32, two bf16 ulps of it in bf16) plus 1e-6; dq exactly 0 where
no key is visible, dk and dv exactly 0 for a masked key. K5-fwd returns
fp32 in both types and differs from its plain version only in the order of
fp32 sums: chip_smoke.check_gmm, 1e-5 of the largest entry in fp32, K4's
relative limits in bf16. K5-bwd sums in fp32 with dout kept at fp32
accuracy and rounds once, as its plain version does:
chip_smoke.check_gmm_bwd, K5-fwd's limits, and in bf16 at least 99% of the
entries equal to the plain version's; its split of dout into bf16 hi + lo
is its plain version's bit for bit. K6 and K7 multiply bf16-rounded x by
weights exact in bf16 and sum in fp32, as their plain versions do, in
another order: 1e-5 of the largest entry in fp32 outputs, one bf16 ulp of
it in bf16 outputs (chip_smoke.QUANT_FP32_REL, chip_smoke.bf16_ulp); K6 and
K7 on both their routes (tensor cores, CUDA cores), two runs bitwise equal.
Under activation checkpointing ('full' and 'dots') a block's K1, K3, K4 or
K5 runs its forward again in the backward on the same inputs; each is
deterministic (two runs bitwise equal), so the block's gradients equal the
unwrapped block's bit for bit.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.models import DeepEarthModel
from deepearth_tpu_torch.configs import (
    DeepSeekBlockConfig,
    FusionConfig,
    MLAConfig,
    MoEConfig,
    TransformerConfig,
)
from deepearth_tpu_torch.models.deepseek import (
    DeepSeekBlock,
    MLAttention,
    MoELayer,
    remat_wrap,
)
from deepearth_tpu_torch.models.fusion import FusionLayer
from deepearth_tpu_torch.models.transformer import TransformerBlock
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.ops import attention as tdpa
from deepearth_tpu_torch.ops import attention_smallseq as tattn
from deepearth_tpu_torch.ops import attention_vmem as tvmem
from deepearth_tpu_torch.ops import flash_attention as tflash
from deepearth_tpu_torch.ops import grid4d_encode as tg4
from deepearth_tpu_torch.ops import grouped_matmul as tgmm
from deepearth_tpu_torch.ops import hash_encoding as the
from deepearth_tpu_torch.ops import quant as tquant
from deepearth_tpu_torch.training import Trainer

pytestmark = pytest.mark.cuda

ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ATTN_BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -7, 1e-4)}
HASH_BWD_TOL = 1e-5
VMEM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the routes of K1 and K2-bwd that no main path takes
NO_OFF_GRID_K1_K2 = {"pairwise_attention_fwd_warp": 0,
                     "pairwise_attention_bwd_warp": 0,
                     "hash_encode_bwd_scalar": 0}
NO_K3_TO_K5 = {"vmem_attention_fwd": 0, "vmem_attention_fwd_mma": 0,
               "vmem_attention_fwd_fp32": 0, "vmem_attention_bwd": 0,
               "vmem_attention_bwd_mma": 0, "vmem_attention_bwd_fp32": 0,
               "flash_attention_fwd": 0, "flash_attention_fwd_mma": 0,
               "flash_attention_fwd_fp32": 0, "flash_attention_bwd": 0,
               "flash_attention_bwd_mma": 0, "flash_attention_bwd_fp32": 0,
               "grouped_matmul_fwd": 0, "grouped_matmul_fwd_mma": 0,
               "grouped_matmul_fwd_fp32": 0, "grouped_matmul_split_dout": 0,
               "grouped_matmul_bwd_dlhs": 0, "grouped_matmul_bwd_dlhs_mma": 0,
               "grouped_matmul_bwd_dlhs_fp32": 0,
               "grouped_matmul_bwd_drhs": 0, "grouped_matmul_bwd_drhs_mma": 0,
               "grouped_matmul_bwd_drhs_fp32": 0, "int8_bmm": 0,
               "int8_bmm_fma": 0, "int4_bmm": 0, "int4_bmm_fma": 0}
NO_SPLAT = {"splat_bin": 0, "splat_composite_fwd": 0,
            "splat_composite_bwd": 0}


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
    (2, 5, 999, 768, 12, True),  # Nq != Nk, past the stream's 3 tokens
    (3, 3, 100, 640, 4, False),  # Dh = 160: lanes loop over the head
    (2, 3, 777, 768, 12, True),  # Nq != Nk on the stream, a key mask
    (3, 3, 1000, 432, 12, False),  # Dh = 36: off the 8-element grid
])
def test_pairwise_attention_matches_plain(cuda, dtype, nq, nk, b, d, heads,
                                          mask):
    """Both of K1-fwd's routes against the plain version: the dispatch
    (the streaming kernel in bf16 on its grid, else the warp kernel) and
    the warp kernel by its own wrapper; launches by route, two runs bitwise
    equal."""
    smoke = _smoke()
    g = torch.Generator(device=cuda).manual_seed(b)
    q = torch.randn((nq, b, d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((nk, b, d), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    key_mask = None
    if mask:
        key_mask = torch.rand((b, nk), generator=g, device=cuda) > 0.4
        key_mask[:17] = False  # rows that see no key
    kw = dict(n_heads=heads, scale=(d // heads) ** -0.5, key_mask=key_mask)
    streams = (dtype == torch.bfloat16 and (d // heads) % 8 == 0
               and nq <= 3 and nk <= 3)
    ref = tattn.pairwise_token_attention_plain(q, k, v, **kw)
    for route, name in ((tattn.pairwise_token_attention,
                         "pairwise_attention_fwd" if streams
                         else "pairwise_attention_fwd_warp"),
                        (lambda q, k, v, n_heads, scale, key_mask:
                         kernels.pairwise_attention_fwd_warp(
                             q, k, v, n_heads, scale, key_mask),
                         "pairwise_attention_fwd_warp")):
        kernels.reset_launch_counts()
        out = route(q, k, v, **kw)
        torch.cuda.synchronize()
        assert kernels.launch_counts == smoke.expected_launches(**{name: 1})
        assert out.dtype == dtype and out.shape == (nq, b, d)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=ATTN_TOL[dtype])
        if mask:
            assert bool((out[:, :17] == 0).all())
        assert torch.equal(out, route(q, k, v, **kw))


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
    (2, 3, 777, 768, 12, True, False),  # Nq != Nk on the stream
    (3, 3, 100, 640, 4, False, False),  # Dh = 160
    (8, 8, 300, 256, 4, True, False),  # past the stream's 3 tokens a side
    (3, 3, 500, 768, 12, True, True),  # qkv views with a key mask
    (3, 3, 1000, 432, 12, True, False),  # Dh = 36: off the 8-element grid
])
def test_pairwise_attention_bwd_matches_plain(cuda, dtype, nq, nk, b, d,
                                              heads, mask, fused):
    """Both of K1-bwd's routes against the plain version: the dispatch
    (the streaming kernel in bf16 on its grid, else the warp kernel) and
    the warp kernel by its own wrapper; launches by route, two runs bitwise
    equal."""
    smoke = _smoke()
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
    streams = (dtype == torch.bfloat16 and (d // heads) % 8 == 0
               and nq <= 3 and nk <= 3)
    ref = tattn.pairwise_token_attention_bwd_plain(
        q, k, v, do, n_heads=heads, scale=scale, key_mask=key_mask)
    for route, name in ((kernels.pairwise_attention_bwd,
                         "pairwise_attention_bwd" if streams
                         else "pairwise_attention_bwd_warp"),
                        (kernels.pairwise_attention_bwd_warp,
                         "pairwise_attention_bwd_warp")):
        kernels.reset_launch_counts()
        got = route(q, k, v, do, heads, scale, key_mask)
        torch.cuda.synchronize()
        assert kernels.launch_counts == smoke.expected_launches(**{name: 1})
        rtol, atol = ATTN_BWD_TOL[dtype]
        for a, r in zip(got, ref):
            assert a.dtype == dtype and a.shape == r.shape
            assert a.is_contiguous()
            diff = (a.float() - r.float()).abs()
            assert bool((diff <= rtol * r.float().abs() + atol).all()), \
                (name, diff.max().item())
            if mask:
                assert bool((a[:, :17] == 0).all())
        again = route(q, k, v, do, heads, scale, key_mask)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


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
        # fp32: K1 by its warp routes; F = 2: K2-bwd by its dense route
        assert {kernels.launch_counts[k] for k in (
            "pairwise_attention_fwd_warp", "pairwise_attention_bwd_warp",
            "hash_encode_fwd", "hash_encode_bwd")} == (
            {1} if name == "kernel" else {0})
        assert kernels.launch_counts["pairwise_attention_fwd"] == 0
        assert kernels.launch_counts["pairwise_attention_bwd"] == 0
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
    """Both of K2-bwd's routes against the plain version: the dispatch (the
    dense route at F = 2, else the scalar one) and the scalar route by its
    own wrapper, with the launches by route."""
    smoke = _smoke()
    x = coords(d + 5, 4096, d, cuda)
    g = torch.Generator(device=cuda).manual_seed(levels)
    grad_out = torch.randn((4096, levels * f), generator=g, device=cuda)
    res = torch.tensor([2.0 ** (4 + i) for i in range(levels)], device=cuda)
    shape = (levels, table, f)
    kw = dict(interpolation=interpolation, table_size=table_size)
    ref = the.hash_encode_bwd_plain(x, grad_out, res, shape, **kw)
    abs_sum = the.hash_encode_bwd_plain(x, grad_out.abs(), res, shape, **kw)
    for route, name in ((kernels.hash_encode_bwd,
                         "hash_encode_bwd" if f == 2
                         else "hash_encode_bwd_scalar"),
                        (kernels.hash_encode_bwd_scalar,
                         "hash_encode_bwd_scalar")):
        kernels.reset_launch_counts()
        got = route(x, grad_out, res, shape, table_size or table,
                    interpolation == "linear")
        torch.cuda.synchronize()
        assert kernels.launch_counts == smoke.expected_launches(**{name: 1})
        assert got.shape == shape
        assert bool(((got - ref).abs() <= HASH_BWD_TOL * abs_sum).all())
        if table_size:
            assert bool((got[:, table_size:] == 0).all())


_DENSE_BWD_CASES = pytest.mark.parametrize("d,levels,table,interpolation", [
    (3, 16, 2 ** 19, "linear"),  # A-stack spatial
    (1, 8, 2 ** 17, "linear"),  # A-stack temporal
    (2, 3, 1001, "nearest"),  # an odd table: a tail past the 16-byte stores
])


def _dense_bwd_case(cuda, d, levels, table, interpolation, offset=0):
    """coords, grad_out (a contiguous view ``offset`` floats into its
    storage), resolutions, the table shape, and the plain version's
    gradient and sum of |terms|."""
    x = coords(d, 4096, d, cuda)
    g = torch.Generator(device=cuda).manual_seed(d)
    grad_out = torch.randn((offset + 4096 * levels * 2,), generator=g,
                           device=cuda)[offset:].view(4096, levels * 2)
    res = torch.tensor([2.0 ** (2 + i) for i in range(levels)], device=cuda)
    shape = (levels, table, 2)
    kw = dict(interpolation=interpolation)
    ref = the.hash_encode_bwd_plain(x, grad_out, res, shape, **kw)
    abs_sum = the.hash_encode_bwd_plain(x, grad_out.abs(), res, shape, **kw)
    return x, grad_out, res, shape, ref, abs_sum


@_DENSE_BWD_CASES
def test_hash_encode_bwd_writes_every_entry(cuda, d, levels, table,
                                            interpolation):
    """K2-bwd's dense route into memory that holds NaN before the call (the
    caching allocator hands back the block just freed): every entry comes
    out finite and within the limit, so the kernels write every row
    themselves."""
    x, grad_out, res, shape, ref, abs_sum = _dense_bwd_case(
        cuda, d, levels, table, interpolation)
    filled = torch.full(shape, float("nan"), device=cuda)
    ptr = filled.data_ptr()
    del filled
    got = kernels.hash_encode_bwd_dense(x, grad_out, res, shape, table,
                                        interpolation == "linear")
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    assert bool(got.isfinite().all())
    assert bool(((got - ref).abs() <= HASH_BWD_TOL * abs_sum).all())


@_DENSE_BWD_CASES
def test_hash_encode_bwd_takes_a_misaligned_grad_out(cuda, d, levels, table,
                                                     interpolation):
    """K2-bwd's dense route with grad_out a contiguous view one float into
    its storage, which the scatter's float2 loads cannot read in place: the
    wrapper hands the kernels an aligned copy, and the result is within the
    limit."""
    x, grad_out, res, shape, ref, abs_sum = _dense_bwd_case(
        cuda, d, levels, table, interpolation, offset=1)
    assert grad_out.is_contiguous() and grad_out.data_ptr() % 8 == 4
    got = kernels.hash_encode_bwd_dense(x, grad_out, res, shape, table,
                                        interpolation == "linear")
    torch.cuda.synchronize()
    assert bool(((got - ref).abs() <= HASH_BWD_TOL * abs_sum).all())


def test_hash_encode_refuses_coords_gradient(cuda):
    with pytest.raises(NotImplementedError, match="coords"):
        the.hash_encode(torch.rand((4, 3), device=cuda, requires_grad=True),
                        torch.zeros((2, 256, 2), device=cuda),
                        torch.tensor([16.0, 32.0], device=cuda))


# chip_smoke.grid4d_cases' names: A-stack and decomposition configs, fp32
# and bf16, masks absent, partial and all False, xyzt strided, B = 1,
# nearest corners on level counts that do not divide 32
GRID4D_CASES = [
    "A-stack B=4096 bf16", "A-stack B=4096 bf16 masked",
    "A-stack B=4096 fp32 masked", "A-stack B=4096 bf16 all-False",
    "A-stack B=4096 bf16 xyzt strided", "A-stack B=1 bf16 masked",
    "A-stack B=37 fp32", "decompositions B=1000 bf16 masked",
    "decompositions B=1000 fp32", "nearest T=3001 L12/5 B=777 fp32 masked",
    "nearest T=3001 L12/5 B=777 bf16"]


@pytest.mark.parametrize("case", GRID4D_CASES)
def test_grid4d_encode_matches_plain(cuda, case):
    """K2-fwd's Grid4D encode (one launch) bit for bit against the plain
    composition, two runs alike, one launch a run
    (chip_smoke._grid4d_case)."""
    smoke = _smoke()
    assert set(smoke.grid4d_cases()) == set(GRID4D_CASES)
    gen = torch.Generator(device=cuda).manual_seed(0)
    err, exact, launches = smoke._grid4d_case(gen,
                                              *smoke.grid4d_cases()[case])
    assert err == 0 and exact and launches == 2


def test_grid4d_encode_off_its_route_takes_the_per_table_kernel(cuda):
    """F = 3: each table through the per-table kernel, the masks, cat and
    cast as torch operations; equal to the plain composition."""
    smoke = _smoke()
    gen = torch.Generator(device=cuda).manual_seed(1)
    cfg = smoke.Grid4DConfig(n_spatial_levels=4, n_temporal_levels=2,
                             n_features_per_level=3, hash_table_size=4096)
    tables, res, cfgs = smoke.grid4d_tables(gen, cfg)
    xyzt, sm, tm = smoke.grid4d_inputs(gen, 512, "partial")
    kernels.reset_launch_counts()
    out = tg4.grid4d_encode(xyzt, tables, res, cfgs, sm, tm,
                            out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert kernels.launch_counts["grid4d_encode_fwd"] == 0
    assert kernels.launch_counts["hash_encode_fwd"] == 2
    assert torch.equal(out, tg4.grid4d_encode_plain(
        xyzt, tables, res, cfgs, sm, tm, out_dtype=torch.bfloat16))


def test_grid4d_encode_gradient_equals_the_composition(cuda):
    """The tables' gradient through the Grid4D encode's autograd.Function
    (one K2-bwd call a table) against autograd through the per-table
    composition (the per-table kernel, the same K2-bwd): atomics add in another
    order, so within 1e-5 of each gradient's largest entry."""
    smoke = _smoke()
    gen = torch.Generator(device=cuda).manual_seed(2)
    grid4d = smoke.Grid4DConfig(n_spatial_levels=16, n_temporal_levels=8,
                                hash_table_size=2 ** 19,
                                use_decompositions=True)
    tables, res, cfgs = smoke.grid4d_tables(gen, grid4d)
    leaves = [t.requires_grad_() for t in tables]
    xyzt, sm, tm = smoke.grid4d_inputs(gen, 4096, "partial", strided=True)
    cot = torch.randn((4096, grid4d.output_dim), generator=gen,
                      device=cuda).bfloat16()
    grads = {}
    for name, want in (("function", dict(grid4d_encode_fwd=1,
                                         hash_encode_bwd=5)),
                       ("composition", dict(hash_encode_fwd=5,
                                            hash_encode_bwd=5))):
        kernels.reset_launch_counts()
        args = (xyzt, leaves, res, cfgs, sm, tm)
        out = (tg4.grid4d_encode(*args, out_dtype=torch.bfloat16)
               if name == "function" else
               tg4._compose(the.hash_encode, *args, torch.bfloat16))
        out.backward(cot)
        torch.cuda.synchronize()
        assert kernels.launch_counts == smoke.expected_launches(**want)
        grads[name] = [t.grad.clone() for t in leaves]
        for t in leaves:
            t.grad = None
    for a, b in zip(grads["function"], grads["composition"]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


def test_astack_train_step_launches_every_kernel(cuda):
    """One train step of the A-stack model at B=4096 with masking: K2-fwd 1
    (the Grid4D encode), K2-bwd 2, K1-fwd 16, K1-bwd 16 launches, and a
    finite loss."""
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
        "grid4d_encode_fwd": 1, "hash_encode_fwd": 0, "hash_encode_bwd": 2,
        "pairwise_attention_fwd": 16, "pairwise_attention_bwd": 16,
        **NO_OFF_GRID_K1_K2, **NO_K3_TO_K5, **NO_SPLAT}
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
    with pytest.raises(ValueError, match="streaming route"):
        kernels.pairwise_attention_fwd_tma(q, q, q, 2, 0.125)  # fp32
    with pytest.raises(ValueError, match="streaming route"):
        kernels.pairwise_attention_fwd_tma(
            *(torch.randn((3, 4, 72), device=cuda, dtype=torch.bfloat16)
              for _ in range(3)), 2, 0.125)  # Dh = 36
    with pytest.raises(ValueError, match="dense route"):
        kernels.hash_encode_bwd_dense(
            torch.rand((4, 3), device=cuda), torch.zeros((4, 6), device=cuda),
            torch.tensor([16.0, 32.0], device=cuda), (2, 256, 3), 256, True)
    with pytest.raises(ValueError, match="streaming route"):
        kernels.pairwise_attention_bwd_tma(q, q, q, q, 2, 0.125)  # fp32
    with pytest.raises(ValueError, match="streaming route"):
        kernels.pairwise_attention_bwd_tma(
            *(torch.randn((3, 4, 72), device=cuda, dtype=torch.bfloat16)
              for _ in range(4)), 2, 0.125)  # Dh = 36
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
    (8, 8, 576, 576, 128, 128, False, True),  # the flagship's vision MLA
    (2, 2, 100, 300, 40, 36, True, False),  # off TMA's grid: mma.sync
    (4, 2, 200, 500, 64, 64, True, False),  # 128-row blocks, ragged keys
])
def test_vmem_attention_matches_plain(cuda, dtype, b, h, nq, nk, dqk, dv,
                                      mask, strided):
    """K3-fwd against its plain version by the route the shapes and strides
    choose (TMA for bf16 on the 8-element grid, mma.sync for other bf16,
    CUDA cores for fp32), once on that route's counter, two runs bitwise
    equal."""
    smoke = _smoke()
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
    route = smoke.attention_route(q, k, v)
    assert route == ("" if dtype == torch.bfloat16 and dqk % 8 == 0
                     and dv % 8 == 0 else
                     "_mma" if dtype == torch.bfloat16 else "_fp32")
    assert kernels.launch_counts == smoke.expected_launches(
        **{f"vmem_attention_fwd{route}": 1})
    assert out.dtype == dtype and out.shape == (b, h, nq, dv)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=VMEM_TOL[dtype])
    if mask:
        assert bool((out[0] == 0).all())
    assert torch.equal(kernels.vmem_attention_fwd(q, k, v, kw["scale"],
                                                  key_mask), out)


@pytest.mark.parametrize("b,h,nq,nk,dqk,dv,strided", [
    (16, 8, 576, 576, 48, 32, True),  # the MLA site
    (16, 8, 16, 576, 64, 64, False),  # the cross site
    (8, 8, 576, 576, 128, 128, True),  # the flagship's vision MLA
])
def test_vmem_attention_fwd_mma_route_on_the_tma_grid(cuda, b, h, nq, nk,
                                                      dqk, dv, strided):
    """K3-fwd's mma.sync route (``attention_vmem.cu``), which the model's
    sites no longer take, called on them: within VMEM_TOL of the plain
    version and of the TMA route, counted as vmem_attention_fwd_mma."""
    smoke = _smoke()
    g = torch.Generator(device=cuda).manual_seed(nq + 5)
    q, k, v, _, _ = smoke.attention_case(g, b, h, nq, nk, dqk, dv,
                                         torch.bfloat16, strided=strided)
    kernels.reset_launch_counts()
    mma = kernels.vmem_attention_fwd_mma(q, k, v, dqk ** -0.5)
    tma = kernels.vmem_attention_fwd_tma(q, k, v, dqk ** -0.5)
    torch.cuda.synchronize()
    assert kernels.launch_counts == smoke.expected_launches(
        vmem_attention_fwd=1, vmem_attention_fwd_mma=1)
    ref = tvmem.vmem_attention_plain(q, k, v, scale=dqk ** -0.5)
    for out in (mma, tma):
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=VMEM_TOL[torch.bfloat16])
    with pytest.raises(ValueError, match="TMA route"):
        kernels.vmem_attention_fwd_tma(q.float(), k.float(), v.float(), 0.1)


def test_dot_product_attention_routes_k3_shapes_to_the_kernel(cuda):
    q = torch.randn((2, 2, 16, 32), device=cuda)
    k = torch.randn((2, 2, 300, 32), device=cuda)
    kernels.reset_launch_counts()
    out = tdpa.dot_product_attention(q, k, k, scale=0.2)
    ref = tvmem.vmem_attention_plain(q, k, k, scale=0.2)
    torch.cuda.synchronize()
    # fp32: K3-fwd's CUDA-core route
    assert kernels.launch_counts["vmem_attention_fwd_fp32"] == 1
    torch.testing.assert_close(out, ref, rtol=0, atol=VMEM_TOL[torch.float32])
    short = torch.randn((2, 2, 23, 32), device=cuda)
    tdpa.dot_product_attention(short, short, short, scale=0.2)
    assert kernels.launch_counts["vmem_attention_fwd_fp32"] == 1  # plain at 23


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,nq,nk,dqk,dv,mask,strided", [
    (16, 8, 576, 576, 48, 32, False, True),  # the MLA site, v a view
    (16, 8, 16, 576, 64, 64, False, False),  # the cross site
    (3, 2, 100, 260, 48, 80, True, False),  # ragged, masked
    (2, 2, 33, 1024, 128, 128, True, False),  # the longest row, widest head
    (1, 1, 1, 1, 8, 8, False, False),  # one key
    (8, 8, 576, 576, 128, 128, False, True),  # the flagship's vision MLA
    (2, 2, 100, 300, 40, 36, True, False),  # off TMA's grid: mma.sync
])
def test_vmem_attention_bwd_matches_plain(cuda, dtype, b, h, nq, nk, dqk, dv,
                                          mask, strided):
    """K3-bwd against its plain version by the route the shapes and
    strides choose (TMA for bf16 on the 8-element grid, mma.sync for other
    bf16, CUDA cores for fp32), once on that route's counter, two runs
    bitwise equal."""
    smoke = _smoke()
    g = torch.Generator(device=cuda).manual_seed(nq + nk + 1)
    q, k, v, dout, key_mask = smoke.attention_case(g, b, h, nq, nk, dqk, dv,
                                                   dtype, mask, strided)
    kernels.reset_launch_counts()
    got = kernels.vmem_attention_bwd(q, k, v, dout, dqk ** -0.5, key_mask)
    ref = tvmem.vmem_attention_bwd_plain(q, k, v, dout, scale=dqk ** -0.5,
                                         key_mask=key_mask)
    torch.cuda.synchronize()
    route = smoke.attention_route(q, k, v)
    assert route == ("" if dtype == torch.bfloat16 and dqk % 8 == 0
                     and dv % 8 == 0 else
                     "_mma" if dtype == torch.bfloat16 else "_fp32")
    assert kernels.launch_counts == smoke.expected_launches(
        **{f"vmem_attention_bwd{route}": 1})
    smoke.check_grads("K3-bwd", got, ref, dtype, key_mask)
    again = kernels.vmem_attention_bwd(q, k, v, dout, dqk ** -0.5, key_mask)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


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
    assert kernels.launch_counts == smoke.expected_launches(
        vmem_attention_fwd=1, vmem_attention_bwd=1)
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
    (1, 8, 4608, 128, 128, False, False, True),  # the flagship's clip MLA
    (2, 2, 700, 40, 36, False, False, False),  # off TMA's grid: mma.sync
    (2, 2, 700, 128, 64, True, False, False),  # Dqk != Dv, both panels
    # heads above 128: DeepSeek-V3's MLA (192 / 128), and 256 / 256 (Dv
    # split across two blocks in the forward, dk and dv in two kernels in
    # the backward)
    (1, 16, 1024, 192, 128, False, False, True),
    (2, 2, 1500, 192, 128, True, True, False),
    (2, 4, 1000, 256, 256, True, False, False),
    (1, 4, 4608, 256, 256, False, False, True),
    (2, 2, 700, 200, 136, False, True, False),  # partial panels
    (2, 2, 700, 190, 126, True, False, False),  # off TMA's grid: mma.sync
])
def test_flash_attention_matches_plain(cuda, dtype, b, h, n, dqk, dv, mask,
                                       causal, strided):
    """K4-fwd and K4-bwd against their plain versions, each by the route
    the shapes and strides choose (TMA for bf16 on the 8-element grid,
    mma.sync for other bf16, CUDA cores for fp32), once on that route's
    counter, two runs of each bitwise equal; bf16 on the grid also on the
    mma.sync route (its wrappers take any shapes)."""
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
    route = smoke.attention_route(q, k, v)
    assert route == ("" if dtype == torch.bfloat16 and dqk % 8 == 0
                     and dv % 8 == 0 else
                     "_mma" if dtype == torch.bfloat16 else "_fp32")
    assert kernels.launch_counts == smoke.expected_launches(**{
        f"flash_attention_fwd{route}": 1, f"flash_attention_bwd{route}": 1})
    again = kernels.flash_attention_bwd(q, k, v, out, lse, dout, kw["scale"],
                                        key_mask, causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    out2, lse2 = kernels.flash_attention_fwd(q, k, v, kw["scale"], key_mask,
                                             causal)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert out.dtype == dtype and out.shape == (b, h, n, dv)
    smoke.check_flash_out("K4-fwd", out, ref, dtype)
    assert torch.equal(lse.isinf(), ref_lse.isinf())
    finite = ref_lse.isfinite()
    torch.testing.assert_close(lse[finite], ref_lse[finite], rtol=0,
                               atol=1e-4)
    if mask:
        assert bool((out[0] == 0).all())  # the library would give mean(v)
    smoke.check_grads("K4-bwd", got, ref_grads, dtype, key_mask)
    if route == "":
        out, lse = kernels.flash_attention_fwd_mma(q, k, v, kw["scale"],
                                                   key_mask, causal)
        smoke.check_flash_out("K4-fwd mma.sync", out, ref, dtype)
        smoke.check_grads("K4-bwd mma.sync", kernels.flash_attention_bwd_mma(
            q, k, v, out, lse, dout, kw["scale"], key_mask, causal),
            ref_grads, dtype, key_mask)


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
        wide = torch.randn((1, 2, 40, 264), device=cuda, dtype=torch.bfloat16)
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
    # DeepSeek-V3's heads (q 192, v 128) run K4; above 256 the MLA raises
    cfg = MLAConfig(hidden_dim=64, n_heads=2, kv_lora_rank=16,
                    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128,
                    use_flash_attention=True, flash_min_seq=16)
    mla = MLAttention(cfg, Init(torch.Generator(device=cuda), cuda),
                      torch.bfloat16)
    kernels.reset_launch_counts()
    with torch.no_grad():
        x = torch.randn((1, 32, 64), device=cuda)
        out = mla(x)
        with _smoke().plain_versions():
            ref = mla(x)
    assert kernels.launch_counts["flash_attention_fwd"] == 1
    assert (out.float() - ref.float()).abs().max().item() <= \
        2e-2 * ref.float().abs().max().item()
    cfg.qk_nope_head_dim = 200
    mla = MLAttention(cfg, Init(torch.Generator(device=cuda), cuda),
                      torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="up to 256"):
        mla(torch.randn((1, 32, 64), device=cuda))


def test_flash_bwd_tma_route_rejects_what_it_does_not_take(cuda):
    """The TMA routes' wrappers (K4-fwd, K4-bwd, K3-bwd) refuse head dims
    and strides off the 8-element grid and fp32, which the entries send
    elsewhere; a strided v whose start is off a 16-byte boundary is copied
    and stays on the route."""
    smoke = _smoke()
    g = torch.Generator(device=cuda).manual_seed(9)
    for dqk, dv, dtype in ((40, 36, torch.bfloat16), (48, 32, torch.float32)):
        q, k, v, do, _ = smoke.attention_case(g, 1, 2, 100, 100, dqk, dv,
                                              dtype)
        out, lse = kernels.flash_attention_fwd(q, k, v, 0.1)
        with pytest.raises(ValueError, match="TMA route"):
            kernels.flash_attention_bwd_tma(q, k, v, out, lse, do, 0.1)
        with pytest.raises(ValueError, match="TMA route"):
            kernels.flash_attention_fwd_tma(q, k, v, 0.1)
        with pytest.raises(ValueError, match="TMA route"):
            kernels.vmem_attention_bwd_tma(q, k, v, do, 0.1)
    q, k, v, do, _ = smoke.attention_case(g, 2, 2, 300, 300, 48, 32,
                                          torch.bfloat16)
    wide = torch.randn((2, 300, 2, 36), generator=g, device=cuda).to(
        torch.bfloat16)
    odd = wide[..., 4:].transpose(1, 2)  # strides off the grid
    out, lse = kernels.flash_attention_fwd(q, k, odd, 0.1)
    with pytest.raises(ValueError, match="TMA route"):
        kernels.flash_attention_bwd_tma(q, k, odd, out, lse, do, 0.1)
    base = torch.randn((2 * 2 * 300 * 32 + 1,), generator=g,
                       device=cuda).to(torch.bfloat16)
    shifted = base[1:].view(2, 2, 300, 32)  # 2 bytes past a boundary
    kernels.reset_launch_counts()
    out, lse = kernels.flash_attention_fwd(q, k, shifted, 0.1)
    got = kernels.flash_attention_bwd(q, k, shifted, out, lse, do, 0.1)
    got3 = kernels.vmem_attention_bwd(q, k, shifted, do, 0.1)
    assert kernels.launch_counts == smoke.expected_launches(
        flash_attention_fwd=1, flash_attention_bwd=1, vmem_attention_bwd=1)
    smoke.check_flash_out("shifted v", out, tflash.flash_attention_plain(
        q, k, shifted, scale=0.1), torch.bfloat16)
    smoke.check_grads("shifted v", got, tflash.flash_attention_bwd_plain(
        q, k, shifted, out, lse, do, scale=0.1), torch.bfloat16)
    smoke.check_grads("shifted v K3", got3, tvmem.vmem_attention_bwd_plain(
        q, k, shifted, do, scale=0.1), torch.bfloat16)


def test_mla_backward_at_4608_takes_the_tma_route(cuda):
    """The multimodal model's vision MLA (Dqk 48, Dv 32, v a view of the kv
    projection) over a clip's 4608 patches: under autograd K4-bwd runs once
    on its TMA route, never on mma.sync, no plain version reached."""
    smoke = _smoke()
    cfg = smoke.multimodal_config()
    from deepearth_tpu_torch.models.encoders import (
        encoder_transformer_config)
    mla_cfg = encoder_transformer_config(cfg.modalities["vision"],
                                         cfg.hidden_dim).mla
    mla = MLAttention(mla_cfg, Init(torch.Generator(device=cuda).manual_seed(
        5), cuda), torch.bfloat16)
    x = torch.randn((2, 4608, cfg.hidden_dim), device=cuda)
    kernels.reset_launch_counts()
    with smoke.plain_versions_refused():
        mla(x).float().square().mean().backward()
    torch.cuda.synchronize()
    assert kernels.launch_counts == smoke.expected_launches(
        flash_attention_fwd=1, flash_attention_bwd=1)


def test_multimodal_train_steps_launch_k3_and_k4(cuda):
    """One train step of the multimodal model at universal dim 64 with
    vision at 576 patches (K3-fwd 2, K3-bwd 2, K2 1/2) and at 4608 patches
    (K4-fwd 1, K4-bwd 1, K2 1/2), masking on, no plain version reached."""
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
            "grid4d_encode_fwd": 1, "hash_encode_fwd": 0,
            "hash_encode_bwd": 2, "pairwise_attention_fwd": 0,
            "pairwise_attention_bwd": 0,
            **NO_OFF_GRID_K1_K2, **NO_K3_TO_K5, **NO_SPLAT, **want}
        assert np.isfinite(metrics["loss/total"].item())
        assert np.isfinite(metrics["grad_norm"].item())


def test_multimodal_forward_launches_k3_twice(cuda):
    """The multimodal model at full width, one small request: K3-fwd 2,
    K2-fwd 1, K1-fwd 0 launches, finite features, no plain version."""
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
        "grid4d_encode_fwd": 1, "hash_encode_fwd": 0, "hash_encode_bwd": 0,
        "pairwise_attention_fwd": 0, "pairwise_attention_bwd": 0,
        **NO_OFF_GRID_K1_K2, **NO_K3_TO_K5, **NO_SPLAT,
        "vmem_attention_fwd": 2}
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


# K5: fp32 output in both types; chip_smoke.check_gmm holds it (1e-5 of the
# largest entry in fp32, K4's relative limits in bf16)
GMM_CASES = {  # group sizes, K, N, M (None: the sum of the sizes)
    "empty groups, tiles across groups": ([0, 70, 0, 130, 100, 0], 96, 200,
                                          None),
    "groups of 1-3 rows, a tile ending mid-group": ([1, 2, 3, 1, 130, 2, 0,
                                                     3], 64, 136, None),
    "K=8 N=8": ([5, 9, 3], 8, 8, None),
    "M=1": ([0, 1, 0], 64, 64, None),
    "K and N off the 8-element grid": ([100, 57, 100], 100, 130, None),
    "odd K and N": ([5, 40, 19], 33, 31, None),
    "rows past the last group": ([30, 20], 64, 128, 100),
    "flagship 2816 E8 2048x2048": ([352, 420, 318, 360, 300, 380, 346, 340],
                                   2048, 2048, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_grouped_matmul_matches_plain(cuda, dtype, case):
    """K5-fwd by the route the shapes choose (TMA for bf16 with K and N
    multiples of 8, mma.sync for other bf16, CUDA cores for fp32), once on
    that route's counter, two runs bitwise equal."""
    smoke = _smoke()
    sizes, k, n, m = GMM_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(0)
    lhs, rhs, gs = smoke.gmm_case(gen, sizes, k, n, dtype, m)
    route = smoke.fwd_route(dtype, lhs.shape[0], k, n)
    kernels.reset_launch_counts()
    out = tgmm.gmm(lhs, rhs, gs)
    assert kernels.launch_counts == smoke.expected_launches(
        **{f"grouped_matmul_fwd{route}": 1})
    assert torch.equal(out, kernels.grouped_matmul_fwd(lhs, rhs, gs))
    smoke.check_gmm(case, out, tgmm.gmm_plain(lhs, rhs, gs), dtype)
    if m is not None:
        assert bool((out[sum(sizes):] == 0).all())


def test_grouped_matmul_refusals_and_card_backward(cuda):
    smoke = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(1)
    lhs, rhs, gs = smoke.gmm_case(gen, [3, 5], 16, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        kernels.grouped_matmul_fwd(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="share"):
        kernels.grouped_matmul_fwd(lhs.float(), rhs, gs)
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.grouped_matmul_fwd(lhs, rhs, gs.cpu())
    kernels.reset_launch_counts()
    empty = kernels.grouped_matmul_fwd(lhs[:0], rhs, torch.zeros_like(gs))
    assert empty.shape == (0, 8) and not any(kernels.launch_counts.values())
    # the TMA route's wrapper refuses what its route does not take
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.grouped_matmul_fwd_tma(*smoke.gmm_case(gen, [5, 40, 19], 33,
                                                       31, torch.bfloat16))
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.grouped_matmul_fwd_tma(lhs.float(), rhs.float(), gs)
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.grouped_matmul_fwd_tma(lhs[:0], rhs, torch.zeros_like(gs))
    # autograd on the card: K5-bwd's two kernels (the TMA route: K 16, N 8),
    # once each and only for the inputs that need a gradient, after one
    # split of dout
    for needs in ((True, True), (True, False), (False, True)):
        leaves = [x.detach().clone().requires_grad_(r)
                  for x, r in zip((lhs, rhs), needs)]
        kernels.reset_launch_counts()
        with smoke.plain_versions_refused():
            tgmm.gmm(*leaves, gs).sum().backward()
        torch.cuda.synchronize()
        assert kernels.launch_counts["grouped_matmul_split_dout"] == 1
        assert kernels.launch_counts["grouped_matmul_bwd_dlhs"] == needs[0]
        assert kernels.launch_counts["grouped_matmul_bwd_drhs"] == needs[1]
        ref = tgmm.gmm_bwd_plain(lhs, rhs, gs, torch.ones((8, 8),
                                                          device=cuda))
        for leaf, r in zip(leaves, ref):
            if leaf.requires_grad:
                smoke.check_gmm_bwd("autograd", (leaf.grad, leaf.grad),
                                    (r, r), torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        kernels.grouped_matmul_bwd(lhs, rhs, gs, torch.ones(
            (8, 8), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="int32"):
        kernels.grouped_matmul_bwd(lhs, rhs, gs.long(),
                                   torch.ones((8, 8), device=cuda))


K5_BWD_CASES = {**GMM_CASES, "M=0": ([0, 0, 0], 64, 64, None)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(K5_BWD_CASES))
def test_grouped_matmul_bwd_matches_plain(cuda, dtype, case):
    """K5-bwd's dlhs and drhs on an fp32 dout with genuine low bits, by the
    route the shapes choose (TMA for bf16 with K and N multiples of 8,
    mma.sync for other bf16, CUDA cores for fp32), each route's counter:
    an empty group's drhs exactly 0 (from a torch.empty output), dlhs of
    the rows past the last group 0, M = 0 launches dlhs nothing, two runs
    bitwise equal."""
    smoke = _smoke()
    sizes, k, n, m = K5_BWD_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(3)
    lhs, rhs, gs = smoke.gmm_case(gen, sizes, k, n, dtype, m)
    dout = torch.randn((lhs.shape[0], n), generator=gen, device=cuda)
    route = smoke.bwd_route(dtype, lhs.shape[0], k, n)
    kernels.reset_launch_counts()
    got = kernels.grouped_matmul_bwd(lhs, rhs, gs, dout)
    torch.cuda.synchronize()
    assert kernels.launch_counts == smoke.expected_launches(**{
        "grouped_matmul_split_dout": int(route == ""),
        f"grouped_matmul_bwd_dlhs{route}": int(lhs.shape[0] > 0),
        f"grouped_matmul_bwd_drhs{route}": 1})
    smoke.check_gmm_bwd(case, got, tgmm.gmm_bwd_plain(lhs, rhs, gs, dout),
                        dtype)
    again = kernels.grouped_matmul_bwd(lhs, rhs, gs, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, size in enumerate(sizes):
        if size == 0:
            assert bool((got[1][g] == 0).all())
    if m is not None:
        assert bool((got[0][sum(sizes):] == 0).all())


@pytest.mark.parametrize("shape", [(2816, 2048), (37, 200), (5, 31),
                                   (1, 3), (64, 130)])
def test_split_dout_matches_plain_bitwise(cuda, shape):
    """K5-bwd's split against split_dout_plain, bit for bit (16-byte and
    element-wise paths), on values with genuine low bits; a strided view
    is split as its contiguous copy."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    dout = torch.randn(shape, generator=gen, device=cuda) * 3.0
    kernels.reset_launch_counts()
    for x in (dout, dout.t()):
        hi, lo = kernels.grouped_matmul_split_dout(x)
        want = tgmm.split_dout_plain(x)
        assert hi.is_contiguous() and lo.is_contiguous()
        assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    torch.cuda.synchronize()
    assert kernels.launch_counts["grouped_matmul_split_dout"] == 2
    with pytest.raises(ValueError, match="float32"):
        kernels.grouped_matmul_split_dout(dout.bfloat16())


def test_grouped_matmul_bwd_tma_launchers_check_their_inputs(cuda):
    """The TMA route's launchers read the split they are given and launch
    nothing else; they refuse parts that are not dout's split in bf16 and
    shapes off TMA's 8-element grid, which the entry sends to mma.sync."""
    smoke = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(7)
    lhs, rhs, gs = smoke.gmm_case(gen, [40, 0, 88], 64, 96, torch.bfloat16)
    dout = torch.randn((128, 96), generator=gen, device=cuda)
    hi, lo = kernels.grouped_matmul_split_dout(dout)
    kernels.reset_launch_counts()
    got = (kernels.grouped_matmul_bwd_dlhs_tma(hi, lo, rhs, gs),
           kernels.grouped_matmul_bwd_drhs_tma(lhs, hi, lo, gs))
    torch.cuda.synchronize()
    assert kernels.launch_counts == smoke.expected_launches(
        grouped_matmul_bwd_dlhs=1, grouped_matmul_bwd_drhs=1)
    smoke.check_gmm_bwd("parts", got, tgmm.gmm_bwd_plain(lhs, rhs, gs, dout),
                        torch.bfloat16)
    with pytest.raises(ValueError, match="split"):
        kernels.grouped_matmul_bwd_dlhs_tma(hi.float(), lo, rhs, gs)
    with pytest.raises(ValueError, match="split"):
        kernels.grouped_matmul_bwd_drhs_tma(lhs, hi, lo[:5], gs)
    lhs, rhs, gs = smoke.gmm_case(gen, [5, 40, 19], 33, 32, torch.bfloat16)
    hi, lo = kernels.grouped_matmul_split_dout(
        torch.randn((64, 32), generator=gen, device=cuda))
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.grouped_matmul_bwd_dlhs_tma(hi, lo, rhs, gs)
    with pytest.raises(ValueError, match="multiples of 8"):
        kernels.grouped_matmul_bwd_drhs_tma(lhs, hi, lo, gs)


def test_ragged_moe_layer_launches_k5_three_times(cuda):
    """A bf16 MoE layer forced ragged: gate, up and down through K5 with no
    plain version reached; its output close to the plain path's."""
    smoke = _smoke()
    cfg = MoEConfig(n_routed_experts=8, num_experts_per_tok=2, n_group=2,
                    topk_group=1, moe_intermediate_size=256, hidden_dim=128,
                    dispatch_mode="ragged")
    gen = torch.Generator(device="cuda").manual_seed(2)
    layer = MoELayer(cfg, Init(gen, "cuda", torch.bfloat16), torch.bfloat16)
    x = torch.randn((4, 300, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    kernels.reset_launch_counts()
    with torch.inference_mode(), smoke.plain_versions_refused():
        out = layer(x)
    assert kernels.launch_counts == smoke.expected_launches(
        grouped_matmul_fwd=3)  # the TMA route: K 128 and 256, N 256 and 128
    assert layer.mode == "ragged" and out.shape == x.shape
    with torch.inference_mode(), smoke.plain_versions():
        ref = layer(x)
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= 2 ** -6 * ref.float().abs().max().item()


def test_ragged_moe_layer_backward_launches_k5_bwd(cuda):
    """A bf16 MoE layer forced ragged, trained one backward: K5-fwd 3 times
    and K5-bwd's split, dlhs and drhs 3 times each (gate, up, down; the
    TMA route), no plain version reached; the router gets its aux term's
    gradient."""
    smoke = _smoke()
    cfg = MoEConfig(n_routed_experts=8, num_experts_per_tok=2, n_group=2,
                    topk_group=1, moe_intermediate_size=256, hidden_dim=128,
                    dispatch_mode="ragged")
    gen = torch.Generator(device="cuda").manual_seed(4)
    layer = MoELayer(cfg, Init(gen, "cuda", torch.bfloat16), torch.bfloat16)
    x = torch.randn((4, 300, 128), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    kernels.reset_launch_counts()
    with smoke.plain_versions_refused():
        out = layer(x)
        (out.float().square().mean() + 0.01 * layer.aux_loss).backward()
    torch.cuda.synchronize()
    assert layer.mode == "ragged"
    assert {k: kernels.launch_counts[k] for k in (
        "grouped_matmul_fwd", "grouped_matmul_split_dout",
        "grouped_matmul_bwd_dlhs", "grouped_matmul_bwd_drhs")} == {
            "grouped_matmul_fwd": 3, "grouped_matmul_split_dout": 3,
            "grouped_matmul_bwd_dlhs": 3, "grouped_matmul_bwd_drhs": 3}
    for name, p in layer.named_parameters():
        if name != "e_score_correction_bias":
            assert p.grad is not None and bool(p.grad.isfinite().all()), name
    assert x.grad is not None and bool(x.grad.isfinite().all())


# K6 / K7: the decode path's shapes at tools/bench_decode.py's widths (as
# chip_smoke.QUANT_CASES) and a few off its grid
QUANT_TEST_CASES = {
    "q_proj C1": (1, 1, 2048, 3072), "q_proj C5": (1, 5, 2048, 3072),
    "q_proj C32": (1, 32, 2048, 3072), "kv_a C8": (1, 8, 2048, 576),
    "experts up C4": (16, 4, 2048, 1024),
    "experts up C128": (16, 128, 2048, 1024),
    "experts down C32": (16, 32, 1024, 2048),
    "dense down C8": (1, 8, 8192, 2048),
    "E3 C17 D512 F136 (ragged tiles)": (3, 17, 512, 136),
    "E1 C1 D256 F4 (one column group)": (1, 1, 256, 4),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4], ids=["K6", "K7"])
@pytest.mark.parametrize("case", list(QUANT_TEST_CASES))
def test_quant_bmm_matches_plain(cuda, dtype, bits, case):
    smoke = _smoke()
    e, c, d, f = QUANT_TEST_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x, q, s = smoke.quant_case(gen, e, c, d, f, bits, dtype)
    name = "int8_bmm" if bits == 8 else "int4_bmm"
    dispatch = tquant.int8_bmm if bits == 8 else tquant.int4_bmm
    plain = tquant.int8_bmm_plain if bits == 8 else tquant.int4_bmm_plain
    kernels.reset_launch_counts()
    with smoke.plain_versions_refused():
        out = dispatch(x, q, s, out_dtype=dtype)
    torch.cuda.synchronize()
    # every case here is on the tensor-core routes (int8_bmm, int4_bmm),
    # none on the CUDA-core ones (int8_bmm_fma, int4_bmm_fma)
    assert kernels.launch_counts == smoke.expected_launches(**{name: 1})
    ref = plain(x, q, s, dtype)
    assert out.shape == (e, c, f) and out.dtype == dtype
    tol = (smoke.QUANT_FP32_REL * ref.abs().max().item()
           if dtype == torch.float32 else smoke.bf16_ulp(ref))
    assert smoke.max_err(out, ref) <= tol
    assert torch.equal(dispatch(x, q, s, out_dtype=dtype), out)
    # fp32 x with a bf16 output, as a bf16 model over an fp32 cache asks
    mixed = getattr(kernels, name)(x.float(), q, s, torch.bfloat16)
    ref = plain(x.float(), q, s, torch.bfloat16)
    assert smoke.max_err(mixed, ref) <= smoke.bf16_ulp(ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["q_proj C5", "experts up C128",
                                  "E3 C17 D512 F136 (ragged tiles)"])
def test_int4_bmm_fma_route_matches_plain(cuda, dtype, case):
    """K7's CUDA-core route (``quant_matmul.cu`` and its split reduction),
    which the decode path no longer takes, on the decode shapes: within the
    same limits as the tensor-core route, counted as int4_bmm_fma, two runs
    bitwise equal."""
    smoke = _smoke()
    e, c, d, f = QUANT_TEST_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(9)
    x, q, s = smoke.quant_case(gen, e, c, d, f, 4, dtype)
    kernels.reset_launch_counts()
    out = kernels.int4_bmm_fma(x, q, s, dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts == smoke.expected_launches(int4_bmm_fma=1)
    ref = tquant.int4_bmm_plain(x, q, s, dtype)
    tol = (smoke.QUANT_FP32_REL * ref.abs().max().item()
           if dtype == torch.float32 else smoke.bf16_ulp(ref))
    assert smoke.max_err(out, ref) <= tol
    assert torch.equal(kernels.int4_bmm_fma(x, q, s, dtype), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["q_proj C5", "experts up C4",
                                  "experts down C32", "dense down C8"])
def test_int8_bmm_fma_route_matches_plain(cuda, dtype, case):
    """K6's CUDA-core route (``quant_matmul.cu`` and its split reduction),
    which the decode path no longer takes, on the decode shapes: within the
    same limits as the tensor-core route, counted as int8_bmm_fma, two runs
    bitwise equal."""
    smoke = _smoke()
    e, c, d, f = QUANT_TEST_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(11)
    x, q, s = smoke.quant_case(gen, e, c, d, f, 8, dtype)
    kernels.reset_launch_counts()
    out = kernels.int8_bmm_fma(x, q, s, dtype)
    torch.cuda.synchronize()
    assert kernels.launch_counts == smoke.expected_launches(int8_bmm_fma=1)
    ref = tquant.int8_bmm_plain(x, q, s, dtype)
    tol = (smoke.QUANT_FP32_REL * ref.abs().max().item()
           if dtype == torch.float32 else smoke.bf16_ulp(ref))
    assert smoke.max_err(out, ref) <= tol
    assert torch.equal(kernels.int8_bmm_fma(x, q, s, dtype), out)


def test_int8_bmm_routes_by_shape(cuda):
    """kernels.int8_bmm takes the CUDA-core route off the tensor-core grid
    (D 96: off the 64-row stages; C = 129) and the tensor-core route on it;
    int8_bmm_tc refuses what it does not take."""
    smoke = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(12)
    for (e, c, d, f), name in (((1, 3, 96, 200), "int8_bmm_fma"),
                               ((1, 129, 256, 128), "int8_bmm_fma"),
                               ((1, 3, 256, 200), "int8_bmm")):
        x, q, s = smoke.quant_case(gen, e, c, d, f, 8, torch.bfloat16)
        kernels.reset_launch_counts()
        out = kernels.int8_bmm(x, q, s)
        torch.cuda.synchronize()
        assert kernels.launch_counts == smoke.expected_launches(**{name: 1})
        ref = tquant.int8_bmm_plain(x, q, s)
        assert smoke.max_err(out, ref) <= smoke.bf16_ulp(ref)
    x, q, s = smoke.quant_case(gen, 1, 3, 96, 200, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="tensor-core route"):
        kernels.int8_bmm_tc(x, q, s)


def test_int4_bmm_routes_by_shape(cuda):
    """kernels.int4_bmm takes the CUDA-core route off the tensor-core grid
    (48 packed rows: less than one 64-row stage; C = 129) and the
    tensor-core route on it; int4_bmm_tc refuses what it does not take."""
    smoke = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(10)
    for (e, c, d, f), name in (((1, 3, 96, 200), "int4_bmm_fma"),
                               ((1, 129, 256, 128), "int4_bmm_fma"),
                               ((1, 3, 256, 200), "int4_bmm")):
        x, q, s = smoke.quant_case(gen, e, c, d, f, 4, torch.bfloat16)
        kernels.reset_launch_counts()
        out = kernels.int4_bmm(x, q, s)
        torch.cuda.synchronize()
        assert kernels.launch_counts == smoke.expected_launches(**{name: 1})
        ref = tquant.int4_bmm_plain(x, q, s)
        assert smoke.max_err(out, ref) <= smoke.bf16_ulp(ref)
    x, q, s = smoke.quant_case(gen, 1, 3, 96, 200, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="tensor-core route"):
        kernels.int4_bmm_tc(x, q, s)


def test_quant_wrappers_reject_what_the_kernels_do_not_take(cuda):
    smoke = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, q, s = smoke.quant_case(gen, 2, 3, 256, 130, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="one CUDA device"):
        kernels.int8_bmm(x, q.cpu(), s)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.int8_bmm(x.half(), q, s)
    with pytest.raises(ValueError, match="int8"):
        kernels.int8_bmm(x, q.float(), s)
    with pytest.raises(ValueError, match="D/2"):
        kernels.int4_bmm(x, q, s)
    with pytest.raises(ValueError, match="F <= Fp"):
        kernels.int8_bmm(x, q[..., :128], s)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.int8_bmm(x, q[..., :130].contiguous(), s)
    kernels.reset_launch_counts()
    empty = kernels.int8_bmm(x[:, :0], q, s)
    assert empty.shape == (2, 0, 130)
    assert kernels.launch_counts["int8_bmm"] == 0
    # the einsum route (D not a multiple of 128) launches nothing, as the
    # JAX package leaves its kernel there
    x2, q2, s2 = smoke.quant_case(gen, 1, 4, 200, 64, 8, torch.bfloat16)
    tquant.int8_bmm(x2, q2, s2)
    assert kernels.launch_counts["int8_bmm"] == 0


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_quantized_decode_step_launches_its_kernel(cuda, bits):
    """One decode step of a tiny bf16 LM quantized on the card: K6 (int8)
    or K7 (int4) once per quantized product, no plain version reached, its
    logits within a few bf16 ulps of the plain path's."""
    from deepearth_tpu_torch.models import (
        DeepSeekForCausalLM, causal_lm_decode_step, init_cache)

    smoke = _smoke()
    cfg = DeepSeekBlockConfig(
        hidden_dim=256, n_layers=3, intermediate_size=512,
        mla=MLAConfig(hidden_dim=256, n_heads=4, kv_lora_rank=256,
                      qk_rope_head_dim=32, qk_nope_head_dim=64,
                      v_head_dim=64),
        moe=MoEConfig(n_routed_experts=4, num_experts_per_tok=2,
                      moe_intermediate_size=256, hidden_dim=256),
        first_k_dense_replace=1)
    gen = torch.Generator(device="cuda").manual_seed(7)
    model = DeepSeekForCausalLM(cfg, 512, generator=gen, device="cuda",
                                compute_dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    qm = tquant.quantize_decoder_params(model, bits=bits)
    per_step = 3 * 3 + 3 + 6 * 2  # MLA, layer 0's SwiGLU, 2 MoE layers
    ids = torch.randint(0, 512, (4, 6), generator=gen, device="cuda")
    name = "int8_bmm" if bits == 8 else "int4_bmm"

    def run(plain, pinned=None):
        caches = [init_cache(cfg.mla, 4, 6, torch.bfloat16, "cuda")
                  for _ in range(3)]
        logits = []
        with torch.inference_mode(), smoke.gate_log(pinned) as log, (
                smoke.plain_versions() if plain
                else smoke.plain_versions_refused()):
            for t in range(6):
                out, caches = causal_lm_decode_step(qm, caches, ids[:, t], 6)
                logits.append(out)
        return torch.stack(logits), log

    kernels.reset_launch_counts()
    got, log = run(plain=False)
    torch.cuda.synchronize()
    assert kernels.launch_counts == {**{k: 0 for k in kernels.launch_counts},
                                     name: 6 * per_step}
    ref, _ = run(plain=True, pinned=log)
    assert bool(got.isfinite().all())
    assert smoke.max_err(got, ref) <= 8 * smoke.bf16_ulp(ref)


def test_quick_start_on_the_card_launches_k2_once_and_k1(cuda):
    """The README's quick start on the card (``api.DeepEarth()``'s
    defaults: 4 fusion layers, 4 tokens, token-major): K2-fwd 1 and K1-fwd
    6 launches a predict, K1-fwd on its warp route (4 tokens, past the
    streaming route's 3), and nothing else, no plain version reached; a
    finite float32 embedding within phase 19's limit (chip_smoke.SLICE_TOL)
    of the same predict through the plain versions."""
    from deepearth_tpu_torch.api import DeepEarth

    smoke = _smoke()
    earth = smoke.register_quick_start(DeepEarth())
    assert earth.device.type == "cuda"
    assert smoke.k1_per_forward(earth._config.fusion) == 6
    emb, _ = smoke.counted(lambda: earth.predict(**smoke.QUICK_START),
                           {"grid4d_encode_fwd": 1,
                            "pairwise_attention_fwd_warp": 6}, "quick start")
    assert emb.shape == (256,) and emb.dtype == np.float32
    assert np.isfinite(emb).all()
    with smoke.plain_versions():
        ref = earth.predict(**smoke.QUICK_START)
    err = smoke.api_diff([(emb, ref)])
    assert all(err[k] <= smoke.SLICE_TOL[k] for k in smoke.SLICE_TOL), err


def test_device_prefetch_on_the_card(cuda):
    """data.device_prefetch on the card: every leaf of every batch arrives
    on the card with its dtype and its bits, read by the consumer's stream
    right after the hand-over (its wait on the copy's event) while a
    matmul step runs on that stream, and still intact after later batches
    were sent (record_stream keeps the allocator off their memory); the
    default device is the card."""
    from deepearth_tpu_torch.data import device_prefetch
    from deepearth_tpu_torch.data.batches import leaves, map_leaves

    rng = np.random.default_rng(0)
    batches = [{"xyzt": rng.random((16, 4)).astype(np.float32),
                "modalities": {
                    "species": rng.integers(0, 232, 16).astype(np.int32),
                    "vision": rng.standard_normal((16, 576, 1408)).astype(
                        np.float16)},
                "spatial_mask": rng.random(16) < 0.5} for _ in range(5)]
    w = torch.randn(4096, 4096, device=cuda)
    kept, read = [], []
    for out in device_prefetch(iter(batches), size=2):
        for _ in range(4):
            w = torch.tanh(w @ w)  # the step, on the consumer's stream
        read.append(map_leaves(lambda t: t.clone(), out))
        kept.append(out)
    torch.cuda.synchronize()
    for got in (kept, read):
        assert len(got) == len(batches)
        for out, b in zip(got, batches):
            for t, x in zip(leaves(out), leaves(b)):
                assert t.device.type == "cuda"
                assert np.array_equal(t.cpu().numpy(), x)
                assert t.cpu().numpy().dtype == x.dtype


def _remat_block(kind, gen):
    """(a bf16 block holding one kernel, its input, the kernels it launches
    in a forward): K1 in a token-major fusion layer (self- and
    cross-attention over 3 tokens), K3 in a transformer block over 300
    tokens, K4 in a DeepSeek block's MLA over 1024 tokens, K5 in a DeepSeek
    block whose MoE takes the ragged path (its MLA over 300 tokens runs
    K3)."""
    init = Init(gen, "cuda", torch.bfloat16)
    bf = torch.bfloat16
    mla = dict(hidden_dim=128, n_heads=4, kv_lora_rank=32,
               qk_rope_head_dim=16, qk_nope_head_dim=48, v_head_dim=64)
    if kind == "K1":
        block = FusionLayer(FusionConfig(universal_dim=128, num_heads=4),
                            0, init, bf)
        x = torch.randn((3, 64, 128), generator=gen, device="cuda")
        return (block, x.to(bf), {"pairwise_attention_fwd": 2},
                lambda b, h: b(h, h, token_major=True))
    if kind == "K3":
        block = TransformerBlock(TransformerConfig(hidden_dim=128, n_heads=2),
                                 init, bf)
        x = torch.randn((4, 300, 128), generator=gen, device="cuda")
        return block, x.to(bf), {"vmem_attention_fwd": 1}, None
    cfg = DeepSeekBlockConfig(
        hidden_dim=128, n_layers=2, intermediate_size=256,
        mla=MLAConfig(**mla, use_flash_attention=True),
        moe=MoEConfig(n_routed_experts=8, num_experts_per_tok=2,
                      moe_intermediate_size=256, hidden_dim=128,
                      dispatch_mode="ragged"))
    if kind == "K4":
        block = DeepSeekBlock(cfg, 0, init, bf)
        x = torch.randn((2, 1024, 128), generator=gen, device="cuda")
        return block, x.to(bf), {"flash_attention_fwd": 1}, None
    block = DeepSeekBlock(cfg, 1, init, bf)  # its MLA: K3 at 300 keys
    x = torch.randn((4, 300, 128), generator=gen, device="cuda")
    return (block, x.to(bf), {"grouped_matmul_fwd": 3,
                              "vmem_attention_fwd": 1}, None)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("kind", ["K1", "K3", "K4", "K5"])
def test_kernels_under_remat_give_the_unwrapped_gradients(cuda, kind,
                                                          policy):
    """The block's input and parameter gradients with the block under
    remat_wrap equal the unwrapped block's bit for bit; the forward kernel
    launches once more (the recompute), the backward kernels as often."""
    smoke = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(7)
    block, x, fwd, call = _remat_block(kind, gen)
    call = call or (lambda b, h: b(h))
    dout = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    runs = {}
    for wrapped in (False, True):
        fn = remat_wrap(block, policy) if wrapped else block
        h = x.clone().requires_grad_()
        block.zero_grad(set_to_none=True)
        kernels.reset_launch_counts()
        with smoke.plain_versions_refused():
            out = call(fn, h)
            out.backward(dout)
        torch.cuda.synchronize()
        runs[wrapped] = (out.detach(), h.grad, {
            n: p.grad for n, p in block.named_parameters()
            if p.grad is not None}, dict(kernels.launch_counts))
    (out0, dx0, g0, n0), (out1, dx1, g1, n1) = runs[False], runs[True]
    assert torch.equal(out1, out0)
    assert torch.equal(dx1, dx0)
    assert g1.keys() == g0.keys() and g0
    for name, g in g0.items():
        assert torch.equal(g1[name], g), name
    for name, count in fwd.items():
        assert n0[name] == count and n1[name] == 2 * count, (name, n0, n1)
    assert {k: v for k, v in n1.items() if k not in fwd} == {
        k: v for k, v in n0.items() if k not in fwd}



# -- K8 and K9: Gaussian splatting ------------------------------------------- #

# K9-fwd composites in fp32, a list in runs (kernels.splat_plan) combined
# per pixel; the colour sums and the transmittance product round in
# another order than the plain version's cumprod and einsum (and its exp
# is one ex2), an error that grows like the square root of the list's
# length: 1e-5 of the image's largest entry for lists up to 512 entries,
# 1e-4 for the dense image's thousands. K9-bwd recovers each entry's
# transmittance by multiplying the one after its run by reciprocals, and
# its dense sums meet in atomics in any order: each gradient within 1e-4
# of its largest entry for the tiles (one block a tile: one add an entry,
# two runs bitwise equal, except the background's sum over the tiles),
# 1e-3 for the dense image's sums over 65,536 pixels.
SPLAT_IMAGE_TOL = {"tiled": 1e-5, "dense": 1e-4}
SPLAT_GRAD_TOL = {"tiled": 1e-4, "dense": 1e-3}
# K8 is exact: its lists and counts bit for bit both plain versions'
# (bin_tiles_plain, JAX's top_k; bin_tiles_chunked_plain, its own
# algorithm), and two launches bitwise equal.


def splat_scene(seed, g, behind, device, extent=1.0):
    """A random scene (numpy from ``seed``), ``behind`` Gaussians behind
    the camera of :func:`splat_camera`."""
    from deepearth_tpu_torch.reconstruction import GaussianScene

    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (g, 3))
    means[:behind, 2] = rng.uniform(-4.0, -2.6, behind)
    return GaussianScene(*(torch.tensor(a, dtype=torch.float32, device=device)
                           for a in (means,
                                     np.log(0.03) + 0.3 * rng.normal(size=(g, 3)),
                                     rng.normal(size=(g, 4)),
                                     rng.normal(size=(g, 3)),
                                     rng.normal(0.5, 1.5, g))))


def splat_camera(device, size=64):
    from deepearth_tpu_torch.reconstruction import Camera

    return Camera(torch.eye(3, device=device),
                  torch.tensor([0.0, 0.0, 2.5], device=device),
                  size * 220 / 256, size * 220 / 256, size / 2, size / 2,
                  size, size)


def splat_lists(scene, cam, kind, k=None):
    """The inputs render / render_tiled give K9 (and K8's, tiled)."""
    from deepearth_tpu_torch.reconstruction import gaussian_splat as tgs

    lists = (tgs.dense_lists(scene, cam) if kind == "dense"
             else tgs.tile_lists(scene, cam, max_per_tile=k))
    return lists.lists, lists.geometry, lists.binning


SPLAT_CASES = {  # name: (kind, G, behind, K, scene extent)
    "tiled_k512": ("tiled", 4000, 40, 512, 1.0),
    "tiled_over_budget": ("tiled", 4000, 40, 16, 1.0),
    "tiled_empty_tiles": ("tiled", 300, 10, 64, 0.1),
    "dense": ("dense", 1500, 30, None, 1.0),
}


@pytest.mark.parametrize("name", SPLAT_CASES)
def test_splat_bin_matches_plain(cuda, name):
    from deepearth_tpu_torch.ops import splat

    kind, g, behind, k, extent = SPLAT_CASES[name]
    if kind == "dense":
        k = 64
    scene = splat_scene(0, g, behind, cuda, extent)
    _, _, binning = splat_lists(scene, splat_camera(cuda), "tiled", k)
    kernels.reset_launch_counts()
    idx, count = kernels.splat_bin(*binning)
    torch.cuda.synchronize()
    assert kernels.launch_counts["splat_bin"] == 1
    ref_idx, ref_count = splat.bin_tiles_plain(*binning)
    assert torch.equal(count, ref_count)
    assert torch.equal(idx, ref_idx)
    chunked = splat.bin_tiles_chunked_plain(*binning)
    assert torch.equal(chunked[0], idx) and torch.equal(chunked[1], count)
    again = kernels.splat_bin(*binning)
    assert torch.equal(again[0], idx) and torch.equal(again[1], count)
    if name == "tiled_empty_tiles":
        assert (count == 0).any() and (count > 0).any()
    if name == "tiled_over_budget":
        assert (count == k).any()


# chip_smoke.splat_bin_edges' cases and splat_bin_grids' grids (T = 4,096
# in one window of K8's counters, 16,384 in three, 5,000 x 2 tiles)
SPLAT_BIN_EDGES = ("edge_on_centre", "inf_radius", "huge_xy", "far_rounding",
                   "nan_xy_valid", "all_invalid", "k_equals_g", "non_square",
                   "chunk_inside_first_k", "g_not_multiple", "chunks_past_k",
                   "tile_of_10", "grid_1024px", "grid_2048px",
                   "grid_5000x2_tiles")


@pytest.mark.parametrize("name", SPLAT_BIN_EDGES)
def test_splat_bin_edges_match_plain(cuda, name):
    from deepearth_tpu_torch.ops import splat

    smoke = _smoke()
    cases = smoke.splat_bin_edges(cuda) | smoke.splat_bin_grids(cuda)
    assert set(cases) == set(SPLAT_BIN_EDGES)
    *binning, chunk = cases[name]
    kernels.reset_launch_counts()
    idx, count = smoke.splat_bin_at(binning, chunk)
    torch.cuda.synchronize()
    assert kernels.launch_counts["splat_bin"] == 1
    ref_idx, ref_count = splat.bin_tiles_plain(*binning)
    assert torch.equal(count, ref_count) and torch.equal(idx, ref_idx)
    chunked = splat.bin_tiles_chunked_plain(*binning, chunk)
    assert torch.equal(chunked[0], idx) and torch.equal(chunked[1], count)
    again = smoke.splat_bin_at(binning, chunk)
    assert torch.equal(again[0], idx) and torch.equal(again[1], count)


@pytest.mark.parametrize("background", [False, True], ids=["no_bg", "bg"])
@pytest.mark.parametrize("name", SPLAT_CASES)
def test_splat_composite_matches_plain(cuda, name, background):
    from deepearth_tpu_torch.ops import splat

    kind, g, behind, k, extent = SPLAT_CASES[name]
    scene = splat_scene(1, g, behind, cuda, extent)
    lists, geometry, _ = splat_lists(scene, splat_camera(cuda), kind, k)
    bg = torch.tensor([0.2, 0.3, 0.4], device=cuda) if background else None
    kernels.reset_launch_counts()
    out, state = kernels.splat_composite_fwd(*lists, bg, *geometry,
                                             keep_state=True)
    render_only = kernels.splat_composite_fwd(*lists, bg, *geometry)
    dout = torch.randn(out.shape, generator=torch.Generator(
        device="cuda").manual_seed(2), device=cuda)
    grads = kernels.splat_composite_bwd(*lists, bg, state, dout, *geometry)
    again = kernels.splat_composite_bwd(*lists, bg, state, dout, *geometry)
    torch.cuda.synchronize()
    assert kernels.launch_counts["splat_composite_fwd"] == 2
    assert kernels.launch_counts["splat_composite_bwd"] == 2
    assert torch.equal(out, render_only)
    ref = splat.composite_plain(*lists, bg, *geometry)
    assert (out - ref).abs().max() <= SPLAT_IMAGE_TOL[kind] * ref.abs().max()
    # the kept state: per (run, pixel) the transmittance after the run and
    # the colour behind it, as the plain segment algebra keeps them
    xy, abc, opac, color = lists
    assert state.shape == kernels.splat_state_shape(
        xy.shape[0], xy.shape[1], *geometry[2:])
    _, ref_state = splat.composite_segments_plain(*lists, bg, *geometry)
    got_ends = torch.ldexp(state[:, :, 0], state[:, :, 1].int())
    ref_ends = torch.ldexp(ref_state[:, :, 0], ref_state[:, :, 1].int())
    assert (got_ends - ref_ends).abs().max() <= SPLAT_IMAGE_TOL[kind]
    assert ((state[:, :, 2:] - ref_state[:, :, 2:]).abs().max()
            <= SPLAT_IMAGE_TOL[kind] * ref_state[:, :, 2:].abs().max())
    # the final transmittance: the plain image of black entries over white
    ref_t = splat.composite_plain(xy, abc, opac, torch.zeros_like(color),
                                  torch.ones(3, device=cuda), *geometry)
    got_t = splat.final_transmittance(state, *geometry)
    assert (got_t - ref_t[..., 0]).abs().max() <= SPLAT_IMAGE_TOL[kind]
    ref_grads = splat.composite_bwd_plain(*lists, bg, dout, *geometry)
    for got, want, rerun in zip(grads, ref_grads, again):
        if want is None:
            assert got is None and not background
            continue
        assert (got - want).abs().max() <= (
            SPLAT_GRAD_TOL[kind] * want.abs().max())
        if kind == "tiled" and got.dim() > 1:  # not the background's sum
            assert torch.equal(got, rerun)
    # a zeroed entry (unfilled slot, behind the camera) adds no gradient
    off = lists[2] == 0
    assert all((grads[i][off] == 0).all() for i in (0, 1, 3))


def test_splat_render_and_gradients_go_through_the_kernels(cuda):
    """render / render_tiled and their backward on the card launch K8
    (tiled), K9-fwd and K9-bwd once each and no plain version, and agree
    with the plain versions; the Gaussians behind the camera get zero
    gradients."""
    from deepearth_tpu_torch.reconstruction import GaussianScene
    from deepearth_tpu_torch.reconstruction import gaussian_splat as tgs

    smoke = _smoke()
    scene = splat_scene(3, 2000, 20, cuda)
    cam = splat_camera(cuda)
    target = torch.rand((64, 64, 3), generator=torch.Generator(
        device="cuda").manual_seed(4), device=cuda)
    for kind, fn, want in (
            ("dense", tgs.render, {"splat_composite_fwd": 1,
                                   "splat_composite_bwd": 1}),
            ("tiled", tgs.render_tiled, {"splat_bin": 1,
                                         "splat_composite_fwd": 1,
                                         "splat_composite_bwd": 1})):
        runs = []
        for plain in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in scene]
            kernels.reset_launch_counts()
            with (smoke.plain_versions() if plain
                  else smoke.plain_versions_refused()):
                img = fn(GaussianScene(*leaves), cam)
                loss = torch.mean((img - target) ** 2)
                grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            if not plain:
                assert {n: c for n, c in kernels.launch_counts.items()
                        if c} == want
            runs.append((img.detach(), grads))
        (img, grads), (ref_img, ref_grads) = runs
        assert (img - ref_img).abs().max() <= (
            SPLAT_IMAGE_TOL[kind] * ref_img.abs().max())
        behind = scene.means[:, 2] < -2.5
        for got, ref in zip(grads, ref_grads):
            assert (got - ref).abs().max() <= (
                SPLAT_GRAD_TOL[kind] * ref.abs().max() + 1e-12)
            assert (got[behind] == 0).all()


@pytest.mark.parametrize("kind, g, backward", [
    ("tiled", 65_536, True), ("dense", 16_000, False),
    ("dense", 2_000, True)], ids=["tiled_65536", "dense_16000", "dense_2000"])
def test_splat_composite_at_phase_23_shapes(cuda, kind, g, backward):
    """K9-fwd (and K9-bwd) against their plain versions at phase 23's
    scenes (256 x 256, init_scene at G, tiles of 16 with K = 512); the
    tiled backward twice, bitwise equal."""
    from deepearth_tpu_torch.ops import splat
    from deepearth_tpu_torch.reconstruction import gaussian_splat as tgs

    smoke = _smoke()
    gen = torch.Generator(device="cuda").manual_seed(g)
    scene = tgs.init_scene(gen, g)
    inp = smoke.splat_inputs(scene, smoke.splat_camera(), kind)
    lists, geometry = inp["lists"], inp["geometry"]
    kernels.reset_launch_counts()
    out, state = kernels.splat_composite_fwd(*lists, None, *geometry,
                                             keep_state=True)
    ref = splat.composite_plain(*lists, None, *geometry)
    assert (out - ref).abs().max() <= SPLAT_IMAGE_TOL[kind] * ref.abs().max()
    if not backward:
        return
    dout = torch.randn(out.shape, generator=gen, device=cuda)
    grads = kernels.splat_composite_bwd(*lists, None, state, dout, *geometry)
    again = kernels.splat_composite_bwd(*lists, None, state, dout, *geometry)
    torch.cuda.synchronize()
    assert kernels.launch_counts["splat_composite_bwd"] == 2
    ref_grads = splat.composite_bwd_plain(*lists, None, dout, *geometry)
    for got, want, rerun in zip(grads[:4], ref_grads[:4], again[:4]):
        assert (got - want).abs().max() <= (
            SPLAT_GRAD_TOL[kind] * want.abs().max())
        if kind == "tiled":
            assert torch.equal(got, rerun)


def test_splat_wrappers_reject_what_the_kernels_do_not_take(cuda):
    xy = torch.zeros((2, 4, 2), device=cuda)
    abc, col = torch.zeros((2, 4, 3), device=cuda), torch.zeros((2, 4, 3),
                                                                device=cuda)
    opac = torch.zeros((2, 4), device=cuda)
    with pytest.raises(ValueError, match="one list a region"):
        kernels.splat_composite_fwd(xy, abc, opac, col, None, 16, 16, 16, 16)
    with pytest.raises(ValueError, match="float32"):
        kernels.splat_composite_fwd(xy.double(), abc, opac, col, None, 16,
                                    32, 16, 16)
    # the state of the single-walk design, a pixel's final transmittance
    with pytest.raises(ValueError, match="state must be"):
        kernels.splat_composite_bwd(xy, abc, opac, col, None,
                                    torch.zeros((16, 32, 2), device=cuda),
                                    torch.zeros((16, 32, 3), device=cuda),
                                    16, 32, 16, 16)
    with pytest.raises(ValueError, match="k must be"):
        kernels.splat_bin(torch.zeros((3, 2), device=cuda),
                          torch.zeros(3, device=cuda),
                          torch.ones(3, dtype=torch.bool, device=cuda),
                          2, 2, 16, 4)


# -- the operators torch.export traces: K1-fwd, K2-fwd ----------------------- #


def test_k1_and_k2_operators_pass_opcheck(cuda):
    """torch.library.opcheck on the two registered operators: the schema,
    the fake implementation against the kernel's output, and the op through
    AOT dispatch with dynamic shapes."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn((3, 64, 256), generator=gen, device=cuda).to(
        torch.bfloat16) for _ in range(3))
    torch.library.opcheck(torch.ops.deepearth.pairwise_attention_fwd.default,
                          (q, k, v, 4, 0.125, None))
    mask = torch.rand((64, 3), generator=gen, device=cuda) > 0.3
    torch.library.opcheck(torch.ops.deepearth.pairwise_attention_fwd.default,
                          (q.float(), k.float(), v.float(), 4, 0.125, mask))
    xyzt = torch.rand((100, 4), generator=gen, device=cuda)
    tables = [torch.randn((l, 2 ** 12, 2), generator=gen, device=cuda) * 1e-2
              for l in (4, 2)]
    res = [torch.tensor([16.0 * 2 ** i for i in range(t.shape[0])],
                        device=cuda) for t in tables]
    spatial = torch.rand(100, generator=gen, device=cuda) > 0.5
    torch.library.opcheck(torch.ops.deepearth.grid4d_encode_fwd.default,
                          (xyzt, tables, res, [2 ** 12, 2 ** 12],
                           [True, True], [0, 1, 2, 3], [3, 1], [1, 2],
                           spatial, None, torch.bfloat16))


def test_exported_quick_start_launches_k1_and_k2(cuda):
    """export_model_forward of the README's quick start, reloaded: the
    program launches K2-fwd and K1-fwd as the eager forward does, through
    the operators, and gives its outputs bit for bit."""
    from deepearth_tpu_torch.api import DeepEarth
    from deepearth_tpu_torch.export import export_model_forward, load_exported

    smoke = _smoke()
    earth = smoke.register_quick_start(DeepEarth())
    job = smoke.api_batch(3, 16)
    earth.predict_batch(**job)
    batch = earth._prepare_batch(job["locations"], job["times"], job["data"])
    blob = export_model_forward(earth._model, None, batch)
    fn = load_exported(blob)
    runs = []
    for call in (lambda: fn(batch), lambda: earth._model(batch)):
        kernels.reset_launch_counts()
        with torch.no_grad(), smoke.plain_versions_refused():
            out = call()
        torch.cuda.synchronize()
        runs.append((out, {n: c for n, c in kernels.launch_counts.items()
                           if c}))
    (fused, recon), got = runs[0]
    ref, want = runs[1]
    assert got == want == {"grid4d_encode_fwd": 1,
                           "pairwise_attention_fwd_warp": 6}
    assert torch.equal(fused, ref["fused_representation"])
    assert all(torch.equal(recon[k], ref["reconstructions"][k])
               for k in ref["reconstructions"])


def test_export_refuses_a_model_reaching_another_kernel(cuda):
    """A function that reaches a backward kernel (K3-bwd here; none is an
    operator) raises ValueError under the export trace: an exported
    program is an inference program."""
    from deepearth_tpu_torch.export import export_fn

    q = torch.randn((2, 2, 300, 64), device=cuda)
    with pytest.raises(ValueError, match="inference program"):
        export_fn(lambda x: kernels.vmem_attention_bwd(x, x, x, x, 0.125), q)


def _operator_cases(cuda):
    """name -> (the operator, a function reaching it through the ops
    layer, its inputs on the card at a small shape)."""
    from deepearth_tpu_torch.ops import splat as tsplat

    gen = torch.Generator(device="cuda").manual_seed(21)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    res = torch.tensor([16.0 * 1.5 ** i for i in range(8)], device=cuda)
    w8 = torch.randint(-127, 128, (1, 256, 384), generator=gen, device=cuda,
                       dtype=torch.int8)
    w4 = torch.randint(-128, 128, (1, 128, 384), generator=gen, device=cuda,
                       dtype=torch.int8)
    scale = torch.rand((1, 1, 384), generator=gen, device=cuda) * 1e-2
    xy = torch.rand((300, 2), generator=gen, device=cuda) * 64
    radius = torch.rand(300, generator=gen, device=cuda) * 6
    valid = torch.rand(300, generator=gen, device=cuda) > 0.1
    lists = (rand(16, 96, 2).abs() * 16, rand(16, 96, 3).abs() * 0.05,
             torch.rand((16, 96), generator=gen, device=cuda),
             torch.rand((16, 96, 3), generator=gen, device=cuda))
    bf = torch.bfloat16
    return {
        "hash_encode_fwd": (lambda c, t: the.hash_encode(
            c, t, res, table_size=2 ** 12), (
                torch.rand((1000, 3), generator=gen, device=cuda),
                rand(8, 2 ** 12, 2) * 1e-2)),
        "vmem_attention_fwd": (lambda q, k, v: tvmem.vmem_attention(
            q, k, v, scale=0.125), tuple(rand(2, 4, 300, 64, dtype=bf)
                                         for _ in range(3))),
        "flash_attention_fwd": (lambda q, k, v: tflash.flash_attention(
            q, k, v, scale=0.125, causal=True), tuple(
                rand(1, 2, 1100, 64, dtype=bf) for _ in range(3))),
        "grouped_matmul_fwd": (lambda lhs, rhs, sizes: tgmm.gmm(
            lhs, rhs, sizes), (
                rand(100, 64, dtype=bf), rand(4, 64, 128, dtype=bf),
                torch.tensor([30, 0, 50, 20], dtype=torch.int32,
                             device=cuda))),
        "int8_bmm": (lambda x, w, s: tquant.int8_bmm(x, w, s), (
            rand(1, 8, 256, dtype=bf), w8, scale)),
        "int4_bmm": (lambda x, w, s: tquant.int4_bmm(x, w, s), (
            rand(1, 8, 256, dtype=bf), w4, scale)),
        "splat_bin": (lambda a, r, m: tsplat.bin_tiles(a, r, m, 4, 4, 16, 32),
                      (xy, radius, valid)),
        "splat_composite_fwd": (lambda *t: tsplat.composite(
            *t, None, 64, 64, 16, 16), lists),
    }


@pytest.mark.parametrize("name", [
    "hash_encode_fwd", "vmem_attention_fwd", "flash_attention_fwd",
    "grouped_matmul_fwd", "int8_bmm", "int4_bmm", "splat_bin",
    "splat_composite_fwd"])
def test_exported_forward_operator_matches_eager(cuda, name):
    """export_fn of a function reaching one forward kernel through the ops
    layer, reloaded: the program holds the operator, launches the kernel
    as the eager call does (no plain version reached), and gives its
    outputs bit for bit."""
    from deepearth_tpu_torch.export import export_fn, load_exported

    smoke = _smoke()
    fn, args = _operator_cases(cuda)[name]
    blob = export_fn(fn, *args)
    program = load_exported(blob)
    runs = []
    for call in (lambda: program(*args), lambda: fn(*args)):
        kernels.reset_launch_counts()
        with torch.no_grad(), smoke.plain_versions_refused():
            out = call()
        torch.cuda.synchronize()
        runs.append((out if isinstance(out, tuple) else (out,),
                     {n: c for n, c in kernels.launch_counts.items() if c}))
    (got, got_launches), (want, want_launches) = runs
    assert got_launches == want_launches and len(want_launches) == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    targets = {str(n.target) for n in torch.export.load(
        io.BytesIO(blob)).graph_module.graph.nodes if n.op == "call_function"}
    assert f"deepearth.{name}.default" in targets


def test_forward_operators_pass_opcheck(cuda):
    """torch.library.opcheck on the eight forward operators added beside
    K1-fwd's and the Grid4D encode's: the schema, each fake against the
    kernel's output (shapes, strides, dtypes), and the operator through AOT
    dispatch with dynamic shapes, at _operator_cases' inputs."""
    cases = _operator_cases(cuda)
    coords, tables = cases["hash_encode_fwd"][1]
    res = torch.tensor([16.0 * 1.5 ** i for i in range(8)], device=cuda)
    q, k, v = cases["vmem_attention_fwd"][1]
    fq, fk, fv = cases["flash_attention_fwd"][1]
    x, w8, scale = cases["int8_bmm"][1]
    ops = torch.ops.deepearth
    for op, args in (
            (ops.hash_encode_fwd, (coords, tables, res, 2 ** 12, True)),
            (ops.vmem_attention_fwd, (q, k, v, 0.125, None)),
            (ops.flash_attention_fwd, (fq, fk, fv, 0.125, None, True)),
            (ops.grouped_matmul_fwd, cases["grouped_matmul_fwd"][1]),
            (ops.int8_bmm, (x, w8, scale, torch.bfloat16)),
            (ops.int4_bmm, (*cases["int4_bmm"][1], torch.float32)),
            (ops.splat_bin, (*cases["splat_bin"][1], 4, 4, 16, 32)),
            (ops.splat_composite_fwd, (*cases["splat_composite_fwd"][1],
                                       None, 64, 64, 16, 16))):
        torch.library.opcheck(op.default, args)
