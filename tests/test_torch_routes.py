"""The routes that K1, K2-bwd, K3, K4, K5-fwd, K6 and K7 take on the card,
decided on the CPU.

``kernels.gmm_fwd_tma_route``, ``kernels.flash_fwd_tma_route``,
``kernels.flash_bwd_tma_route``, ``kernels.vmem_fwd_tma_route`` and
``kernels.vmem_bwd_tma_route`` choose between the wgmma kernels over TMA
tiles, the mma.sync kernels and the CUDA-core kernels from the shapes (and
for the attention kernels the strides) alone,
``kernels.int8_bmm_tc_route`` and ``kernels.int4_bmm_tc_route`` between
K6's and K7's tensor-core kernels and their CUDA-core ones from the shapes
alone, ``kernels.pairwise_fwd_tma_route`` and
``kernels.pairwise_bwd_tma_route`` between K1's streaming kernels and its
one-warp-per-(row, head) kernels from the shapes and strides, and
``kernels.hash_bwd_dense_route`` between K2-bwd's dense and scalar kernels
from F, so they are plain functions that run here. Every int8 and int4
product of ``chip_smoke``'s decode model (phase 18) at B=1, 8 and 32 is
held to the tensor-core routes, and the q, k and v that the A-stack's
fusion attention hands K1 (the fused projection's views) to both of K1's
streaming routes. The
MLA hands
K4 (at 4608 patches, its flash gate) or K3 (at 576, through
``dot_product_attention``) views of its projections: these tests build the
port's ``MLAttention`` on the CPU at the multimodal model's vision config
and at the flagship's, and the multimodal model's query-token
cross-attention, capture the q, k and v each forms, and hold their head
dims and strides to the TMA routes, so that the main path cannot slip onto
mma.sync unseen.
"""

import itertools
import os
import sys
from unittest import mock

import pytest
import torch

from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.configs import ModalityConfig, integrated_config
from deepearth_tpu_torch.models import deepseek, encoders, fusion
from deepearth_tpu_torch.models.encoders import encoder_transformer_config
from deepearth_tpu_torch.models.layers import Init
from deepearth_tpu_torch.ops import attention_vmem

CLIP_PATCHES, IMAGE_PATCHES = 4608, 576


@pytest.mark.parametrize("dtype,m,k,n,want", [
    (torch.bfloat16, 2816, 2048, 2048, True),  # the simulator at B=64
    (torch.bfloat16, 1, 8, 8, True),  # the smallest shape on the route
    (torch.bfloat16, 300, 128, 256, True),  # the card tests' MoE layer
    (torch.bfloat16, 0, 64, 64, False),  # M = 0 launches nothing
    (torch.bfloat16, 100, 100, 136, False),  # K off the 8-element grid
    (torch.bfloat16, 100, 136, 130, False),  # N off the grid
    (torch.bfloat16, 64, 4, 64, False),  # K below 8
    (torch.float32, 2816, 2048, 2048, False),  # fp32: the CUDA cores
    (torch.float16, 64, 64, 64, False),
])
def test_gmm_fwd_tma_route(dtype, m, k, n, want):
    assert kernels.gmm_fwd_tma_route(dtype, m, k, n) is want


CONTIGUOUS = [8 * 4608 * 48, 4608 * 48, 48]
# (dtype, Dqk, Dv, the strides of q, k, v along B, H, N, whether the TMA
# routes take them); K4-fwd and K4-bwd share the rule, with head dims up to
# 256 (K3's routes stop at 128: VMEM_ROUTE_CASES)
ATTENTION_ROUTE_CASES = [
    (torch.bfloat16, 48, 32, CONTIGUOUS * 3, True),  # the multimodal MLA
    (torch.bfloat16, 128, 128, [8 * 4608 * 128, 128, 1024] * 3, True),
    (torch.bfloat16, 64, 64, [64] * 9, True),
    (torch.bfloat16, 8, 8, [8] * 9, True),
    (torch.bfloat16, 136, 128, [8 * 136] * 9, True),  # past 128
    (torch.bfloat16, 192, 128, [8 * 192] * 9, True),  # DeepSeek-V3's MLA
    (torch.bfloat16, 256, 256, [8 * 256] * 9, True),
    (torch.bfloat16, 264, 128, [8 * 264] * 9, False),  # past 256
    (torch.bfloat16, 192, 264, [8 * 264] * 9, False),
    (torch.bfloat16, 40, 36, [8 * 40] * 9, False),  # Dv off the grid
    (torch.bfloat16, 4, 8, [8] * 9, False),  # below 8
    (torch.bfloat16, 48, 32, CONTIGUOUS * 2 + [8 * 4608 * 66, 66, 528],
     False),  # an unaligned head stride of v
    (torch.bfloat16, 48, 32, [0] + CONTIGUOUS[1:] + CONTIGUOUS * 2,
     False),  # a broadcast batch
    (torch.bfloat16, 48, 32, CONTIGUOUS * 2 + [8 * 4608 * 64, 64, 513],
     False),  # an unaligned row stride of v
    (torch.float32, 48, 32, CONTIGUOUS * 3, False),  # fp32: the CUDA cores
]


@pytest.mark.parametrize("dtype,d_qk,d_v,strides,want",
                         ATTENTION_ROUTE_CASES)
def test_flash_bwd_tma_route(dtype, d_qk, d_v, strides, want):
    assert kernels.flash_bwd_tma_route(dtype, d_qk, d_v, strides) is want


@pytest.mark.parametrize("dtype,d_qk,d_v,strides,want",
                         ATTENTION_ROUTE_CASES + [
    (torch.bfloat16, 128, 128, [8 * 4608 * 256, 256, 2048, 4608 * 256, 256,
                                2048, 4608 * 256, 256, 2048], True),
    (torch.bfloat16, 48, 32, [8, 4608 * 48, 48] * 3,
     True),  # a batch of one: _tma_strides gives its dim the stride 8
    (torch.bfloat16, 128, 120, [8 * 128] * 9, True),  # Dv below the panel
    (torch.bfloat16, 48, 32, CONTIGUOUS * 2 + [8 * 4608 * 64, 64, 516],
     False),  # a row stride of v off the grid
])
def test_flash_fwd_tma_route(dtype, d_qk, d_v, strides, want):
    assert kernels.flash_fwd_tma_route(dtype, d_qk, d_v, strides) is want


MLA_576 = [8 * 576 * 48, 576 * 48, 48]
# (dtype, Dqk, Dv, the strides of q, k, v along B, H, N, whether the TMA
# routes take them); K3-fwd and K3-bwd share the rule
VMEM_ROUTE_CASES = [
    (torch.bfloat16, 48, 32, MLA_576 * 2 + [576 * 8 * 64, 64, 8 * 64],
     True),  # the multimodal MLA site, v a view of the kv projection
    (torch.bfloat16, 64, 64, [8 * 16 * 64, 64, 512, 8 * 576 * 64, 64, 512,
                              8 * 576 * 64, 64, 512], True),  # cross site
    (torch.bfloat16, 128, 128, [8 * 576 * 128, 128, 1024] * 3, True),
    (torch.bfloat16, 48, 80, [8 * 48] * 6 + [8 * 80] * 3, True),
    (torch.bfloat16, 8, 8, [8] * 9, True),  # one key, the narrowest heads
    (torch.bfloat16, 40, 36, [8 * 40] * 9, False),  # Dv off the grid
    (torch.bfloat16, 48, 32, MLA_576 * 2 + [576 * 8 * 66, 66, 8 * 66],
     False),  # head and row strides of v off the grid
    (torch.bfloat16, 136, 64, [8 * 136] * 9, False),  # past 128
    (torch.float32, 48, 32, MLA_576 * 3, False),  # fp32: the CUDA cores
    (torch.float16, 48, 32, MLA_576 * 3, False),
]


@pytest.mark.parametrize("dtype,d_qk,d_v,strides,want", VMEM_ROUTE_CASES)
def test_vmem_bwd_tma_route(dtype, d_qk, d_v, strides, want):
    assert kernels.vmem_bwd_tma_route(dtype, d_qk, d_v, strides) is want


@pytest.mark.parametrize("dtype,d_qk,d_v,strides,want", VMEM_ROUTE_CASES)
def test_vmem_fwd_tma_route(dtype, d_qk, d_v, strides, want):
    assert kernels.vmem_fwd_tma_route(dtype, d_qk, d_v, strides) is want


@pytest.mark.parametrize("e,c,d,fp,want", [
    (1, 8, 2048, 3072, True),  # q_proj at B=8
    (1, 1, 2048, 640, True),  # kv_a_proj_with_mqa (F 576) at B=1
    (16, 16, 2048, 1024, True),  # the experts' w_gate at B=32
    (16, 128, 1024, 2048, True),  # the drop-free slots of B=32
    (1, 8, 8192, 2048, True),  # layer 0's w_down: cluster 16, chunk 256
    (1, 1, 128, 128, True),  # the smallest: one stage, one tile
    (1, 129, 2048, 3072, False),  # C past 128
    (1, 8, 2048, 3000, False),  # Fp off the 128 grid
    (1, 8, 96, 128, False),  # 48 packed rows: less than one stage
    (1, 8, 2 * 2112, 128, False),  # 2112 rows: one chunk past 1024
    (1, 8, 2049, 3072, False),  # D odd
    (1, 0, 2048, 3072, False),  # C = 0 launches nothing
])
def test_int4_bmm_tc_route(e, c, d, fp, want):
    assert kernels.int4_bmm_tc_route(e, c, d, fp) is want


@pytest.mark.parametrize("e,c,rows,fp,plan", [
    (1, 8, 1024, 3072, (1, 1, 8, 128)),  # q_proj: 24 tiles x 8 = 192
    (1, 8, 1024, 640, (1, 1, 16, 64)),  # kv_a: 5 tiles, the most ranks
    (16, 4, 1024, 1024, (1, 1, 2, 512)),  # 128 tiles x 2
    (16, 32, 512, 2048, (4, 1, 1, 512)),  # 256 tiles: no split
    (16, 128, 1024, 1024, (4, 4, 1, 1024)),  # four column tiles of 32
    (1, 16, 4096, 2048, (2, 1, 16, 256)),
    (1, 1, 64 * 33, 128, (1, 1, 1, 64 * 33)),  # 33 stages: no split fits
])
def test_int4_tc_plan(e, c, rows, fp, plan):
    assert kernels.int4_tc_plan(e, c, rows, fp) == plan


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_every_int4_decode_product_takes_the_tensor_core_route(batch):
    """Each K7 product of one decode step of chip_smoke's decode model
    (tools/bench_decode.py's config, its int4 tree built on the meta
    device) takes K7's tensor-core route: the dense projections at E=1,
    C=batch, the experts at E=16, C=capacity(batch)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    products = chip_smoke.decode_products(
        chip_smoke.decode_trees_on_meta()[4], batch)
    assert sum(products.values()) == chip_smoke.QUANT_PER_STEP
    for bits, e, c, d, f in products:
        assert bits == 4
        assert kernels.int4_bmm_tc_route(e, c, d, -(-f // 128) * 128), (
            e, c, d, f)


@pytest.mark.parametrize("e,c,d,fp,want", [
    (1, 8, 2048, 3072, True),  # q_proj at B=8
    (1, 1, 2048, 640, True),  # kv_a_proj_with_mqa (F 576) at B=1
    (16, 4, 2048, 1024, True),  # the experts' w_gate at B <= 8
    (16, 16, 1024, 2048, True),  # the experts' w_down at B=32
    (16, 128, 2048, 1024, True),  # 128 slots: chunks of 1024 over 2 ranks
    (1, 8, 8192, 2048, True),  # layer 0's w_down: cluster 16, chunk 512
    (1, 1, 64, 128, True),  # the smallest: one stage, one tile
    (1, 129, 2048, 3072, False),  # C past 128
    (1, 8, 2048, 3000, False),  # Fp off the 128 grid
    (1, 8, 96, 128, False),  # D off the 64-row stages
    (1, 8, 48, 128, False),  # less than one stage
    (1, 8, 64 * 33, 128 * 132, False),  # 33 stages a chunk: no split fits
    (1, 0, 2048, 3072, False),  # C = 0 launches nothing
])
def test_int8_bmm_tc_route(e, c, d, fp, want):
    assert kernels.int8_bmm_tc_route(e, c, d, fp) is want


@pytest.mark.parametrize("e,c,rows,fp,plan", [
    (1, 8, 2048, 3072, (1, 1, 8, 256)),  # q_proj: 24 tiles x 8 = 192
    (16, 4, 2048, 1024, (1, 1, 2, 1024)),  # the experts: 128 tiles x 2
    (1, 8, 8192, 2048, (1, 1, 16, 512)),  # layer 0's 8192 -> 2048: 16 tiles
    (1, 8, 2048, 640, (1, 1, 16, 128)),  # kv_a: 5 tiles, the most ranks
    (16, 16, 1024, 2048, (2, 1, 1, 1024)),  # 256 tiles: no split
    (16, 128, 2048, 1024, (4, 4, 2, 1024)),  # 512 tiles, but 2048 rows
    (1, 1, 64 * 33, 128 * 132, (1, 1, 1, 64 * 33)),  # no power of two fits
])
def test_int8_tc_plan(e, c, rows, fp, plan):
    assert kernels.int8_tc_plan(e, c, rows, fp) == plan


def test_int8_tc_plan_is_int4s_where_int4s_fits():
    """K6's plan departs from K7's rule only where K7's chunk would pass
    1024 rows."""
    for e, c, rows, fp in itertools.product((1, 4, 16), (1, 8, 32, 128),
                                            (64, 512, 1024, 2048, 8192),
                                            (128, 640, 1024, 3072)):
        plan = kernels.int4_tc_plan(e, c, rows, fp)
        if plan[3] <= kernels.QUANT_TC_MAX_CHUNK:
            assert kernels.int8_tc_plan(e, c, rows, fp) == plan


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_every_int8_decode_product_takes_the_tensor_core_route(batch):
    """Each K6 product of one decode step of chip_smoke's decode model
    (tools/bench_decode.py's config, its int8 tree built on the meta
    device) takes K6's tensor-core route: the dense projections at E=1,
    C=batch, the experts at E=16, C=capacity(batch)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    products = chip_smoke.decode_products(
        chip_smoke.decode_trees_on_meta()[8], batch)
    assert sum(products.values()) == chip_smoke.QUANT_PER_STEP
    for bits, e, c, d, f in products:
        assert bits == 8
        assert kernels.int8_bmm_tc_route(e, c, d, -(-f // 128) * 128), (
            e, c, d, f)


A_STACK = [4096 * 2304, 2304]  # the fused qkv projection's (token, row)
# strides at B=4096, D=768
# (dtype, Nq, Nk, head dim, the token and row strides of q, k and v as
# kernels._pairwise_strides gives them, whether K1-bwd's streaming route
# takes them)
PAIRWISE_ROUTE_CASES = [
    (torch.bfloat16, 3, 3, 64, A_STACK * 3, True),  # the A-stack site
    (torch.bfloat16, 3, 3, 64, [4096 * 768, 768] * 3, True),  # contiguous
    (torch.bfloat16, 3, 3, 64, [4096 * 768, 768] + [4096 * 1536, 1536] * 2,
     True),  # cross-attention: k, v views of the fused kv projection
    (torch.bfloat16, 1, 3, 8, [8, 96] * 3, True),  # one query
    (torch.bfloat16, 2, 3, 256, [4096 * 512, 512] * 3, True),
    (torch.bfloat16, 3, 3, 160, [1000 * 640, 640] * 3, True),
    (torch.bfloat16, 3, 3, 36, [1000 * 432, 432] * 3,
     False),  # a head dim off the 8-element grid
    (torch.bfloat16, 3, 3, 264, [1000 * 1056, 1056] * 3, False),  # past 256
    (torch.bfloat16, 2, 4, 64, [1000 * 768, 768] * 3, False),  # Nk past 3
    (torch.bfloat16, 4, 2, 64, [1000 * 768, 768] * 3, False),  # Nq past 3
    (torch.bfloat16, 8, 8, 64, [1000 * 768, 768] * 3, False),
    (torch.bfloat16, 0, 3, 64, [8, 768] * 3, False),  # no query
    (torch.bfloat16, 3, 3, 64, A_STACK * 2 + [4096 * 2304, 2300],
     False),  # a row stride of v off the grid
    (torch.bfloat16, 3, 3, 64, [0, 768] + [4096 * 768, 768] * 2,
     False),  # a broadcast token dim
    (torch.float32, 3, 3, 64, A_STACK * 3, False),  # fp32: the warp kernel
    (torch.float16, 3, 3, 64, A_STACK * 3, False),
]


@pytest.mark.parametrize("dtype,nq,nk,head_dim,strides,want",
                         PAIRWISE_ROUTE_CASES)
def test_pairwise_bwd_tma_route(dtype, nq, nk, head_dim, strides, want):
    assert kernels.pairwise_bwd_tma_route(dtype, nq, nk, head_dim,
                                          strides) is want


@pytest.mark.parametrize("dtype,nq,nk,head_dim,strides,want",
                         PAIRWISE_ROUTE_CASES)
def test_pairwise_fwd_tma_route(dtype, nq, nk, head_dim, strides, want):
    """K1-fwd takes its streaming route on exactly K1-bwd's shapes."""
    assert kernels.pairwise_fwd_tma_route(dtype, nq, nk, head_dim,
                                          strides) is want


@pytest.mark.parametrize("f,want", [(2, True), (1, False), (3, False),
                                    (4, False)])
def test_hash_bwd_dense_route(f, want):
    """K2-bwd writes the dense gradient whole at F = 2, every Grid4D
    configuration's."""
    assert kernels.hash_bwd_dense_route(f) is want


def test_pairwise_strides_ignore_dims_of_extent_one():
    x = torch.empty((1, 1, 64)).as_strided((1, 1, 64), (3, 5, 1))
    assert kernels._pairwise_strides(x) == [8, 8]
    y = torch.empty((3, 4, 3 * 64))[..., :64]
    assert kernels._pairwise_strides(y) == [4 * 192, 192]


def _astack_fusion_views(cross):
    """The q, k, v (and head count) that the A-stack's fusion attention
    (768 wide, 12 heads, 3 tokens) hands K1: at a self-attention site the
    fused qkv projection's views, at a cross-attention site q and the kv
    projection's views."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke

    cfg = chip_smoke.astack_config()
    attn = fusion.FusionAttention(cfg.fusion, Init(
        torch.Generator().manual_seed(0), "cpu"), torch.bfloat16)
    seen = {}

    def capture(q, k, v, **kwargs):
        seen.update(q=q, k=k, v=v, n_heads=kwargs["n_heads"])
        return torch.zeros_like(q)

    x = torch.zeros((3, 4, cfg.fusion.universal_dim))
    with mock.patch.object(fusion, "pairwise_token_attention", capture), \
            torch.no_grad():
        attn(x, x if cross else None)
    return seen["q"], seen["k"], seen["v"], seen["n_heads"]


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_astack_fusion_views_take_the_k1_bwd_streaming_route(cross):
    """The A-stack's fusion attention hands K1 q, k and v whose shapes and
    strides K1-bwd's streaming route takes, with 16-byte starts (no copy on
    the card)."""
    q, k, v, n_heads = _astack_fusion_views(cross)
    assert q.dtype == torch.bfloat16 and not v.is_contiguous()
    head_dim = q.shape[-1] // n_heads
    assert head_dim == 64
    strides = [s for t in (q, k, v) for s in kernels._pairwise_strides(t)]
    assert kernels.pairwise_bwd_tma_route(q.dtype, q.shape[0], k.shape[0],
                                          head_dim, strides)
    for t in (q, k, v):
        assert t.stride(-1) == 1 and (2 * t.storage_offset()) % 16 == 0


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_astack_fusion_views_take_the_k1_fwd_streaming_route(cross):
    """The same views take K1-fwd's streaming route, through the dispatch's
    own rule (kernels._pairwise_on_grid), with 16-byte starts."""
    q, k, v, n_heads = _astack_fusion_views(cross)
    assert q.dtype == torch.bfloat16 and not v.is_contiguous()
    assert kernels._pairwise_on_grid(kernels.pairwise_fwd_tma_route, q, k, v,
                                     n_heads)
    for t in (q, k, v):
        assert t.stride(-1) == 1 and (2 * t.storage_offset()) % 16 == 0


def test_tma_strides_ignore_dims_of_extent_one():
    x = torch.empty((1, 3, 10, 48)).as_strided((1, 3, 10, 48),
                                               (5, 480, 48, 1))
    assert kernels._tma_strides(x) == [8, 480, 48]


def _multimodal_vision_mla():
    """The vision encoder's MLA of the multimodal model (universal dim 512,
    8 heads: Dqk 48, Dv 32)."""
    m = ModalityConfig(name="vision", input_dim=1408, n_tokens=16,
                       encoder_layers=1, encoder_heads=8)
    return encoder_transformer_config(m, 512).mla


def _flagship_vision_mla():
    """The flagship's vision encoder MLA (universal dim 2048: Dqk 128, Dv
    128)."""
    cfg = integrated_config(use_deepseek_fusion=True)
    return encoder_transformer_config(cfg.modalities["vision"],
                                      cfg.fusion.universal_dim).mla


@pytest.mark.parametrize("make_cfg,d_qk,d_v", [
    (_multimodal_vision_mla, 48, 32),
    (_flagship_vision_mla, 128, 128),
], ids=["multimodal", "flagship"])
def test_mla_flash_views_take_the_tma_route(make_cfg, d_qk, d_v):
    """At 4608 patches the MLA's q, k and v (v a strided view of its kv
    projection) have the head dims, strides and 16-byte starts the TMA
    route takes. On the CPU the gate runs dot_product_attention on the same
    views, so the views are captured there (not computed)."""
    cfg = make_cfg()
    assert cfg.use_flash_attention and CLIP_PATCHES >= cfg.flash_min_seq
    gen = torch.Generator().manual_seed(0)
    mla = deepseek.MLAttention(cfg, Init(gen, "cpu"), torch.float32)
    seen = {}

    def capture(q, k, v, **kwargs):
        seen.update(q=q, k=k, v=v)
        return torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype)

    x = torch.zeros((2, CLIP_PATCHES, cfg.hidden_dim))
    with mock.patch.object(deepseek, "dot_product_attention", capture), \
            torch.no_grad():
        mla(x)
    q, k, v = seen["q"], seen["k"], seen["v"]
    assert q.shape[-1] == k.shape[-1] == d_qk and v.shape[-1] == d_v
    assert not v.is_contiguous()  # the kv projection's view, read in place
    strides = [s for t in (q, k, v) for s in kernels._tma_strides(t)]
    assert kernels.flash_fwd_tma_route(torch.bfloat16, d_qk, d_v, strides)
    assert kernels.flash_bwd_tma_route(torch.bfloat16, d_qk, d_v, strides)
    for t in (q, k, v):  # 16-byte starts in bf16: no copy on the card
        assert t.stride(-1) == 1 and (2 * t.storage_offset()) % 16 == 0


def _capture(module, site, x, *args):
    """The q, k, v that ``module`` hands ``site.dot_product_attention`` on
    x, captured on the CPU (nothing is computed)."""
    seen = {}

    def capture(q, k, v, **kwargs):
        seen.update(q=q, k=k, v=v)
        return torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype)

    with mock.patch.object(site, "dot_product_attention", capture), \
            torch.no_grad():
        module(x, *args)
    return seen["q"], seen["k"], seen["v"]


def _assert_k3_tma(q, k, v, d_qk, d_v):
    """K3 takes these views (its router's shape gate) and the TMA routes of
    K3-fwd and K3-bwd take them in place (16-byte starts: no copy on the
    card)."""
    assert q.shape[-1] == k.shape[-1] == d_qk and v.shape[-1] == d_v
    assert attention_vmem.supported(q.shape[2], k.shape[2], d_qk, d_v,
                                    False, False)
    strides = [s for t in (q, k, v) for s in kernels._tma_strides(t)]
    assert kernels.vmem_fwd_tma_route(torch.bfloat16, d_qk, d_v, strides)
    assert kernels.vmem_bwd_tma_route(torch.bfloat16, d_qk, d_v, strides)
    for t in (q, k, v):
        assert t.stride(-1) == 1 and (2 * t.storage_offset()) % 16 == 0


@pytest.mark.parametrize("make_cfg,d_qk,d_v", [
    (_multimodal_vision_mla, 48, 32),
    (_flagship_vision_mla, 128, 128),
], ids=["multimodal", "flagship"])
def test_mla_views_at_576_take_the_k3_tma_route(make_cfg, d_qk, d_v):
    """At 576 patches (the multimodal train step's and the flagship's) the
    MLA stays below the flash gate and runs K3 on the card; its q, k and v
    (v a strided view of the kv projection) take the TMA routes of K3-fwd
    and K3-bwd."""
    cfg = make_cfg()
    assert IMAGE_PATCHES < cfg.flash_min_seq
    mla = deepseek.MLAttention(cfg, Init(torch.Generator().manual_seed(0),
                                         "cpu"), torch.float32)
    q, k, v = _capture(mla, deepseek, torch.zeros((2, IMAGE_PATCHES,
                                                   cfg.hidden_dim)))
    assert not v.is_contiguous()
    _assert_k3_tma(q, k, v, d_qk, d_v)


def test_cross_attention_views_take_the_k3_tma_route():
    """The multimodal model's query-token cross-attention (16 tokens of 512
    into 576 patches, 8 heads of 64) runs K3, and its views take the TMA
    routes of K3-fwd and K3-bwd."""
    m = ModalityConfig(name="vision", input_dim=1408, n_tokens=16,
                       encoder_layers=1, encoder_heads=8)
    cross = encoders._CrossAttention(512, m.encoder_heads, Init(
        torch.Generator().manual_seed(0), "cpu"), torch.float32)
    q, k, v = _capture(cross, encoders, torch.zeros((2, m.n_tokens, 512)),
                       torch.zeros((2, IMAGE_PATCHES, 512)))
    _assert_k3_tma(q, k, v, 64, 64)
