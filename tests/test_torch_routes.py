"""The routes that K3-bwd, K4 and K5-fwd take on the card, decided on the
CPU.

``kernels.gmm_fwd_tma_route``, ``kernels.flash_fwd_tma_route``,
``kernels.flash_bwd_tma_route`` and ``kernels.vmem_bwd_tma_route`` choose
between the wgmma kernels over TMA tiles, the mma.sync kernels and the
CUDA-core kernels from the shapes (and for the attention kernels the
strides) alone, so they are plain functions that run here. The MLA hands
K4 (at 4608 patches, its flash gate) or K3 (at 576, through
``dot_product_attention``) views of its projections: these tests build the
port's ``MLAttention`` on the CPU at the multimodal model's vision config
and at the flagship's, and the multimodal model's query-token
cross-attention, capture the q, k and v each forms, and hold their head
dims and strides to the TMA routes, so that the main path cannot slip onto
mma.sync unseen.
"""

from unittest import mock

import pytest
import torch

from deepearth_tpu_torch import kernels
from deepearth_tpu_torch.configs import ModalityConfig, integrated_config
from deepearth_tpu_torch.models import deepseek, encoders
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
# routes take them); K4-fwd, K4-bwd and K3-bwd share the rule
ATTENTION_ROUTE_CASES = [
    (torch.bfloat16, 48, 32, CONTIGUOUS * 3, True),  # the multimodal MLA
    (torch.bfloat16, 128, 128, [8 * 4608 * 128, 128, 1024] * 3, True),
    (torch.bfloat16, 64, 64, [64] * 9, True),
    (torch.bfloat16, 8, 8, [8] * 9, True),
    (torch.bfloat16, 136, 128, [8 * 136] * 9, False),  # past 128
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


@pytest.mark.parametrize("dtype,d_qk,d_v,strides,want", [
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
])
def test_vmem_bwd_tma_route(dtype, d_qk, d_v, strides, want):
    assert kernels.vmem_bwd_tma_route(dtype, d_qk, d_v, strides) is want


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
    """K3 takes these views (its router's shape gate) and K3-bwd's TMA
    route takes them in place (16-byte starts: no copy on the card)."""
    assert q.shape[-1] == k.shape[-1] == d_qk and v.shape[-1] == d_v
    assert attention_vmem.supported(q.shape[2], k.shape[2], d_qk, d_v,
                                    False, False)
    strides = [s for t in (q, k, v) for s in kernels._tma_strides(t)]
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
    (v a strided view of the kv projection) take K3-bwd's TMA route."""
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
    into 576 patches, 8 heads of 64) runs K3, and its views take K3-bwd's
    TMA route."""
    m = ModalityConfig(name="vision", input_dim=1408, n_tokens=16,
                       encoder_layers=1, encoder_heads=8)
    cross = encoders._CrossAttention(512, m.encoder_heads, Init(
        torch.Generator().manual_seed(0), "cpu"), torch.float32)
    q, k, v = _capture(cross, encoders, torch.zeros((2, m.n_tokens, 512)),
                       torch.zeros((2, IMAGE_PATCHES, 512)))
    _assert_k3_tma(q, k, v, 64, 64)
