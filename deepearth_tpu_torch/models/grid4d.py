"""Grid4D spacetime encoder, PyTorch port of ``deepearth_tpu/models/grid4d.py``.

Hash mode encodes xyz and t (and, with ``use_decompositions``, xyt/yzt/xzt)
through hash grids, all of them at once by ``ops.grid4d_encode`` (one kernel
launch on the card); 'sincos' mode is the table-free periodic-time +
multi-scale-space MLP. Masks multiply the features: a masked coordinate
contributes zeros.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import Grid4DConfig
from ..ops.grid4d_encode import DECOMPOSITIONS, grid4d_encode
from ..ops.hash_encoding import HashEncoding
from .layers import Dense, Init, LayerNorm

_PERIODS = ("hourly", "daily", "yearly")


def _masked(f: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return f if mask is None else f * mask[:, None].to(f.dtype)


class Grid4DEncoder(nn.Module):
    """(x, y, z, t) -> hidden_dim embedding."""

    def __init__(self, cfg: Grid4DConfig, hidden_dim: int, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = cd = compute_dtype
        if cfg.encoding_mode == "sincos":
            fd = cfg.sincos_feat_dim
            for name in _PERIODS:
                self.add_module(f"temporal_{name}", Dense(2, fd, init, cd))
            for i in range(len(cfg.spatial_scales_m)):
                self.add_module(f"spatial_scale{i}", Dense(3, fd, init, cd))
            n_feats = len(_PERIODS) + len(cfg.spatial_scales_m)
            self.fusion_in = Dense(n_feats * fd, cfg.sincos_mlp_dim, init, cd)
            self.fusion_out = Dense(cfg.sincos_mlp_dim, hidden_dim, init, cd)
            return
        if cfg.encoding_mode != "hash":
            raise ValueError(f"unknown encoding_mode {cfg.encoding_mode!r}")
        pd, g, dev = init.dtype, init.generator, init.device
        self.spatial = HashEncoding(cfg.spatial, pd, device=dev, generator=g)
        self.temporal = HashEncoding(cfg.temporal, pd, device=dev, generator=g)
        if cfg.use_decompositions:
            for name in DECOMPOSITIONS:
                self.add_module(name, HashEncoding(
                    cfg.decomposition, pd, device=dev, generator=g))
        self.proj_in = Dense(cfg.output_dim, hidden_dim, init, cd)
        # torch's LayerNorm default eps: hash features start near 1e-4, so
        # var << eps and eps sets the output scale
        self.proj_norm = LayerNorm(hidden_dim, 1e-5, init, cd)
        self.proj_out = Dense(hidden_dim, hidden_dim, init, cd)

    def forward(self, xyzt: torch.Tensor,
                spatial_mask: Optional[torch.Tensor] = None,
                temporal_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """xyzt: (B, 4) in [0, 1]; masks: (B,) bool, False zeroes the
        features. Returns (B, hidden_dim) in the compute dtype."""
        cfg = self.cfg
        if cfg.encoding_mode == "sincos":
            return self._sincos(xyzt, spatial_mask, temporal_mask)
        encs = [self.spatial, self.temporal]
        if cfg.use_decompositions:
            encs += [getattr(self, name) for name in DECOMPOSITIONS]
        combined = grid4d_encode(
            xyzt, [e.tables for e in encs], [e.resolutions for e in encs],
            [e.cfg for e in encs], spatial_mask, temporal_mask,
            out_dtype=self.compute_dtype)
        h = F.gelu(self.proj_norm(self.proj_in(combined)))
        return self.proj_out(h)

    def _sincos(self, xyzt, spatial_mask, temporal_mask):
        cfg, cd = self.cfg, self.compute_dtype
        two_pi = 2.0 * math.pi
        seconds = xyzt[:, 3] * cfg.time_span_seconds
        hours = (seconds / 3600.0) % 24.0
        days = (seconds / 86400.0) % 365.0
        years = seconds / (86400.0 * 365.0)
        periodic = {
            "hourly": two_pi * hours / 24.0,
            "daily": two_pi * days / 365.0,
            "yearly": two_pi * years,
        }
        feats = []
        for name in _PERIODS:
            # sin and cos of the fp32 angles in float64, rounded once to
            # fp32, as ops/rope.py takes them: torch's first fp32 CPU cos
            # of a process now and then keeps only about half the mantissa
            a = periodic[name].double()
            v = torch.stack([torch.sin(a), torch.cos(a)], -1).float().to(cd)
            feats.append(_masked(getattr(self, f"temporal_{name}")(v),
                                 temporal_mask))
        xyz_m = xyzt[:, :3] * cfg.spatial_span_meters
        for i, scale in enumerate(cfg.spatial_scales_m):
            f = getattr(self, f"spatial_scale{i}")((xyz_m / scale).to(cd))
            feats.append(_masked(f, spatial_mask))
        h = F.relu(self.fusion_in(torch.cat(feats, dim=-1)))
        return self.fusion_out(h)
