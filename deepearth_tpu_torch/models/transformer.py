"""MLP blocks of the fusion stack, PyTorch port of
``deepearth_tpu/models/transformer.py`` (``KernelParam``, ``MLP``,
``GatedMLP``). The attention blocks of that module are not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import TransformerConfig
from .layers import Dense, Init


class KernelParam(nn.Module):
    """A bias-free projection weight, stored (out, in), that the caller
    concatenates with others into one matmul (q/k/v, gate/up)."""

    def __init__(self, d_in: int, d_out: int, init: Init):
        super().__init__()
        self.weight = init.normal((d_out, d_in), 0.02)

    def forward(self) -> torch.Tensor:
        return self.weight


class MLP(nn.Module):
    """GELU MLP: fc1 -> exact GELU -> fc2."""

    def __init__(self, cfg: TransformerConfig, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        hidden = int(cfg.hidden_dim * cfg.mlp_ratio)
        self.fc1 = Dense(cfg.hidden_dim, hidden, init, compute_dtype, std=0.02)
        self.fc2 = Dense(hidden, cfg.hidden_dim, init, compute_dtype, std=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class GatedMLP(nn.Module):
    """SiLU-gated MLP: (silu(x Wg) * x Wu) Wd, gate and up as one matmul."""

    def __init__(self, hidden_dim: int, mlp_ratio: float, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        inner = int(hidden_dim * mlp_ratio)
        self.compute_dtype = compute_dtype
        self.gate_proj = KernelParam(hidden_dim, inner, init)
        self.up_proj = KernelParam(hidden_dim, inner, init)
        self.down_proj = KernelParam(inner, hidden_dim, init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        w_gu = torch.cat([self.gate_proj(), self.up_proj()]).to(cd)
        gate, up = F.linear(x.to(cd), w_gu).chunk(2, dim=-1)
        return F.linear(F.silu(gate) * up, self.down_proj().to(cd))
