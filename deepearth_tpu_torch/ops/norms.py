"""Normalization layers, PyTorch port of ``deepearth_tpu/ops/norms.py``."""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    """Variance-only norm computed in fp32. The weight stays fp32 whatever
    the parameter dtype, as in the JAX package, and the normalized value is
    cast to the input dtype *before* the weight multiplies it, then cast
    again: in bf16 that order decides the rounding."""

    def __init__(self, dim: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                              device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        variance = xf.square().mean(dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(variance + self.eps)
        return (self.weight * xf.to(x.dtype)).to(x.dtype)
