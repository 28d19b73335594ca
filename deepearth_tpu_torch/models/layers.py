"""Parameter factory, dropout, and the flax layer equivalents the port's
modules use.

``Dense``, ``LayerNorm`` and ``Embed`` hold their parameters in the parameter
dtype and compute in the compute dtype, as flax's ``nn.Dense(dtype=...,
param_dtype=...)`` and friends do. Dense weights are stored (out, in), as
``torch.nn.Linear`` stores them; the flax kernel is (in, out).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Init:
    """Where new parameters live and the generator every draw comes from.

    The generator must belong to ``device`` (``torch.Generator(device=...)``),
    so that a model is made directly on its card from a seed.
    """

    def __init__(self, generator: torch.Generator, device=None,
                 dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.device = torch.device(device) if device is not None else None
        self.dtype = dtype

    def empty(self, shape, dtype=None) -> torch.Tensor:
        return torch.empty(shape, device=self.device, dtype=dtype or self.dtype)

    def normal(self, shape, std: float = 0.02) -> nn.Parameter:
        return nn.Parameter(
            self.empty(shape).normal_(0.0, std, generator=self.generator))

    def lecun_normal(self, shape_out_in) -> nn.Parameter:
        """flax's default Dense kernel init: truncated normal, var 1/fan_in."""
        std = math.sqrt(1.0 / shape_out_in[1]) / 0.87962566103423978
        return nn.Parameter(nn.init.trunc_normal_(
            self.empty(shape_out_in), 0.0, std, -2 * std, 2 * std,
            generator=self.generator))

    def zeros(self, shape) -> nn.Parameter:
        return nn.Parameter(self.empty(shape).zero_())

    def ones(self, shape) -> nn.Parameter:
        return nn.Parameter(self.empty(shape).fill_(1.0))


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: in training mode keep each element with
    probability 1 - p and scale it by 1 / (1 - p); the identity in eval mode
    or at p = 0. The mask comes from ``generator`` (on x's device), never
    from the global generator, as flax's comes from the 'dropout' rng."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.bernoulli(
        torch.full(x.shape, 1.0 - p, device=x.device), generator=generator)
    return torch.where(keep.bool(), x / (1.0 - p), torch.zeros_like(x))


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x @ W^T + b in the compute dtype."""

    def __init__(self, d_in: int, d_out: int, init: Init,
                 compute_dtype: torch.dtype, *, use_bias: bool = True,
                 std: float = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = (init.lecun_normal((d_out, d_in)) if std is None
                       else init.normal((d_out, d_in), std))
        self.bias = init.zeros((d_out,)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (scale and bias) in the compute dtype."""

    def __init__(self, dim: int, eps: float, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = init.ones((dim,))
        self.bias = init.zeros((dim,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.layer_norm(x.to(cd), self.weight.shape, self.weight.to(cd),
                            self.bias.to(cd), self.eps)


class Embed(nn.Module):
    """flax ``nn.Embed`` with normal(0.02) init; rows come out in the compute
    dtype."""

    def __init__(self, vocab: int, dim: int, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = init.normal((vocab, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight).to(self.compute_dtype)
