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

    Parameters go to the card unless the caller names another device
    (``device="cpu"``); without a card that default raises rather than
    building on the CPU. The generator must belong to ``device``
    (``torch.Generator(device=...)``), so that a model is made directly on
    its card from a seed.
    """

    def __init__(self, generator: torch.Generator, device="cuda",
                 dtype: torch.dtype = torch.float32):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the model is built on the card by default; "
                "pass device='cpu' (and a CPU generator) to build it on the "
                "CPU")
        self.generator = generator
        self.device = device
        self.dtype = dtype

    def empty(self, shape, dtype=None) -> torch.Tensor:
        return torch.empty(shape, device=self.device, dtype=dtype or self.dtype)

    def normal(self, shape, std: float = 0.02) -> nn.Parameter:
        return nn.Parameter(
            self.empty(shape).normal_(0.0, std, generator=self.generator))

    def lecun_normal(self, shape_out_in) -> nn.Parameter:
        """flax's default Dense and Conv kernel init: truncated normal, var
        1/fan_in, fan_in every axis but the first (a conv's (out, in, k):
        in * k)."""
        fan_in = math.prod(shape_out_in[1:])
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
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


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over one spatial axis, on (B, N, C) inputs, with its
    default 'SAME' padding: ceil(N / stride) outputs, the zeros split as
    flax splits them (the smaller half before). The weight is stored
    (out, in, kernel), as ``torch.nn.Conv1d`` stores it; the flax kernel is
    (kernel, in, out), so the two are each other's axes reversed."""

    def __init__(self, d_in: int, d_out: int, kernel_size: int, stride: int,
                 init: Init, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel_size, self.stride = kernel_size, stride
        self.weight = init.lecun_normal((d_out, d_in, kernel_size))
        self.bias = init.zeros((d_out,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, C_in) -> (B, ceil(N / stride), C_out)."""
        cd, k, s = self.compute_dtype, self.kernel_size, self.stride
        n = x.shape[1]
        pad = max((-(-n // s) - 1) * s + k - n, 0)
        h = F.pad(x.to(cd).transpose(1, 2), (pad // 2, pad - pad // 2))
        out = F.conv1d(h, self.weight.to(cd), self.bias.to(cd), stride=s)
        return out.transpose(1, 2)


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

    def attend(self, query: torch.Tensor) -> torch.Tensor:
        """flax ``Embed.attend``: query (..., dim) against every row, both in
        the compute dtype; (..., vocab). The tied LM head."""
        cd = self.compute_dtype
        return query.to(cd) @ self.weight.to(cd).T
