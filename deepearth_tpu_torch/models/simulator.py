"""Inductive simulator, PyTorch port of ``deepearth_tpu/models/simulator.py``:
the deep DeepSeek-style transformer over fused tokens, its presets, the
token-level masking strategies and the per-dataset decoder heads.

The presets standard / high_precision / fast / ultra are the JAX package's
(24/32/12/48 layers, up to 128 experts; ``configs.simulator_config``). The
masking strategies draw from a ``torch.Generator`` where JAX takes a key:
their shapes and structure are JAX's, their draws are torch's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs import DeepSeekBlockConfig, simulator_config
from .deepseek import DeepSeekTransformer
from .layers import Dense, Init


class InductiveSimulator(nn.Module):
    """A learned mask token put in place of the hidden tokens, then the
    DeepSeek stack (``transformer``), with ``remat`` under ``remat_policy``.

    flax makes ``mask_token`` at the first call that passes a
    ``token_mask``; the port builds before any call, so ``mask_token=False``
    builds a simulator without one (the tree of a JAX simulator initialised
    without a mask), which then refuses a ``token_mask``.
    """

    def __init__(self, cfg: DeepSeekBlockConfig, init: Init,
                 compute_dtype: torch.dtype = torch.float32, *,
                 remat: bool = False, remat_policy: str = "full",
                 mask_token: bool = True):
        super().__init__()
        self.cfg = cfg
        if mask_token:
            self.mask_token = init.normal((1, 1, cfg.hidden_dim))
        self.transformer = DeepSeekTransformer(
            cfg, init, compute_dtype, remat=remat, remat_policy=remat_policy)

    def forward(self, tokens: torch.Tensor,
                token_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens (B, N, D); token_mask optional (B, N) bool, True =
        visible. Returns (B, N, D)."""
        if token_mask is not None:
            if not hasattr(self, "mask_token"):
                raise ValueError("this simulator was built without a mask "
                                 "token (mask_token=False)")
            tokens = torch.where(token_mask[..., None], tokens,
                                 self.mask_token.to(tokens.dtype))
        return self.transformer(tokens, generator=generator)


def create_inductive_simulator(
        preset: str = "standard", *, generator: torch.Generator,
        device="cuda", compute_dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32, remat: bool = False,
        remat_policy: str = "full", **overrides
) -> Tuple[InductiveSimulator, DeepSeekBlockConfig]:
    """The preset's config with ``overrides`` set on it (its fields, as in
    the JAX package), and a simulator built from it on ``device`` (the card
    unless the caller names another) with parameters drawn from
    ``generator``."""
    cfg = simulator_config(preset)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    init = Init(generator, device, param_dtype)
    return InductiveSimulator(cfg, init, compute_dtype, remat=remat,
                              remat_policy=remat_policy), cfg


class MaskingStrategy:
    """Token-level masks over a (B, N) token grid, True = visible. Tokens
    may carry (temporal, spatial) structure, ``grid`` = (T, S) with
    N = T * S. Each method draws from ``generator`` and returns a (batch,
    n_tokens) bool tensor on its device."""

    def __init__(self, mask_ratio: float = 0.15,
                 grid: Optional[Tuple[int, int]] = None):
        self.mask_ratio = mask_ratio
        self.grid = grid

    def _keep(self, generator: torch.Generator, shape) -> torch.Tensor:
        return torch.rand(shape, generator=generator,
                          device=generator.device) < 1.0 - self.mask_ratio

    def random(self, generator: torch.Generator, batch: int,
               n_tokens: int) -> torch.Tensor:
        """Each token kept with probability 1 - mask_ratio."""
        return self._keep(generator, (batch, n_tokens))

    def block(self, generator: torch.Generator, batch: int,
              n_tokens: int) -> torch.Tensor:
        """One contiguous block of round(n_tokens * mask_ratio) tokens (at
        least 1) hidden per sample."""
        block_len = max(1, int(round(n_tokens * self.mask_ratio)))
        start = torch.randint(0, max(1, n_tokens - block_len + 1), (batch,),
                              generator=generator, device=generator.device)
        pos = torch.arange(n_tokens, device=generator.device)[None, :]
        hidden = (pos >= start[:, None]) & (pos < start[:, None] + block_len)
        return ~hidden

    def temporal(self, generator: torch.Generator, batch: int,
                 n_tokens: int) -> torch.Tensor:
        """Whole temporal slices hidden (needs ``grid``)."""
        t, s = self._grid(n_tokens)
        return self._keep(generator, (batch, t)).repeat_interleave(s, dim=1)

    def spatial(self, generator: torch.Generator, batch: int,
                n_tokens: int) -> torch.Tensor:
        """Whole spatial positions hidden at every time (needs ``grid``)."""
        t, s = self._grid(n_tokens)
        return self._keep(generator, (batch, s)).repeat(1, t)

    def _grid(self, n_tokens: int) -> Tuple[int, int]:
        if self.grid is None:
            raise ValueError("temporal/spatial masking needs grid=(T, S)")
        t, s = self.grid
        if t * s != n_tokens:
            raise ValueError(f"grid {self.grid} != {n_tokens} tokens")
        return t, s


class DatasetSpecificDecoder(nn.Module):
    """Per-dataset linear reconstruction heads ``head_{name}`` from
    ``input_dim`` (flax takes it from the first call) to each
    ``output_dims`` entry."""

    def __init__(self, output_dims: Dict[str, int], input_dim: int,
                 init: Init, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = sorted(output_dims)
        for name in self.names:
            self.add_module(f"head_{name}", Dense(
                input_dim, output_dims[name], init, compute_dtype))

    def forward(self, fused: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, f"head_{name}")(fused)
                for name in self.names}
