"""Bidirectional cross-modal reconstruction, the C-stack, PyTorch port of
``deepearth_tpu/models/bidirectional.py``.

* :class:`VisionSequenceDecoder`: a conditioning vector -> the full V-JEPA2
  patch grid (T, H, W, C). Learned patch queries cross-attend into 4
  conditioning tokens and one matmul projects them to the channels. With 4
  keys the attention is the plain path on every device, as in JAX.
* :class:`BidirectionalReconstructor`: vision -> language and language ->
  vision (pooled, or the full grid).
* :class:`MultimodalAutoencoder`: pooled vision + language -> a fusion
  bottleneck -> reconstruction heads and a species classifier.

flax sizes each Dense from its first input; the port builds before any
data, so every module takes its input widths (the JAX defaults: V-JEPA2's
1408 per patch, a 7168-wide language embedding).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import Dense, Init, LayerNorm

_LN_EPS = 1e-6  # flax's LayerNorm default


class VisionSequenceDecoder(nn.Module):
    """Conditioning (B, cond_dim) -> (B, T, H, W, channels)."""

    def __init__(self, cond_dim: int,
                 grid: Tuple[int, int, int] = (8, 24, 24),
                 channels: int = 1408, hidden_dim: int = 512,
                 n_heads: int = 8, n_layers: int = 2, *, init: Init,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        D, cd = hidden_dim, compute_dtype
        self.grid, self.channels = tuple(grid), channels
        self.n_heads, self.n_layers = n_heads, n_layers
        self.compute_dtype = cd
        T, H, W = grid
        self.cond_proj = Dense(cond_dim, 4 * D, init, cd)
        self.patch_queries = init.normal((T * H * W, D))
        for i in range(n_layers):
            self.add_module(f"norm_{i}", LayerNorm(D, _LN_EPS, init, cd))
            for w in "qkvo":
                self.add_module(f"{w}_{i}", Dense(D, D, init, cd,
                                                  use_bias=False))
            self.add_module(f"mlp_norm_{i}", LayerNorm(D, _LN_EPS, init, cd))
            self.add_module(f"mlp_up_{i}", Dense(D, 2 * D, init, cd))
            self.add_module(f"mlp_down_{i}", Dense(2 * D, D, init, cd))
        self.channel_proj = Dense(D, channels, init, cd)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        B = cond.shape[0]
        T, H, W = self.grid
        P, D = T * H * W, self.patch_queries.shape[1]
        Hh = self.n_heads
        Dh = D // Hh
        cond_tokens = self.cond_proj(cond).view(B, 4, D)
        q = self.patch_queries.to(self.compute_dtype)[None].expand(B, P, D)
        for i in range(self.n_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            qh = layer("q")(layer("norm")(q)).view(B, P, Hh, Dh).transpose(
                1, 2)
            kh = layer("k")(cond_tokens).view(B, 4, Hh, Dh).transpose(1, 2)
            vh = layer("v")(cond_tokens).view(B, 4, Hh, Dh).transpose(1, 2)
            att = dot_product_attention(qh, kh, vh, scale=Dh ** -0.5)
            q = q + layer("o")(att.transpose(1, 2).reshape(B, P, D))
            mlp = layer("mlp_up")(layer("mlp_norm")(q))
            q = q + layer("mlp_down")(F.gelu(mlp))
        return self.channel_proj(q).view(B, T, H, W, self.channels)


class _MLPStack(nn.Module):
    """Dense -> LayerNorm -> GELU for every width of ``dims`` but the last,
    then a Dense to the last (``fc{i}``, ``ln{i}``)."""

    def __init__(self, in_dim: int, dims: Sequence[int], init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.n = len(dims)
        widths = [in_dim, *dims]
        for i in range(self.n):
            self.add_module(f"fc{i}", Dense(widths[i], widths[i + 1], init,
                                            compute_dtype))
            if i < self.n - 1:
                self.add_module(f"ln{i}", LayerNorm(widths[i + 1], _LN_EPS,
                                                    init, compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n - 1):
            x = F.gelu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(x)))
        return getattr(self, f"fc{self.n - 1}")(x)


class BidirectionalReconstructor(nn.Module):
    """vision <-> language cross-reconstruction: ``vision_to_language`` (an
    MLP over the pooled patches) and ``language_to_vision`` (an MLP to the
    pooled vision embedding) or, with ``full_vision_output``,
    ``language_to_vision_full`` (a :class:`VisionSequenceDecoder` to the
    whole patch grid)."""

    def __init__(self, vision_dim: int = 1408, language_dim: int = 7168,
                 hidden_dim: int = 512,
                 vision_grid: Tuple[int, int, int] = (8, 24, 24),
                 full_vision_output: bool = False, *, init: Init,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        h, cd = hidden_dim, compute_dtype
        self.compute_dtype = cd
        self.full_vision_output = full_vision_output
        self.vision_to_language = _MLPStack(
            vision_dim, (2 * h, 2 * h, language_dim), init, cd)
        if full_vision_output:
            self.language_to_vision_full = VisionSequenceDecoder(
                language_dim, vision_grid, vision_dim, h, init=init,
                compute_dtype=cd)
        else:
            self.language_to_vision = _MLPStack(
                language_dim, (2 * h, 2 * h, vision_dim), init, cd)

    def forward(self, vision: Optional[torch.Tensor] = None,
                language: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """vision (B, S, vision_dim) or (B, vision_dim); language (B,
        language_dim); either may be absent."""
        cd, out = self.compute_dtype, {}
        if vision is not None:
            v = vision.to(cd)
            if v.dim() == 3:
                v = v.mean(dim=1)  # the pooled patches
            out["language_from_vision"] = self.vision_to_language(v)
        if language is not None:
            lang = language.to(cd)
            out["vision_from_language"] = (
                self.language_to_vision_full(lang) if self.full_vision_output
                else self.language_to_vision(lang))
        return out


class MultimodalAutoencoder(nn.Module):
    """Fusion-bottleneck autoencoder with a species classifier."""

    def __init__(self, vision_dim: int = 1408, language_dim: int = 7168,
                 bottleneck_dim: int = 256, n_species: int = 232,
                 hidden_dim: int = 512, *, init: Init,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        h, z, cd = hidden_dim, bottleneck_dim, compute_dtype
        self.compute_dtype = cd
        self.vision_enc = _MLPStack(vision_dim, (h, h), init, cd)
        self.language_enc = _MLPStack(language_dim, (h, h), init, cd)
        self.bottleneck = _MLPStack(2 * h, (h, z), init, cd)
        self.vision_dec = _MLPStack(z, (h, vision_dim), init, cd)
        self.language_dec = _MLPStack(z, (h, language_dim), init, cd)
        self.classifier = Dense(z, n_species, init, cd)

    def forward(self, vision: torch.Tensor, language: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """vision (B, S, vision_dim) or (B, vision_dim); language (B,
        language_dim)."""
        cd = self.compute_dtype
        v = vision.to(cd)
        if v.dim() == 3:
            v = v.mean(dim=1)
        fused = torch.cat([self.vision_enc(v),
                           self.language_enc(language.to(cd))], dim=-1)
        z = self.bottleneck(fused)
        return {"embedding": z, "vision_recon": self.vision_dec(z),
                "language_recon": self.language_dec(z),
                "species_logits": self.classifier(z)}
