"""Perceiver-style shared latent pool, PyTorch port of
``deepearth_tpu/models/shared_space.py``.

Frozen backbone features of any modalities are projected to one width; a
pool of learned latents cross-attends into the concatenated tokens, then
self-attends; the latents' mean is the shared embedding, and a head per
modality reconstructs its pooled features from it. On the card the
cross-attention over 256-1024 tokens (576 V-JEPA2 patches and a language
token: 577 keys) takes the kernels K3 through ``dot_product_attention``,
as the JAX package takes its Pallas kernel; the latents' 32 x 32
self-attention stays on the plain path there, as in JAX.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import Dense, Init, LayerNorm

_LN_EPS = 1e-6  # flax's LayerNorm default


class LatentPool(nn.Module):
    """``n_latents`` learned latents; each of ``n_layers`` layers
    cross-attends them into the tokens (``cross{i}_q/k/v/o``), self-attends
    them (``self{i}_*``) and runs a GELU MLP (``mlp_up_{i}``,
    ``mlp_down_{i}``), each pre-LayerNormed and added back."""

    def __init__(self, n_latents: int = 32, dim: int = 256, n_heads: int = 8,
                 n_layers: int = 2, *, init: Init,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        D, cd = dim, compute_dtype
        self.n_heads, self.n_layers = n_heads, n_layers
        self.compute_dtype = cd
        self.latents = init.normal((1, n_latents, D))
        for i in range(n_layers):
            for site in (f"cross{i}", f"self{i}"):
                for w in "qkvo":
                    self.add_module(f"{site}_{w}",
                                    Dense(D, D, init, cd, use_bias=False))
            for name in ("cross_norm", "self_norm", "mlp_norm"):
                self.add_module(f"{name}_{i}", LayerNorm(D, _LN_EPS, init, cd))
            self.add_module(f"mlp_up_{i}", Dense(D, 4 * D, init, cd))
            self.add_module(f"mlp_down_{i}", Dense(4 * D, D, init, cd))

    def _attend(self, q_in, kv_in, site):
        B, Nq, D = q_in.shape
        Nk, H = kv_in.shape[1], self.n_heads
        Dh = D // H
        proj = lambda w, x: getattr(self, f"{site}_{w}")(x)  # noqa: E731
        q = proj("q", q_in).view(B, Nq, H, Dh).transpose(1, 2)
        k = proj("k", kv_in).view(B, Nk, H, Dh).transpose(1, 2)
        v = proj("v", kv_in).view(B, Nk, H, Dh).transpose(1, 2)
        o = dot_product_attention(q, k, v, scale=Dh ** -0.5)
        return proj("o", o.transpose(1, 2).reshape(B, Nq, D))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S, dim) -> latents (B, n_latents, dim)."""
        B = tokens.shape[0]
        z = self.latents.to(self.compute_dtype).expand(B, -1, -1)
        kv = tokens.to(self.compute_dtype)
        for i in range(self.n_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            z = z + self._attend(layer("cross_norm")(z), kv, f"cross{i}")
            z = z + self._attend(layer("self_norm")(z), z, f"self{i}")
            h = F.gelu(layer("mlp_up")(layer("mlp_norm")(z)))
            z = z + layer("mlp_down")(h)
        return z


class MultimodalSharedSpace(nn.Module):
    """Projection heads (``proj_{name}``), the shared latent pool
    (``pool``) and per-modality reconstruction heads (``recon_{name}``)
    over the modalities of ``modality_dims`` (name -> native feature
    dim)."""

    def __init__(self, modality_dims: Dict[str, int], dim: int = 256,
                 n_latents: int = 32, n_heads: int = 8, n_layers: int = 2, *,
                 init: Init, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = sorted(modality_dims)
        self.compute_dtype = compute_dtype
        for name in self.names:
            self.add_module(f"proj_{name}", Dense(
                modality_dims[name], dim, init, compute_dtype))
        self.pool = LatentPool(n_latents, dim, n_heads, n_layers, init=init,
                               compute_dtype=compute_dtype)
        for name in self.names:
            self.add_module(f"recon_{name}", Dense(
                dim, modality_dims[name], init, compute_dtype))

    def forward(self, features: Dict[str, torch.Tensor]
                ) -> Dict[str, object]:
        """features: {name: (B, S, Dn) or (B, Dn)} frozen-backbone
        features; the modalities present are projected in name order and
        concatenated along the tokens."""
        tokens, pooled = [], {}
        for name in self.names:
            if name not in features:
                continue
            f = features[name].to(self.compute_dtype)
            if f.dim() == 2:
                f = f[:, None, :]
            proj = getattr(self, f"proj_{name}")(f)
            tokens.append(proj)
            pooled[name] = proj.mean(dim=1)
        latents = self.pool(torch.cat(tokens, dim=1))
        shared = latents.mean(dim=1)
        recon = {name: getattr(self, f"recon_{name}")(shared)
                 for name in self.names if name in features}
        return {"shared_embedding": shared, "latents": latents,
                "modality_projections": pooled, "reconstructions": recon}
