"""MLP-UNet multimodal reconstructors with skip connections, PyTorch port
of ``deepearth_tpu/models/mlp_unet.py``.

The encoder halves the width each stage (down to 32), the decoder doubles it
back with skip concatenation. Input-level masking hides a random share of
the input features; the masks come from a ``torch.Generator`` where JAX
takes a key (their shapes and rates are JAX's, their draws torch's).
:class:`BimodalMLPUNet` is the image <-> species system: one shared U-Net
reconstructs masked embeddings of either modality in one space, and
:func:`species_topk` retrieves species by cosine similarity against a
species table that is frozen (a buffer) or learned (a parameter).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, Init, LayerNorm, dropout

_LN_EPS = 1e-6  # flax's LayerNorm default


class MLPUNet(nn.Module):
    """1-D MLP U-Net over feature vectors: ``stem``, ``depth`` encoder
    stages (``enc_ln{i}``, ``enc{i}``, dropout, skip, ``down{i}``), as many
    decoder stages (``up{i}``, skip concatenated, ``dec_ln{i}``, ``dec{i}``,
    dropout), then ``head``."""

    def __init__(self, input_dim: int, output_dim: int, base_width: int = 512,
                 depth: int = 3, dropout: float = 0.0, *, init: Init,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = compute_dtype
        self.depth, self.p = depth, dropout
        self.compute_dtype = cd
        self.stem = Dense(input_dim, base_width, init, cd)
        width, widths = base_width, []
        h = base_width  # the running width
        for i in range(depth):
            self.add_module(f"enc_ln{i}", LayerNorm(h, _LN_EPS, init, cd))
            self.add_module(f"enc{i}", Dense(h, width, init, cd))
            widths.append(width)
            h, width = width, max(width // 2, 32)
            self.add_module(f"down{i}", Dense(h, width, init, cd))
            h = width
        for i in range(depth):
            w = widths[-(i + 1)]
            self.add_module(f"up{i}", Dense(h, w, init, cd))
            self.add_module(f"dec_ln{i}", LayerNorm(2 * w, _LN_EPS, init, cd))
            self.add_module(f"dec{i}", Dense(2 * w, w, init, cd))
            h = w
        self.head = Dense(h, output_dim, init, cd)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In training mode dropout draws its masks from ``generator``."""
        h = self.stem(x)
        skips = []
        for i in range(self.depth):
            h = getattr(self, f"enc_ln{i}")(h)
            h = F.gelu(getattr(self, f"enc{i}")(h))
            h = dropout(h, self.p, self.training, generator)
            skips.append(h)
            h = getattr(self, f"down{i}")(h)
        for i in range(self.depth):
            h = getattr(self, f"up{i}")(h)
            h = torch.cat([h, skips[-(i + 1)]], dim=-1)
            h = getattr(self, f"dec_ln{i}")(h)
            h = F.gelu(getattr(self, f"dec{i}")(h))
            h = dropout(h, self.p, self.training, generator)
        return self.head(h)


def input_feature_mask(generator: torch.Generator, shape: Tuple[int, ...],
                       mask_prob: float) -> torch.Tensor:
    """Per-feature keep mask (True = keep), each feature kept with
    probability 1 - mask_prob; on the generator's device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) < 1.0 - mask_prob


class MultimodalUNet(nn.Module):
    """Cross-modal U-Net: masked vision + language in, both reconstructed
    out. In training mode each input's features are hidden at its rate,
    the vision mask drawn first."""

    def __init__(self, vision_dim: int, language_dim: int,
                 base_width: int = 512, depth: int = 3,
                 vision_mask_prob: float = 0.0,
                 language_mask_prob: float = 0.3, *, init: Init,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vision_dim = vision_dim
        self.vision_mask_prob = vision_mask_prob
        self.language_mask_prob = language_mask_prob
        self.compute_dtype = compute_dtype
        n = vision_dim + language_dim
        self.unet = MLPUNet(n, n, base_width, depth, init=init,
                            compute_dtype=compute_dtype)

    def forward(self, vision: torch.Tensor, language: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """vision (B, S, Dv) or (B, Dv); language (B, Dl). In training mode
        the masks come from ``generator`` (required there)."""
        v = vision.to(self.compute_dtype)
        if v.dim() == 3:
            v = v.mean(dim=1)
        lang = language.to(self.compute_dtype)
        if self.training:
            if generator is None:
                raise ValueError("input masking in training mode needs a "
                                 "torch.Generator")
            v = v * input_feature_mask(generator, v.shape,
                                       self.vision_mask_prob)
            lang = lang * input_feature_mask(generator, lang.shape,
                                             self.language_mask_prob)
        out = self.unet(torch.cat([v, lang], dim=-1), generator)
        return {"vision_recon": out[..., : self.vision_dim],
                "language_recon": out[..., self.vision_dim:]}


class BimodalMLPUNet(nn.Module):
    """Image <-> species reconstructor: one shared :class:`MLPUNet`
    (``mlp_unet``: depth 2 from ``hidden_dim``, 512 -> 256 -> 128 at the
    defaults, dropout 0.1) reconstructs a masked embedding of either
    modality in the ``embedding_dim`` space. The species table is
    ``species_table`` if given (frozen: a buffer, never trained), else the
    learned parameter ``species_embeddings``."""

    def __init__(self, n_species: int, embedding_dim: int = 2048,
                 hidden_dim: int = 512, bottleneck_dim: int = 128,
                 mask_ratio: float = 0.5,
                 species_table: Optional[torch.Tensor] = None, *, init: Init,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_ratio = mask_ratio
        self.bottleneck_dim = bottleneck_dim
        self.compute_dtype = compute_dtype
        if species_table is not None:
            self.register_buffer("species_table", torch.as_tensor(
                species_table).to(device=init.device))
        else:
            self.species_embeddings = init.normal((n_species, embedding_dim))
        self.mlp_unet = MLPUNet(embedding_dim, embedding_dim, hidden_dim, 2,
                                0.1, init=init, compute_dtype=compute_dtype)

    def table(self) -> torch.Tensor:
        """The species table (S, embedding_dim) in the compute dtype."""
        t = (self.species_table if hasattr(self, "species_table")
             else self.species_embeddings)
        return t.to(self.compute_dtype)

    def forward(self, embedding: Optional[torch.Tensor] = None,
                species_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Reconstruct a masked embedding from exactly one of ``embedding``
        (the image direction, (B, D)) or ``species_ids`` (the species
        direction, (B,) ints). In training mode (with ``mask_ratio`` > 0)
        the mask and the dropout draw from ``generator``. Returns
        ``recon``, ``target``, ``mask`` and ``species_table``."""
        table = self.table()
        if (embedding is None) == (species_ids is None):
            raise ValueError("pass exactly one of embedding / species_ids")
        target = (embedding.to(self.compute_dtype) if embedding is not None
                  else table[species_ids.long()])
        if not self.training or self.mask_ratio <= 0:
            mask = torch.ones_like(target, dtype=torch.bool)
        else:
            if generator is None:
                raise ValueError("input masking in training mode needs a "
                                 "torch.Generator")
            mask = input_feature_mask(generator, target.shape,
                                      self.mask_ratio)
        recon = self.mlp_unet(target * mask, generator)
        return {"recon": recon, "target": target, "mask": mask,
                "species_table": table}


def species_topk(recon: torch.Tensor, species_table: torch.Tensor,
                 k: int = 1) -> torch.Tensor:
    """Cosine top-k species retrieval: recon (B, D) against species_table
    (S, D); (B, k) int32 species indices, best first."""
    r = recon / (torch.linalg.vector_norm(recon, dim=-1, keepdim=True) + 1e-8)
    t = species_table / (torch.linalg.vector_norm(
        species_table, dim=-1, keepdim=True) + 1e-8)
    return torch.topk(r @ t.T, k, dim=-1).indices.to(torch.int32)
