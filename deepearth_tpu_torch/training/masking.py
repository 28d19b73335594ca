"""Spatiotemporal and modality masking for self-supervised reconstruction,
PyTorch port of ``deepearth_tpu/training/masking.py``.

Masks are boolean with True = visible: the model replaces a masked modality
with its learned mask token and zeroes masked coordinate features, and the
losses are taken over the masked entries only. Every draw comes from the
``torch.Generator`` the caller passes, on that generator's device; the bits
differ from ``jax.random``'s, the rates do not.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..configs import MaskingConfig


def _visible(generator: torch.Generator, shape, mask_prob: float
             ) -> torch.Tensor:
    """Bool tensor of ``shape``, each entry True with probability
    1 - mask_prob."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) >= mask_prob


def sample_masks(generator: torch.Generator, batch_size: int,
                 modality_names: Sequence[str], cfg: MaskingConfig,
                 modality_probs: Optional[Dict[str, float]] = None
                 ) -> Dict[str, object]:
    """Per-observation masks: 'spatial_mask' and 'temporal_mask' (B,) bool
    and 'modality_masks' {name: (B,) bool}; True = visible. A modality hides
    with its own probability from ``modality_probs``, else
    ``cfg.modality_mask_prob``."""
    modality_probs = modality_probs or {}
    return {
        "spatial_mask": _visible(generator, (batch_size,),
                                 cfg.spatial_mask_prob),
        "temporal_mask": _visible(generator, (batch_size,),
                                  cfg.temporal_mask_prob),
        "modality_masks": {
            name: _visible(generator, (batch_size,),
                           modality_probs.get(name, cfg.modality_mask_prob))
            for name in modality_names},
    }


def mae_patch_mask(generator: torch.Generator, batch_size: int,
                   n_patches: int, mask_prob: float) -> torch.Tensor:
    """MAE-style per-patch mask (B, P) bool, True = visible."""
    return _visible(generator, (batch_size, n_patches), mask_prob)


def mlm_token_mask(generator: torch.Generator, batch_size: int, seq_len: int,
                   mask_prob: float) -> torch.Tensor:
    """MLM-style per-token mask (B, S) bool, True = visible."""
    return _visible(generator, (batch_size, seq_len), mask_prob)
