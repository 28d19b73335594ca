"""Reconstruction decoders, PyTorch port of ``deepearth_tpu/models/decoders.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, Init, LayerNorm


class ModalityDecoder(nn.Module):
    """Shrinking MLP: hidden -> hidden -> hidden/2 -> out (LayerNorm eps
    1e-5, exact GELU)."""

    def __init__(self, hidden_dim: int, output_dim: int, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        cd = compute_dtype
        self.fc1 = Dense(hidden_dim, hidden_dim, init, cd)
        self.ln1 = LayerNorm(hidden_dim, 1e-5, init, cd)
        self.fc2 = Dense(hidden_dim, hidden_dim // 2, init, cd)
        self.ln2 = LayerNorm(hidden_dim // 2, 1e-5, init, cd)
        self.fc3 = Dense(hidden_dim // 2, output_dim, init, cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.ln1(self.fc1(x)))
        h = F.gelu(self.ln2(self.fc2(h)))
        return self.fc3(h)


class SpatiotemporalDecoder(nn.Module):
    """Shrinking MLP + sigmoid for normalized coordinates in [0, 1]:
    hidden -> hidden/2 -> hidden/4 -> out (3 spatial, 1 temporal)."""

    def __init__(self, hidden_dim: int, output_dim: int, init: Init,
                 compute_dtype: torch.dtype):
        super().__init__()
        cd = compute_dtype
        self.fc1 = Dense(hidden_dim, hidden_dim // 2, init, cd)
        self.ln1 = LayerNorm(hidden_dim // 2, 1e-5, init, cd)
        self.fc2 = Dense(hidden_dim // 2, hidden_dim // 4, init, cd)
        self.ln2 = LayerNorm(hidden_dim // 4, 1e-5, init, cd)
        self.fc3 = Dense(hidden_dim // 4, output_dim, init, cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.ln1(self.fc1(x)))
        h = F.gelu(self.ln2(self.fc2(h)))
        return torch.sigmoid(self.fc3(h))
