"""Multi-resolution hash encoding (InstantNGP-style), PyTorch port.

Counterpart of ``deepearth_tpu/ops/hash_encoding.py``: the same XOR-prime
uint32 hash, level stacking into one (L, T, F) table, corner order and
d-linear weight order, so fp32 results agree with the JAX package to
rounding.

:func:`hash_encode` dispatches on the device of its input: a CUDA tensor
goes to the hand-written kernel (``kernels/csrc/hash_encode.cu``), a CPU
tensor to :func:`hash_encode_plain`, the plain PyTorch version of the same
function.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import kernels
from ..configs import HashEncodingConfig

HASH_PRIMES = (1, 2654435761, 805459861, 3674653429)
_U32 = 0xFFFFFFFF


def _corner_offsets(coords_dim: int):
    """All 2^D corner offsets of a unit cell; corner c has bit d = (c >> d) & 1."""
    return [[(c >> d) & 1 for d in range(coords_dim)]
            for c in range(1 << coords_dim)]


def hash_grid_indices(grid_coords: torch.Tensor, table_size: int,
                      coords_dim: int) -> torch.Tensor:
    """XOR-prime hash of integer grid coordinates.

    The JAX package hashes in uint32. Here the arithmetic is int64 masked to
    the low 32 bits after every multiply: an int64 product keeps its low 32
    bits exact even when it overflows, so the indices are identical.

    Args:
        grid_coords: (..., D) integer grid cell coordinates.
        table_size: hash table length; the modulo follows the 32-bit wrap.
        coords_dim: D.

    Returns:
        (...,) int64 indices in [0, table_size).
    """
    g = grid_coords.to(torch.int64) & _U32
    h = (g[..., 0] * HASH_PRIMES[0]) & _U32
    for d in range(1, coords_dim):
        h = h ^ ((g[..., d] * HASH_PRIMES[d]) & _U32)
    if table_size & (table_size - 1) == 0:
        return h & (table_size - 1)
    return h % table_size


def hash_encode_plain(coords: torch.Tensor, tables: torch.Tensor,
                      resolutions: torch.Tensor, *,
                      interpolation: str = "linear",
                      table_size: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`hash_encode` (any device)."""
    if interpolation not in ("linear", "nearest"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    L, T, F = tables.shape
    table_size = table_size or T
    D = coords.shape[-1]
    batch_shape = coords.shape[:-1]
    flat = coords.reshape(-1, D).to(torch.float32)
    # (N, L, D): one fp32 multiply then floor, as the JAX code does
    scaled = flat[:, None, :] * resolutions.to(torch.float32)[None, :, None]
    floor = torch.floor(scaled)
    grid = floor.to(torch.int32)
    level_offset = torch.arange(L, device=coords.device) * T
    tflat = tables.reshape(L * T, F)

    def fetch(bits):  # (N, L, F)
        corner = torch.stack([grid[..., d] + bits[d] for d in range(D)], -1)
        idx = hash_grid_indices(corner, table_size, D) + level_offset
        return tflat[idx]

    if interpolation == "nearest":
        out = fetch([0] * D)
    else:
        frac = scaled - floor
        out = torch.zeros((flat.shape[0], L, F), dtype=torch.float32,
                          device=coords.device)
        for bits in _corner_offsets(D):
            w = torch.ones_like(frac[..., 0])
            for d in range(D):
                w = w * (frac[..., d] if bits[d] else 1.0 - frac[..., d])
            out = out + w[..., None] * fetch(bits)
    return out.reshape(*batch_shape, L * F)


def hash_encode(coords: torch.Tensor, tables: torch.Tensor,
                resolutions: torch.Tensor, *, interpolation: str = "linear",
                table_size: Optional[int] = None) -> torch.Tensor:
    """Encode continuous coordinates with a multi-level hash grid.

    Args:
        coords: (..., D) coordinates, typically in [0, 1].
        tables: (L, T, F) fp32 feature tables for all levels.
        resolutions: (L,) fp32 per-level grid resolutions.
        interpolation: 'linear' (d-linear over the 2^D corners) or 'nearest'.
        table_size: hash modulus (defaults to T).

    Returns:
        (..., L * F) fp32, point-major, then level, then feature.
    """
    if coords.device.type == "cpu":
        return hash_encode_plain(coords, tables, resolutions,
                                 interpolation=interpolation,
                                 table_size=table_size)
    if interpolation not in ("linear", "nearest"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    L, T, F = tables.shape
    D = coords.shape[-1]
    out = kernels.hash_encode_fwd(
        coords.reshape(-1, D).to(torch.float32), tables, resolutions,
        table_size or T, interpolation == "linear")
    return out.reshape(*coords.shape[:-1], L * F)


def init_hash_tables(cfg: HashEncodingConfig, *, generator: torch.Generator,
                     device=None, dtype=torch.float32) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) tables of shape (L, T, F)."""
    t = torch.empty(
        (cfg.n_levels, cfg.hash_table_size, cfg.n_features_per_level),
        device=device, dtype=dtype)
    return t.uniform_(-1e-4, 1e-4, generator=generator)


class HashEncoding(nn.Module):
    """Learned hash tables plus :func:`hash_encode`."""

    def __init__(self, cfg: HashEncodingConfig, param_dtype=torch.float32, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        # tables stay fp32 under a bf16 parameter dtype: bf16 would degrade
        # the d-linear interpolation
        dtype = torch.float32 if param_dtype == torch.bfloat16 else param_dtype
        self.tables = nn.Parameter(init_hash_tables(
            cfg, generator=generator, device=device, dtype=dtype))
        self.register_buffer(
            "resolutions",
            torch.tensor(cfg.resolutions, dtype=torch.float32, device=device),
            persistent=False)

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        return hash_encode(coords, self.tables, self.resolutions,
                           interpolation=self.cfg.interpolation,
                           table_size=self.cfg.hash_table_size)
