"""Multi-resolution hash encoding (InstantNGP-style), PyTorch port.

Counterpart of ``deepearth_tpu/ops/hash_encoding.py``: the same XOR-prime
uint32 hash, level stacking into one (L, T, F) table, corner order and
d-linear weight order, so fp32 results agree with the JAX package to
rounding.

:func:`hash_encode` is a ``torch.autograd.Function`` that dispatches on
the device of its input: for a CUDA tensor the forward and the table
gradient are the hand-written kernels K2-fwd and K2-bwd
(``kernels/csrc/hash_encode.cu``; K2-bwd writes the dense gradient whole
where ``kernels.hash_bwd_dense_route`` holds, F = 2), for a CPU tensor
their plain PyTorch versions :func:`hash_encode_plain` and
:func:`hash_encode_bwd_plain`.
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


def _cell_corners(coords: torch.Tensor, resolutions: torch.Tensor, L: int,
                  T: int, table_size: int, interpolation: str):
    """The table rows each point reads on each level, and their weights.

    Yields one (idx, w) per corner in the JAX corner order: idx (N, L) int64
    rows of the flattened (L*T, F) table, w (N, L) fp32 d-linear weights
    (None for nearest, whose one corner has weight 1). The forward and the
    backward both walk these, so the backward scatters to exactly the rows,
    with exactly the weights, that the forward gathered.
    """
    if interpolation not in ("linear", "nearest"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    D = coords.shape[-1]
    # (N, L, D): one fp32 multiply then floor, as the JAX code does
    scaled = coords[:, None, :] * resolutions.to(torch.float32)[None, :, None]
    floor = torch.floor(scaled)
    grid = floor.to(torch.int32)
    level_offset = torch.arange(L, device=coords.device) * T

    def index(bits):
        corner = torch.stack([grid[..., d] + bits[d] for d in range(D)], -1)
        return hash_grid_indices(corner, table_size, D) + level_offset

    if interpolation == "nearest":
        yield index([0] * D), None
        return
    frac = scaled - floor
    for bits in _corner_offsets(D):
        w = torch.ones_like(frac[..., 0])
        for d in range(D):
            w = w * (frac[..., d] if bits[d] else 1.0 - frac[..., d])
        yield index(bits), w


def hash_encode_plain(coords: torch.Tensor, tables: torch.Tensor,
                      resolutions: torch.Tensor, *,
                      interpolation: str = "linear",
                      table_size: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K2-fwd (any device)."""
    L, T, F = tables.shape
    D = coords.shape[-1]
    batch_shape = coords.shape[:-1]
    flat = coords.reshape(-1, D).to(torch.float32)
    tflat = tables.reshape(L * T, F)
    corners = _cell_corners(flat, resolutions, L, T, table_size or T,
                            interpolation)
    if interpolation == "nearest":
        out = tflat[next(corners)[0]]
    else:
        out = torch.zeros((flat.shape[0], L, F), dtype=torch.float32,
                          device=coords.device)
        for idx, w in corners:
            out = out + w[..., None] * tflat[idx]
    return out.reshape(*batch_shape, L * F)


def hash_encode_bwd_plain(coords: torch.Tensor, grad_out: torch.Tensor,
                          resolutions: torch.Tensor, tables_shape, *,
                          interpolation: str = "linear",
                          table_size: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K2-bwd, the twin of the JAX package's
    ``_packed_gather_bwd``: the gradient of :func:`hash_encode_plain` with
    respect to the tables, an ``index_add_`` of w * grad_out into an fp32
    (L, T, F) table. coords (..., D), grad_out (..., L*F)."""
    L, T, F = tables_shape
    D = coords.shape[-1]
    flat = coords.reshape(-1, D).to(torch.float32)
    g = grad_out.reshape(-1, L, F).to(torch.float32)
    grad = torch.zeros((L * T, F), dtype=torch.float32, device=coords.device)
    for idx, w in _cell_corners(flat, resolutions, L, T, table_size or T,
                                interpolation):
        src = g if w is None else w[..., None] * g
        grad.index_add_(0, idx.reshape(-1), src.reshape(-1, F))
    return grad.reshape(L, T, F)


class _HashEncode(torch.autograd.Function):
    """(K2-fwd, K2-bwd) for CUDA tensors, their plain versions for CPU
    tensors; differentiable with respect to the tables only."""

    @staticmethod
    def forward(ctx, coords, tables, resolutions, table_size, interpolation):
        ctx.save_for_backward(coords, resolutions)
        ctx.tables_shape, ctx.tables_dtype = tuple(tables.shape), tables.dtype
        ctx.table_size, ctx.interpolation = table_size, interpolation
        if coords.device.type == "cpu":
            return hash_encode_plain(coords, tables, resolutions,
                                     interpolation=interpolation,
                                     table_size=table_size)
        return kernels.hash_encode_fwd(coords, tables, resolutions,
                                       table_size, interpolation == "linear")

    @staticmethod
    def backward(ctx, grad_out):
        coords, resolutions = ctx.saved_tensors
        if coords.device.type == "cpu":
            grad = hash_encode_bwd_plain(
                coords, grad_out, resolutions, ctx.tables_shape,
                interpolation=ctx.interpolation, table_size=ctx.table_size)
        else:
            grad = kernels.hash_encode_bwd(
                coords, grad_out, resolutions, ctx.tables_shape,
                ctx.table_size, ctx.interpolation == "linear")
        return None, grad.to(ctx.tables_dtype), None, None, None


def hash_encode(coords: torch.Tensor, tables: torch.Tensor,
                resolutions: torch.Tensor, *, interpolation: str = "linear",
                table_size: Optional[int] = None) -> torch.Tensor:
    """Encode continuous coordinates with a multi-level hash grid,
    differentiable with respect to the tables.

    Args:
        coords: (..., D) coordinates, typically in [0, 1]. The JAX train
            step differentiates params only, so coords may not require grad.
        tables: (L, T, F) fp32 feature tables for all levels.
        resolutions: (L,) fp32 per-level grid resolutions.
        interpolation: 'linear' (d-linear over the 2^D corners) or 'nearest'.
        table_size: hash modulus (defaults to T).

    Returns:
        (..., L * F) fp32, point-major, then level, then feature.
    """
    if interpolation not in ("linear", "nearest"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if torch.is_grad_enabled() and coords.requires_grad:
        raise NotImplementedError(
            "hash_encode has no gradient with respect to coords; only the "
            "tables are differentiated, as in the JAX train step")
    L, T, F = tables.shape
    D = coords.shape[-1]
    out = _HashEncode.apply(coords.reshape(-1, D).to(torch.float32), tables,
                            resolutions, table_size or T, interpolation)
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
